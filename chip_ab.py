#!/usr/bin/env python3
"""Compare two checkouts of the port on one NVIDIA card, in turns.

    python3 chip_ab.py <root A> <root B>

Runs the end-to-end phases of each checkout's own ``chip_smoke.py``
(digits, wide, serving, conv, LM training) in four child processes, in
the order A, B, B, A, so that drift of the card or of its host shows as
a difference between a checkout's two runs. Each checkout builds its own
kernels into its own ``build/kernels/``. Prints one line per metric with
the four readings, and writes them all to ``chiprun_out/chip_ab.json``
under the directory this script lies in. To compare a change with its
parent, unpack the parent into a directory that ``.gitignore`` lists:

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    python3 chip_ab.py build/parent .

Exits non-zero when CUDA is unavailable or a child fails.
"""

import json
import os
import subprocess
import sys

CHILD = r'''
import json, sys
import torch
import chip_smoke as cs
from lua_mapreduce_tpu_torch import ops
from lua_mapreduce_tpu_torch.ops import _build

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all()
gen = torch.Generator(device="cuda").manual_seed(0)
m = {}
m["digits wall s"] = cs.phase_digits(torch, ops)[2]
m["wide ms/step"] = cs.phase_wide(torch, ops, gen)[1]["step_ms"]
for tag, r in cs.phase_serving(torch, ops).items():
    for key in ("prefill_ms", "decode_step_ms", "step_kernel_ms"):
        m[f"serving {tag} {key}"] = r[key]
for name, r in cs.phase_conv(torch, ops, gen).items():
    for key in ("step_ms", "profiled_step_device_ms"):
        m[f"conv {name} {key}"] = r[key]
for tag, r in cs.phase_lm_train(torch, ops).items():
    for key in ("step_ms", "profiled_step_device_ms"):
        m[f"lm {tag} {key}"] = r[key]
    for kernel, ms in r["profiled_step_kernel_ms"].items():
        m[f"lm {tag} {kernel} ms"] = ms
print("RESULT " + json.dumps(m), flush=True)
'''


def run(root):
    """The metrics of one child run of ``root``'s phases."""
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                          capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{root}: exit {proc.returncode}\n"
                       f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")


def main(argv):
    import torch
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available", file=sys.stderr)
        return 2
    roots = [os.path.abspath(a) for a in argv[1:]]
    order = [("A", roots[0]), ("B", roots[1]), ("B", roots[1]),
             ("A", roots[0])]
    runs = [(tag, run(root)) for tag, root in order]
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{gpu}; A = {roots[0]}, B = {roots[1]}; runs A, B, B, A")
    for key in runs[0][1]:
        vals = "  ".join(f"{tag} {m[key]:10.4f}" for tag, m in runs)
        print(f"{key:48s} {vals}")
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "chip_ab.json"), "w") as f:
        json.dump({"gpu": gpu, "roots": roots, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
