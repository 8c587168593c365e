#!/usr/bin/env python3
"""Compare two checkouts of the port on one NVIDIA card, in turns.

    python3 chip_ab.py <root A> <root B>

Runs the end-to-end phases of each checkout's own ``chip_smoke.py``
(digits, wide, serving, conv, LM training), then k-means at SIFT1M's
shape and ALS at MovieLens-1M's through this script's own
``chip_smoke.py`` (``kmeans_timed``, ``als_timed``: the captured loops
of phases 15 and 16 without their full-size float64 checks, so that a
checkout older than them is measured the same way), in four child
processes, in the order A, B, B, A, so that drift of the card or of its
host shows as a difference between a checkout's two runs. Each checkout
builds its own kernels into its own ``build/kernels/``. Prints one line
per metric with
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
import importlib.util, json, sys
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
wide = cs.phase_wide(torch, ops, gen)[1]
for key in ("step_ms", "eager_step_ms"):
    if key in wide:
        m[f"wide {key}"] = wide[key]
for tag, r in cs.phase_serving(torch, ops).items():
    for key in ("prefill_ms", "decode_step_ms", "step_kernel_ms",
                "capture_ms", "decode_step_ms_without_capture",
                "eager_decode_step_ms"):
        if key in r:
            m[f"serving {tag} {key}"] = r[key]
for name, r in cs.phase_conv(torch, ops, gen).items():
    for key in ("step_ms", "eager_step_ms", "profiled_step_device_ms"):
        if key in r:
            m[f"conv {name} {key}"] = r[key]
for tag, r in cs.phase_lm_train(torch, ops).items():
    for key in ("step_ms", "profiled_step_device_ms"):
        m[f"lm {tag} {key}"] = r[key]
    for kernel, ms in r["profiled_step_kernel_ms"].items():
        m[f"lm {tag} {kernel} ms"] = ms
# the timed parts of phases 15-16 from this script's chip_smoke.py, run on
# the checkout's own package (the working directory comes first on the path)
spec = importlib.util.spec_from_file_location("chip_smoke_ab", sys.argv[1])
ab = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ab)
mesh = ab.card_mesh(torch)
km = ab.kmeans_timed(torch, ops, mesh)[1]
m["kmeans ms/iteration"] = km["replay_ms_per_iter"]
m["kmeans kernel ms/iteration"] = km["kernel_ms_per_iter"]
als = ab.als_timed(torch, ops, mesh)[1]
m["als ms/round"] = als["replay_ms_per_iter"]
m["als kernel ms/round"] = als["kernel_ms_per_iter"]
print("RESULT " + json.dumps(m), flush=True)
'''


def run(root):
    """The metrics of one child run of ``root``'s phases."""
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chip_smoke.py")
    proc = subprocess.run([sys.executable, "-c", CHILD, here], cwd=root,
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
    keys = list(dict.fromkeys(k for _, m in runs for k in m))
    for key in keys:
        vals = "  ".join(f"{tag} {m[key]:10.4f}" if key in m
                         else f"{tag} {'-':>10s}" for tag, m in runs)
        print(f"{key:48s} {vals}")
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "chip_ab.json"), "w") as f:
        json.dump({"gpu": gpu, "roots": roots, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
