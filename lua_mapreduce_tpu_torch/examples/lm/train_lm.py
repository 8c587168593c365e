"""LM training from the command line — the port of
``examples/lm/train_lm.py``.

A decoder-only transformer trained through ``make_train_step`` over a
(dp, sp) mesh (``--dp``, ``--sp``: batch over dp, sequence over sp,
``--attn`` ring / zigzag / ulysses over sp; ``--zero1`` shards the
optimizer state over dp), with
block rematerialization (``cfg.remat``, always on, as in the JAX
script), gradient accumulation (``--grad-accum``), optional bf16
parameters with f32 master weights (``--bf16``), atomic asynchronous
checkpoints to any storage spec (``--ckpt``, ``--ckpt-every``) and exact
resume (``--resume``: batches are seeded per step, so a resumed run is
the run that never stopped, bit for bit).

Synthetic task (default): tok[t+1] = (tok[t] + stride) % vocab with a
per-sequence stride. ``--data`` trains on a text file (or the repo's own
docs) with a char or word tokenizer, a held-out tail for validation
(``--val-frac``, ``--eval-every``) and early stopping (``--patience``).

    python -m lua_mapreduce_tpu_torch.examples.lm.train_lm --steps 30
    python -m lua_mapreduce_tpu_torch.examples.lm.train_lm --device cpu
    torchrun --nproc-per-node 4 -m lua_mapreduce_tpu_torch.examples.lm.\
train_lm --dp 2 --sp 2 --attn zigzag --zero1

The mesh needs a world of dp·sp ranks, one process each: started by
``torchrun`` (NCCL, rank r on card r), by ``parallel.mesh.spawn``, or —
for dp = sp = 1 — by the script itself (a world of one rank, NCCL on a
card, gloo with ``--device cpu``). ``--dp``/``--sp`` 0 factor the world
as the JAX script factors its devices. Every rank draws the same global
batch and trains on its tile (``shard_batch``; zigzag batches are
permuted there). Rank 0 prints and writes the checkpoint; under
``--zero1`` with dp > 1 each dp rank's optimizer chunks go to
``lm.dp{i}.ckpt`` beside it.

Differences from the JAX script: ``--device`` (default ``"cuda"``);
``--attn`` defaults to ``ring``, where the JAX script defaults to
``zigzag``: on one shard zigzag splits every layer's attention into
three quadrant calls. ``--profile DIR`` writes a ``torch.profiler``
trace of the run into DIR (``utils/profiling.device_trace``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from lua_mapreduce_tpu_torch.models import transformer as tt


def synthetic_batch(rng, vocab: int, batch: int, seq: int):
    """Sequences tok[t+1] = (tok[t] + stride) % vocab, stride ∈ {1, 2}."""
    start = rng.randint(0, vocab, (batch, 1))
    stride = rng.randint(1, 3, (batch, 1))
    toks = (start + stride * np.arange(seq + 1)) % vocab
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


# char-level tokenizer for the real-text mode: 64 classes, everything
# outside the set folds to index 0 (space)
_CHARSET = (" abcdefghijklmnopqrstuvwxyz0123456789.,;:!?'\"()-_/=+*#%<>[]\n`|")
_CHAR_TO_ID = {c: i for i, c in enumerate(_CHARSET)}
REPO_DOCS = "repo-docs"          # sentinel: train on this repo's docs


def load_corpus(data: str, tok: str = "char"):
    """``data`` is a path to a text file, or REPO_DOCS for the repo's own
    documentation. ``tok``: ``"char"`` (the 64-way charset) or
    ``"word:N"`` (the N most frequent corpus words, id 0 = <unk>).
    Returns (ids int32 array, id_to_str list, joiner string)."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    if data == REPO_DOCS:
        paths = [os.path.join(repo, p)
                 for p in ("README.md", "docs/DESIGN.md", "SURVEY.md")]
    else:
        paths = [data]
    text = "\n".join(open(p, encoding="utf-8", errors="replace").read()
                     for p in paths).lower()
    if tok == "char":
        ids = np.array([_CHAR_TO_ID.get(c, 0) for c in text], np.int32)
        return ids, list(_CHARSET), ""
    if tok.startswith("word:"):
        import collections
        import re
        n_vocab = int(tok.split(":", 1)[1])
        if n_vocab < 2:
            raise SystemExit(f"--tok {tok}: vocab must be >= 2")
        words = re.findall(r"[a-z0-9']+|[^\sa-z0-9']", text)
        common = collections.Counter(words).most_common(n_vocab - 1)
        id_to_str = ["<unk>"] + [w for w, _ in common]
        w_to_id = {w: i for i, w in enumerate(id_to_str)}
        ids = np.array([w_to_id.get(w, 0) for w in words], np.int32)
        return ids, id_to_str, " "
    raise SystemExit(f"unknown --tok {tok!r} (use 'char' or 'word:N')")


def corpus_batch(rng, data: np.ndarray, batch: int, seq: int):
    if len(data) < seq + 2:
        raise SystemExit(
            f"corpus has {len(data)} tokens — needs at least seq+2 = "
            f"{seq + 2} for one training window; use a bigger file or "
            f"a smaller --seq")
    off = rng.randint(0, len(data) - seq - 1, batch)
    idx = off[:, None] + np.arange(seq + 1)
    toks = data[idx]
    return toks[:, :-1], toks[:, 1:]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel mesh axis (0 = auto: factor the "
                         "world's ranks as dp x sp)")
    ap.add_argument("--sp", type=int, default=0,
                    help="sequence-parallel mesh axis (0 = auto)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--grad-accum", type=int, default=2)
    ap.add_argument("--attn", default="ring",
                    choices=["ring", "zigzag", "ulysses"])
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="grouped-query attention kv heads "
                         "(0 = n_heads, plain MHA)")
    ap.add_argument("--modern", action="store_true",
                    help="llama-style recipe: rope + rmsnorm + swiglu")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window attention")
    ap.add_argument("--zero1", action="store_true",
                    help="shard optimizer state over dp (ZeRO-1)")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 params with f32 master weights")
    ap.add_argument("--ckpt", default=None,
                    help="storage spec for checkpoints, e.g. shared:/tmp/lm")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true",
                    help="continue from --ckpt's lm.ckpt if present")
    ap.add_argument("--data", default=None,
                    help="real-text mode: a text file path, "
                         f"or '{REPO_DOCS}' for this repo's docs "
                         "(default: the synthetic stride task)")
    ap.add_argument("--tok", default="char",
                    help="corpus tokenizer: 'char' or 'word:N'")
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=128)
    ap.add_argument("--val-frac", type=float, default=0.1,
                    help="corpus tail held out for validation "
                         "(corpus mode only; 0 disables)")
    ap.add_argument("--eval-every", type=int, default=25,
                    help="steps between validation evals (corpus mode)")
    ap.add_argument("--patience", type=int, default=0,
                    help=">0: stop after this many evals without a new "
                         "best validation loss")
    ap.add_argument("--target-loss", type=float, default=None,
                    help="stop once train loss < target; the run FAILS "
                         "(exit 1) if it is never reached")
    ap.add_argument("--out-json", default=None,
                    help="write the run summary to this path")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="wrap the run in a torch.profiler trace written "
                         "to DIR (Chrome trace JSON)")
    return ap


def main() -> None:
    args = build_parser().parse_args()
    summary = run(args)
    if args.out_json:
        import json
        with open(args.out_json, "w") as f:
            json.dump(summary, f, indent=1)
            f.write("\n")
    if args.target_loss is not None and not summary["reached_target"]:
        final = summary["losses"][-1][1] if summary["losses"] else "n/a"
        raise SystemExit(
            f"target loss {args.target_loss} not reached in "
            f"{args.steps} steps (final {final})")


def _join_world(device: str) -> None:
    """Under a launcher that sets ``WORLD_SIZE`` > 1 (torchrun), join its
    world (``env://``: NCCL with rank r on card ``LOCAL_RANK`` for
    ``cuda``, gloo for ``cpu``); a world already running is kept."""
    import torch.distributed as dist
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) < 2:
        return
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")


def _mesh_shape(args) -> None:
    """Fill ``args.dp``/``args.sp`` from the running world's size as the
    JAX script fills them from its devices: both 0 → sp 2 when the size
    is even, dp the largest the batch and grad_accum split into; one 0 →
    the world over the other."""
    import torch.distributed as dist
    nv = dist.get_world_size() if dist.is_initialized() else 1
    if not args.dp and not args.sp:
        args.sp = 2 if nv % 2 == 0 else 1
        ga = max(args.grad_accum, 1)
        args.dp = next((d for d in range(nv // args.sp, 0, -1)
                        if args.batch % d == 0
                        and (args.batch // d) % ga == 0), None)
        if args.dp is None:
            raise SystemExit(
                f"no feasible dp: batch={args.batch} must split as "
                f"batch % dp == 0 with (batch // dp) % grad_accum == 0 "
                f"for some dp <= {nv // args.sp} (grad_accum={ga})")
    elif not args.dp or not args.sp:
        free = nv // max(args.dp, args.sp, 1)
        args.dp = args.dp or free
        args.sp = args.sp or free
    if args.dp * args.sp != nv:
        raise SystemExit(
            f"dp={args.dp} x sp={args.sp} needs a world of "
            f"{args.dp * args.sp} ranks, this one has {nv}: start it with "
            f"torchrun --nproc-per-node {args.dp * args.sp} (or "
            f"lua_mapreduce_tpu_torch.parallel.mesh.spawn)")


def run(args) -> dict:
    """Train as the flags of :func:`build_parser` say; returns the run
    summary (loss curve, validation losses, tokens/s, config, a greedy
    sample). With ``--profile`` the whole run is traced."""
    from lua_mapreduce_tpu_torch.utils.profiling import device_trace

    _join_world(args.device)
    _mesh_shape(args)
    with contextlib.ExitStack() as stack:
        if getattr(args, "profile", None):
            stack.enter_context(device_trace(args.profile))
        return _run(args)


def _run(args) -> dict:
    import torch.distributed as dist

    from lua_mapreduce_tpu_torch.parallel import zero1 as z1
    from lua_mapreduce_tpu_torch.parallel.mesh import make_mesh
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    from lua_mapreduce_tpu_torch.train import checkpoint as ckpt
    from lua_mapreduce_tpu_torch.train import optim
    from lua_mapreduce_tpu_torch.train.precision import with_f32_master

    mesh = make_mesh(dp=args.dp, mp=args.sp, device=args.device,
                     axis_names=("dp", "sp"))
    dev = mesh.device
    lead = dist.get_rank() == 0
    dp_i, sp_i = mesh.axis_index("dp"), mesh.axis_index("sp")

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    if args.batch % args.dp or args.seq % args.sp:
        raise SystemExit(f"batch {args.batch} x seq {args.seq} does not "
                         f"tile over dp={args.dp} x sp={args.sp}")
    tok = args.tok
    if tok != "char" and not args.data:
        raise SystemExit(f"--tok {tok} builds its vocab FROM the corpus;"
                         " it requires --data (the synthetic task is "
                         "char-mode only)")
    data, id_to_str, joiner = (load_corpus(args.data, tok) if args.data
                               else (None, list(_CHARSET), ""))
    vocab = 64 if tok == "char" else -(-len(id_to_str) // 128) * 128
    mk = (tt.TransformerConfig.llama_style if args.modern
          else tt.TransformerConfig)
    cfg = mk(vocab=vocab, d_model=args.d_model, n_heads=args.n_heads,
             n_layers=args.n_layers, d_ff=args.d_ff, max_seq=args.seq,
             remat=True, n_kv_heads=args.kv_heads, window=args.window)
    if args.window and args.attn != "ring":
        raise SystemExit("--window runs as the banded ring: use "
                         "--attn ring")
    params = tt.init_transformer(0, cfg, device=dev)
    if args.bf16:
        params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    params = {k: v.detach().requires_grad_(True) for k, v in params.items()}

    # optax.adam(3e-3), as the JAX script (train/optim.py says how)
    def make_opt(leaves):
        if args.bf16:
            return with_f32_master(leaves, lambda ms: optim.adam(ms, 3e-3))
        return optim.adam(leaves, 3e-3)

    if args.zero1:
        opt_state = z1.init_state(make_opt, params, mesh)
        opt = opt_state[1]
    else:
        opt = opt_state = make_opt(params.values())
    # zigzag batches are permuted when they are cut into tiles
    # (shard_batch), so the step never gathers a sequence
    zz = args.attn == "zigzag"
    step = tt.make_train_step(cfg, opt_state, mesh=mesh, attn=args.attn,
                              grad_accum=args.grad_accum, zigzag_layout=zz,
                              zero1=args.zero1)
    schedule = "zigzag" if zz else "contiguous"

    store = get_storage_from(args.ckpt) if args.ckpt else None
    # replicated state is written by rank 0; ZeRO-1 chunks by the first
    # sp rank of each dp index, to a file of their own when dp > 1
    sharded_state = args.zero1 and args.dp > 1
    ckpt_name = f"lm.dp{dp_i}.ckpt" if sharded_state else "lm.ckpt"
    writer = sp_i == 0 and (dp_i == 0 or sharded_state)
    target = args.target_loss
    val_frac = args.val_frac if data is not None else 0.0
    eval_every = max(1, args.eval_every)
    patience = args.patience
    val_batch = None
    if val_frac > 0:
        n_val = int(len(data) * val_frac)
        if n_val < args.seq + 2:
            raise SystemExit(
                f"--val-frac {val_frac} keeps only {n_val} tokens — "
                f"needs at least seq+2 = {args.seq + 2}")
        train_data, val_data = data[:-n_val], data[-n_val:]
        data = train_data
        n_win = min(16, max(1, (len(val_data) - 1) // args.seq))
        offs = np.linspace(0, len(val_data) - args.seq - 1, n_win,
                           dtype=np.int64)
        idx = offs[:, None] + np.arange(args.seq + 1)
        vt = torch.as_tensor(val_data[idx], device=dev).long()
        val_batch = (vt[:, :-1], vt[:, 1:])

    def val_loss_fn():
        with torch.no_grad():
            logits = tt.transformer_apply(params, val_batch[0], cfg=cfg)
            return float(torch.nn.functional.cross_entropy(
                logits.float().flatten(0, 1), val_batch[1].flatten()))

    def state():
        return {"params": params, "opt": optim.state_tree(opt),
                "step": torch.zeros((), dtype=torch.int32)}

    start_step = 0
    if store is not None and args.resume and ckpt.exists(store, ckpt_name):
        # strict load: a checkpoint of another configuration fails here
        loaded = ckpt.load_pytree(store, ckpt_name, state(),
                                  check_shapes=True, check_dtypes=True)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(loaded["params"][k])
        optim.load_state_tree(opt, loaded["opt"])
        start_step = int(loaded["step"])
        say(f"resumed from checkpoint at step {start_step}")

    losses, val_losses = [], []
    best_val, best_step, stopped_early = None, start_step, False
    best_params = None
    saver = ckpt.AsyncCheckpoint()
    reached = target is None
    t0 = time.time()
    warm_t0 = None              # tokens/sec excludes the first step
    i = start_step
    loss = None
    try:
        for i in range(start_step + 1, args.steps + 1):
            # per-step seeded batches: resume at step k sees exactly the
            # batches steps k+1.. would have seen
            rng = np.random.RandomState(1000 + 7919 * i)
            if data is not None:
                toks, tgts = corpus_batch(rng, data, args.batch, args.seq)
            else:
                toks, tgts = synthetic_batch(rng, cfg.vocab, args.batch,
                                             args.seq)
            loss = step(params, *tt.shard_batch(mesh, toks, tgts,
                                                schedule=schedule))
            if i == start_step + 1:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                warm_t0 = time.time()
            # the loss is read (a device sync) only on the print cadence
            if i == start_step + 1 or i % 5 == 0 or i == args.steps:
                lf = float(loss)
                losses.append((i, round(lf, 4)))
                say(f"step {i:4d}  loss {lf:.4f}  "
                    f"({time.time() - t0:.1f}s)")
                if target is not None and lf < target:
                    reached = True
                    say(f"target loss {target} reached at step {i}")
                    break
            if val_batch is not None and i % eval_every == 0:
                vl = val_loss_fn()
                val_losses.append((i, round(vl, 4)))
                if best_val is None or vl < best_val:
                    best_val, best_step = vl, i
                    if patience:
                        best_params = {k: v.detach().clone()
                                       for k, v in params.items()}
                say(f"  val  {i:4d}  loss {vl:.4f}"
                    + ("  (best)" if best_step == i else ""))
                if patience and (i - best_step) >= patience * eval_every:
                    stopped_early = True
                    say(f"early stop at step {i}: no val improvement "
                        f"since step {best_step} ({patience} evals)")
                    break
            if store is not None and writer and i % args.ckpt_every == 0:
                st = state()
                st["step"] = torch.tensor(i, dtype=torch.int32)
                saver.submit(store, ckpt_name, st)
                say(f"  checkpoint @ step {i}")
    finally:
        saver.wait()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if patience and best_params is not None:
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(best_params[k])
        if store is not None and writer:
            st = state()
            st["step"] = torch.tensor(best_step, dtype=torch.int32)
            ckpt.save_pytree(store, ckpt_name, st)
            say(f"  checkpoint restored to best-val step {best_step}")
    # every rank returns once every checkpoint of the run is written, so
    # a run started after this one (a --resume) reads the same files
    if dist.get_world_size() > 1:
        dist.barrier()
    ran_any = i > start_step
    steps_done = i
    toks_per_step = args.batch * args.seq
    warm_s = time.time() - (warm_t0 or t0)
    tokens_per_sec = (toks_per_step * max(0, steps_done - start_step - 1)
                      / max(warm_s, 1e-9)) if ran_any else 0.0
    if ran_any:
        say(f"done: final loss {float(loss):.4f} "
            f"({args.attn} attention, dp={args.dp} sp={args.sp}, "
            f"grad_accum={args.grad_accum}, remat=on"
            + (", llama-style" if args.modern else "")
            + (f", window={args.window}" if args.window else "")
            + (", zero1" if args.zero1 else "")
            + (", bf16+f32-master" if args.bf16 else "") + ")")

    with torch.no_grad():
        if not ran_any:
            sample = None
            say(f"checkpoint already at step {start_step} >= --steps "
                f"{args.steps}; nothing to train")
        elif data is None:
            # generate: prompt prefill + KV-cached greedy decode
            prompt = np.arange(8, dtype=np.int32)[None, :] % cfg.vocab
            out = tt.greedy_decode(params, torch.as_tensor(prompt), 8,
                                   cfg=cfg, use_prefill=True)[0].cpu()
            say(f"prompt {prompt[0].tolist()} -> continuation "
                f"{out[8:].tolist()} (stride-1 truth: "
                f"{[(8 + j) % cfg.vocab for j in range(8)]})")
            sample = out.tolist()
        else:
            p_len = min(32, max(4, cfg.max_seq // 4))
            n_new = min(48, cfg.max_seq - p_len)
            toks, _ = corpus_batch(rng, data, 1, p_len)
            out = tt.greedy_decode(params, torch.as_tensor(toks), n_new,
                                   cfg=cfg, use_prefill=True)[0].cpu()
            sample = joiner.join(id_to_str[t] if t < len(id_to_str)
                                 else "?" for t in out.tolist())
            say(f"sample: {sample!r}")

    return {
        "data": args.data or "synthetic-stride",
        "losses": losses,
        "val_losses": val_losses,
        "best_val": best_val,
        "best_step": best_step if best_val is not None else None,
        "stopped_early": stopped_early,
        "steps": steps_done,
        "resumed_at": start_step or None,
        "reached_target": reached,
        "target_loss": target,
        "tokens_per_sec": round(tokens_per_sec, 1),
        "platform": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "config": {
            "dp": args.dp, "sp": args.sp, "seq": args.seq,
            "batch": args.batch, "grad_accum": args.grad_accum,
            "attn": args.attn, "modern": args.modern, "tok": tok,
            "zero1": args.zero1, "bf16": args.bf16,
            "vocab": cfg.vocab, "d_model": cfg.d_model,
            "n_layers": cfg.n_layers, "d_ff": cfg.d_ff,
        },
        "sample": sample,
    }


if __name__ == "__main__":
    main()
