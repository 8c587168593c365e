"""LM training on one device, from the command line — the port of
``examples/lm/train_lm.py``.

A decoder-only transformer trained through ``make_train_step`` with
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

Differences from the JAX script: ``--device`` (default ``"cuda"``);
``--attn`` defaults to ``ring``, where the JAX script defaults to
``zigzag``: on one device zigzag splits every layer's attention into
three quadrant calls, and its sequence-parallel form is a later slice.
``--dp``/``--sp`` other than 1, ``--zero1``, ``--profile`` and the
zigzag/Ulysses schedules raise NotImplementedError.
"""

from __future__ import annotations

import argparse
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
                    help="data-parallel axis: 0 or 1 (one device)")
    ap.add_argument("--sp", type=int, default=0,
                    help="sequence-parallel axis: 0 or 1 (one device)")
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
                    help="shard optimizer state over dp (not in the port)")
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
                    help="device trace (not in the port)")
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


def _check_unported(args) -> None:
    if args.dp not in (0, 1) or args.sp not in (0, 1):
        raise NotImplementedError(
            f"dp={args.dp} x sp={args.sp} is a multi-device mesh, not in "
            f"the port yet (ROADMAP A4/A7); the port trains on one device")
    if args.zero1:
        raise NotImplementedError("--zero1 is not in the port yet "
                                  "(ROADMAP A4)")
    if args.profile:
        raise NotImplementedError("--profile is not in the port yet "
                                  "(ROADMAP A9: a torch.profiler bridge)")


def run(args) -> dict:
    """Train as the flags of :func:`build_parser` say; returns the run
    summary (loss curve, validation losses, tokens/s, config, a greedy
    sample)."""
    from lua_mapreduce_tpu_torch.device import resolve_device
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    from lua_mapreduce_tpu_torch.train import checkpoint as ckpt
    from lua_mapreduce_tpu_torch.train import optim
    from lua_mapreduce_tpu_torch.train.precision import with_f32_master

    _check_unported(args)
    args.dp, args.sp = 1, 1
    dev = resolve_device(args.device)
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
    if args.bf16:
        opt = with_f32_master(params.values(),
                              lambda ms: optim.adam(ms, 3e-3))
    else:
        opt = optim.adam(params.values(), 3e-3)
    step = tt.make_train_step(cfg, opt, attn=args.attn,
                              grad_accum=args.grad_accum)

    store = get_storage_from(args.ckpt) if args.ckpt else None
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
    if store is not None and args.resume and ckpt.exists(store, "lm.ckpt"):
        # strict load: a checkpoint of another configuration fails here
        loaded = ckpt.load_pytree(store, "lm.ckpt", state(),
                                  check_shapes=True, check_dtypes=True)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(loaded["params"][k])
        optim.load_state_tree(opt, loaded["opt"])
        start_step = int(loaded["step"])
        print(f"resumed from checkpoint at step {start_step}", flush=True)

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
            loss = step(params, toks, tgts)
            if i == start_step + 1:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                warm_t0 = time.time()
            # the loss is read (a device sync) only on the print cadence
            if i == start_step + 1 or i % 5 == 0 or i == args.steps:
                lf = float(loss)
                losses.append((i, round(lf, 4)))
                print(f"step {i:4d}  loss {lf:.4f}  "
                      f"({time.time() - t0:.1f}s)", flush=True)
                if target is not None and lf < target:
                    reached = True
                    print(f"target loss {target} reached at step {i}",
                          flush=True)
                    break
            if val_batch is not None and i % eval_every == 0:
                vl = val_loss_fn()
                val_losses.append((i, round(vl, 4)))
                if best_val is None or vl < best_val:
                    best_val, best_step = vl, i
                    if patience:
                        best_params = {k: v.detach().clone()
                                       for k, v in params.items()}
                print(f"  val  {i:4d}  loss {vl:.4f}"
                      + ("  (best)" if best_step == i else ""), flush=True)
                if patience and (i - best_step) >= patience * eval_every:
                    stopped_early = True
                    print(f"early stop at step {i}: no val improvement "
                          f"since step {best_step} "
                          f"({patience} evals)", flush=True)
                    break
            if store is not None and i % args.ckpt_every == 0:
                st = state()
                st["step"] = torch.tensor(i, dtype=torch.int32)
                saver.submit(store, "lm.ckpt", st)
                print(f"  checkpoint @ step {i}", flush=True)
    finally:
        saver.wait()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if patience and best_params is not None:
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(best_params[k])
        if store is not None:
            st = state()
            st["step"] = torch.tensor(best_step, dtype=torch.int32)
            ckpt.save_pytree(store, "lm.ckpt", st)
            print(f"  checkpoint restored to best-val step {best_step}",
                  flush=True)
    ran_any = i > start_step
    steps_done = i
    toks_per_step = args.batch * args.seq
    warm_s = time.time() - (warm_t0 or t0)
    tokens_per_sec = (toks_per_step * max(0, steps_done - start_step - 1)
                      / max(warm_s, 1e-9)) if ran_any else 0.0
    if ran_any:
        print(f"done: final loss {float(loss):.4f} "
              f"({args.attn} attention, one device, "
              f"grad_accum={args.grad_accum}, remat=on"
              + (", llama-style" if args.modern else "")
              + (f", window={args.window}" if args.window else "")
              + (", bf16+f32-master" if args.bf16 else "") + ")")

    with torch.no_grad():
        if not ran_any:
            sample = None
            print(f"checkpoint already at step {start_step} >= --steps "
                  f"{args.steps}; nothing to train", flush=True)
        elif data is None:
            # generate: prompt prefill + KV-cached greedy decode
            prompt = np.arange(8, dtype=np.int32)[None, :] % cfg.vocab
            out = tt.greedy_decode(params, torch.as_tensor(prompt), 8,
                                   cfg=cfg, use_prefill=True)[0].cpu()
            print(f"prompt {prompt[0].tolist()} -> continuation "
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
            print(f"sample: {sample!r}")

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
            "dp": 1, "sp": 1, "seq": args.seq,
            "batch": args.batch, "grad_accum": args.grad_accum,
            "attn": args.attn, "modern": args.modern, "tok": tok,
            "zero1": False, "bf16": args.bf16,
            "vocab": cfg.vocab, "d_model": cfg.d_model,
            "n_layers": cfg.n_layers, "d_ff": cfg.d_ff,
        },
        "sample": sample,
    }


if __name__ == "__main__":
    main()
