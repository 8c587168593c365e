"""lmr-trace CLI: inspect a run's flushed spans.

Copy of the JAX package's ``trace/__main__.py`` (the torch package imports
nothing of the JAX package).

    python -m lua_mapreduce_tpu_torch.trace STORAGE_SPEC [--top K]
        [--export chrome.json] [--format json]

STORAGE_SPEC is the task's storage ("shared:DIR" / "object:DIR" /
"mem:TAG" for an in-process store) — the same spec the server and
workers ran with; spans live there as ``_trace.*`` files. Default
output: the phase waterfall, per-op latency histograms (p50/p95/p99),
the pre-merge overlap measured from real spans, and the top-k slowest
jobs. ``--export`` writes Chrome trace-event JSON loadable in Perfetto
(ui.perfetto.dev) or chrome://tracing; ``--format json`` emits the
whole report as one machine-readable document.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m lua_mapreduce_tpu_torch.trace",
        description="Assemble and render lmr-trace spans from a store.")
    p.add_argument("storage", help="backend[:path] spec the traced task "
                                   "ran with (spans live as _trace.* "
                                   "files there)")
    p.add_argument("--top", type=int, default=10,
                   help="how many slowest jobs to list (default 10)")
    p.add_argument("--export", metavar="FILE", default=None,
                   help="write Chrome trace-event JSON (Perfetto / "
                        "chrome://tracing) to FILE")
    p.add_argument("--format", choices=("text", "json"), default="text")
    return p


def report(col) -> dict:
    """The full machine-readable report (the text renderer and the
    ``--format json`` output share it)."""
    return {"spans": len(col.spans),
            "phases": col.phase_waterfall(),
            "premerge_overlap": col.premerge_overlap(),
            "ops": col.op_stats(),
            "speculation": col.speculation_outcomes(),
            # engine per iteration + the lowering decision chain
            # (DESIGN §26): a silent in-graph→store fallback must be
            # visible in the default report, not only in raw spans
            "engines": {str(it): eng for it, eng
                        in col.engines_by_iteration().items()},
            "lowering": col.lowering_decisions(),
            # controller decision chain (lmr-autotune, DESIGN §29):
            # every applied knob change with its evidence payload
            "autotune": col.autotune_decisions()}


def _bar(frac: float, width: int = 32) -> str:
    n = max(0, min(width, int(round(frac * width))))
    return "#" * n + "." * (width - n)


def render_text(col, top: int) -> str:
    rep = report(col)
    out = [f"lmr-trace: {rep['spans']} spans"]
    rows = rep["phases"]
    if rows:
        t_lo = min(r["t0"] for r in rows)
        t_hi = max(r["t1"] for r in rows)
        width = max(t_hi - t_lo, 1e-9)
        out.append("\nphase waterfall (wall-aligned):")
        for r in rows:
            lead = int(round((r["t0"] - t_lo) / width * 32))
            span_w = max(1, int(round(r["window_s"] / width * 32)))
            bar = " " * lead + "=" * min(span_w, 32 - lead)
            out.append(f"  {r['phase']:>10} |{bar:<32}| "
                       f"{r['window_s']:8.3f}s window  "
                       f"{r['busy_s']:8.3f}s busy  {r['jobs']} jobs")
    if rep["engines"]:
        parts = [f"it{it}={eng}" for it, eng in rep["engines"].items()]
        out.append("\nengine per iteration: " + "  ".join(parts))
    for d in rep["lowering"]:
        if d["span"] == "lowering":
            out.append(f"lowering: engine={d.get('engine')} "
                       f"(requested={d.get('requested')}, "
                       f"verdict={d.get('verdict')}) — "
                       f"{d.get('reason', '')}")
        elif d["span"].startswith("lowering."):
            # per-stage hybrid verdict (DESIGN §28)
            out.append(f"lowering: stage {d.get('stage')} -> "
                       f"{d.get('engine')} "
                       f"(compiled={d.get('compiled')})")
        elif d["span"] == "hybrid.fallback":
            out.append(f"lowering: HYBRID FALLBACK it{d['it']} "
                       f"stage={d.get('stage')} — {d.get('reason', '')}")
        else:
            out.append(f"lowering: RUNTIME FALLBACK it{d['it']} — "
                       f"{d.get('reason', '')}")
    if rep["premerge_overlap"] is not None:
        out.append(f"\npre-merge overlap (from spans): "
                   f"{rep['premerge_overlap']:.2%} "
                   f"[{_bar(rep['premerge_overlap'])}]")
    if rep["ops"]:
        out.append("\nper-op latency (ms):")
        out.append(f"  {'op':<24} {'count':>7} {'p50':>9} {'p95':>9} "
                   f"{'p99':>9} {'max':>9} {'total_s':>9}")
        for name, st in rep["ops"].items():
            out.append(f"  {name:<24} {st['count']:>7} {st['p50_ms']:>9.3f} "
                       f"{st['p95_ms']:>9.3f} {st['p99_ms']:>9.3f} "
                       f"{st['max_ms']:>9.3f} {st['total_s']:>9.3f}")
    slow = col.slowest_jobs(top)
    if slow:
        out.append(f"\ntop {len(slow)} slowest jobs (total body time):")
        for r in slow:
            out.append(f"  {r['ns']}/{r['job']}: {r['body_s']:.3f}s over "
                       f"{r['executions']} execution(s) by "
                       f"{', '.join(r['workers'])}")
    for o in rep["speculation"]:
        out.append(f"\nspeculation: {o['ns']}/{o['job']} won by "
                   f"{o['winner']} (losers: "
                   f"{', '.join(o['losers']) or 'none'}; "
                   f"cancelled={o['cancelled']})")
    for d in rep["autotune"]:
        out.append(f"autotune: it{d['it']} {d['knob']} "
                   f"{d.get('old')} -> {d.get('new')} "
                   f"({d.get('metric')}={d.get('observed')}, "
                   f"threshold {d.get('threshold')})")
    return "\n".join(out)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    from lua_mapreduce_tpu_torch.trace.collect import TraceCollection
    col = TraceCollection.from_store(get_storage_from(args.storage))
    if not col.spans:
        print("no _trace.* spans found — was the run traced? "
              "(--trace / LMR_TRACE=1)", file=sys.stderr)
        return 1
    if args.export:
        doc = col.to_chrome()
        with open(args.export, "w") as f:
            json.dump(doc, f)
        print(f"wrote {len(doc['traceEvents'])} trace events to "
              f"{args.export} (load in ui.perfetto.dev)", file=sys.stderr)
    if args.format == "json":
        print(json.dumps(report(col), indent=2))
    else:
        print(render_text(col, args.top))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BrokenPipeError:
        # pipe-safety (`... | head`): the reader closing early is a
        # normal exit, not a traceback. Re-point stdout at devnull so
        # the interpreter's shutdown flush cannot re-raise.
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        code = 0
    raise SystemExit(code)
