"""``lmr-analyze``: the analysis CLI.

    python -m lua_mapreduce_tpu_torch.analysis \\
        [lint|deep|conc|protocol|task|rules|callgraph|all] [options]

``lint`` runs the per-function rule registry over the package (or
explicit paths); ``deep`` runs the interprocedural pass (call graph +
context propagation, LMR013+); ``conc`` runs the concurrency pass
(thread-spawn graph + interprocedural locksets + lock-order cycles,
LMR026-030) and re-finds the seeded races; ``task <module>...``
statically validates user task modules (contract + determinism +
lowerability verdict); ``protocol`` exhaustively model-checks the
lease lifecycle; ``callgraph`` prints the graph's size; ``all`` (the
default) runs lint + deep + conc + the stale-suppression audit +
protocol.

Exit code 0 = clean; with ``--fail-on-findings`` any surviving finding
exits 1 (the CI gate); ``--fail-on-stale`` exits 1 when a suppression
(inline pragma or baseline entry) no longer fires; a protocol violation
of the shipped model, an unresolvable/invalid task module, or a task
verdict differing from ``--expect`` always exits 1.

``--format json`` emits one machine-readable payload; ``--format
sarif`` (lint/deep/conc/task) emits SARIF 2.1.0 for CI/editor
annotation.

Copy of the JAX package's ``analysis/__main__.py`` over this package:
the default paths are ``lua_mapreduce_tpu_torch/`` and the default
baseline its own (empty) ``analysis/baseline.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from lua_mapreduce_tpu_torch.analysis import contracts as contracts_mod
from lua_mapreduce_tpu_torch.analysis import dataflow as dataflow_mod
from lua_mapreduce_tpu_torch.analysis import lint as lint_mod
from lua_mapreduce_tpu_torch.analysis import protocol as proto_mod
from lua_mapreduce_tpu_torch.analysis import sarif as sarif_mod


def _cmd_lint(args) -> tuple:
    findings = lint_mod.run_lint(args.paths or None,
                                 baseline=args.baseline)
    fail = bool(findings) and args.fail_on_findings
    return findings, fail


def _protocol_suite(args):
    """The default exhaustive sweep: the full lifecycle with worker
    death, then the failure path (release/mark-broken) on a smaller
    box, then the seeded-race regressions (each MUST be re-found)."""
    runs = []
    base = proto_mod.ModelConfig(n_workers=args.workers, n_jobs=args.jobs,
                                 batch_k=args.batch_k)
    runs.append(("lifecycle+death", base))
    runs.append(("failure-path", dataclasses.replace(
        base, n_jobs=2, batch_k=min(args.batch_k, 2), allow_fail=True,
        allow_death=False)))
    # the reconstruct-vs-requeue scavenge edge (DESIGN §20): budgeted
    # data-loss events + repair + lost-data requeue, exhaustively — on
    # a 2-job box so loss×death interleavings stay tractable
    runs.append(("replica-recovery", dataclasses.replace(
        base, n_jobs=2, batch_k=min(args.batch_k, 2),
        data_loss_budget=2)))
    # the duplicate-lease edge (DESIGN §21): speculate / claim_spec /
    # racing commits / revoke, exhaustively with worker death — PINNED
    # to a 2-worker 2-job box (~377k states; the spec dimension
    # multiplies the space, so the lifecycle box above stays spec-free,
    # and at 2 workers the model's tag-free claim_spec scan order
    # matches both engines exactly, keeping violation traces replayable)
    runs.append(("speculation", dataclasses.replace(
        base, n_workers=2, n_jobs=2,
        batch_k=min(args.batch_k, 2), allow_spec=True)))
    # the watch/notify edge (DESIGN §23): sleep / notify-wake /
    # timeout-fallback / lost-notification interleavings, exhaustively
    # with worker death — on a 2-job box (the wakeup-bit dimension
    # multiplies the space like the spec dimension does)
    runs.append(("notify-wakeup", dataclasses.replace(
        base, n_jobs=2, batch_k=min(args.batch_k, 2),
        allow_notify=True)))
    # the erasure-coded decode ladder (DESIGN §27): block-at-a-time
    # loss (lose_parity) + decode-repair + the rerun rung, exhaustively
    # — same 2-job box as replica-recovery, with the budget spent one
    # block at a time instead of one copy at a time
    runs.append(("coded-recovery", dataclasses.replace(
        base, n_jobs=2, batch_k=min(args.batch_k, 2),
        data_loss_budget=2, coded=True)))
    # the elastic join/leave edge (DESIGN §29): pool membership as
    # state — absent-worker join, idle-worker graceful retire — with
    # death, exhaustively on a 2-worker 2-job box (the membership
    # modes add little space; retire purity and the no-lease-abandoned
    # rule are the invariants that matter)
    runs.append(("elastic-pool", dataclasses.replace(
        base, n_workers=2, n_jobs=2, batch_k=min(args.batch_k, 2),
        elastic=True)))
    # the leader-lease/fencing edge (DESIGN §31): two contending
    # coordinators over one CAS lease — election, renewal, expiry
    # takeover, fenced zombie writes — exhaustively on a 2-job box
    # (the coordinator plane is job-transparent, so its invariants are
    # the overlap/zombie ones, not the job lifecycle)
    runs.append(("leader-lease", dataclasses.replace(
        base, n_jobs=2, batch_k=min(args.batch_k, 2), ha=True)))
    if args.seed_bug:
        bugs = [args.seed_bug]
    else:
        bugs = list(proto_mod.KNOWN_BUGS)
    out = []
    failed = False
    for name, cfg in runs:
        res = proto_mod.check_protocol(cfg)
        entry = {"run": name, "config": dataclasses.asdict(cfg),
                 "states": res.states, "transitions": res.transitions,
                 "quiescent_states": res.quiescent,
                 "wall_s": round(res.wall_s, 3), "ok": res.ok}
        if not res.ok:
            entry["violation"] = res.violation.message
            entry["trace"] = [list(t) for t in res.violation.trace]
            failed = True
        out.append(entry)
    for bug in bugs:
        extra = {}
        if bug in proto_mod.LOSS_BUGS:
            # loss-edge bugs are unreachable without loss events; the
            # smaller box keeps the seeded sweep fast
            extra = dict(n_jobs=2, batch_k=min(args.batch_k, 2),
                         data_loss_budget=2)
        elif bug in proto_mod.SPEC_BUGS:
            # spec-edge bugs need the duplicate-lease dimension and a
            # second worker to hold the shadow lease (pinned to 2 for
            # trace replayability, like the exhaustive run)
            extra = dict(n_workers=2, n_jobs=2,
                         batch_k=min(args.batch_k, 2), allow_spec=True)
        elif bug in proto_mod.NOTIFY_BUGS:
            # notify-edge bugs need the wakeup dimension plus at least
            # one lost-notification event to be reachable
            extra = dict(n_jobs=2, batch_k=min(args.batch_k, 2),
                         allow_notify=True)
        elif bug in proto_mod.ELASTIC_BUGS:
            # elastic-edge bugs need the pool-membership dimension and
            # a second worker (the last one starts absent)
            extra = dict(n_workers=2, n_jobs=2,
                         batch_k=min(args.batch_k, 2), elastic=True)
        elif bug in proto_mod.HA_BUGS:
            # HA-edge bugs need the coordinator plane: the lease clock,
            # two contenders, and the fencing guard on lead_write
            extra = dict(n_jobs=2, batch_k=min(args.batch_k, 2),
                         ha=True)
        elif bug in proto_mod.CODED_BUGS:
            # coded-edge bugs need the stripe data plane and enough
            # budget to degrade a stripe (and, for the decode-blind
            # requeue, to re-run a producer into the mid-commit window)
            extra = dict(n_jobs=2, batch_k=min(args.batch_k, 2),
                         data_loss_budget=2, coded=True)
        cfg = dataclasses.replace(base, bug=bug, **extra)
        res = proto_mod.check_protocol(cfg)
        entry = {"run": f"seeded:{bug}", "states": res.states,
                 "wall_s": round(res.wall_s, 3),
                 "found": not res.ok}
        if res.ok:
            entry["error"] = ("seeded bug NOT detected — the checker "
                              "lost its teeth")
            failed = True
        else:
            entry["violation"] = res.violation.message
            entry["trace_len"] = len(res.violation.trace)
        out.append(entry)
    return {"protocol": out}, failed


def _cmd_conc(args) -> tuple:
    """The concurrency pass plus the seeded-race pins: every race in
    KNOWN_RACES must be re-found on its fixture (the protocol checker's
    discipline — a pass that stops seeing a planted race has quietly
    lost its teeth, and the gate must say so, not stay green)."""
    from lua_mapreduce_tpu_torch.analysis import lockset as lockset_mod
    res = lockset_mod.analyze_conc(args.paths or None,
                                   baseline=args.baseline)
    fail = bool(res.findings) and args.fail_on_findings
    seeded = []
    for name, (_rel, rule, _src) in sorted(lockset_mod.KNOWN_RACES.items()):
        hits = lockset_mod.find_seeded(name)
        entry = {"run": f"seeded:{name}", "rule": rule,
                 "found": bool(hits)}
        if not hits:
            entry["error"] = ("seeded race NOT re-found — the conc "
                              "pass lost its teeth")
            fail = True
        seeded.append(entry)
    return res, seeded, fail


def _cmd_task(args) -> tuple:
    """Check every task-module spec; the payload carries one report per
    spec. Fails on findings (always — an invalid task module is never a
    soft result) and on an ``--expect`` verdict mismatch."""
    reports = [contracts_mod.check_task(spec) for spec in args.paths]
    expected = []
    for pin in args.expect_stage or ():
        name, _, want = pin.partition("=")
        if not want:
            raise SystemExit(f"--expect-stage needs NAME=VERDICT, "
                             f"got {pin!r}")
        expected.append((name, want))
    fail = False
    for rep in reports:
        if any(f.severity == "error" for f in rep.findings):
            fail = True
        if args.expect and rep.verdict != args.expect:
            fail = True
        if args.expect_ingraph_fn and not any(
                fr.verdict == contracts_mod.VERDICT_INGRAPH
                for fr in rep.functions.values()):
            fail = True
        stages = contracts_mod.stage_report(rep)
        for name, want in expected:
            if name in stages:
                got = "compiled" if stages[name]["compiled"] \
                    else "interpreted"
            else:
                fr = rep.functions.get(name)
                got = fr.verdict if fr is not None else "<missing>"
            if got != want:
                print(f"{rep.spec}: --expect-stage {name}={want} "
                      f"but oracle says {got}", file=sys.stderr)
                fail = True
    return reports, fail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lua_mapreduce_tpu_torch.analysis",
        description="framework-aware lint, interprocedural deep pass, "
                    "task-contract checker + lease-protocol model checker")
    ap.add_argument("command", nargs="?", default="all",
                    choices=("all", "lint", "deep", "conc", "protocol",
                             "rules", "task", "callgraph"))
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to lint, or task-module specs for "
                         "the task command (default: the package)")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text")
    ap.add_argument("--fail-on-findings", action="store_true",
                    help="exit 1 when lint/deep findings survive "
                         "suppression")
    ap.add_argument("--fail-on-stale", action="store_true",
                    help="exit 1 when an inline pragma or baseline entry "
                         "no longer suppresses anything")
    ap.add_argument("--baseline", default=None,
                    help="suppression file (default: analysis/baseline.json)")
    ap.add_argument("--expect", default=None,
                    choices=(contracts_mod.VERDICT_INGRAPH,
                             contracts_mod.VERDICT_STORE,
                             contracts_mod.VERDICT_INVALID),
                    help="task: required task-level verdict")
    ap.add_argument("--expect-ingraph-fn", action="store_true",
                    help="task: require at least one in-graph-eligible "
                         "function")
    ap.add_argument("--expect-stage", action="append", default=None,
                    metavar="NAME=VERDICT",
                    help="task: pin a per-stage lowering verdict "
                         "(repeatable; DESIGN §28). NAME is a hybrid "
                         "stage ('map'/'reduce', VERDICT "
                         "'compiled'/'interpreted') or a function name "
                         "('mapfn'..., VERDICT 'in-graph'/'store-plane'/"
                         "'invalid'); a mismatch fails the gate")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--batch-k", type=int, default=2)
    ap.add_argument("--seed-bug", default=None,
                    choices=proto_mod.KNOWN_BUGS,
                    help="restrict the seeded-race regression to one bug")
    args = ap.parse_args(argv)

    if args.format == "sarif" and args.command not in ("lint", "deep",
                                                       "conc", "task"):
        ap.error("--format sarif applies to lint/deep/conc/task only")
    if args.fail_on_stale and args.command != "all":
        # only `all` runs the suppression audit — a scoped lint/deep
        # pass cannot tell live pragmas from stale ones, so honoring
        # the flag there would mint a permanently green gate
        ap.error("--fail-on-stale applies to the all command (it runs "
                 "the stale-suppression audit)")
    if args.fail_on_stale and args.paths:
        # a subset of the PACKAGE drops context seeds that live outside
        # it (an LMR014 helper's seed sits in store/), so live pragmas
        # would read as stale; self-contained external trees are fine
        from lua_mapreduce_tpu_torch.analysis.lint import _PKG_ROOT
        for p in args.paths:
            ap_ = os.path.abspath(p)
            if ap_ != _PKG_ROOT and ap_.startswith(_PKG_ROOT + os.sep):
                ap.error("--fail-on-stale needs the whole package in "
                         "view: a package-scoped subset cannot tell "
                         "live pragmas (whose context seeds may live "
                         "outside it) from stale ones")

    if args.command == "rules":
        catalog = lint_mod.rule_catalog()
        if args.format == "json":
            print(json.dumps(catalog, indent=2))
        else:
            for r in catalog:
                print(f"{r['id']} [{r['severity']}] "
                      f"({', '.join(r['paths'])}): {r['title']}")
                print(f"    {r['rationale']}")
        return 0

    if args.command == "callgraph":
        from lua_mapreduce_tpu_torch.analysis.callgraph import build_callgraph
        g = build_callgraph(args.paths or None)
        payload = {"callgraph": {
            "nodes": g.node_count(), "edges": g.edge_count(),
            "interface_methods": len(g.interface_methods()),
            "unresolved_calls": g.unresolved}}
        if args.format == "json":
            print(json.dumps(payload, indent=2))
        else:
            cg = payload["callgraph"]
            print(f"callgraph: {cg['nodes']} nodes, {cg['edges']} edges, "
                  f"{cg['interface_methods']} interface methods, "
                  f"{cg['unresolved_calls']} unresolved call sites")
        return 0

    if args.command == "task":
        if not args.paths:
            ap.error("task requires at least one module spec")
        reports, fail = _cmd_task(args)
        if args.format == "json":
            print(json.dumps(
                {"tasks": [contracts_mod.report_dict(r)
                           for r in reports]}, indent=2))
        elif args.format == "sarif":
            fs = [f for r in reports for f in r.findings]
            print(sarif_mod.format_sarif(fs))
        else:
            for r in reports:
                print(contracts_mod.format_text(r))
        return 1 if fail else 0

    payload = {}
    findings = None
    rc = 0
    if args.command == "lint":
        findings, fail = _cmd_lint(args)
        payload.update(lint_mod.report_dict(findings))
        rc = max(rc, 1 if fail else 0)
    if args.command == "deep":
        res = dataflow_mod.analyze(args.paths or None,
                                   baseline=args.baseline)
        findings = res.findings
        payload.update(lint_mod.report_dict(findings))
        payload["callgraph"] = {"nodes": res.graph.node_count(),
                                "edges": res.graph.edge_count(),
                                "reached": res.reached,
                                "wall_s": round(res.wall_s, 3)}
        rc = max(rc, 1 if findings and args.fail_on_findings else 0)
    if args.command == "conc":
        res, seeded, fail = _cmd_conc(args)
        findings = res.findings
        payload.update(lint_mod.report_dict(findings))
        payload["conc"] = {
            "locks": len(res.locks),
            "spawn_sites": len(res.tgraph.spawns),
            "thread_entries": len(res.tgraph.entries),
            "order_edges": len(res.order_edges),
            "cycles": [sorted(c) for c in res.cycles],
            "wall_s": round(res.wall_s, 3),
            "seeded": seeded}
        rc = max(rc, 1 if fail else 0)
    if args.command == "all":
        # one combined pass: per-function + deep findings with shared
        # suppression, plus the stale audit over both
        audit = lint_mod.run_audit(args.paths or None,
                                   baseline=args.baseline)
        findings = audit.findings
        payload.update(lint_mod.report_dict(findings))
        payload["stale_pragmas"] = audit.stale_pragmas
        payload["stale_baseline"] = audit.stale_baseline
        rc = max(rc, 1 if findings and args.fail_on_findings else 0)
        rc = max(rc, 1 if audit.stale and args.fail_on_stale else 0)
    if args.command in ("all", "protocol"):
        try:
            proto_payload, fail = _protocol_suite(args)
        except ValueError as e:
            # out-of-range --workers/--jobs/--batch-k is a usage error,
            # not a protocol violation
            ap.error(str(e))
        except RuntimeError as e:
            # an allowed-but-too-big box (3 workers × 4 jobs) exceeding
            # the state cap is equally a usage problem — report it
            # cleanly, don't traceback
            ap.error(f"{e}; try fewer workers/jobs")
        payload.update(proto_payload)
        rc = max(rc, 1 if fail else 0)

    if args.format == "sarif":
        print(sarif_mod.format_sarif(findings or []))
        return rc
    if args.format == "json":
        print(json.dumps(payload, indent=2))
        return rc
    if findings is not None:
        if findings:
            print(lint_mod.format_text(findings))
        label = {"lint": "lint", "deep": "deep",
                 "conc": "conc"}.get(args.command, "lint+deep+conc")
        print(f"{label}: {len(findings)} finding(s)")
    if "conc" in payload:
        c = payload["conc"]
        print(f"conc: {c['locks']} locks, {c['spawn_sites']} spawn "
              f"sites, {c['thread_entries']} thread entries, "
              f"{c['order_edges']} order edges, {len(c['cycles'])} "
              f"cycles, {c['wall_s']}s")
        for e in c["seeded"]:
            status = f"re-found {e['rule']}" if e["found"] else "MISSED"
            print(f"conc {e['run']}: {status}")
    if "callgraph" in payload:
        cg = payload["callgraph"]
        print(f"callgraph: {cg['nodes']} nodes, {cg['edges']} edges, "
              f"{cg['reached']} context-reached functions, "
              f"{cg['wall_s']}s")
    for p in payload.get("stale_pragmas", ()):
        print(f"{p['path']}:{p['line']}: stale suppression — "
              f"# lmr: disable={p['rule']} no longer fires")
    for e in payload.get("stale_baseline", ()):
        print(f"baseline: stale entry {e.get('rule')} @ "
              f"{e.get('path')}:{e.get('line', '*')} "
              f"({e.get('reason', '')}) no longer fires")
    if "stale_pragmas" in payload:
        n = len(payload["stale_pragmas"]) + len(payload["stale_baseline"])
        print(f"suppression audit: {n} stale entr"
              f"{'y' if n == 1 else 'ies'}")
    for entry in payload.get("protocol", ()):
        if entry["run"].startswith("seeded:"):
            status = ("re-found: " + entry["violation"]
                      if entry["found"] else "MISSED")
            print(f"protocol {entry['run']}: {status} "
                  f"[{entry['states']} states, {entry['wall_s']}s]")
        else:
            status = "ok" if entry["ok"] else \
                f"VIOLATION: {entry['violation']}"
            print(f"protocol {entry['run']}: {status} "
                  f"[{entry['states']} states, {entry['transitions']} "
                  f"transitions, {entry['quiescent_states']} quiescent, "
                  f"{entry['wall_s']}s]")
    return rc


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # `... | head` closed the pipe: not an error. Point stdout at
        # devnull so interpreter shutdown does not retry the flush.
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
