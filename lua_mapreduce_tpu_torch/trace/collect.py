"""Trace collection: assemble flushed spans into answers (DESIGN §22).

Copy of the JAX package's ``trace/collect.py`` (the torch package imports
nothing of the JAX package).

The span layer records and flushes; this module turns the ``_trace.*``
files in a store back into the three artifacts the tentpole promises:

- **per-job lifecycle chains** — claim → body → spill publish → commit
  for every job, with speculation clones, infra releases, and retry
  attempts attached — and a completeness check chaos tests assert
  against (every committed job must have an unbroken chain);
- **per-op latency histograms** — p50/p95/p99/max for every store and
  coord RPC op that ran;
- **Chrome trace-event JSON** — loadable in Perfetto / chrome://tracing
  (and ui.perfetto.dev), one track per worker, so the whole cluster's
  timeline is scrubbable next to a JAX device profile.

Pure functions over span dicts — no engine imports, no clock reads —
so the collector runs identically in-process (tests), from the CLI
(``python -m lua_mapreduce_tpu_torch.trace``), and against a store another
fleet wrote.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from lua_mapreduce_tpu_torch.trace.span import TRACE_NS

_BODY_SUFFIX = ".body"


def read_spans(store) -> List[dict]:
    """Parse every ``_trace.*`` file in ``store`` (reads go through the
    unwrapped innermost store, like the flushes that wrote them)."""
    from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
    raw = unwrap(store)
    spans: List[dict] = []
    for name in raw.list(f"{TRACE_NS}.*"):
        for line in raw.lines(name):
            line = line.strip()
            if line:
                spans.append(json.loads(line))
    return spans


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an unsorted sequence (q in [0, 100]):
    the smallest value with at least q% of the sample at or below it —
    rank ceil(q/100 · N). (Not round(x + .5): Python rounds half to
    even, so that form overshoots the rank whenever q/100 · N is
    integral — p50 of two samples must be the FIRST, not the second.)"""
    if not values:
        return 0.0
    vs = sorted(values)
    idx = max(0, min(len(vs) - 1, math.ceil(q / 100.0 * len(vs)) - 1))
    return vs[idx]


class TraceCollection:
    """One run's spans, indexed for the three artifact shapes."""

    def __init__(self, spans: Iterable[dict]):
        self.spans = [s for s in spans if s.get("t1") is not None]
        self.by_sid = {s["sid"]: s for s in self.spans}
        # grouped per (iteration, ns, job): namespaces are dropped and
        # re-inserted per task iteration with job ids restarting at 0,
        # so an iteration-blind (ns, job) key would conflate every
        # iteration's reuse of id 0 into one bogus chain ("10 commit
        # spans"). Spans predating the "it" field read as iteration 0.
        self.by_job: Dict[Tuple, List[dict]] = {}
        for s in self.spans:
            if s.get("ns") is not None and s.get("job") is not None:
                self.by_job.setdefault(
                    (s.get("it", 0), s["ns"], s["job"]), []).append(s)
        for group in self.by_job.values():
            group.sort(key=lambda s: (s["t0"], s["t1"]))
        self.last_iteration = max((s.get("it", 0) for s in self.spans),
                                  default=0)

    @classmethod
    def from_store(cls, store) -> "TraceCollection":
        return cls(read_spans(store))

    # -- per-op latency histograms ------------------------------------------

    def op_stats(self) -> Dict[str, dict]:
        """{op name: {count, p50_ms, p95_ms, p99_ms, max_ms, total_s}}
        for every ``store.*`` / ``coord.*`` op span, plus ``dispatch``
        (insert→claim per job, lmr-sched DESIGN §23) so job-dispatch
        latency reports in the same histogram table as the RPCs."""
        buckets: Dict[str, List[float]] = {}
        for s in self.spans:
            name = s["name"]
            if name.startswith(("store.", "coord.")) or name == "dispatch":
                buckets.setdefault(name, []).append(s["t1"] - s["t0"])
        out = {}
        for name, durs in sorted(buckets.items()):
            ms = [d * 1000.0 for d in durs]
            out[name] = {"count": len(ms),
                         "p50_ms": round(percentile(ms, 50), 3),
                         "p95_ms": round(percentile(ms, 95), 3),
                         "p99_ms": round(percentile(ms, 99), 3),
                         "max_ms": round(max(ms), 3),
                         "total_s": round(sum(durs), 4)}
        return out

    def dispatch_stats(self) -> Optional[dict]:
        """The ``dispatch`` histogram row (insert→claim per job) — the
        control plane's dispatch-latency p50/p99, or None for a run
        with no dispatch spans (untraced claims, virtual-clock runs)."""
        return self.op_stats().get("dispatch")

    # -- per-job lifecycle chains -------------------------------------------

    def job_chain(self, ns, job_id, iteration: Optional[int] = None
                  ) -> dict:
        """One job's lifecycle: its claim/body/commit spans plus the
        release/broken/speculation markers, sorted by time.
        ``iteration=None`` picks the LATEST iteration that saw this
        (ns, job) — matching the job-store state a caller just read."""
        if iteration is None:
            its = [it for (it, n, j) in self.by_job
                   if n == ns and j == job_id]
            iteration = max(its) if its else 0
        group = self.by_job.get((iteration, ns, job_id), [])
        return {
            "ns": ns, "job": job_id, "iteration": iteration,
            "claims": [s for s in group if s["name"] == "claim"],
            "bodies": [s for s in group
                       if s["name"].endswith(_BODY_SUFFIX)],
            "commits": [s for s in group if s["name"] == "commit"],
            "releases": [s for s in group
                         if s["name"] == "status.waiting"],
            "broken": [s for s in group if s["name"] == "status.broken"],
            "spec_claims": [s for s in group if s["name"] == "claim"
                            and s.get("attrs", {}).get("speculative")],
            "spec_cancels": [s for s in group
                             if s["name"] == "spec_cancel"],
            "spans": group,
        }

    def check_complete(self, committed: Sequence[Tuple]) -> List[str]:
        """Verify every (ns, job_id) in ``committed`` has an unbroken
        claim → body → commit chain; returns human-readable problems
        (empty = complete). A chain is unbroken when the job has at
        least one claim, at least one body that STARTED no earlier than
        some claim, exactly one commit, and the commit closes no
        earlier than that body started — duplicate executions (retries,
        speculation) legitimately add extra claim/body spans, never
        extra commits."""
        eps = 1e-6
        problems = []
        for ns, jid in committed:
            ch = self.job_chain(ns, jid)
            if not ch["claims"]:
                problems.append(f"{ns}/{jid}: no claim span")
                continue
            if not ch["bodies"]:
                problems.append(f"{ns}/{jid}: no body span")
                continue
            if len(ch["commits"]) != 1:
                problems.append(f"{ns}/{jid}: {len(ch['commits'])} commit "
                                "span(s), expected exactly 1")
                continue
            commit = ch["commits"][0]
            ordered = [b for b in ch["bodies"]
                       if any(c["t0"] <= b["t0"] + eps
                              for c in ch["claims"])
                       and b["t0"] <= commit["t1"] + eps]
            if not ordered:
                problems.append(f"{ns}/{jid}: no body inside the "
                                "claim->commit window")
        return problems

    # -- engine selection (in-graph lowering, DESIGN §26) -------------------

    def lowering_decisions(self) -> List[dict]:
        """The ``lowering`` spans' payloads — the engine-selection
        decision (requested/chosen engine, oracle verdict, per-function
        reasons), the hybrid plane's per-stage ``lowering.<stage>``
        verdicts (DESIGN §28), and any runtime ``ingraph.fallback`` /
        ``hybrid.fallback`` degrades, in time order: the timeline proof
        that an interpreted stage (or a whole store-plane fallback) was
        a DECISION, not a silent drop."""
        out = []
        for s in sorted(self.spans, key=lambda s: (s["t0"], s["t1"])):
            if s["name"] in ("lowering", "ingraph.fallback",
                             "hybrid.fallback") \
                    or s["name"].startswith("lowering."):
                entry = {"span": s["name"], "it": s.get("it", 0),
                         "t0": s["t0"]}
                entry.update(s.get("attrs") or {})
                out.append(entry)
        return out

    def autotune_decisions(self) -> List[dict]:
        """The controller's ``autotune.<knob>`` spans in time order
        (lmr-autotune, DESIGN §29) — every applied knob change with its
        evidence payload (observed metric, the threshold that tripped,
        old→new, direction). This is the explainability contract: a
        perf knob that moved without an entry here moved OUTSIDE the
        controller (operator action or a bug), and the stability
        acceptance (no knob reverses direction more than once per
        chaos window) is checkable straight off this list."""
        out = []
        for s in sorted(self.spans, key=lambda s: (s["t0"], s["t1"])):
            if s["name"].startswith("autotune."):
                entry = {"span": s["name"],
                         "knob": s["name"].split(".", 1)[1],
                         "it": s.get("it", 0), "t0": s["t0"]}
                entry.update(s.get("attrs") or {})
                out.append(entry)
        return out

    def engines_by_iteration(self) -> Dict[int, str]:
        """Which engine actually executed each iteration's data plane:
        ``ingraph`` when the compiled program ran (an ``ingraph.run``
        span), ``store`` when job bodies / phase barriers did. An
        iteration showing BOTH ran in-graph first and degraded mid-
        iteration — it reports as ``store`` (that is where its results
        came from), with the fallback visible in
        :meth:`lowering_decisions`."""
        out: Dict[int, str] = {}
        hybrid_its = set()
        for s in self.spans:
            it = s.get("it", 0)
            if s["name"].endswith(_BODY_SUFFIX) \
                    or s["name"].startswith("phase."):
                out[it] = "store"
            elif s["name"] == "ingraph.run":
                out.setdefault(it, "ingraph")
            elif s["name"] == "hybrid.run":
                # compiled legs ride the store phases (DESIGN §28):
                # the iteration still reports where its results came
                # from, qualified as hybrid rather than pure store
                hybrid_its.add(it)
        return {it: ("hybrid" if out[it] == "store" and it in hybrid_its
                     else out[it]) for it in sorted(out)}

    def speculation_outcomes(self) -> List[dict]:
        """Per speculated (iteration, job): the winner/loser shape of
        its duplicate execution. ``winner`` is the worker whose commit
        landed; ``losers`` are the other workers that ran a body (the
        first-commit-wins casualty, clone or disowned original);
        ``cancelled`` says a spec_cancel span dissolved a shadow lease."""
        out = []
        for (it, ns, jid), group in sorted(self.by_job.items(),
                                           key=lambda kv: str(kv[0])):
            spec_claims = [s for s in group if s["name"] == "claim"
                           and s.get("attrs", {}).get("speculative")]
            if not spec_claims:
                continue
            commits = [s for s in group if s["name"] == "commit"]
            winner = commits[0]["worker"] if commits else None
            bodies = [s for s in group if s["name"].endswith(_BODY_SUFFIX)]
            losers = sorted({b["worker"] for b in bodies
                             if winner is not None
                             and b["worker"] != winner})
            out.append({"iteration": it, "ns": ns, "job": jid,
                        "winner": winner, "losers": losers,
                        "cancelled": any(s["name"] == "spec_cancel"
                                         for s in group),
                        "commit_count": len(commits)})
        return out

    # -- waterfall / phase timing -------------------------------------------

    def _bodies_by_label(self, iteration: Optional[int] = None
                         ) -> Dict[str, List[dict]]:
        out: Dict[str, List[dict]] = {}
        for s in self.spans:
            if iteration is not None and s.get("it", 0) != iteration:
                continue
            if s["name"].endswith(_BODY_SUFFIX):
                out.setdefault(s["name"][:-len(_BODY_SUFFIX)],
                               []).append(s)
        return out

    def phase_waterfall(self) -> List[dict]:
        """Per job-label (map / pre_merge / reduce) window + totals,
        from real body spans instead of JobTimes inference."""
        rows = []
        for label, bodies in sorted(self._bodies_by_label().items()):
            t0 = min(b["t0"] for b in bodies)
            t1 = max(b["t1"] for b in bodies)
            rows.append({"phase": label, "jobs": len(bodies),
                         "t0": t0, "t1": t1,
                         "window_s": round(t1 - t0, 4),
                         "busy_s": round(sum(b["t1"] - b["t0"]
                                             for b in bodies), 4)})
        return rows

    def premerge_overlap(self) -> Optional[float]:
        """Fraction of pre-merge body time hidden behind the map phase,
        computed from REAL spans (stats.overlap_fraction's shape, minus
        the JobTimes inference) — over the LAST iteration only: mixing
        iterations would compare pre-merges against another iteration's
        map window. None when either phase is absent."""
        bodies = self._bodies_by_label(self.last_iteration)
        maps, pres = bodies.get("map"), bodies.get("pre_merge")
        if not maps or not pres:
            return None
        map_end = max(b["t1"] for b in maps)
        total = sum(b["t1"] - b["t0"] for b in pres)
        if total <= 0:
            return None
        hidden = sum(max(0.0, min(b["t1"], map_end) - b["t0"])
                     for b in pres)
        return min(1.0, hidden / total)

    def slowest_jobs(self, k: int = 10) -> List[dict]:
        """Top-k jobs by TOTAL body time (duplicate executions summed —
        a straggler's cost includes the clone that covered it)."""
        per_job = []
        for (it, ns, jid), group in self.by_job.items():
            bodies = [s for s in group if s["name"].endswith(_BODY_SUFFIX)]
            if not bodies:
                continue
            per_job.append({
                "iteration": it, "ns": ns, "job": jid,
                "body_s": round(sum(b["t1"] - b["t0"] for b in bodies), 4),
                "executions": len(bodies),
                "workers": sorted({b["worker"] for b in bodies}),
            })
        per_job.sort(key=lambda r: -r["body_s"])
        return per_job[:k]

    # -- Chrome trace-event export ------------------------------------------

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (the Perfetto-loadable subset): one
        complete ("X") event per span in MICROSECONDS, one tid per
        worker with a thread_name metadata record, span attrs + ids in
        ``args``. Times are rebased to the earliest span so the
        timeline starts at 0 regardless of the host clock."""
        if not self.spans:
            return {"traceEvents": [], "displayTimeUnit": "ms"}
        base = min(s["t0"] for s in self.spans)
        tids: Dict[str, int] = {}
        events: List[dict] = []
        for w in sorted({s["worker"] for s in self.spans}):
            tids[w] = len(tids) + 1
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tids[w], "args": {"name": w}})
        for s in self.spans:
            args = {"sid": s["sid"], "parent": s.get("parent"),
                    "ns": s.get("ns"), "job": s.get("job"),
                    "attempt": s.get("attempt"), "it": s.get("it")}
            args.update(s.get("attrs") or {})
            events.append({
                "name": s["name"], "ph": "X", "pid": 1,
                "tid": tids[s["worker"]],
                "ts": round((s["t0"] - base) * 1e6, 1),
                "dur": round(max(0.0, s["t1"] - s["t0"]) * 1e6, 1),
                "cat": s["name"].split(".")[0],
                "args": {k: v for k, v in args.items() if v is not None},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome(doc: dict) -> List[str]:
    """Schema check for the exported trace-event JSON (the acceptance
    gate's oracle): required keys, types, non-negative times, metadata
    thread names for every tid. Returns problems (empty = valid)."""
    problems = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    named_tids = set()
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in ("X", "M"):
            problems.append(f"event {i}: ph {ph!r} not in (X, M)")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"event {i}: missing name")
        if not isinstance(ev.get("pid"), int) \
                or not isinstance(ev.get("tid"), int):
            problems.append(f"event {i}: pid/tid must be ints")
        if ph == "M":
            if ev.get("name") == "thread_name":
                named_tids.add(ev.get("tid"))
            continue
        for key in ("ts", "dur"):
            v = ev.get(key)
            if not isinstance(v, (int, float)) or v < 0:
                problems.append(f"event {i}: {key}={v!r} not a "
                                "non-negative number")
        if not isinstance(ev.get("args", {}), dict):
            problems.append(f"event {i}: args not a dict")
    for ev in events:
        if ev.get("ph") == "X" and ev.get("tid") not in named_tids:
            problems.append(f"tid {ev.get('tid')} has no thread_name "
                            "metadata")
            break
    return problems
