"""TracingStore / TracingJobStore — per-op span wrappers (DESIGN §22).

Copy of the JAX package's ``trace/wrappers.py`` (the torch package imports
nothing of the JAX package).

Siblings of faults/wrappers.py's retry layer, stacked INSIDE it by the
shared wiring points (``wrap_store`` / ``wrap_jobstore``)::

    RetryingStore( TracingStore( FaultyStore( real ) ) )     — data plane
    RetryingJobStore( TracingJobStore( FaultyJobStore( real ) ) ) — coord

The ordering is the point: sitting under the retry layer and over the
injection layer means EVERY retry attempt — including one that dies on
an injected fault — records its own span (tagged with the error class),
parented to whatever job-body span is open on the thread. Degraded
whole-file reads (core/segment.py re-enters through the same stack)
appear the same way: extra child spans under the consuming body, which is exactly
the "why was this reduce slow" answer the phase aggregates can't give.

Every wrapper records into the process tracer; when no tracer is active
the wiring points simply skip this layer, so tracing-off runs carry
zero overhead and zero behavioral difference.
"""

from __future__ import annotations

from typing import Iterator, List

from lua_mapreduce_tpu_torch.faults.plan import RPC_OPS
from lua_mapreduce_tpu_torch.store.base import FileBuilder, Store
from lua_mapreduce_tpu_torch.trace.span import Tracer


class _TracingBuilder(FileBuilder):
    """Passthrough builder whose ``build`` — the spill-publish moment —
    records a span. Writes are not individually traced: a build span
    plus the byte count says everything a timeline needs without a
    span per 256KB frame."""

    def __init__(self, store: "TracingStore"):
        self._store = store
        self._inner = store._inner.builder()
        self._bytes = 0

    def write(self, data: str) -> None:
        self._bytes += len(data)
        self._inner.write(data)

    def write_bytes(self, data: bytes) -> None:
        self._bytes += len(data)
        self._inner.write_bytes(data)

    def build(self, name: str) -> None:
        tr = self._store._tracer
        t0 = tr.clock()
        try:
            self._inner.build(name)
        except BaseException as exc:
            tr.op("store.build", t0, file=name, bytes=self._bytes,
                  error=type(exc).__name__)
            raise
        tr.op("store.build", t0, file=name, bytes=self._bytes)

    def close(self) -> None:
        self._inner.close()


class TracingStore(Store):
    """Span per data-plane op. Unknown attributes (``local_path``,
    memfs test hooks) forward to the wrapped store so native fast paths
    keep working — ops that bypass the portable plane are covered by
    the enclosing job-body span instead of an op span."""

    def __init__(self, inner: Store, tracer: Tracer):
        self._inner = inner
        self._tracer = tracer
        # mirror the inner backend's publish ambiguity: the retrying
        # builder reads it off its direct inner layer (this one)
        self.publish_ambiguous = getattr(inner, "publish_ambiguous", True)

    def __getattr__(self, attr):
        return getattr(self._inner, attr)

    def _op(self, op: str, name: str, fn):
        tr = self._tracer
        t0 = tr.clock()
        try:
            out = fn()
        except BaseException as exc:
            tr.op(f"store.{op}", t0, file=name, error=type(exc).__name__)
            raise
        tr.op(f"store.{op}", t0, file=name)
        return out

    def builder(self) -> FileBuilder:
        return _TracingBuilder(self)

    def lines(self, name: str) -> Iterator[str]:
        # the span covers the CONSUMPTION window (open through last
        # record), which is the cost a merge actually pays — an
        # open-only span would read as free for a 100MB stream
        tr = self._tracer
        t0 = tr.clock()
        err = None
        try:
            yield from self._inner.lines(name)
        except GeneratorExit:
            raise       # consumer stopped reading early (one-record
            #             manifest peeks) — a normal close, not a fault
        except BaseException as exc:
            err = type(exc).__name__
            raise
        finally:
            if err is None:
                tr.op("store.lines", t0, file=name)
            else:
                tr.op("store.lines", t0, file=name, error=err)

    def read_range(self, name: str, offset: int, length: int) -> bytes:
        return self._op("read_range", name,
                        lambda: self._inner.read_range(name, offset, length))

    def size(self, name: str) -> int:
        return self._op("size", name, lambda: self._inner.size(name))

    def list(self, pattern: str) -> List[str]:
        return self._op("list", pattern, lambda: self._inner.list(pattern))

    def exists(self, name: str) -> bool:
        return self._op("exists", name, lambda: self._inner.exists(name))

    def remove(self, name: str) -> None:
        return self._op("remove", name, lambda: self._inner.remove(name))

    def classify(self, exc: BaseException):
        return self._inner.classify(exc)


# --------------------------------------------------------------------------
# coord plane
# --------------------------------------------------------------------------


class TracingJobStore:
    """Span per coord RPC, plus derived PER-JOB lifecycle spans.

    The RPC wrapper sees exactly what the protocol decided — which jobs
    a claim leased, which commits landed, which status CASes took — so
    the per-job claim/commit/release/broken spans that the lifecycle
    chain (claim → body → commit) is assembled from are emitted HERE,
    from ground truth, instead of being reconstructed from engine-side
    bookkeeping that a lost race would falsify. A loser's commit_batch
    returns no ids → no commit span → exactly one commit span per
    committed job, by construction (the first-commit-wins CAS is the
    arbiter, DESIGN §21).
    """

    def __init__(self, inner, tracer: Tracer):
        self._inner = inner
        self._tracer = tracer

    def __getattr__(self, attr):
        return getattr(self._inner, attr)

    def classify(self, exc: BaseException):
        return self._inner.classify(exc)

    # -- per-op wrappers (generated below, faults/wrappers.py style) -------

    def _post_claim_batch(self, sp, args, out):
        for doc in out:
            self._tracer.add(
                "claim", sp["t0"], sp["t1"], ns=args[0],
                job_id=doc.get("_id"),
                attempt=int(doc.get("repetitions") or 0),
                parent=sp["sid"])
            # the DISPATCH span (lmr-sched, DESIGN §23): insert→claim
            # per job, from the payload's insert stamp to this claim's
            # close — the latency the watch/notify layer exists to
            # shrink, reported natively by the collector's per-op
            # histograms. Guarded against clock mismatch: a virtual-
            # clock tracer cannot be compared to the doc's wall stamp.
            ct = doc.get("creation_time")
            if isinstance(ct, (int, float)) and ct <= sp["t1"]:
                self._tracer.add(
                    "dispatch", float(ct), sp["t1"], ns=args[0],
                    job_id=doc.get("_id"),
                    attempt=int(doc.get("repetitions") or 0),
                    parent=sp["sid"])

    def _post_commit_batch(self, sp, args, out):
        for jid in out:
            self._tracer.add("commit", sp["t0"], sp["t1"], ns=args[0],
                             job_id=jid, attempt=-1, parent=sp["sid"])

    def _post_set_job_status(self, sp, args, out):
        if not out or len(args) < 3:
            return
        status = args[2]
        label = getattr(status, "name", str(status)).lower()
        self._tracer.add(f"status.{label}", sp["t0"], sp["t1"], ns=args[0],
                         job_id=args[1], attempt=-1, parent=sp["sid"])

    def _post_claim_spec(self, sp, args, out):
        if out is not None:
            self._tracer.add(
                "claim", sp["t0"], sp["t1"], ns=args[0],
                job_id=out.get("_id"),
                attempt=int(out.get("repetitions") or 0),
                parent=sp["sid"], speculative=True)

    def _post_speculate(self, sp, args, out):
        if out:
            self._tracer.add("speculate", sp["t0"], sp["t1"], ns=args[0],
                             job_id=args[1], attempt=-1, parent=sp["sid"])

    def _post_cancel_spec(self, sp, args, out):
        if out:
            self._tracer.add("spec_cancel", sp["t0"], sp["t1"], ns=args[0],
                             job_id=args[1], attempt=-1, parent=sp["sid"])

    _POST = {"claim_batch": _post_claim_batch,
             "claim_spec": _post_claim_spec,
             "commit_batch": _post_commit_batch,
             "set_job_status": _post_set_job_status,
             "speculate": _post_speculate,
             "cancel_spec": _post_cancel_spec}


def _make_rpc_wrappers():
    """Generate the wrapped RPC methods once at import (the
    faults/wrappers.py pattern — a hand-written wall would drift).
    ``claim`` is included alongside the RPC_OPS set: the single-claim
    compatibility surface must not silently bypass tracing."""
    def tracing(op):
        post = TracingJobStore._POST.get(op)

        def call(self, *args, **kw):
            tr = self._tracer
            ns = args[0] if args and isinstance(args[0], str) else None
            t0 = tr.clock()
            try:
                out = getattr(self._inner, op)(*args, **kw)
            except BaseException as exc:
                tr.op(f"coord.{op}", t0, ns=ns, error=type(exc).__name__)
                raise
            sp = tr.op(f"coord.{op}", t0, ns=ns)
            if post is not None:
                post(self, sp, args, out)
            return out
        call.__name__ = op
        return call

    for op in sorted(RPC_OPS | {"claim"}):
        setattr(TracingJobStore, op, tracing(op))


_make_rpc_wrappers()
