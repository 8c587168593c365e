"""lmr-trace — store-native distributed tracing (DESIGN §22).

Copy of the JAX package's ``trace/__init__.py`` (the torch package imports
nothing of the JAX package).

Three pieces:

- ``span``     — :class:`Tracer` (buffered spans on an injectable
  clock, deterministic ids, store-file flush under the ``_trace.``
  prefix) and the process-global ``install_tracer``/``active_tracer``
  plumbing (``--trace`` / ``LMR_TRACE``);
- ``wrappers`` — :class:`TracingStore` / :class:`TracingJobStore`,
  stacked inside the retry layer by faults/wrappers.py's wiring points
  so every retry attempt, failover read, and degraded read is a child
  span of the consuming job body;
- ``collect``  — :class:`TraceCollection` (lifecycle chains + the
  completeness oracle, per-op latency histograms, phase waterfall,
  span-measured pre-merge overlap, Chrome trace-event export) and
  ``validate_chrome``; rendered by ``python -m lua_mapreduce_tpu_torch.trace``.
"""

from lua_mapreduce_tpu_torch.trace.collect import (TraceCollection, read_spans,
                                             validate_chrome)
from lua_mapreduce_tpu_torch.trace.span import (TRACE_NS, Tracer, active_tracer,
                                          install_tracer, span_id,
                                          trace_generation)

__all__ = [
    "TRACE_NS", "Tracer", "active_tracer", "install_tracer", "span_id",
    "trace_generation", "TraceCollection", "read_spans", "validate_chrome",
]


def utest() -> None:
    """Run the subsystem's module self-tests."""
    from lua_mapreduce_tpu_torch.trace import collect, span, wrappers
    for mod in (span, wrappers, collect):
        mod.utest()
