"""Static analysis of the port package and of user task modules.

Copies of the JAX package's ``analysis/`` modules, reading this
package's source:

- :mod:`lint` + :mod:`rules` — the framework-aware AST lint pass and its
  rule registry (LMR001-012, LMR018), with inline ``# lmr: disable=``
  pragmas, the (empty) checked-in baseline and the stale-suppression
  audit (:func:`run_audit`). LMR007 polices the functions a CUDA-graph
  capture or an fx trace runs once.
- :mod:`callgraph` + :mod:`dataflow` — the whole-program call graph and
  the interprocedural deep rules (LMR013-017).
- :mod:`threads` + :mod:`lockset` — the thread-spawn graph and the
  lockset / lock-order pass (LMR026-030); :func:`static_lock_model` is
  the ground truth of the runtime sanitizer (``utils/lockcheck.py``).
- :mod:`contracts` — the task-contract checker and the lowerability
  oracle the compiled engines consult (LMR020-025).
- :mod:`sarif` — the SARIF 2.1.0 export of findings.
- :mod:`protocol` — the small-scope model checker of the JobStore lease
  lifecycle, whose violation traces replay against the real job stores
  (:func:`replay_trace`).

CLI: ``python -m lua_mapreduce_tpu_torch.analysis`` (see ``--help``).
"""

from lua_mapreduce_tpu_torch.analysis.callgraph import (CallGraph,
                                                        build_callgraph)
from lua_mapreduce_tpu_torch.analysis.contracts import (TaskReport,
                                                        check_task)
from lua_mapreduce_tpu_torch.analysis.dataflow import run_deep
from lua_mapreduce_tpu_torch.analysis.lint import (AuditReport, Finding,
                                                   all_rules, format_text,
                                                   run_audit, run_lint)
from lua_mapreduce_tpu_torch.analysis.lockset import (ConcResult,
                                                      analyze_conc,
                                                      run_conc,
                                                      static_lock_model)
from lua_mapreduce_tpu_torch.analysis.protocol import (LeaseModel,
                                                       ModelConfig,
                                                       check_protocol,
                                                       replay_trace)
from lua_mapreduce_tpu_torch.analysis.threads import (ThreadGraph,
                                                      build_thread_graph)

__all__ = [
    "Finding", "run_lint", "run_audit", "AuditReport", "all_rules",
    "format_text",
    "CallGraph", "build_callgraph", "run_deep",
    "ThreadGraph", "build_thread_graph",
    "ConcResult", "analyze_conc", "run_conc", "static_lock_model",
    "TaskReport", "check_task",
    "ModelConfig", "LeaseModel", "check_protocol", "replay_trace",
    "utest",
]


def utest() -> None:
    """Self-test: the lint engine finds a seeded fixture violation and
    the port package is lint-clean; the call graph resolves every edge
    kind; each interprocedural rule re-finds its seeded
    helper-indirection race and the package is deep-clean with no stale
    suppressions; the contract checker classifies its fixtures; the
    thread-spawn graph and lockset pass re-find their seeded races and
    the package is conc-clean; the protocol model passes a tiny
    exhaustive run and re-finds a seeded race."""
    import os

    from lua_mapreduce_tpu_torch.analysis import (callgraph, contracts,
                                                  dataflow, lint, lockset,
                                                  protocol, sarif, threads)

    lint.utest()
    callgraph.utest()
    dataflow.utest()
    contracts.utest()
    sarif.utest()
    threads.utest()
    lockset.utest()
    protocol.utest()

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    audit = run_audit([pkg])
    assert audit.findings == [], (
        "package must ship lint+deep clean:\n"
        + format_text(audit.findings))
    assert not audit.stale, (
        "suppressions must not outlive the code they excused: "
        f"{audit.stale_pragmas} {audit.stale_baseline}")
