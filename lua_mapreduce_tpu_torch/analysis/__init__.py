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
from lua_mapreduce_tpu_torch.analysis.threads import (ThreadGraph,
                                                      build_thread_graph)

__all__ = [
    "Finding", "run_lint", "run_audit", "AuditReport", "all_rules",
    "format_text",
    "CallGraph", "build_callgraph", "run_deep",
    "ThreadGraph", "build_thread_graph",
    "ConcResult", "analyze_conc", "run_conc", "static_lock_model",
    "TaskReport", "check_task",
]
