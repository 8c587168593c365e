"""The six-user-function engine contract.

Copy of the JAX package's ``engine/contract.py`` (reference
server.lua:427-445 module validation). A user program is

    taskfn(emit)                    — enumerate map jobs as (key, value)
    mapfn(key, value, emit)         — emit intermediate (key, value) pairs
    partitionfn(key) -> int         — key space → reducer partition
    reducefn(key, values) -> value  — fold a key's value list
    combinerfn(key, values) -> value  [optional] map-side pre-reduction
    finalfn(pairs) -> True|False|None|"loop"  [optional]

Each function is supplied as a *module spec*: an import path string, a
module object, a dict, or a bare callable. Modules may carry an
``init(args)`` hook, called exactly once per distinct module even when
one module provides several functions (server.lua:454-458's dedup).
Reducer property flags (``associative_reducer``, ``commutative_reducer``,
``idempotent_reducer``) live on the reducefn's module or function; all
three together enable the singleton fast path of the reduce merge
(job.lua:264-275).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Optional

FN_NAMES = ("taskfn", "mapfn", "partitionfn", "reducefn", "combinerfn",
            "finalfn")
_REQUIRED = ("taskfn", "mapfn", "partitionfn", "reducefn")
_FLAGS = ("associative_reducer", "commutative_reducer", "idempotent_reducer")


@dataclasses.dataclass
class _Loaded:
    fn: Callable
    module: Any            # identity used for init dedup
    init: Optional[Callable]
    flags: Dict[str, bool]


def _load_fn(spec: Any, fname: str) -> _Loaded:
    """Resolve one function spec to (callable, module, init, flags)."""
    if isinstance(spec, str):
        spec = importlib.import_module(spec)
    if callable(spec) and not hasattr(spec, fname):
        # bare callable; it may carry flags/init as attributes
        return _Loaded(
            fn=spec, module=spec,
            init=getattr(spec, "init", None),
            flags={f: bool(getattr(spec, f, False)) for f in _FLAGS})
    if isinstance(spec, dict):
        if fname not in spec:
            raise TypeError(f"module dict for {fname!r} has no {fname!r} "
                            "entry")
        fn = spec[fname]
        return _Loaded(
            fn=fn, module=_DictKey(spec),
            init=spec.get("init"),
            flags={f: bool(spec.get(f, getattr(fn, f, False)))
                   for f in _FLAGS})
    fn = getattr(spec, fname, None)
    if fn is None or not callable(fn):
        raise TypeError(
            f"module {getattr(spec, '__name__', spec)!r} does not define a "
            f"callable {fname!r} (reference contract server.lua:429-445)")
    # flags may live on the module (reducefn.lua:9-13 style) OR on the
    # function itself; the module value wins when set
    return _Loaded(fn=fn, module=spec, init=getattr(spec, "init", None),
                   flags={f: bool(getattr(spec, f, getattr(fn, f, False)))
                          for f in _FLAGS})


class _DictKey:
    """Identity wrapper so dict-style modules dedup by dict identity."""

    def __init__(self, d: dict):
        self._d = d

    def __hash__(self):
        return id(self._d)

    def __eq__(self, other):
        return isinstance(other, _DictKey) and other._d is self._d


class TaskSpec:
    """A fully-resolved, initialized user program plus storage specs.

    Mirrors server:configure (server.lua:419-462): resolves the six
    modules, validates the contract, parses storage, and runs the
    dedup'd ``init`` hooks.
    """

    def __init__(self,
                 taskfn: Any,
                 mapfn: Any,
                 partitionfn: Any,
                 reducefn: Any,
                 combinerfn: Any = None,
                 finalfn: Any = None,
                 init_args: Optional[dict] = None,
                 storage: str = "mem",
                 result_storage: Optional[str] = None,
                 result_ns: str = "result"):
        given = {"taskfn": taskfn, "mapfn": mapfn, "partitionfn": partitionfn,
                 "reducefn": reducefn, "combinerfn": combinerfn,
                 "finalfn": finalfn}
        for name in _REQUIRED:
            if given[name] is None:
                raise TypeError(f"TaskSpec requires {name!r}")

        self._loaded: Dict[str, _Loaded] = {}
        for name, spec in given.items():
            if spec is not None:
                self._loaded[name] = _load_fn(spec, name)

        # validate storage specs eagerly, like server:configure
        from lua_mapreduce_tpu_torch.store.router import parse_storage
        parse_storage(storage)
        if result_storage is not None:
            parse_storage(result_storage)

        self.init_args = dict(init_args or {})
        self.storage = storage
        self.result_storage = result_storage
        self.result_ns = result_ns

        rflags = self._loaded["reducefn"].flags
        self.associative = rflags["associative_reducer"]
        self.commutative = rflags["commutative_reducer"]
        self.idempotent = rflags["idempotent_reducer"]

        self._run_inits()

    @property
    def taskfn(self) -> Callable:
        return self._loaded["taskfn"].fn

    @property
    def mapfn(self) -> Callable:
        return self._loaded["mapfn"].fn

    @property
    def partitionfn(self) -> Callable:
        return self._loaded["partitionfn"].fn

    @property
    def reducefn(self) -> Callable:
        return self._loaded["reducefn"].fn

    @property
    def combinerfn(self) -> Optional[Callable]:
        loaded = self._loaded.get("combinerfn")
        return loaded.fn if loaded else None

    @property
    def finalfn(self) -> Optional[Callable]:
        loaded = self._loaded.get("finalfn")
        return loaded.fn if loaded else None

    @property
    def fast_path(self) -> bool:
        """assoc ∧ commut ∧ idempotent — singleton groups skip reducefn
        (job.lua:264-275)."""
        return self.associative and self.commutative and self.idempotent

    @property
    def combiner_for_map(self) -> Optional[Callable]:
        """The map-side pre-reduction function. Only an explicit combinerfn
        combines map-side — reducer flags alone enable the merge fast path
        but do not implicitly combine (the reference's test matrix runs
        no-combiner+flagged-reducer as a distinct config, test.sh:8-73)."""
        return self.combinerfn

    @property
    def state_hooks(self):
        """The optional loop-state hooks ``(save_state, restore_state)``
        of the user program, or ``(None, None)``.

        A module running the ``"loop"`` protocol may carry state that
        threads BETWEEN iterations outside the store. A module that
        defines module-level ``save_state() -> obj`` (any
        JSON-serializable value) and ``restore_state(obj)`` opts into the
        Server's ``_state.<iteration>`` checkpoint: the Server publishes
        ``save_state()`` before every loop flip, and a resuming Server
        calls ``restore_state`` so iteration N+1 sees exactly the state N
        produced. Both hooks must be on ONE module (finalfn's first)."""
        for name in ("finalfn", "taskfn") + FN_NAMES:
            loaded = self._loaded.get(name)
            if loaded is None:
                continue
            save = getattr(loaded.module, "save_state", None)
            restore = getattr(loaded.module, "restore_state", None)
            if callable(save) and callable(restore):
                return save, restore
        return None, None

    def describe(self) -> dict:
        """Importable-module description (only str specs survive a process
        boundary — same restriction as the reference, where workers
        ``require`` module names from the task doc, task.lua:27-58). The
        lowerability oracle reads each slot's module name from it."""
        import types
        desc = {}
        for name, loaded in self._loaded.items():
            mod = loaded.module
            if not isinstance(mod, types.ModuleType):
                raise TypeError(
                    f"{name} must be an importable module path to run on "
                    f"out-of-process workers (got {type(mod).__name__})")
            desc[name] = mod.__name__
        return {
            "functions": desc,
            "init_args": self.init_args,
            "storage": self.storage,
            "result_storage": self.result_storage,
            "result_ns": self.result_ns,
        }

    @classmethod
    def from_description(cls, desc: dict) -> "TaskSpec":
        """The TaskSpec a :meth:`describe` dict names — how a worker in
        another process loads the task from the task document
        (task.lua:27-58)."""
        return cls(init_args=desc.get("init_args"),
                   storage=desc.get("storage", "mem"),
                   result_storage=desc.get("result_storage"),
                   result_ns=desc.get("result_ns", "result"),
                   **desc["functions"])

    def _run_inits(self) -> None:
        seen = set()
        for name in FN_NAMES:
            loaded = self._loaded.get(name)
            if loaded is None or loaded.init is None:
                continue
            if loaded.module in seen:
                continue
            seen.add(loaded.module)
            loaded.init(self.init_args)


def utest() -> None:
    """Self-test (reference server.lua:629-655 utest role): contract
    validation and flag resolution."""
    def reducefn(key, values):
        return sum(values)
    reducefn.associative_reducer = True
    reducefn.commutative_reducer = True
    spec = TaskSpec(taskfn={"taskfn": lambda emit: emit("k", 1)},
                    mapfn={"mapfn": lambda k, v, emit: emit(k, v)},
                    partitionfn={"partitionfn": lambda k: 0},
                    reducefn={"reducefn": reducefn})
    assert spec.associative and spec.commutative and not spec.idempotent
    try:
        TaskSpec(taskfn=None, mapfn=None, partitionfn=None, reducefn=None)
    except TypeError:
        pass
    else:  # pragma: no cover
        raise AssertionError("missing required fn must be rejected")
    try:
        parse_err = False
        TaskSpec(taskfn={"taskfn": lambda e: None},
                 mapfn={"mapfn": lambda k, v, e: None},
                 partitionfn={"partitionfn": lambda k: 0},
                 reducefn={"reducefn": reducefn}, storage="mongo:db")
    except ValueError:
        parse_err = True
    assert parse_err, "bogus storage spec must be rejected eagerly"
