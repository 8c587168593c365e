"""CUDA-graph capture: the port's counterpart of ``lax.scan`` under ``jit``.

The JAX package runs a training epoch and the decode loop as one
``lax.scan`` inside ``jit``: the host dispatches the loop once. The port
captures ONE step of such a loop in a ``torch.cuda.CUDAGraph`` and
replays it: the step's inputs and outputs live in static device tensors
the step reads and writes (the position of a decode step, the batch of a
training step), so a replay needs no host round trip and launches the
step's kernels in one call.

:class:`CapturedGraph` captures a function once and replays it, crediting
the kernel launches its capture recorded at every replay
(``ops.recording_launches``). A capture that fails raises; there is no
fallback to eager execution. :func:`on_side_stream` runs the eager call
before a capture on a side stream, as torch's whole-network capture
recipe asks. :func:`captures` counts the captures, as the JAX package
counts its traces, and keeps the last one's host time. :func:`scan` is
``lax.scan`` over a step with no per-step inputs: the step captured once
and replayed, its state kept in static tensors, the graph cached across
calls (:func:`clear_cache` frees the cached graphs).
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from lua_mapreduce_tpu_torch import ops
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map

_count = 0
_last: Optional[Tuple[str, float]] = None


def captures() -> Tuple[int, Optional[Tuple[str, float]]]:
    """The number of captures since :func:`reset_captures`, and the last
    one's (tag, host ms) — None before the first."""
    return _count, _last


def reset_captures() -> None:
    global _count, _last
    _count, _last = 0, None


def on_side_stream(fn: Callable[[], Any]) -> Any:
    """``fn()`` on a side stream ordered after, and before, the current
    stream's work: where the eager call before a capture runs (it
    creates the lazily built state — libraries, autograd streams,
    optimizer buffers — outside the capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    return out


class CapturedGraph:
    """``fn`` captured once in a CUDA graph; :meth:`replay` runs it.

    ``fn`` must read and write only tensors that outlive the graph (its
    static inputs and outputs) and make no host round trip; its return
    value (tensors in the graph's memory pool, rewritten by every replay)
    is kept as :attr:`output`. The kernel launches the capture passes
    through are kept as :attr:`launches` and credited at every replay.

    The capture runs in ``"thread_local"`` mode: only the capturing
    thread is barred from the calls a capture cannot record, so another
    thread of the process (an in-process worker pool) launching its own
    kernels or syncing on its own stream neither breaks the capture nor
    is refused. Work that must not interleave with a capture on another
    thread (the compiled MapReduce planes') takes
    ``engine.ingraph.COMPILE_LOCK``."""

    def __init__(self, fn: Callable[[], Any], tag: str = "graph"):
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with ops.recording_launches() as self.launches:
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.output = fn()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        global _count, _last
        _count, _last = _count + 1, (tag, self.capture_ms)

    def replay(self) -> Any:
        self.graph.replay()
        ops.credit_launches(self.launches)
        return self.output


_CACHE_SIZE = 8
_cache: "collections.OrderedDict[tuple, _ScanEntry]" = \
    collections.OrderedDict()


class _ScanEntry(NamedTuple):
    graph: CapturedGraph
    state: Any              # the static state tensors the graph updates
    consts: List[torch.Tensor]   # the static copies of the tensor args


def clear_cache() -> None:
    """Drop every cached :func:`scan` graph (and with it its memory
    pool and static tensors)."""
    _cache.clear()


def _signature(tree: Any) -> tuple:
    leaves, spec = tree_flatten(tree)
    return repr(spec), tuple((tuple(t.shape), t.dtype, t.device)
                             for t in leaves)


def _cache_key(step: Callable, state: Any, args: tuple, mesh: Any) -> tuple:
    """What a cached :func:`scan` graph is valid for: the step, the
    mesh, the non-tensor args, and the structure, shapes, dtypes and
    devices of the state and of the tensor args — never their values."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    static = tuple(None if isinstance(a, torch.Tensor) else a for a in args)
    return step, mesh, static, _signature(state), _signature(tensors)


def scan(step: Callable[..., Tuple[Any, Any]], state: Any, n_steps: int,
         *args: Any, mesh: Any = None, tag: str = "scan"
         ) -> Tuple[Any, Any]:
    """``lax.scan(lambda s, _: step(s, *args), state, None,
    length=n_steps)``: returns the final state and the per-step outputs
    stacked on a new leading axis. ``state`` is a tree of tensors;
    ``step(state, *args)`` returns ``(new_state, out)``, a state of the
    same structure and a tree of tensors. Each of ``args`` is a tensor
    the step reads (data, never written) or a hashable value the step
    is built from (a mesh, a rate, an axis name).

    On a card the step is captured once in a CUDA graph and replayed,
    and the graph is cached: on (``step``, the non-tensor ``args``, the
    ``mesh`` whose collectives the step runs when it is not among them,
    and the shapes, dtypes and devices of the state's and the tensor
    args' leaves), the last few kept. A miss runs step 0 eagerly on a side
    stream (the capture's warm-up: it builds the libraries, and the NCCL
    communicators of any collective in the step, outside the capture),
    then captures the step, with its write of the new state into static
    state tensors, and replays it for steps 1 .. n-1. A hit copies the
    initial state and the tensor args into the cached graph's static
    tensors and replays it for every step: no capture. After each replay
    one device-to-device copy per output leaf files the step's output;
    no step makes a host round trip. The step must read nothing but its
    arguments, since a hit replays the graph it captured before. On the
    CPU the steps run eagerly.
    """
    leaves = tree_leaves(state)
    if n_steps <= 0:
        raise ValueError(f"scan needs n_steps >= 1, got {n_steps}")
    if not leaves or leaves[0].device.type != "cuda":
        outs = []
        for _ in range(n_steps):
            state, out = step(state, *args)
            outs.append(out)
        return state, tree_map(lambda *xs: torch.stack(xs), *outs)
    tensors = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
    key = _cache_key(step, state, args, mesh)
    entry = _cache.get(key)
    if entry is not None:
        _cache.move_to_end(key)
        tree_map(lambda s, v: s.copy_(v), entry.state, state)
        for c, i in zip(entry.consts, tensors):
            c.copy_(args[i])
        graph, static = entry.graph, entry.state
        first = graph.replay()
    else:
        static = tree_map(lambda t: t.detach().clone(), state)
        consts = [args[i].detach().clone() for i in tensors]
        call_args = list(args)
        for c, i in zip(consts, tensors):
            call_args[i] = c

        def body():
            new, out = step(static, *call_args)
            tree_map(lambda s, v: s.copy_(v), static, new)
            return out

        first = on_side_stream(body)
        graph = None
        if n_steps > 1:
            graph = CapturedGraph(body, tag=tag)
            _cache[key] = _ScanEntry(graph, static, consts)
            if len(_cache) > _CACHE_SIZE:
                _cache.popitem(last=False)
    stacked = tree_map(lambda o: o.new_empty((n_steps,) + o.shape), first)
    tree_map(lambda s, o: s[0].copy_(o), stacked, first)
    for i in range(1, n_steps):
        tree_map(lambda s, o: s[i].copy_(o), stacked, graph.replay())
    # the cached graph rewrites its static state at its next use
    return tree_map(lambda t: t.clone(), static), stacked
