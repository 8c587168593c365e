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
``lax.scan`` over a step with no inputs of its own: the step captured
once and replayed, its state kept in static tensors.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Tuple

import torch

from lua_mapreduce_tpu_torch import ops
from torch.utils._pytree import tree_leaves, tree_map

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
    through are kept as :attr:`launches` and credited at every replay."""

    def __init__(self, fn: Callable[[], Any], tag: str = "graph"):
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with ops.recording_launches() as self.launches:
            with torch.cuda.graph(self.graph):
                self.output = fn()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        global _count, _last
        _count, _last = _count + 1, (tag, self.capture_ms)

    def replay(self) -> Any:
        self.graph.replay()
        ops.credit_launches(self.launches)
        return self.output


def scan(step: Callable[[Any], Tuple[Any, Any]], state: Any, n_steps: int,
         tag: str = "scan") -> Tuple[Any, Any]:
    """``lax.scan(lambda s, _: step(s), state, None, length=n_steps)``:
    returns the final state and the per-step outputs stacked on a new
    leading axis. ``state`` is a tree of tensors; ``step(state)``
    returns ``(new_state, out)``, a state of the same structure and a
    tree of tensors.

    On a card, step 0 runs eagerly on a side stream (the capture's
    warm-up: it builds the libraries, and the NCCL communicators of any
    collective in the step, outside the capture), then the step, with
    its write of the new state into static state tensors, is captured
    once and replayed for steps 1 .. n-1; after each replay one
    device-to-device copy per output leaf files the step's output. No
    step makes a host round trip. On the CPU the steps run eagerly.
    """
    leaves = tree_leaves(state)
    if n_steps <= 0:
        raise ValueError(f"scan needs n_steps >= 1, got {n_steps}")
    if not leaves or leaves[0].device.type != "cuda":
        outs = []
        for _ in range(n_steps):
            state, out = step(state)
            outs.append(out)
        return state, tree_map(lambda *xs: torch.stack(xs), *outs)
    static = tree_map(lambda t: t.detach().clone(), state)

    def body():
        new, out = step(static)
        tree_map(lambda s, v: s.copy_(v), static, new)
        return out

    first = on_side_stream(body)
    stacked = tree_map(lambda o: o.new_empty((n_steps,) + o.shape), first)
    tree_map(lambda s, o: s[0].copy_(o), stacked, first)
    if n_steps > 1:
        graph = CapturedGraph(body, tag=tag)
        for i in range(1, n_steps):
            tree_map(lambda s, o: s[i].copy_(o), stacked, graph.replay())
    return static, stacked
