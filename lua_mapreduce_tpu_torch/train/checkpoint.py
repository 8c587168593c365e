"""Model checkpointing through the storage layer.

Port of ``lua_mapreduce_tpu/train/checkpoint.py`` in the same text
format — a v2 JSON manifest line (leaf count, per-leaf dtype names, the
tree's structure string) plus one base64 ``.npy`` line per leaf — so the
two packages load each other's checkpoints. Trees are nested dicts
(leaves in sorted-key order, recursively, which is ``jax.tree.flatten``
order), tuples and lists (in order) of tensors, numpy arrays or Python
scalars.

bfloat16 leaves are written as the JAX package writes them: an ``.npy``
of 2-byte void elements with descr ``'<V2'`` and the dtype name
``"bfloat16"`` in the manifest. They are written and read through a
16-bit integer view — ml_dtypes is never imported.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_log = logging.getLogger(__name__)


def _flatten(tree: Any, leaves: List[Any]) -> str:
    """Append ``tree``'s leaves in ``jax.tree.flatten`` order; return
    its structure in ``str(PyTreeDef)`` notation."""
    if isinstance(tree, dict):
        parts = []
        for k in sorted(tree):
            parts.append(f"{k!r}: {_flatten(tree[k], leaves)}")
        return "{" + ", ".join(parts) + "}"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_flatten(x, leaves) for x in tree)
        if isinstance(tree, list):
            return f"[{inner}]"
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    if tree is None:
        return "None"
    leaves.append(tree)
    return "*"


def tree_flatten(tree: Any) -> Tuple[List[Any], str]:
    """(leaves, structure string) in ``jax.tree.flatten`` order."""
    leaves: List[Any] = []
    structure = _flatten(tree, leaves)
    return leaves, f"PyTreeDef({structure})"


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """Rebuild ``like``'s structure around ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}      # keep the template's order
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        if t is None:
            return None
        return next(it)

    return build(like)


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _npy_bytes(leaf: Any) -> bytes:
    buf = io.BytesIO()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy()
            np.lib.format.write_array_header_1_0(
                buf, {"descr": "<V2", "fortran_order": False,
                      "shape": tuple(bits.shape)})
            buf.write(bits.tobytes())
            return buf.getvalue()
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _save_flat(store, name: str, leaves: List[Any], dtypes: List[str],
               structure: str) -> None:
    """The one checkpoint writer (sync and async paths). ``leaves`` is
    consumed: each slot is released once its bytes are written."""
    with store.builder() as b:
        b.write(json.dumps({"v": 2, "n": len(leaves), "dtypes": dtypes,
                            "treedef": structure}) + "\n")
        for i in range(len(leaves)):
            leaf, leaves[i] = leaves[i], None
            b.write(base64.b64encode(_npy_bytes(leaf)).decode() + "\n")
        b.build(name)


def save_pytree(store, name: str, tree: Any) -> None:
    """Atomically publish ``tree`` as checkpoint file ``name``."""
    leaves, structure = tree_flatten(tree)
    _save_flat(store, name, leaves, [_dtype_name(x) for x in leaves],
               structure)


class AsyncCheckpoint:
    """Background checkpoint writer (the JAX package's
    ``AsyncCheckpoint``): ``submit(store, name, tree)`` copies every
    tensor leaf to host memory synchronously — consistent with the step
    that submits, and safe against the optimizer's in-place updates —
    then serializes and publishes on a worker thread. At most one write
    is in flight: a submit waits for the previous write. ``wait()``
    blocks until the last write is durable and re-raises a background
    failure."""

    def __init__(self):
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, store, name: str, tree: Any) -> None:
        self.wait()                       # one in-flight write max
        leaves, structure = tree_flatten(tree)
        dtypes = [_dtype_name(x) for x in leaves]
        host = [x.detach().to("cpu", copy=True)
                if isinstance(x, torch.Tensor) else x for x in leaves]

        def write():
            try:
                _save_flat(store, name, host, dtypes, structure)
            except BaseException as e:    # re-raised by wait()
                _log.warning("async checkpoint write of %r failed "
                             "(re-raised at wait()): %r", name, e)
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err


def _to_tensor(arr: np.ndarray, recorded: Any, where: str) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.names is None:
        if recorded != "bfloat16" or arr.dtype.itemsize != 2:
            raise ValueError(f"{where}: leaf of dtype {recorded!r} "
                             f"({arr.dtype}) has no torch counterpart here")
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def load_pytree(store, name: str, like: Any, *,
                check_shapes: bool = False,
                check_dtypes: bool = False) -> Any:
    """Load checkpoint ``name`` as CPU tensors; ``like`` supplies the
    tree structure. Leaves come back in their WRITTEN dtype (bfloat16
    included); ``check_dtypes`` / ``check_shapes`` pin them to the
    template's leaves and raise on a mismatch."""
    lines = iter(store.lines(name))
    header = json.loads(next(lines))
    arrays = []
    for _ in range(header["n"]):
        raw = base64.b64decode(next(lines).strip())
        arrays.append(np.load(io.BytesIO(raw), allow_pickle=False))
    like_leaves, _ = tree_flatten(like)
    if len(arrays) != len(like_leaves):
        raise ValueError(f"checkpoint {name!r} has {len(arrays)} leaves, "
                         f"expected {len(like_leaves)}")
    recorded = header.get("dtypes") or [None] * len(arrays)
    if len(recorded) != len(arrays):
        raise ValueError(
            f"checkpoint {name!r}: manifest records {len(recorded)} "
            f"dtypes for {len(arrays)} leaves — truncated or corrupted "
            "manifest")
    out = []
    for i, (arr, tmpl) in enumerate(zip(arrays, like_leaves)):
        leaf = _to_tensor(arr, recorded[i], f"checkpoint {name!r} leaf {i}")
        if check_dtypes:
            want = (tmpl.dtype if isinstance(tmpl, torch.Tensor) else
                    torch.from_numpy(np.asarray(tmpl)).dtype)
            if leaf.dtype != want:
                raise ValueError(
                    f"checkpoint {name!r} leaf {i} was written as "
                    f"{recorded[i] or leaf.dtype} but the template expects "
                    f"{want} — load with a matching template and cast "
                    "explicitly")
        shape = tuple(tmpl.shape if isinstance(tmpl, torch.Tensor)
                      else np.shape(tmpl))
        if check_shapes and shape != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint {name!r} leaf {i}: shape {tuple(leaf.shape)} "
                f"does not match the template's {shape}")
        out.append(leaf)
    return tree_unflatten(like, out)


def exists(store, name: str) -> bool:
    return store.exists(name)
