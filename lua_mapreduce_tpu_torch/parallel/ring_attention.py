"""Ring attention — only its single-device oracle in this slice.

Port of ``lua_mapreduce_tpu/parallel/ring_attention.py:50-59``. The ring
schedule (KV shards rotating between devices, merged by the flash
kernel's lse) comes with the sequence-parallel slice, in this file.
"""

from __future__ import annotations

from lua_mapreduce_tpu_torch.ops.attention import flash_attention

_NEG_INF = -1e30      # finite mask fill: -inf breaks the m-subtraction


def attention_reference(q, k, v, *, causal: bool = False, window: int = 0):
    """Single-device softmax attention, (B, L, H, D) layout — one oracle
    for the whole port (delegates to the kernel library's
    ``flash_attention``: the plain version on the CPU, the kernel on a
    card)."""
    return flash_attention(q, k, v, causal=causal, window=window)
