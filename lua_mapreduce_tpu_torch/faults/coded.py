"""Erasure-coded shuffle redundancy: k+m striping, decode-from-survivors.

Copy of the JAX package's ``faults/coded.py``
(the torch package imports nothing of the JAX package).

DESIGN §27. The replicated data plane (faults/replicate.py, DESIGN §20)
buys millisecond failover at ``r``·1.0x write amplification — full
copies on distinct placement tags. Coded MapReduce's core result
(PAPERS.md) is that the same durability is cheaper than copies: split a
payload into ``k`` data blocks, derive ``m`` Reed–Solomon parity blocks
over GF(256), and place each of the ``k+m`` blocks on a DISTINCT
placement tag (engine/placement.py). Any ``m`` lost tags still leave
``k`` evaluations of the degree-<k polynomial — enough to reconstruct
everything — at ``(k+m)/k`` write amplification: 4+1 ≈ 1.27x tolerates
any single-domain loss that r=2 pays 2.0x for.

Stripe layout (one logical file)::

    ^0.<t0>^<name>  ...  ^<k-1>.<tk-1>^<name>     k data blocks
    ^<k>.<tk>^<name> ... ^<k+m-1>.<..>^<name>     m parity blocks
    ^M^<name>  (+ m replica copies ~j.<t>~^M^<name>)   the manifest

Block ``i`` lives on tag ``(primary_tag(name)+i) % NUM_TAGS`` — the
replica formula, so the blocks occupy ``k+m`` distinct tags; the
manifest is replicated ``m+1``-way on distinct tags, so any ``m`` tag
losses leave both a readable manifest and ≥ ``k`` blocks. All stripe
names start with ``^`` — glob-transparent to every discovery/cleanup
pattern, exactly like ``~`` replica names. The manifest (a one-line
JSON doc naming the block set with per-block CRCs) publishes LAST: a
producer killed mid-stripe leaves orphan blocks that no reader can see
(``exists``/``list`` answer for the manifest), so partial stripes are
invisible and a re-publish of the same name simply overwrites.

Group stripes (the bandwidth half, DESIGN §27): a push-mode mapper
holding several partitions' final frames concatenates them into ONE
payload, stripes it once, and writes each member its own manifest with
an ``(off, len)`` window into the shared block set — one coded
combination serving multiple reducer inboxes, amortizing the parity
and manifest cost across partitions instead of paying it per fragment.

The read side (:class:`CodedStore`, the ``reading_view`` twin of
ReplicatedStore) serves LOGICAL names: the systematic fast path
concatenates the ``k`` data blocks (no GF math on the healthy path);
a classified storage fault or a per-block CRC mismatch — a corrupted
block is a lost block — triggers decode-from-survivors inline, counted
``decode_reads`` + ``map_reruns_avoided`` once per name. Fewer than
``k`` readable blocks raises :class:`LostShuffleDataError`, the same
classified-transient escalation replication uses: the worker releases,
the scavenger tries :func:`repair_stripe`, and only a truly lost
stripe falls through to the map re-run last resort (engine/server.py).

Name construction (the ``^``-sigil grammar) is THIS module's monopoly —
lint rule LMR012 flags stripe-name literals anywhere else; placement.py
owns the parsing side (tag routing must work for every copy shape).
No new dependencies: the codec is pure Python (``bytes.translate`` +
big-int XOR) with a vectorized numpy table-gather fast path when numpy
is importable.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

from lua_mapreduce_tpu_torch.engine.placement import (NUM_TAGS, check_replication,
                                                      primary_tag, replica_names,
                                                      replica_pattern,
                                                      resolve_replication)
from lua_mapreduce_tpu_torch.faults.errors import (LostShuffleDataError,
                                                   classify_exception)
from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
from lua_mapreduce_tpu_torch.store.base import FileBuilder, Store, encode_chunks


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _classifier(store):
    return getattr(store, "classify", classify_exception)


# --------------------------------------------------------------------------
# GF(256) Reed–Solomon codec (poly 0x11d, generator 2)
# --------------------------------------------------------------------------

_GF_POLY = 0x11D
_EXP = [0] * 512
_LOG = [0] * 256
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _GF_POLY
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]
del _x, _i


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return _EXP[_LOG[a] + _LOG[b]]


def _gf_inv(a: int) -> int:
    return _EXP[255 - _LOG[a]]


_ROW_CACHE: Dict[int, bytes] = {}


def _mul_row(c: int) -> bytes:
    """The 256-entry multiply-by-``c`` table as bytes —
    ``block.translate(row)`` is the C-speed scalar·vector product the
    pure-Python path leans on."""
    row = _ROW_CACHE.get(c)
    if row is None:
        row = bytes(_gf_mul(c, b) for b in range(256))
        _ROW_CACHE[c] = row
    return row


_COEF_CACHE: Dict[Tuple[Tuple[int, ...], int], Tuple[int, ...]] = {}


def _lagrange_coeffs(xs: Tuple[int, ...], x: int) -> Tuple[int, ...]:
    """``c_j`` with ``P(x) = Σ c_j · P(xs[j])`` for every polynomial of
    degree < len(xs) — evaluation as a linear combination of any
    len(xs) known points, the one primitive both encode (data points
    0..k-1 → parity points k..k+m-1) and decode (any k survivors →
    the missing points) reduce to. GF(2^8) subtraction is XOR."""
    key = (xs, x)
    out = _COEF_CACHE.get(key)
    if out is None:
        coeffs = []
        for j, xj in enumerate(xs):
            num, den = 1, 1
            for t, xt in enumerate(xs):
                if t != j:
                    num = _gf_mul(num, x ^ xt)
                    den = _gf_mul(den, xj ^ xt)
            coeffs.append(_gf_mul(num, _gf_inv(den)))
        out = _COEF_CACHE[key] = tuple(coeffs)
    return out


_NUMPY = None            # (module, 256x256 mul table) | () when absent
_FORCE_PYTHON = False    # tests flip it to cover the fallback path


def _numpy():
    global _NUMPY
    if _NUMPY is None:
        try:
            import numpy as np
            tbl = np.zeros((256, 256), dtype=np.uint8)
            for a in range(1, 256):
                tbl[a] = np.frombuffer(_mul_row(a), np.uint8)
            _NUMPY = (np, tbl)
        except Exception:
            _NUMPY = ()
    return _NUMPY if _NUMPY else (None, None)


def _combine(pairs: Sequence[Tuple[int, bytes]], blen: int) -> bytes:
    """``XOR_j coeff_j · block_j`` over GF(256): the numpy fast path is
    one table gather + XOR per block; the fallback is
    ``bytes.translate`` (the same table, C speed) + big-int XOR —
    vectorized either way, never a Python per-byte loop."""
    np, tbl = (None, None) if _FORCE_PYTHON else _numpy()
    if np is not None:
        acc = np.zeros(blen, np.uint8)
        for c, blk in pairs:
            if c == 0:
                continue
            arr = np.frombuffer(blk, np.uint8)
            acc ^= arr if c == 1 else tbl[c][arr]
        return acc.tobytes()
    acc = 0
    for c, blk in pairs:
        if c == 0:
            continue
        if c != 1:
            blk = blk.translate(_mul_row(c))
        acc ^= int.from_bytes(blk, "big")
    return acc.to_bytes(blen, "big")


def rs_parity(data_blocks: Sequence[bytes], m: int) -> List[bytes]:
    """The ``m`` parity blocks of ``k`` equal-length data blocks:
    evaluations of the interpolating polynomial at points k..k+m-1."""
    k, blen = len(data_blocks), len(data_blocks[0])
    xs = tuple(range(k))
    return [_combine(list(zip(_lagrange_coeffs(xs, x), data_blocks)), blen)
            for x in range(k, k + m)]


def rs_reconstruct(have: Dict[int, bytes], want: Sequence[int],
                   k: int) -> Dict[int, bytes]:
    """Rebuild the blocks at points ``want`` from any ≥ k survivors in
    ``have`` (point index → block). Raises ValueError below k — the
    caller's decode-vs-map-rerun decision point."""
    if len(have) < k:
        raise ValueError(f"need {k} surviving blocks, have {len(have)}")
    xs = tuple(sorted(have))[:k]
    basis = [have[x] for x in xs]
    blen = len(basis[0])
    return {x: _combine(list(zip(_lagrange_coeffs(xs, x), basis)), blen)
            for x in want}


# --------------------------------------------------------------------------
# the coding knob (the unified redundancy value engines thread through)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Coding:
    """A ``k+m`` erasure-coding spec: k data + m parity blocks, any m
    losses decodable, (k+m)/k write amplification. Flows through every
    ``replication=`` parameter in engine/ unchanged — the choke points
    (spill_writer / reading_view / repair) dispatch on the type."""

    k: int
    m: int

    def __post_init__(self):
        if self.k < 2:
            raise ValueError(f"coding k={self.k}: k must be >= 2 (k=1 is "
                             "plain replication — use the replication knob)")
        if self.m < 1:
            raise ValueError(f"coding m={self.m}: at least one parity block")
        if self.k + self.m > NUM_TAGS:
            raise ValueError(
                f"coding {self.k}+{self.m}: k+m blocks must fit the "
                f"{NUM_TAGS} distinct placement tags")

    @property
    def blocks(self) -> int:
        return self.k + self.m

    def __str__(self) -> str:
        return f"{self.k}+{self.m}"


_CODING_RE = re.compile(r"^\s*(\d+)\s*\+\s*(\d+)\s*$")

Redundancy = Union[int, Coding]


def parse_coding(spec) -> Coding:
    """``"4+1"`` → Coding(4, 1); a Coding passes through."""
    if isinstance(spec, Coding):
        return spec
    m = _CODING_RE.match(str(spec))
    if not m:
        raise ValueError(f"coding spec {spec!r} is not of the form 'k+m' "
                         "(e.g. '4+1')")
    return Coding(int(m.group(1)), int(m.group(2)))


def check_redundancy(value) -> Redundancy:
    """Validate the unified redundancy knob: an int replication factor
    (or int-string), a ``"k+m"`` coding spec, or a Coding. None means
    off (1)."""
    if value is None:
        return 1
    if isinstance(value, Coding):
        return value
    if isinstance(value, str) and "+" in value:
        return parse_coding(value)
    return check_replication(value)


def redundancy_on(value) -> bool:
    """True when the redundancy layer is active — coding of any shape,
    or replication > 1 (the engines' gate for scavenger probes and
    lost-data escalation)."""
    red = check_redundancy(value)
    return isinstance(red, Coding) or red > 1


def resolve_redundancy(replication=None, coding=None) -> Redundancy:
    """Server/LocalExecutor shared knob resolution: explicit ``coding``
    argument, else ``LMR_CODING``, else the replication knob (explicit,
    else ``LMR_REPLICATION``, else 1/off). Turning BOTH modes on is
    rejected loudly — they are alternative answers to the same
    durability question, and silently preferring one would make two
    deployments with the same env disagree on the data-plane layout."""
    c = parse_coding(coding) if coding else None
    if c is None:
        env = os.environ.get("LMR_CODING")
        c = parse_coding(env) if env else None
    r = check_redundancy(replication) if replication is not None else None
    if isinstance(r, Coding) and c is None:
        c, r = r, None
    if c is not None:
        if r is not None and r != 1 and r != c:
            raise ValueError(
                f"coding {c} and replication {r} are mutually exclusive "
                "redundancy modes — configure exactly one")
        return c
    return resolve_replication(replication)


def doc_fields(red) -> dict:
    """The task-document encoding of the unified redundancy value —
    JSON-safe (a Coding cannot land in the doc raw): the int
    replication factor plus a ``"coding"`` spec string (empty when
    off). :func:`doc_redundancy` is the decoder."""
    red = check_redundancy(red)
    if isinstance(red, Coding):
        return {"replication": 1, "coding": str(red)}
    return {"replication": red, "coding": ""}


def doc_redundancy(doc, default=1) -> Redundancy:
    """The redundancy a task document deploys: a non-empty ``coding``
    spec wins, else the doc's ``replication``, else ``default`` (the
    follower's own resolved value — docs predating either key must not
    silently turn redundancy off on resume)."""
    doc = doc or {}
    c = doc.get("coding")
    if c:
        return parse_coding(c)
    return check_redundancy(doc.get("replication", default) or 1)


# --------------------------------------------------------------------------
# stripe naming (the ^-sigil grammar — constructed HERE only, LMR012)
# --------------------------------------------------------------------------


def block_names(name: str, coding: Coding) -> List[str]:
    """The k+m physical block names of ``name``'s stripe, data first."""
    pt = primary_tag(name)
    return [f"^{i}.{(pt + i) % NUM_TAGS}^{name}"
            for i in range(coding.blocks)]


def manifest_name(name: str) -> str:
    return f"^M^{name}"


def manifest_copies(name: str, coding: Coding) -> List[str]:
    """The m+1 copy names of ``name``'s stripe manifest — replicated on
    distinct tags so any m tag losses leave one readable (the manifest
    is tiny; replicating it costs bytes the parity math can't save)."""
    return replica_names(manifest_name(name), coding.m + 1)


def manifest_pattern(pattern: str) -> str:
    """The glob matching the primary manifest of every logical name
    matching ``pattern``."""
    return f"^M^{pattern}"


def stripe_patterns(pattern: str) -> List[str]:
    """Globs matching EVERY physical stripe file of every logical name
    matching ``pattern`` — blocks + primary manifests (both carry the
    ``^..^`` wrap) and replica manifest copies. Sweeps pair these with
    the plain pattern."""
    return [f"^*^{pattern}", replica_pattern(manifest_pattern(pattern))]


# --------------------------------------------------------------------------
# write side: stripe publish
# --------------------------------------------------------------------------


def publish_stripe(store: Store, members: Sequence[Tuple[str, bytes]],
                   coding: Coding, group_base: Optional[str] = None) -> int:
    """Stripe the concatenated ``members`` payloads into k+m blocks
    named from ``group_base`` (default: the single member's own name)
    and publish each member's manifest LAST — the visibility gate: a
    producer killed anywhere before its manifest build leaves an
    invisible partial stripe, never a readable torn one.

    Returns the bytes published. Telemetry mirrors _TeeBuilder's
    honest-overhead split: the logical payload once
    (``spill_bytes_primary``), everything beyond it — parity blocks,
    padding, manifests — as ``spill_bytes_parity``.
    """
    if not members:
        raise ValueError("publish_stripe: no members")
    if group_base is None:
        if len(members) != 1:
            raise ValueError("multi-member stripes need a group_base name")
        group_base = members[0][0]
    payload = b"".join(p for _, p in members)
    total = len(payload)
    k, m = coding.k, coding.m
    blen = max(1, -(-total // k))
    data = [payload[i * blen:(i + 1) * blen].ljust(blen, b"\0")
            for i in range(k)]
    blocks = data + rs_parity(data, m)
    names = block_names(group_base, coding)
    published = 0
    for bname, blob in zip(names, blocks):
        with store.builder() as b:
            b.write_bytes(blob)
            b.build(bname)
        published += len(blob)
    bcrc = [_crc(blob) for blob in blocks]
    shared = len(members) > 1
    off = 0
    for lname, p in members:
        doc = {"v": 1, "k": k, "m": m, "blen": blen, "total": total,
               "off": off, "len": len(p), "crc": _crc(p),
               "blocks": names, "bcrc": bcrc, "shared": shared}
        raw = (json.dumps(doc, separators=(",", ":"), sort_keys=True)
               + "\n").encode("utf-8")
        for cname in manifest_copies(lname, coding):
            with store.builder() as b:
                b.write_bytes(raw)
                b.build(cname)
            published += len(raw)
        off += len(p)
    COUNTERS.bump("spill_bytes_primary", total)
    COUNTERS.bump("spill_bytes_parity", published - total)
    return published


class _StripeBuilder(FileBuilder):
    """spill_writer's coded twin of _TeeBuilder: accumulate the chunks,
    stripe on ``build``. The whole payload is held in memory until the
    publish — bounded by the frame size in push mode (the perf path)
    and by one map job's partition output when staged; the push
    engine's eviction tail stays on streaming (m+1)-way replication
    (see tail_redundancy) precisely because it exists to bound memory."""

    def __init__(self, store: Store, coding: Coding):
        self._store = store
        self._coding = coding
        self._chunks: List[Union[str, bytes]] = []

    def write(self, data: str) -> None:
        self._chunks.append(data)

    def write_bytes(self, data: bytes) -> None:
        self._chunks.append(data)

    def build(self, name: str) -> None:
        payload = encode_chunks(self._chunks)
        self._chunks = []
        publish_stripe(self._store, [(name, payload)], self._coding)

    def close(self) -> None:
        self._chunks = []


def stripe_builder(store: Store, coding: Coding) -> FileBuilder:
    """The builder spill_writer wraps for ``coding="k+m"`` publishes."""
    return _StripeBuilder(store, coding)


def tail_redundancy(red: Redundancy) -> int:
    """What the push engine's memory-pressure eviction tail degrades
    to: coded mode falls back to (m+1)-way streaming replication (same
    loss tolerance, no payload buffering — the tail exists to BOUND
    memory), plain replication keeps its own r."""
    red = check_redundancy(red)
    return red.m + 1 if isinstance(red, Coding) else red


class _CaptureBuilder(FileBuilder):
    def __init__(self, store: "CaptureStore"):
        self._store = store
        self._chunks: List[Union[str, bytes]] = []

    def write(self, data: str) -> None:
        self._chunks.append(data)

    def write_bytes(self, data: bytes) -> None:
        self._chunks.append(data)

    def build(self, name: str) -> None:
        self._store.files.append((name, encode_chunks(self._chunks)))
        self._chunks = []

    def close(self) -> None:
        self._chunks = []


class CaptureStore(Store):
    """In-memory single-shot capture target: the push engine serializes
    each group-stripe member through the NORMAL spill_writer path into
    one of these, then hands the captured (name, payload) list to
    :func:`publish_stripe` — group assembly without a parallel
    serialization code path."""

    publish_ambiguous = False

    def __init__(self):
        self.files: List[Tuple[str, bytes]] = []

    def builder(self) -> FileBuilder:
        return _CaptureBuilder(self)

    def _blob(self, name: str) -> bytes:
        for n, b in self.files:
            if n == name:
                return b
        raise FileNotFoundError(name)

    def lines(self, name: str) -> Iterator[str]:
        data = self._blob(name)
        try:
            text = data.decode("utf-8")
        except UnicodeDecodeError:
            text = data.decode("latin-1")
        yield from text.splitlines(keepends=True)

    def list(self, pattern: str) -> List[str]:
        return self._match([n for n, _ in self.files], pattern)

    def exists(self, name: str) -> bool:
        return any(n == name for n, _ in self.files)

    def remove(self, name: str) -> None:
        self.files = [(n, b) for n, b in self.files if n != name]

    def read_range(self, name: str, offset: int, length: int) -> bytes:
        return self._blob(name)[offset:offset + length]

    def size(self, name: str) -> int:
        return len(self._blob(name))


# --------------------------------------------------------------------------
# read side: decode-from-survivors view
# --------------------------------------------------------------------------


class _BadBlock(Exception):
    """Internal: a block read that is present but wrong (short read or
    CRC mismatch) — handled exactly like a lost block, never escapes."""


_PAYLOAD_CACHE_BYTES = 64 << 20


class CodedStore(Store):
    """The coded reading view (reading_view's Coding branch): ops
    address LOGICAL names, served by reassembling the stripe behind
    each manifest; names without a manifest pass through untouched
    (plain result files, pre-coding leftovers).

    The systematic fast path reads the k data blocks and concatenates —
    no GF math when the stripe is healthy. A classified storage fault
    or a per-block CRC mismatch flips the name to decode-from-survivors
    (any k of the k+m blocks), counted ``decode_reads`` +
    ``map_reruns_avoided`` once per name; below k readable blocks the
    classified-transient :class:`LostShuffleDataError` escapes and the
    scavenger/map-rerun ladder takes over, exactly like replication's
    total-copy loss. Decoded group payloads are cached (bounded, keyed
    by block set) so the k members of a group stripe don't re-read the
    shared blocks k times — the segment reader's many ranged reads per
    file lean on this the way they lean on ReplicatedStore's redirect
    cache. Like every reading view, only the portable Store surface is
    exposed: native fast paths (``local_path``) cannot bypass decode."""

    def __init__(self, inner: Store, coding: Coding):
        from lua_mapreduce_tpu_torch.faults.replicate import ReplicatedStore
        self._inner = inner
        self._coding = parse_coding(coding)
        self._lock = threading.Lock()
        self._manifests: Dict[str, dict] = {}
        self._payloads: "Dict[Tuple[str, ...], bytes]" = {}
        self._payload_bytes = 0
        self._counted = set()
        # names WITHOUT a stripe manifest pass through a failover view
        # at the tail factor: the push engine's eviction tails stream at
        # (m+1)-way replication (tail_redundancy — striping would buffer
        # the payload the tail exists not to hold), and the coded view
        # must still serve them with every primary destroyed. Plain
        # unreplicated files are served identically (their copy 0 IS
        # the plain name).
        self._plain = ReplicatedStore(inner, tail_redundancy(self._coding))

    # -- stripe core --------------------------------------------------------

    def _manifest(self, name: str) -> Optional[dict]:
        """The stripe manifest behind logical ``name`` from any
        readable copy, positively cached (manifests are immutable once
        published); None when no copy EXISTS — the passthrough verdict.
        Copies that exist but stay unreadable raise the lost-data
        escalation rather than silently passing through to a plain
        name that was never published."""
        with self._lock:
            man = self._manifests.get(name)
        if man is not None:
            return man
        classify = _classifier(self._inner)
        copies = manifest_copies(name, self._coding)
        seen, last = False, None
        for cname in copies:
            try:
                if not self._inner.exists(cname):
                    continue
                seen = True
                raw = self._inner.read_range(cname, 0,
                                             self._inner.size(cname))
                man = json.loads(raw.decode("utf-8"))
            except Exception as exc:
                if classify(exc) is None:
                    raise
                last = exc
                continue
            with self._lock:
                self._manifests[name] = man
            return man
        if seen:
            raise LostShuffleDataError(
                f"manifest({name!r}): stripe manifest exists but no copy "
                f"is readable (last: {type(last).__name__}: {last})",
                op="manifest", name=name, files=[name]) from last
        return None

    def _read_block(self, bname: str, blen: int, crc: int) -> bytes:
        blob = self._inner.read_range(bname, 0, blen)
        if len(blob) != blen or _crc(blob) != crc:
            raise _BadBlock(bname)
        return blob

    def _group_payload(self, name: str, man: dict) -> bytes:
        """The decoded full-group payload behind ``man`` (truncated to
        ``total``); member windows are sliced by the caller."""
        key = tuple(man["blocks"])
        with self._lock:
            whole = self._payloads.get(key)
        if whole is not None:
            return whole
        classify = _classifier(self._inner)
        k, blen = man["k"], man["blen"]
        names, bcrc = man["blocks"], man["bcrc"]
        have: Dict[int, bytes] = {}
        degraded = False
        for i in range(len(names)):
            if i >= k and len(have) >= k:
                break               # enough survivors; skip spare parity
            try:
                have[i] = self._read_block(names[i], blen, bcrc[i])
            except Exception as exc:
                if not isinstance(exc, _BadBlock) and classify(exc) is None:
                    raise
                if i < k:
                    degraded = True  # a data block needs reconstruction
        if len(have) < k:
            raise LostShuffleDataError(
                f"stripe({name!r}): only {len(have)} of {len(names)} "
                f"blocks readable, {k} needed to decode — scavenger "
                "repair or map re-run required", op="stripe", name=name,
                files=[name])
        if degraded:
            missing = [i for i in range(k) if i not in have]
            have.update(rs_reconstruct(have, missing, k))
            if name not in self._counted:
                self._counted.add(name)
                COUNTERS.bump("decode_reads")
                COUNTERS.bump("map_reruns_avoided")
        whole = b"".join(have[i] for i in range(k))[:man["total"]]
        with self._lock:
            if key not in self._payloads:
                # bounded: evict whole entries FIFO past the cap (the
                # access pattern is one file read to completion, then
                # the next — LRU precision buys nothing here)
                while (self._payloads and
                       self._payload_bytes + len(whole)
                       > _PAYLOAD_CACHE_BYTES):
                    _, old = self._payloads.popitem()
                    self._payload_bytes -= len(old)
                self._payloads[key] = whole
                self._payload_bytes += len(whole)
        return whole

    def _payload(self, name: str, man: dict) -> bytes:
        whole = self._group_payload(name, man)
        payload = whole[man["off"]:man["off"] + man["len"]]
        if _crc(payload) != man["crc"]:
            raise LostShuffleDataError(
                f"stripe({name!r}): decoded payload fails its manifest "
                "CRC — corruption beyond the parity budget", op="stripe",
                name=name, files=[name])
        return payload

    # -- portable surface ---------------------------------------------------

    def builder(self) -> FileBuilder:
        return self._inner.builder()

    def lines(self, name: str) -> Iterator[str]:
        man = self._manifest(name)
        if man is None:
            yield from self._plain.lines(name)
            return
        data = self._payload(name, man)
        try:
            text = data.decode("utf-8")
        except UnicodeDecodeError:
            text = data.decode("latin-1")
        yield from text.splitlines(keepends=True)

    def read_range(self, name: str, offset: int, length: int) -> bytes:
        man = self._manifest(name)
        if man is None:
            return self._plain.read_range(name, offset, length)
        return self._payload(name, man)[offset:offset + length]

    def size(self, name: str) -> int:
        man = self._manifest(name)
        if man is None:
            return self._plain.size(name)
        return man["len"]

    def exists(self, name: str) -> bool:
        classify = _classifier(self._inner)
        if self._plain.exists(name):        # plain name or a tail replica
            return True
        for cname in manifest_copies(name, self._coding):
            try:
                if self._inner.exists(cname):
                    return True
            except Exception as exc:
                if classify(exc) is None:
                    raise
        return False

    def list(self, pattern: str) -> List[str]:
        from lua_mapreduce_tpu_torch.engine.placement import base_name
        names = set(self._inner.list(pattern))
        # stripes are visible at their LOGICAL name while any manifest
        # copy survives — discovery and the reduce pull-integrity check
        # must not report a decodable file as missing; same for a
        # replicated tail whose primary is gone
        for n in self._inner.list(manifest_pattern(pattern)):
            names.add(base_name(n))
        for n in self._inner.list(
                replica_pattern(manifest_pattern(pattern))):
            names.add(base_name(n))
        for n in self._inner.list(replica_pattern(pattern)):
            names.add(base_name(n))
        return sorted(names)

    def remove(self, name: str) -> None:
        # best-effort fanout sweep, classified faults swallowed, like
        # ReplicatedStore.remove; SHARED group blocks outlive any one
        # member (the other members still window into them) and are
        # swept by the namespace-level stripe_patterns cleanup instead
        classify = _classifier(self._inner)
        try:
            man = self._manifest(name)
        except LostShuffleDataError:
            man = None
        self._plain.remove(name)    # plain copy + any tail replicas
        targets = manifest_copies(name, self._coding)
        if man is not None and not man.get("shared"):
            targets += list(man["blocks"])
        for t in targets:
            try:
                self._inner.remove(t)
            except Exception as exc:
                if classify(exc) is None:
                    raise
        with self._lock:
            self._manifests.pop(name, None)

    def classify(self, exc: BaseException):
        return self._inner.classify(exc)


# --------------------------------------------------------------------------
# scavenger reconstruction
# --------------------------------------------------------------------------


def repair_stripe(store: Store, name: str, coding: Coding) -> str:
    """Restore ``name``'s stripe to full k+m blocks + m+1 manifest
    copies from any ≥ k readable blocks — the scavenger's repair rung,
    same verdict contract as replicate.repair: ``"intact"`` (nothing to
    do), ``"repaired"`` (blocks/manifest copies rebuilt, counted
    ``stripe_repairs`` + ``map_reruns_avoided``), ``"degraded"``
    (decodable but every rebuild write failed — inline decode keeps
    serving reads), ``"lost"`` (below k readable blocks, or the
    manifest itself unrecoverable — only then does the caller escalate
    to the map re-run). ``store`` is the plain wrapped store; corrupt
    blocks (CRC mismatch) are treated as lost blocks. Idempotent per
    stripe, so the members of a shared group stripe can each be
    reported lost and repaired once."""
    coding = parse_coding(coding)
    classify = _classifier(store)
    copies = manifest_copies(name, coding)
    raw_man, man = None, None
    missing_copies = []
    for cname in copies:
        try:
            if not store.exists(cname):
                missing_copies.append(cname)
                continue
            raw = store.read_range(cname, 0, store.size(cname))
            doc = json.loads(raw.decode("utf-8"))
        except Exception as exc:
            if classify(exc) is None:
                raise
            missing_copies.append(cname)
            continue
        if man is None:
            raw_man, man = raw, doc
    if man is None:
        # no readable manifest: a readable plain passthrough file is
        # intact; a name with surviving REPLICA copies is a push
        # eviction tail (streamed at tail_redundancy, never striped) —
        # the replica repair rung recovers it; a stripe whose every
        # manifest copy is gone is unrecoverable (the block set is
        # unknowable for group stripes), as is a genuinely absent name
        try:
            if store.exists(name):
                return "intact"
        except Exception as exc:
            if classify(exc) is None:
                raise
        from lua_mapreduce_tpu_torch.faults.replicate import repair as _rrepair
        return _rrepair(store, name, tail_redundancy(coding))
    k = man["k"]
    names, bcrc, blen = man["blocks"], man["bcrc"], man["blen"]
    have: Dict[int, bytes] = {}
    broken: List[int] = []
    for i, bname in enumerate(names):
        try:
            blob = store.read_range(bname, 0, blen)
            if len(blob) != blen or _crc(blob) != bcrc[i]:
                raise _BadBlock(bname)
            have[i] = blob
        except Exception as exc:
            if not isinstance(exc, _BadBlock) and classify(exc) is None:
                raise
            broken.append(i)
    if len(have) < k:
        return "lost"
    if not broken and not missing_copies:
        return "intact"
    rebuilt = 0
    if broken:
        for i, blob in rs_reconstruct(have, broken, k).items():
            try:
                with store.builder() as b:
                    b.write_bytes(blob)
                    b.build(names[i])
                rebuilt += 1
            except Exception as exc:
                if classify(exc) is None:
                    raise
                # target still dark: partial repair, reads keep decoding
    for cname in missing_copies:
        try:
            with store.builder() as b:
                b.write_bytes(raw_man)
                b.build(cname)
            rebuilt += 1
        except Exception as exc:
            if classify(exc) is None:
                raise
    if rebuilt:
        COUNTERS.bump("stripe_repairs")
        COUNTERS.bump("map_reruns_avoided")
        return "repaired"
    return "degraded"


def utest() -> None:
    """Self-test: GF identities, encode/decode under every erasure
    pattern (numpy and pure-Python paths agreeing), the knob grammar,
    stripe naming/placement/glob transparency, publish + CodedStore
    round-trips with loss/corruption, the manifest visibility gate,
    group stripes, and repair_stripe's verdict ladder."""
    import fnmatch
    import itertools
    global _FORCE_PYTHON
    from lua_mapreduce_tpu_torch.engine.placement import base_name, tag_of
    from lua_mapreduce_tpu_torch.store.memfs import MemStore

    # GF(256): inverses, distributivity spot checks, table sanity
    for a in (1, 2, 7, 93, 255):
        assert _gf_mul(a, _gf_inv(a)) == 1
    assert _gf_mul(0, 55) == 0 and _gf_mul(1, 55) == 55

    # RS: every ≤m erasure pattern reconstructs, both codec paths
    payload = bytes((i * 37 + (i >> 3)) % 256 for i in range(997))
    for k, m in ((4, 1), (4, 2), (2, 1), (5, 3)):
        blen = -(-len(payload) // k)
        data = [payload[i * blen:(i + 1) * blen].ljust(blen, b"\0")
                for i in range(k)]
        for force in (False, True):
            _FORCE_PYTHON = force
            try:
                parity = rs_parity(data, m)
                blocks = data + parity
                for lost in itertools.combinations(range(k + m), m):
                    have = {i: b for i, b in enumerate(blocks)
                            if i not in lost}
                    got = rs_reconstruct(have, list(lost), k)
                    assert all(got[i] == blocks[i] for i in lost)
            finally:
                _FORCE_PYTHON = False

    # knob grammar: parse/validate/resolve, replication interop
    assert parse_coding("4+1") == Coding(4, 1) and str(Coding(4, 2)) == "4+2"
    assert check_redundancy("4+1") == Coding(4, 1)
    assert check_redundancy(3) == 3 and check_redundancy(None) == 1
    assert redundancy_on(Coding(4, 1)) and redundancy_on(2)
    assert not redundancy_on(1) and not redundancy_on(None)
    assert tail_redundancy(Coding(4, 2)) == 3 and tail_redundancy(3) == 3
    for bad in ("4", "4-1", "1+1", "4+0", "7+2"):
        try:
            check_redundancy(bad) if "+" in bad else parse_coding(bad)
        except ValueError:
            pass
        else:
            raise AssertionError(f"coding {bad!r} must be rejected")
    try:
        resolve_redundancy(replication=2, coding="4+1")
    except ValueError:
        pass
    else:
        raise AssertionError("both redundancy modes on must be rejected")
    assert resolve_redundancy(replication="4+1") == Coding(4, 1)
    assert resolve_redundancy(replication=2) == 2

    # naming: k+m distinct tags, parse round-trip, glob transparency
    c41 = Coding(4, 1)
    lname = "result.P3.SPILL-00001-00002"
    bn = block_names(lname, c41)
    assert len({tag_of(n) for n in bn}) == c41.blocks
    assert all(base_name(n) == lname for n in bn)
    mans = manifest_copies(lname, c41)
    assert len(mans) == c41.m + 1
    assert len({tag_of(n) for n in mans}) == c41.m + 1
    assert all(base_name(n) == lname for n in mans)
    for phys in bn + mans:
        assert not fnmatch.fnmatchcase(phys, "result.P*")   # invisible
    assert any(fnmatch.fnmatchcase(n, stripe_patterns("result.P*")[0])
               for n in bn + mans[:1])
    assert fnmatch.fnmatchcase(mans[1], stripe_patterns("result.P*")[1])

    # publish + read round-trip; loss of any m blocks decodes inline
    raw = MemStore()
    publish_stripe(raw, [(lname, payload)], c41)
    view = CodedStore(raw, c41)
    assert view.exists(lname) and view.size(lname) == len(payload)
    assert view.read_range(lname, 0, 10 ** 9) == payload
    assert view.list("result.P*") == [lname]
    before = COUNTERS.snapshot().get("decode_reads", 0)
    raw._files.pop(bn[0])                       # lose a data block
    fresh = CodedStore(raw, c41)
    assert fresh.read_range(lname, 5, 17) == payload[5:22]
    assert COUNTERS.snapshot()["decode_reads"] == before + 1
    assert fresh.read_range(lname, 0, 99) == payload[:99]   # counted once
    assert COUNTERS.snapshot()["decode_reads"] == before + 1

    # scavenger: repair rebuilds the lost data block; a corrupted
    # PARITY block (CRC mismatch == lost block) is rebuilt the same way
    assert repair_stripe(raw, lname, c41) == "repaired"
    raw._files[bn[4]] = b"garbage-not-parity"
    assert repair_stripe(raw, lname, c41) == "repaired"
    assert repair_stripe(raw, lname, c41) == "intact"
    assert CodedStore(raw, c41).read_range(lname, 0, 10 ** 9) == payload

    # below k survivors: reads raise the classified transient, repair
    # says lost — the map-rerun last resort
    for n in bn[:2]:
        raw._files.pop(n)
    try:
        CodedStore(raw, c41).read_range(lname, 0, 8)
    except LostShuffleDataError as e:
        assert e.transient and e.lost_files == [lname]
    else:
        raise AssertionError("sub-k survivors must raise lost-data")
    assert repair_stripe(raw, lname, c41) == "lost"

    # manifest gate: blocks without a manifest are INVISIBLE (the
    # SIGKILL-mid-stripe shape) — and a manifest with every copy gone
    # while blocks survive is also correctly not resurrectable
    raw2 = MemStore()
    half = "ns.P0.INBOX-00000001-00000"
    for bname2, blob in zip(block_names(half, c41), [b"x" * 8] * 5):
        with raw2.builder() as b:
            b.write_bytes(blob)
            b.build(bname2)
    gate = CodedStore(raw2, c41)
    assert not gate.exists(half)
    assert gate.list("ns.P0.INBOX-*") == []
    publish_stripe(raw2, [(half, b"whole")], c41)     # re-publish wins
    assert CodedStore(raw2, c41).read_range(half, 0, 99) == b"whole"

    # group stripe: members share one block set; each member windows
    # its own slice; removing one member leaves the others readable
    raw3 = MemStore()
    members = [(f"gns.P{i}.INBOX-00000007-00000",
                bytes((i + 1) * j % 256 for j in range(200 + 31 * i)))
               for i in range(3)]
    publish_stripe(raw3, members, c41, group_base="gns.CODE.00000007")
    gview = CodedStore(raw3, c41)
    for mname, mpay in members:
        assert gview.read_range(mname, 0, 10 ** 9) == mpay
        assert gview.size(mname) == len(mpay)
    gview.remove(members[0][0])
    gv2 = CodedStore(raw3, c41)
    assert not gv2.exists(members[0][0])
    assert gv2.read_range(members[1][0], 0, 10 ** 9) == members[1][1]
    # shared-member repair is idempotent across members
    blocks3 = block_names("gns.CODE.00000007", c41)
    raw3._files.pop(blocks3[1])
    assert repair_stripe(raw3, members[1][0], c41) == "repaired"
    assert repair_stripe(raw3, members[2][0], c41) == "intact"

    # passthrough: plain files below the view are untouched
    with raw3.builder() as b:
        b.write("plain\n")
        b.build("gns.P9.plainfile")
    assert list(gview.lines("gns.P9.plainfile")) == ["plain\n"]
    assert repair_stripe(raw3, "gns.P9.plainfile", c41) == "intact"
    assert not hasattr(gview, "local_path")

    # eviction tails ride (m+1)-way replication under coding (they
    # exist to bound memory — striping would buffer the payload): the
    # coded view fails over to a tail replica with the primary gone,
    # lists/serves the logical name, and the repair rung rebuilds it
    from lua_mapreduce_tpu_torch.faults.replicate import spill_writer
    tname = "gns.P4.INBOX-00000009-00001T"
    with spill_writer(raw3, "v1", tail_redundancy(c41)) as tw:
        tw.add("tk", [7])
        tw.build(tname)
    raw3._files.pop(tname)                       # primary destroyed
    tv = CodedStore(raw3, c41)
    assert tv.exists(tname)
    assert tname in tv.list("gns.P4.INBOX-*")
    assert list(tv.lines(tname)) == ['["tk",[7]]\n']
    assert repair_stripe(raw3, tname, c41) == "repaired"
    assert raw3.exists(tname)
    tv.remove(tname)                             # fans to tail replicas
    assert raw3.list(replica_pattern("gns.P4.INBOX-*")) == []
