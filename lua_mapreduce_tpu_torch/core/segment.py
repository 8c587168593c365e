"""Framed binary spill segments (``JSEG0001``) — the v2 shuffle data plane.

Copy of the JAX package's ``core/segment.py`` (the torch package imports
nothing of the JAX package).

The reference streams intermediate map output as text lines through every
backend (utils.lua:107-120, 133-200) and v1 here kept that faithfully: one
JSON record per line, parsed one ``json.loads`` at a time. Once the shuffle
is pipelined (DESIGN §15) and the control plane batched (DESIGN §16), that
per-record encoding IS the dominant data-plane cost. Exoshuffle-CloudSort
(arXiv:2301.03734) and FaaSTube (arXiv:2411.01830) both locate shuffle
throughput in the record format + IO-granularity layer: pack records into
block-sized frames, address them with an index, and move them with few
large ranged reads instead of thousands of line reads. This module is that
layer for the intermediate store.

File layout (all integers little-endian)::

    "JSEG0001"                                    8-byte magic
    frame*                                        data region
    footer                                        JSON, utf-8
    footer_off:u64 footer_len:u32 footer_crc:u32  24-byte trailer
    "JSEG0001"

    frame := enc_len:u32 dec_len:u32 codec:u8 crc:u32  payload[enc_len]

The *decoded* frame payload is exactly v1 text — concatenated
``dump_record`` lines — so v1 ↔ v2 conversion is pure re-framing and the
frame decoder can batch-parse a whole frame with ONE ``json.loads`` (JSON
strings never contain a raw newline, so joining lines with ``,`` inside
``[...]`` is loss-free). ``crc`` guards the decoded payload (CRC-32/zlib),
``codec`` is per-frame: 0 raw, 1 zlib, 2 lz4 (gated on the ``lz4`` package
being importable; never the default). The footer carries the frame index —
``[offset, enc_len, dec_len, first_key]`` per frame, ``first_key`` being
the serialized JSON of the frame's first record key — so consumers seek
straight to the frames they need and batch consecutive frames into ~1MB
ranged reads.

Readers NEVER need negotiation: :func:`open_segment` sniffs the 8-byte
magic (a v1 text line always starts with ``[``) and
:func:`record_stream` serves both formats, so mixed fleets and old
on-disk runs keep working. Writers negotiate via the task document
(``Server(segment_format=...)``, CLI ``--segment-format``); final reduce
results stay v1 text always, keeping every golden byte-compare intact.
"""

from __future__ import annotations

import json
import logging
import struct
import zlib
from typing import Any, Iterator, List, Optional, Tuple

from lua_mapreduce_tpu_torch.core import tuples
from lua_mapreduce_tpu_torch.core.serialize import (dump_key, dump_record,
                                              load_record)

_log = logging.getLogger(__name__)

MAGIC = b"JSEG0001"
FRAME_BYTES = 1 << 18          # ~256KB decoded payload per frame
READAHEAD_BYTES = 1 << 20      # batch consecutive frames into ~1MB reads

CODEC_RAW = 0
CODEC_ZLIB = 1
CODEC_LZ4 = 2

_FRAME_HDR = struct.Struct("<IIBI")     # enc_len, dec_len, codec, crc
_TRAILER = struct.Struct("<QII8s")      # footer_off, footer_len, crc, magic

FORMATS = ("v1", "v2")

try:                                    # lz4 is optional, never required
    import lz4.block as _lz4            # type: ignore
except ImportError:                     # pragma: no cover - env-dependent
    _lz4 = None


def check_format(fmt: str) -> str:
    if fmt not in FORMATS:
        raise ValueError(f"unknown segment format {fmt!r}; use one of "
                         f"{FORMATS}")
    return fmt


def _encode_frame(payload: bytes, codec: str) -> Tuple[bytes, int]:
    """Compress ``payload`` per the requested codec; fall back to raw
    when compression does not shrink the frame (incompressible data must
    not grow, and the codec byte is per-frame exactly for this)."""
    if codec == "zlib":
        comp = zlib.compress(payload, 1)
        if len(comp) < len(payload):
            return comp, CODEC_ZLIB
    elif codec == "lz4":
        if _lz4 is None:
            # ValueError: a deterministic config error the fault
            # taxonomy maps as permanent — this raise crosses the retry
            # boundary through every spill build (LMR014)
            raise ValueError("segment codec 'lz4' needs the lz4 package; "
                             "use 'zlib' or 'raw'")
        comp = _lz4.compress(payload, store_size=False)
        if len(comp) < len(payload):
            return comp, CODEC_LZ4
    elif codec != "raw":
        raise ValueError(f"unknown segment codec {codec!r}")
    return payload, CODEC_RAW


def _decode_frame(data: bytes, dec_len: int, codec: int, crc: int,
                  where: str) -> bytes:
    if codec == CODEC_RAW:
        payload = data
    elif codec == CODEC_ZLIB:
        payload = zlib.decompress(data)
    elif codec == CODEC_LZ4:
        if _lz4 is None:
            raise ValueError(f"{where}: lz4-compressed frame but the lz4 "
                             "package is not importable")
        payload = _lz4.decompress(data, uncompressed_size=dec_len)
    else:
        raise ValueError(f"{where}: unknown frame codec {codec}")
    if len(payload) != dec_len:
        raise ValueError(f"{where}: frame decoded to {len(payload)} bytes, "
                         f"index says {dec_len}")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise ValueError(f"{where}: frame CRC mismatch (corrupt segment)")
    return payload


class SegmentWriter:
    """Pack records into frames over a builder's raw-bytes surface.

    Same duck-type as :class:`TextWriter` (``add`` / ``build``), so
    every spill writer switches format by construction alone. Frames
    close at ~``frame_bytes`` of decoded payload; the
    footer indexes every frame; ``build`` publishes atomically through
    the underlying builder.
    """

    def __init__(self, builder, codec: str = "zlib",
                 frame_bytes: int = FRAME_BYTES):
        self._b = builder
        self._codec = codec
        self._frame_bytes = frame_bytes
        self._lines: List[str] = []
        self._size = 0
        self._first_key: Optional[str] = None   # serialized key JSON
        self._index: List[list] = []            # [off, enc, dec, first_key]
        self._off = len(MAGIC)
        self._records = 0
        self._decoded_bytes = 0
        # producer-known key metadata: True while every record key is a
        # plain str. Carried in the footer; it licenses the C-speed
        # heapq merge in core/merge.py (native tuple comparison IS
        # key_lt's order within the str rank) — a property v1 text can
        # never promise without a full scan.
        self._str_keys = True
        self._b.write_bytes(MAGIC)

    def add(self, key: Any, values: Any) -> None:
        if type(key) is not str:
            self._str_keys = False
        if self._first_key is None:
            self._first_key = dump_key(key)
        line = dump_record(key, values)
        self._lines.append(line)
        self._size += len(line) + 1
        if self._size >= self._frame_bytes:
            self._close_frame()

    def _close_frame(self) -> None:
        if not self._lines:
            return
        payload = ("\n".join(self._lines) + "\n").encode("utf-8")
        self._records += len(self._lines)
        self._decoded_bytes += len(payload)
        data, codec = _encode_frame(payload, self._codec)
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        self._b.write_bytes(_FRAME_HDR.pack(len(data), len(payload),
                                            codec, crc))
        self._b.write_bytes(data)
        self._index.append([self._off, len(data), len(payload),
                            self._first_key])
        self._off += _FRAME_HDR.size + len(data)
        self._lines, self._size, self._first_key = [], 0, None

    def build(self, name: str) -> None:
        self._close_frame()
        footer = json.dumps({
            "v": 1,
            "frames": self._index,
            "records": self._records,
            "decoded_bytes": self._decoded_bytes,
            "str_keys": self._str_keys,
        }, separators=(",", ":")).encode("utf-8")
        self._b.write_bytes(footer)
        self._b.write_bytes(_TRAILER.pack(self._off, len(footer),
                                          zlib.crc32(footer) & 0xFFFFFFFF,
                                          MAGIC))
        self._b.build(name)

    def close(self) -> None:
        self._b.close()

    def __enter__(self) -> "SegmentWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TextWriter:
    """v1 record writer: one JSON line per record through a plain
    builder — byte-identical to the historical spill format."""

    def __init__(self, builder):
        self._b = builder

    def add(self, key: Any, values: Any) -> None:
        self._b.write(dump_record(key, values) + "\n")

    def build(self, name: str) -> None:
        self._b.build(name)

    def close(self) -> None:
        self._b.close()

    def __enter__(self) -> "TextWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def writer_for(store, segment_format: str = "v1", codec: str = "zlib"):
    """Spill writer over a fresh builder of ``store`` in the negotiated
    format. The ONE switch point every spill producer goes through."""
    check_format(segment_format)
    if segment_format == "v2":
        return SegmentWriter(store.builder(), codec=codec)
    return TextWriter(store.builder())


# parsed-footer cache: a file opened again through the same store
# object skips the trailer + footer ranged reads. The parsed footer is cached per (name, size) ON the
# innermost store object (lifetime tied to the store: no cross-store
# collisions, no stale id reuse), bounded FIFO. Safe under the engine's
# deterministic-overwrite contract (duplicate publishes write identical
# bytes — job.py's stated assumption), and the size key evicts any
# honest rewrite that changed length.
_FOOTER_CACHE_CAP = 1024


def _footer_cache(store) -> Optional[dict]:
    from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
    host = unwrap(store)
    cache = getattr(host, "_jseg_footers", None)
    if cache is None:
        try:
            cache = host._jseg_footers = {}
        except Exception:       # slotted third-party store: skip caching
            return None
    return cache


def purge_footer_cache(store) -> None:
    """Drop every cached footer of ``store`` — the iteration-rollover
    hook: loop tasks REUSE run/fragment names with different contents,
    and fixed-width records (a sort keyspace) can reproduce the exact
    byte size, so the (name, size) key alone cannot catch the rewrite.
    Both engines call this from their iteration-start cleanup
    (Server._clean_runs, LocalExecutor.run_one_iteration)."""
    from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
    cache = getattr(unwrap(store), "_jseg_footers", None)
    if cache:
        cache.clear()


class SegmentReader:
    """Lazy frame decoder over a store's ranged-read surface.

    The footer index is read once per FILE, not per reader: two small
    ranged reads (trailer, then footer) on first open, a per-store
    parsed-footer cache hit on every re-open (see ``_footer_cache``).
    ``iter_records`` walks frames in order, batching consecutive frames
    into ~``readahead`` ranged reads and batch-parsing each frame with
    one ``json.loads``. Nothing beyond one read batch is ever resident.
    """

    def __init__(self, store, name: str, head: Optional[bytes] = None):
        self._store = store
        self._name = name
        self._whole: Optional[bytes] = None   # degradation cache, see _ranged
        size = self._size = store.size(name)
        if size < len(MAGIC) + _TRAILER.size:
            raise ValueError(f"{name}: segment too short ({size} bytes)")
        if head is None:
            head = store.read_range(name, 0, len(MAGIC))
        if head[:len(MAGIC)] != MAGIC:
            raise ValueError(f"{name}: not a JSEG0001 segment")
        cache = _footer_cache(store)
        meta = cache.get((name, size)) if cache is not None else None
        if meta is None:
            trailer = self._ranged(size - _TRAILER.size, _TRAILER.size)
            foot_off, foot_len, foot_crc, magic = _TRAILER.unpack(trailer)
            if magic != MAGIC:
                raise ValueError(f"{name}: segment trailer magic mismatch "
                                 "(truncated or corrupt)")
            footer = self._ranged(foot_off, foot_len)
            if zlib.crc32(footer) & 0xFFFFFFFF != foot_crc:
                raise ValueError(f"{name}: segment footer CRC mismatch")
            meta = json.loads(footer)
            if cache is not None:
                try:
                    if len(cache) >= _FOOTER_CACHE_CAP:
                        cache.pop(next(iter(cache)))    # FIFO bound
                except (KeyError, StopIteration):
                    pass        # concurrent evictor won the race: fine
                cache[(name, size)] = meta
        self.frames: List[list] = meta["frames"]   # [off, enc, dec, key]
        self.records: int = meta.get("records", 0)
        self.decoded_bytes: int = meta.get("decoded_bytes", 0)
        # producer promise: every key is a plain str (absent/False when
        # unknown) — consumers may then merge with native comparisons
        self.str_keys: bool = bool(meta.get("str_keys", False))

    # -- frame access -------------------------------------------------------

    def _ranged(self, off: int, length: int) -> bytes:
        """A ranged read with the degradation rung of DESIGN §19: when a
        ranged read fails with a TRANSIENT store fault that outlived the
        retry layer's budget, fall back to ONE whole-file read and serve
        every remaining range from memory — the same shape as the native
        merge's Python fallback and the premerge poison-to-raw-runs
        ladder. Permanent and non-storage errors propagate untouched."""
        if self._whole is not None:
            return self._whole[off:off + length]
        try:
            return self._store.read_range(self._name, off, length)
        except Exception as exc:
            from lua_mapreduce_tpu_torch.faults.errors import classify_exception
            # the backend's own classify hook when it has one (it knows
            # its SDK's error shapes); the central table for duck-typed
            # third-party stores
            classify = getattr(self._store, "classify", classify_exception)
            if classify(exc) is not True:
                raise
            from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
            self._whole = self._store.read_range(self._name, 0, self._size)
            COUNTERS.bump("degraded_reads")
            _log.warning("%s: ranged reads failing (%s) — degraded to a "
                         "whole-file read (%d bytes)", self._name,
                         type(exc).__name__, self._size)
            return self._whole[off:off + length]

    def frame_payload(self, idx: int, blob: Optional[bytes] = None,
                      blob_off: int = 0) -> bytes:
        """Decoded text payload of frame ``idx`` (from ``blob`` when the
        caller already holds a read batch covering it)."""
        off, enc, dec, _ = self.frames[idx]
        if blob is None:
            blob = self._ranged(off, _FRAME_HDR.size + enc)
            blob_off = off
        base = off - blob_off
        enc_len, dec_len, codec, crc = _FRAME_HDR.unpack_from(blob, base)
        if enc_len != enc or dec_len != dec:
            raise ValueError(f"{self._name}: frame {idx} header disagrees "
                             "with footer index (corrupt segment)")
        data = blob[base + _FRAME_HDR.size:base + _FRAME_HDR.size + enc_len]
        return _decode_frame(data, dec_len, codec, crc,
                             f"{self._name} frame {idx}")

    def _read_batches(self, readahead: int) -> Iterator[Tuple[int, int,
                                                              bytes]]:
        """(first_frame_idx, n_frames, blob) over ~readahead-sized ranged
        reads of consecutive frames."""
        i, n = 0, len(self.frames)
        while i < n:
            j, total = i, 0
            while j < n and (j == i or total +
                             _FRAME_HDR.size + self.frames[j][1] <= readahead):
                total += _FRAME_HDR.size + self.frames[j][1]
                j += 1
            off = self.frames[i][0]
            yield i, j - i, self._ranged(off, total)
            i = j

    # -- record access ------------------------------------------------------

    def iter_records(self, readahead: int = READAHEAD_BYTES
                     ) -> Iterator[Tuple[Any, List[Any]]]:
        intern = tuples.intern
        for first, count, blob in self._read_batches(readahead):
            blob_off = self.frames[first][0]
            for idx in range(first, first + count):
                payload = self.frame_payload(idx, blob, blob_off)
                # frame-level batch decode: ONE json.loads per frame.
                # JSON strings carry newlines only as the two-character
                # escape \n, so splicing lines with "," is loss-free.
                recs = json.loads(b"[" + payload[:-1].replace(b"\n", b",")
                                  + b"]")
                for rec in recs:
                    key = rec[0]
                    if type(key) is list:
                        key = intern(key)
                    yield key, rec[1]


def open_segment(store, name: str) -> Optional[SegmentReader]:
    """SegmentReader for ``name``, or None when it is not a v2 segment —
    v1 text (first byte is ``[``), or a store without the raw-bytes
    surface (duck-typed fakes). Detection is per FILE, so mixed-format
    namespaces (old runs, v1-only workers in the fleet) always read."""
    read_range = getattr(store, "read_range", None)
    if read_range is None or getattr(store, "size", None) is None:
        return None
    try:
        head = read_range(name, 0, len(MAGIC))
    except (OSError, KeyError):
        # missing-file shapes of the bundled backends (sharedfs/objectfs
        # FileNotFoundError, memfs KeyError): let the caller's text path
        # surface its own not-found error. Anything else (a transient
        # store failure on a real segment) must PROPAGATE — degrading to
        # the text reader would mask it behind a decode error
        return None
    if head[:len(MAGIC)] != MAGIC:
        return None
    return SegmentReader(store, name, head=head)


def record_stream(store, name: str) -> Iterator[Tuple[Any, List[Any]]]:
    """(key, values) stream over ``name`` in WHICHEVER format it carries
    — the one reader every merge/premerge consumer uses."""
    reader = open_segment(store, name)
    if reader is not None:
        return reader.iter_records()
    return _text_records(store, name)


def _text_records(store, name: str) -> Iterator[Tuple[Any, List[Any]]]:
    for line in store.lines(name):
        line = line.strip()
        if line:
            yield load_record(line)
