"""Push-based streaming shuffle: memory-budgeted reducer inboxes.

Copy of the JAX package's ``engine/push.py``
(the torch package imports nothing of the JAX package).

The staged shuffle (the reference's shape, DESIGN §15) is stage-and-pull:
a map job accumulates each partition's whole run in one builder and
publishes it as a single file at job end; reducers only see committed
run files. Exoshuffle-CloudSort (PAPERS.md) locates GB-scale shuffle
throughput in *pushing* map output toward reducers as it is produced:
block-sized units land in per-partition reducer **inboxes** the moment
they fill, so the reduce-side merge streams behind the map phase instead
of staging behind a barrier. This module is that layer:

- a map job writes each partition's sorted records through a
  :class:`PushWriter`: records buffer per partition and publish as
  JSEG0001 frame files (core/segment.py) the moment a buffer reaches
  ~frame size — ``<ns>.P<p>.INBOX-<map>-<seq>`` — through
  ``faults.replicate.spill_writer`` (lint LMR009/LMR012), so r-way
  replication and placement tags apply to pushed frames unchanged —
  and under an erasure-coding spec (``--coding k+m``, DESIGN §27) each
  full frame stripes individually while the map's final partial frames
  across partitions publish as ONE shared group stripe
  (:func:`group_base`), amortizing parity overhead below what staged
  per-file striping pays; eviction tails stay streaming-replicated;
- a per-worker :class:`BufferPool` bounds the memory the push layer may
  hold (``--push-budget-mb``): going over budget **evicts** the oldest
  partition buffer to the classic staged path — its records (and the
  rest of that partition's output) stream through a spill builder into
  one ``INBOX-<map>-<seq>T`` tail file, disk-spooled, so pressure
  degrades gracefully to today's staged shuffle instead of OOMing
  (counted ``push_evictions``);
- visibility is **manifest-gated**: the last thing a push execution
  publishes is a tiny per-map manifest (``<ns>.PUSH.M<map>``) naming
  exactly the fragment/tail files its lineage produced. Readers —
  the pre-merge tracker, reduce discovery, the scavenger — consult
  manifests only, so a crashed or duplicate execution's orphan frames
  are *invisible* (and swept at discovery) rather than double-counted.

Byte-identity (the golden-matrix contract) holds because a map's
partition output has strictly increasing, unique keys (run_map_job emits
one record per key), so splitting the run at record boundaries into
seq-ordered fragments and merging them as separate inputs — fragments
of map *m* ordered before the next map's files, exactly the canonical
run order — concatenates equal-key value lists in precisely the order
the staged merge would.

Speculation composes by **quarantine** (DESIGN §21 + §24): a clone
pushes under its spec identity — fragment names carry an ``-s<lineage>``
tag and its manifest lands at ``<ns>.PUSH.M<map>.s<lineage>`` — so
nothing a clone pushed is visible while the race is open. The canonical
manifest is published **if-absent only**: the original publishes it at
body end; a winning clone *promotes* its quarantined manifest right
after its first-commit-wins CAS lands (Worker.run_one), and the server
backstop-promotes any complete spec lineage it finds behind a WRITTEN
job whose promoter died (``ensure_canonical``). Whichever complete
lineage becomes canonical, the records are identical — the job inputs
and user functions are deterministic, the assumption the whole
golden-diff matrix already leans on; quarantine exists because two
lineages may *fragment* differently under different memory pressure.
"""

from __future__ import annotations

import hashlib
import os
import re
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from lua_mapreduce_tpu_torch.core.serialize import dump_record, load_record
from lua_mapreduce_tpu_torch.faults.coded import (CaptureStore, Coding,
                                                  check_redundancy, publish_stripe,
                                                  stripe_patterns, tail_redundancy)
from lua_mapreduce_tpu_torch.faults.replicate import reading_view, spill_writer
from lua_mapreduce_tpu_torch.faults.retry import COUNTERS

INBOX_TAG = "INBOX"
PUSH_NS = "PUSH"               # manifests: <ns>.PUSH.M<mapkey>[.s<lin>]
CODE_TAG = "CODE"              # group stripes: <ns>.CODE.<mapkey>[-s<lin>]

# decoded bytes a partition buffers before its frame publishes — aligned
# with core/segment.FRAME_BYTES so one inbox file is ~one JSEG frame.
# LMR_PUSH_FRAME_KB overrides fleet-wide (the sort bench trades publish
# count against buffer memory with it): bigger frames = fewer store
# publishes and footer reads per byte, smaller = finer streaming.
PUSH_FRAME_BYTES = 1 << 18

DEFAULT_BUDGET_MB = 64.0


def resolve_frame_bytes(arg=None) -> int:
    if arg is not None:
        return int(arg)
    env = os.environ.get("LMR_PUSH_FRAME_KB")
    return int(float(env) * 1024) if env else PUSH_FRAME_BYTES

_INBOX_RE_TMPL = (r"^{ns}\.P(\d+)\.INBOX-(.+?)"
                  r"(?:-s([0-9a-f]{{8}}))?-(\d{{5}})(T?)$")
_MANIFEST_RE_TMPL = r"^{ns}\.PUSH\.M(.+?)(?:\.s([0-9a-f]{{8}}))?$"


def resolve_push(arg) -> bool:
    """The push knob's shared resolution order (Server and LocalExecutor
    must agree on what one environment means): explicit argument, else
    ``LMR_PUSH`` env (the subprocess-fleet round-trip), else off."""
    if arg is None:
        val = os.environ.get("LMR_PUSH")
        if val is None:
            return False
        return val.strip().lower() not in ("", "0", "off", "false", "no")
    return bool(arg)


def resolve_push_budget(arg) -> int:
    """Budget in BYTES: explicit MB argument, else ``LMR_PUSH_BUDGET_MB``,
    else :data:`DEFAULT_BUDGET_MB`. Zero/negative is legal and means
    "buffer nothing": every partition evicts to the staged path on its
    first record — the documented degrade-to-staged floor."""
    if arg is None:
        env = os.environ.get("LMR_PUSH_BUDGET_MB")
        arg = float(env) if env else DEFAULT_BUDGET_MB
    return int(float(arg) * 1024 * 1024)


def lineage_token(worker_name: str) -> str:
    """8-hex quarantine tag of a speculative execution — stable per
    worker (blake2b, never Python's salted hash: promote and the
    server backstop recompute it in other processes)."""
    h = hashlib.blake2b(str(worker_name).encode("utf-8"), digest_size=4)
    return h.hexdigest()


def frag_name(ns: str, part: int, map_key: str, lineage: Optional[str],
              seq: int, tail: bool = False) -> str:
    lin = f"-s{lineage}" if lineage else ""
    return (f"{ns}.P{part}.{INBOX_TAG}-{map_key}{lin}-{seq:05d}"
            + ("T" if tail else ""))


def group_base(ns: str, map_key: str, lineage: Optional[str]) -> str:
    """The LOGICAL base name of one map execution's coded group stripe
    (DESIGN §27): the stripe layer derives the ``^``-sigil block names
    from it (faults/coded.py — never constructed here, LMR012). Clones
    quarantine under their lineage tag exactly like fragments, so a
    clone's group blocks never collide with the original's."""
    lin = f"-s{lineage}" if lineage else ""
    return f"{ns}.{CODE_TAG}.{map_key}{lin}"


def inbox_re(ns: str) -> "re.Pattern":
    return re.compile(_INBOX_RE_TMPL.format(ns=re.escape(ns)))


def parse_inbox_name(ns: str, name: str
                     ) -> Optional[Tuple[int, str, Optional[str], int, bool]]:
    """``(part, map_key, lineage|None, seq, is_tail)`` of an inbox file
    name, or None for any other name."""
    m = inbox_re(ns).match(name)
    if not m:
        return None
    return (int(m.group(1)), m.group(2), m.group(3), int(m.group(4)),
            bool(m.group(5)))


def manifest_name(ns: str, map_key: str,
                  lineage: Optional[str] = None) -> str:
    base = f"{ns}.{PUSH_NS}.M{map_key}"
    return f"{base}.s{lineage}" if lineage else base


def parse_manifest_name(ns: str, name: str
                        ) -> Optional[Tuple[str, Optional[str]]]:
    """``(map_key, lineage|None)`` of a manifest name, or None."""
    m = re.match(_MANIFEST_RE_TMPL.format(ns=re.escape(ns)), name)
    if not m:
        return None
    return m.group(1), m.group(2)


# --------------------------------------------------------------------------
# write side: memory-budgeted push
# --------------------------------------------------------------------------


class BufferPool:
    """One worker's push-memory ledger. Thread-safe (an in-process
    LocalExecutor pool shares one across its map threads); purely
    advisory — writers consult :meth:`over` after each charge and evict
    their own oldest partition, so the fleet-wide bound is
    ``budget + n_threads × frame_bytes`` without any cross-writer
    coordination."""

    def __init__(self, budget_bytes: int):
        self._lock = threading.Lock()
        self._budget = int(budget_bytes)
        self._held = 0

    @property
    def budget(self) -> int:
        with self._lock:
            return self._budget

    @budget.setter
    def budget(self, budget_bytes: int) -> None:
        # the autotune plane retargets a live pool from the worker /
        # executor thread while map threads consult over(): the ledger
        # lock serializes the handoff
        with self._lock:
            self._budget = int(budget_bytes)

    def charge(self, n: int) -> None:
        with self._lock:
            self._held += n

    def uncharge(self, n: int) -> None:
        with self._lock:
            self._held = max(0, self._held - n)

    @property
    def held(self) -> int:
        with self._lock:
            return self._held

    def over(self) -> bool:
        with self._lock:
            return self._held > self._budget


class _PartState:
    __slots__ = ("lines", "bytes", "seq", "frags", "tail_writer",
                 "tail", "born")

    def __init__(self, born: int):
        self.lines: List[Tuple[Any, str]] = []   # (key, serialized line)
        self.bytes = 0
        self.seq = 0
        self.frags: List[str] = []
        self.tail_writer = None         # set once evicted: staged mode
        self.tail: Optional[str] = None
        self.born = born                # eviction order: oldest first


class PushWriter:
    """One map execution's push surface: ``add(part, key, values)``
    records in partition-key order (the caller — run_map_job — already
    iterates sorted keys), ``finish()`` publishes the final partial
    frames, any eviction tails, and the manifest (ALWAYS last: the
    manifest is the visibility gate). ``close()`` releases builders and
    pool charges on every path, published or not."""

    def __init__(self, store, ns: str, map_key: str, replication: int = 1,
                 pool: Optional[BufferPool] = None,
                 lineage: Optional[str] = None,
                 frame_bytes: Optional[int] = None):
        frame_bytes = resolve_frame_bytes(frame_bytes)
        self._store = store
        self._ns = ns
        self._map_key = str(map_key)
        # unified redundancy value: int replication or a Coding spec —
        # spill_writer dispatches per frame, finish() groups under coding
        self._r = check_redundancy(replication)
        self._pool = pool or BufferPool(resolve_push_budget(None))
        self._lineage = lineage
        self._frame_bytes = int(frame_bytes)
        self._parts: Dict[int, _PartState] = {}
        self._births = 0
        self._finished = False
        # adaptive frame codec: start compressing (zlib, the segment
        # default — wordcount-shaped data shrinks ~4x), but once two
        # consecutive fragments fall back to raw the payload is
        # evidently incompressible (a CloudSort keyspace) and further
        # compression attempts are pure wasted CPU on the map's
        # critical path — go sticky-raw for the rest of this map
        self._codec = "zlib"
        self._raw_streak = 0

    # -- record intake ------------------------------------------------------

    def add(self, part: int, key: Any, values: Any) -> None:
        st = self._parts.get(part)
        if st is None:
            st = self._parts[part] = _PartState(self._births)
            self._births += 1
        if st.tail_writer is not None:
            # evicted partition: staged mode — stream straight through
            # the spill builder (disk-spooled), zero buffer growth
            st.tail_writer.add(key, values)
            return
        line = dump_record(key, values)
        st.lines.append((key, line))
        cost = len(line) + 1
        st.bytes += cost
        self._pool.charge(cost)
        if st.bytes >= self._frame_bytes:
            self._flush_frag(part, st)
        elif self._pool.over():
            self._evict_oldest()

    # -- frame publish / eviction -------------------------------------------

    def _flush_frag(self, part: int, st: _PartState) -> None:
        if not st.lines:
            return
        name = frag_name(self._ns, part, self._map_key, self._lineage,
                         st.seq)
        w = spill_writer(self._store, "v2", self._r, codec=self._codec)
        try:
            for key, line in st.lines:
                w.add_line(key, line)
            w.build(name)
            if self._codec != "raw":
                if w.compressed_frames == 0:
                    self._raw_streak += 1
                    if self._raw_streak >= 2:
                        self._codec = "raw"     # sticky: stop paying
                else:
                    self._raw_streak = 0
        finally:
            w.close()
        st.frags.append(name)
        st.seq += 1
        self._pool.uncharge(st.bytes)
        st.lines, st.bytes = [], 0
        COUNTERS.bump("push_frames")

    def _evict_oldest(self) -> None:
        """Over budget: the OLDEST still-buffering partition degrades to
        the classic staged path — its buffered records open the tail
        spill writer (records stream to disk from here on) and the
        buffer's charge is released. Evicting oldest-first matches the
        frame-age intuition: the longest-parked bytes are the least
        likely to fill a frame soon."""
        victims = [(st.born, part, st) for part, st in self._parts.items()
                   if st.tail_writer is None and st.bytes > 0]
        if not victims:
            return
        _, part, st = min(victims)
        st.tail = frag_name(self._ns, part, self._map_key, self._lineage,
                            st.seq, tail=True)
        # the tail exists to BOUND memory, so it never stripes (a stripe
        # buffers its whole payload): under coding it degrades to
        # (m+1)-way streaming replication — same loss tolerance, zero
        # buffering (tail_redundancy; identity for plain replication)
        st.tail_writer = spill_writer(self._store, "v2",
                                      tail_redundancy(self._r),
                                      codec=self._codec)
        for key, line in st.lines:
            st.tail_writer.add_line(key, line)
        self._pool.uncharge(st.bytes)
        st.lines, st.bytes = [], 0
        COUNTERS.bump("push_evictions")

    # -- publish ------------------------------------------------------------

    def manifest(self) -> dict:
        return {
            "lineage": self._lineage or "",
            "parts": {str(part): {"frags": list(st.frags), "tail": st.tail}
                      for part, st in sorted(self._parts.items())
                      if st.frags or st.tail is not None},
        }

    def _finish_group(self, leftovers) -> None:
        """The coded bandwidth half (DESIGN §27): at map end, every
        partition's final partial frame is serialized through the
        NORMAL spill encoding into a capture and the concatenated
        members stripe ONCE — one coded combination serving several
        reducer inboxes, so the parity + manifest overhead (and the
        per-stripe padding a sub-frame fragment would otherwise pay) is
        amortized across partitions instead of charged per fragment.
        A duplicate execution re-publishes the same group base whole —
        blocks first, member manifests last — so the set is consistent
        again before discovery runs (the phase barrier orders
        consumption, exactly the publish-if-absent reasoning above)."""
        cap = CaptureStore()
        for part, st in leftovers:
            name = frag_name(self._ns, part, self._map_key, self._lineage,
                             st.seq)
            w = spill_writer(cap, "v2", 1, codec=self._codec)
            try:
                for key, line in st.lines:
                    w.add_line(key, line)
                w.build(name)
            finally:
                w.close()
            st.frags.append(name)
            st.seq += 1
            self._pool.uncharge(st.bytes)
            st.lines, st.bytes = [], 0
            COUNTERS.bump("push_frames")
        publish_stripe(self._store, cap.files, self._r,
                       group_base=group_base(self._ns, self._map_key,
                                             self._lineage))
        COUNTERS.bump("push_group_stripes")

    def finish(self, publish_over: bool = False) -> dict:
        """Publish final partial frames, build eviction tails, then the
        manifest — the lineage becomes *complete* (every named file
        exists) strictly before it can become *visible*. Returns the
        manifest dict (promote and tests consume it). ``publish_over``:
        the canonical manifest under this map's name is an earlier
        iteration's that the iteration-start sweep could not remove, so
        this one is published over it, not beside it."""
        leftovers = [(part, st) for part, st in sorted(self._parts.items())
                     if st.tail_writer is None and st.lines]
        for part, st in sorted(self._parts.items()):
            if st.tail_writer is not None:
                st.tail_writer.build(st.tail)
        if isinstance(self._r, Coding) and len(leftovers) > 1:
            self._finish_group(leftovers)
        else:
            for part, st in leftovers:
                self._flush_frag(part, st)
        man = self.manifest()
        if self._lineage:
            # speculative clone: quarantined under its spec identity —
            # only a winning commit (promote) or the server backstop
            # can make this lineage canonical
            write_manifest(self._store, manifest_name(
                self._ns, self._map_key, self._lineage), man, self._r)
        else:
            # publish-if-absent: the FIRST complete lineage is the
            # visible one; a duplicate execution (stale requeue, late
            # original) never flips an already-consumable manifest.
            # The exists→build pair is NOT atomic (the Store surface
            # has no conditional put), so two simultaneous duplicates
            # can both publish — tolerated by construction: (a) every
            # lineage that reaches this line is COMPLETE (all named
            # files published first) and carries identical records, so
            # whichever build lands last is valid; (b) consumption
            # ordering is protected by the phase barrier — the
            # pipelined map phase settles every pre-merge before
            # discovery runs, and sweeps of non-canonical files happen
            # ONLY at discovery, so a flip can never dangle a file
            # list a live consumer already resolved (per-partition
            # spill coverage makes mixed-lineage reads consistent).
            canonical = manifest_name(self._ns, self._map_key)
            if publish_over or not reading_view(self._store,
                                                self._r).exists(canonical):
                write_manifest(self._store, canonical, man, self._r)
        self._finished = True
        return man

    def close(self) -> None:
        """Release builders + pool charges on every path (the engine
        builder-lifecycle rule, LMR001): a failed map body must not
        leak its tail writers' fds or its buffered bytes' charges."""
        first = None
        for st in self._parts.values():
            if st.bytes:
                self._pool.uncharge(st.bytes)
                st.lines, st.bytes = [], 0
            if st.tail_writer is not None:
                try:
                    st.tail_writer.close()
                except Exception as exc:
                    if first is None:
                        first = exc
        if first is not None and not self._finished:
            raise first


# --------------------------------------------------------------------------
# manifests: the visibility gate
# --------------------------------------------------------------------------


def write_manifest(store, name: str, man: dict, replication: int) -> None:
    """Manifests ride the replicated spill plane like any shuffle file
    (LMR012): v1 text, one record, failover-readable."""
    w = spill_writer(store, "v1", replication)
    try:
        w.add("push", [man])
        w.build(name)
    finally:
        w.close()


def read_manifest(view, name: str) -> Optional[dict]:
    """Parse a manifest through a (possibly failover) view; None when
    absent. Storage faults propagate — the callers' retry/release
    ladders own them."""
    if not view.exists(name):
        return None
    for line in view.lines(name):
        line = line.strip()
        if line:
            _, values = load_record(line)
            return values[0]
    return None


def manifest_files_by_part(man: dict) -> Dict[int, List[str]]:
    """The per-partition ordered file list of one lineage: fragments in
    seq order, then the eviction tail — exactly the canonical record
    order of that map's partition output."""
    out: Dict[int, List[str]] = {}
    for part, entry in man.get("parts", {}).items():
        files = list(entry.get("frags") or ())
        if entry.get("tail"):
            files.append(entry["tail"])
        if files:
            out[int(part)] = files
    return out


def promote(store, ns: str, map_key: str, lineage: str,
            replication: int, publish_over: bool = False) -> bool:
    """Make a quarantined spec lineage canonical — the winning clone's
    post-commit step (Worker.run_one). Publish-if-absent: if ANY
    complete lineage already became canonical (the original finished
    its body before losing the race), keep it — flipping a manifest a
    consumer may already have read trades one valid lineage for
    another at best and dangles deleted fragments at worst.
    ``publish_over``: the canonical manifest under this map's name may
    be an earlier iteration's that the iteration-start sweep could not
    remove (the job doc's ``leftovers``), so the winner's is published
    over it, as the original's own publish would (``PushWriter.finish``);
    an original that published first named the same records."""
    view = reading_view(store, replication)
    canonical = manifest_name(ns, map_key)
    if not publish_over and view.exists(canonical):
        return False
    man = read_manifest(view, manifest_name(ns, map_key, lineage))
    if man is None:
        return False
    write_manifest(store, canonical, man, replication)
    return True


def ensure_canonical(store, ns: str, map_key: str,
                     replication: int) -> Optional[dict]:
    """The reader-side resolution of a committed map's push lineage:
    the canonical manifest when published; else — the promote gap: a
    winning clone died between its commit CAS and its promote — any
    complete quarantined lineage is backstop-promoted (first in sorted
    order, deterministic across callers). A spec lineage is promoted
    only when every file it names is still VISIBLE: a losing clone's
    stale ``.s`` manifest can outlive its swept fragments (and the
    scavenger's canonical-manifest invalidation re-opens the promote
    path), and promoting a dangling lineage would wedge the recovery
    ladder on files nobody can regenerate under those names. None when
    the map pushed nothing (classic run files, or no output at all)."""
    view = reading_view(store, replication)
    man = read_manifest(view, manifest_name(ns, map_key))
    if man is not None:
        return man
    for name in sorted(view.list(manifest_name(ns, map_key) + ".s*")):
        parsed = parse_manifest_name(ns, name)
        if parsed is None or parsed[0] != map_key:
            continue
        man = read_manifest(view, name)
        if man is None:
            continue
        files = [f for fs in manifest_files_by_part(man).values()
                 for f in fs]
        if not all(view.exists(f) for f in files):
            continue        # dangling lineage (fragments swept): skip
        if not view.exists(manifest_name(ns, map_key)):
            write_manifest(store, manifest_name(ns, map_key), man,
                           replication)
        return man
    return None


# --------------------------------------------------------------------------
# read side: canonical-order discovery (barrier mode) + sweep
# --------------------------------------------------------------------------


def push_file_lists(store, ns: str, map_keys: Iterable[str],
                    replication: int = 1
                    ) -> Tuple[Dict[str, Dict[int, List[str]]], set]:
    """Per-map, per-partition ordered file lists in push mode, manifest
    first, classic runs (a push-off fleet member, the native map fast
    path) as the fallback — plus the set of every referenced name.
    Shared by barrier discovery, pipelined discovery, and the spill
    scavenger so the visibility rule cannot drift between them."""
    from lua_mapreduce_tpu_torch.engine.premerge import run_name_re
    view = reading_view(store, replication)
    run_re = run_name_re(ns)
    runs_by_key: Dict[str, Dict[int, str]] = {}
    for name in view.list(f"{ns}.P*.M*"):
        m = run_re.match(name)
        if m:
            runs_by_key.setdefault(m.group(2), {})[int(m.group(1))] = name
    lists: Dict[str, Dict[int, List[str]]] = {}
    referenced: set = set()
    for key in map_keys:
        key = str(key)
        man = ensure_canonical(store, ns, key, replication)
        if man is not None:
            by_part = manifest_files_by_part(man)
        else:
            by_part = {p: [n] for p, n in runs_by_key.get(key, {}).items()}
        if by_part:
            lists[key] = by_part
            for files in by_part.values():
                referenced.update(files)
    return lists, referenced


def sweep_unreferenced(view, ns: str, referenced: set,
                       keys_done: Iterable[str]) -> int:
    """Drop inbox files no canonical lineage names — crashed attempts'
    orphans, losing clones' quarantined frames, classic runs shadowed
    by a manifest. Best-effort (remove faults are swallowed like every
    consumed-leftover sweep); returns how many were dropped. Only
    files of maps in ``keys_done`` are touched: discovery runs after
    the map barrier, so every listed key is terminal."""
    from lua_mapreduce_tpu_torch.engine.premerge import run_name_re
    done = {str(k) for k in keys_done}
    run_re = run_name_re(ns)
    swept = 0
    for name in view.list(f"{ns}.P*.{INBOX_TAG}-*"):
        parsed = parse_inbox_name(ns, name)
        if parsed is None or name in referenced:
            continue
        if parsed[1] not in done:
            continue
        try:
            view.remove(name)
            swept += 1
        except Exception:
            pass
    # classic runs shadowed by a manifest (a crashed classic attempt
    # behind a pushed re-run, or vice versa): same rule, same sweep
    for name in view.list(f"{ns}.P*.M*"):
        m = run_re.match(name)
        if not m or name in referenced or m.group(2) not in done:
            continue
        key_has_manifest = view.exists(manifest_name(ns, m.group(2)))
        if key_has_manifest:
            try:
                view.remove(name)
                swept += 1
            except Exception:
                pass
    # losing clones' quarantined manifests: once a DIFFERENT lineage is
    # canonical, a surviving .s manifest is pure garbage whose swept
    # fragments could still tempt a later backstop promote (after the
    # scavenger invalidates the canonical) — drop it with the race open
    # only for the promote-gap case (no canonical yet), which the
    # backstop must keep covering
    for name in view.list(f"{ns}.{PUSH_NS}.M*"):
        parsed = parse_manifest_name(ns, name)
        if parsed is None or parsed[1] is None or parsed[0] not in done:
            continue
        key, lineage = parsed
        canon = read_manifest(view, manifest_name(ns, key))
        if canon is not None and canon.get("lineage") != lineage:
            try:
                view.remove(name)
                swept += 1
            except Exception:
                pass
    return swept


def discover_push(store, ns: str, map_keys: Iterable[str],
                  replication: int = 1) -> Dict[int, List[str]]:
    """Barrier-mode reduce discovery with push on: partition → ordered
    file list, interleaved by canonical map-key order with each map's
    fragments in seq order and its eviction tail last — the exact
    merge order the staged path's lexicographic run listing produces,
    so reduce output is byte-identical. Sweeps orphans."""
    order = sorted(str(k) for k in map_keys)
    lists, referenced = push_file_lists(store, ns, order, replication)
    sweep_unreferenced(reading_view(store, replication), ns, referenced,
                       order)
    parts: Dict[int, List[str]] = {}
    for key in order:
        for part, files in sorted(lists.get(key, {}).items()):
            parts.setdefault(part, []).extend(files)
    return parts


def sweep_push_files(view, ns: str) -> frozenset:
    """Iteration-start hygiene (the LocalExecutor analog of the
    server's ``_clean_runs``): stale inbox fragments AND manifests from
    a previous iteration must never leak into this one's discovery —
    a stale canonical manifest would win the publish-if-absent race
    against the fresh lineage and name already-consumed files. Returns
    the names still listed after it (a copy on a dark placement tag
    outlives its remove): a map whose canonical manifest is among them
    publishes over it (``leftovers``), and discovery reads only what a
    canonical manifest names.

    Coded group-stripe BLOCKS (shared by several members, so no single
    member's remove may drop them — DESIGN §27) are swept here by their
    physical stripe patterns: once the member manifests above are gone
    the blocks are unreachable garbage, and this is also where a losing
    clone's orphaned group blocks (invisible since its members were
    swept at discovery) finally go."""
    from lua_mapreduce_tpu_torch.engine.premerge import sweep_leftovers
    patterns = [f"{ns}.P*.{INBOX_TAG}-*", f"{ns}.{PUSH_NS}.M*"]
    patterns += stripe_patterns(f"{ns}.{CODE_TAG}.*")
    return sweep_leftovers(view, patterns)


def utest() -> None:
    """Self-test: naming round-trips + glob transparency, budgeted
    buffering with eviction-to-staged, manifest gating (publish-if-
    absent, quarantine + promote, backstop), and canonical-order
    discovery equal to the staged path's."""
    import fnmatch

    from lua_mapreduce_tpu_torch.core.segment import record_stream
    from lua_mapreduce_tpu_torch.engine.premerge import run_name_re
    from lua_mapreduce_tpu_torch.store.memfs import MemStore

    ns = "r"
    # naming: round-trip, tails, lineages; invisible to classic globs
    f = frag_name(ns, 3, "00000007", None, 2)
    assert parse_inbox_name(ns, f) == (3, "00000007", None, 2, False)
    t = frag_name(ns, 3, "00000007", "ab12cd34", 5, tail=True)
    assert parse_inbox_name(ns, t) == (3, "00000007", "ab12cd34", 5, True)
    assert run_name_re(ns).match(f) is None
    assert not fnmatch.fnmatchcase(f, f"{ns}.P*.M*")
    assert not fnmatch.fnmatchcase(f, f"{ns}.P*.SPILL-*")
    m = manifest_name(ns, "00000007")
    assert parse_manifest_name(ns, m) == ("00000007", None)
    assert parse_manifest_name(ns, m + ".sab12cd34") == ("00000007",
                                                         "ab12cd34")
    assert fnmatch.fnmatchcase(m, f"{ns}.P*.M*")    # _clean_runs sweeps it
    assert run_name_re(ns).match(m) is None          # ...but no run parse

    # budgeted push: 2 partitions, budget below the working set — the
    # oldest partition evicts to a staged tail, the other keeps framing
    store = MemStore()
    pool = BufferPool(budget_bytes=100)
    pw = PushWriter(store, ns, "00000001", pool=pool, frame_bytes=64)
    for i in range(40):
        pw.add(i % 2, f"k{i:04d}", [i])
    man = pw.finish()
    pw.close()
    assert pool.held == 0, "finish/close must release every charge"
    by_part = manifest_files_by_part(man)
    assert set(by_part) == {0, 1}
    names = [n for files in by_part.values() for n in files]
    assert all(store.exists(n) for n in names)
    assert any(n.endswith("T") for n in names), "eviction never fired"
    assert any(not n.endswith("T") for n in names), "no frame published"
    # fragment + tail record streams re-assemble the partition in order
    for part, files in by_part.items():
        recs = [k for nm in files for k, _ in record_stream(store, nm)]
        assert recs == sorted(recs) and len(recs) == 20

    # manifest gate: publish-if-absent + quarantine + promote + backstop
    store2 = MemStore()
    pw = PushWriter(store2, ns, "00000002", pool=BufferPool(1 << 20))
    pw.add(0, "a", [1])
    first = pw.finish()
    pw.close()
    # a duplicate execution (different fragmentation) must NOT flip it
    dup = PushWriter(store2, ns, "00000002", pool=BufferPool(0),
                     frame_bytes=8)
    dup.add(0, "a", [1])
    dup.finish()
    dup.close()
    assert read_manifest(store2, manifest_name(ns, "00000002")) == first
    # a clone quarantines; promote only fills an absent canonical
    lin = lineage_token("clone-w")
    cl = PushWriter(store2, ns, "00000002", pool=BufferPool(1 << 20),
                    lineage=lin)
    cl.add(0, "a", [1])
    cl.finish()
    cl.close()
    assert not promote(store2, ns, "00000002", lin, 1)   # canonical kept
    store2.remove(manifest_name(ns, "00000002"))
    assert promote(store2, ns, "00000002", lin, 1)       # gap: fills it
    assert read_manifest(store2,
                         manifest_name(ns, "00000002"))["lineage"] == lin
    # backstop: canonical gone again -> ensure_canonical re-promotes
    store2.remove(manifest_name(ns, "00000002"))
    man2 = ensure_canonical(store2, ns, "00000002", 1)
    assert man2 is not None and man2["lineage"] == lin
    assert store2.exists(manifest_name(ns, "00000002"))

    # discovery: canonical interleave by map key; orphans swept
    store3 = MemStore()
    for key in ("00000001", "00000003"):
        w = PushWriter(store3, ns, key, pool=BufferPool(1 << 20))
        w.add(0, f"k{key}", [1])
        w.finish()
        w.close()
    # a classic (push-off / native-path) fleet member in the middle
    sw = spill_writer(store3, "v1", 1)
    sw.add("k00000002", [1])
    sw.build(f"{ns}.P0.M00000002")
    sw.close()
    # an orphan fragment from a crashed attempt: no manifest names it
    orphan = spill_writer(store3, "v2", 1)
    orphan.add_line("x", dump_record("x", [0]))
    orphan.build(frag_name(ns, 0, "00000003", "deadbeef", 0))
    orphan.close()
    got = discover_push(store3, ns, ["00000001", "00000002", "00000003"])
    keys_in_order = [parse_inbox_name(ns, n)[1] if "INBOX" in n
                     else n.rsplit(".M", 1)[-1] for n in got[0]]
    assert keys_in_order == ["00000001", "00000002", "00000003"], got
    assert not store3.exists(frag_name(ns, 0, "00000003", "deadbeef", 0))

    # sweep_push_files: iteration hygiene drops fragments AND manifests
    sweep_push_files(store3, ns)
    assert store3.list(f"{ns}.P*.{INBOX_TAG}-*") == []
    assert store3.list(f"{ns}.{PUSH_NS}.M*") == []

    # coded push (DESIGN §27): full frames stripe individually, the
    # final partial frames of SEVERAL partitions publish as one group
    # stripe, the eviction tail stays streaming-replicated — and the
    # whole lineage reads back byte-identical through the coded view
    store4 = MemStore()
    cw = PushWriter(store4, ns, "00000004", replication="4+1",
                    pool=BufferPool(budget_bytes=400), frame_bytes=128)
    for i in range(80):
        cw.add(i % 4, f"c{i:04d}", [i])
    cman = cw.finish()
    cw.close()
    view4 = reading_view(store4, "4+1")
    cby_part = manifest_files_by_part(cman)
    assert set(cby_part) == {0, 1, 2, 3}
    cnames = [n for files in cby_part.values() for n in files]
    plain4 = store4.list(f"{ns}.P*.{INBOX_TAG}-*")
    assert plain4 and all(n.endswith("T") for n in plain4), \
        f"only replicated TAILS may have plain primaries: {plain4}"
    assert all(view4.exists(n) for n in cnames)
    gbase = group_base(ns, "00000004", None)
    assert store4.list(stripe_patterns(gbase)[0]), "no group stripe published"
    for part, files in cby_part.items():
        recs = [k for nm in files for k, _ in record_stream(view4, nm)]
        assert recs == sorted(recs) and len(recs) == 20, (part, recs)
    # discovery resolves the coded lineage like any other
    got4 = discover_push(store4, ns, ["00000004"], replication="4+1")
    assert got4 == {p: fs for p, fs in sorted(cby_part.items())}
    # iteration hygiene sweeps member stripes AND shared group blocks
    sweep_push_files(reading_view(store4, "4+1"), ns)
    leftover4 = store4.list("*") + store4.list(stripe_patterns("*")[0])
    assert leftover4 == [], f"coded sweep left {leftover4}"
