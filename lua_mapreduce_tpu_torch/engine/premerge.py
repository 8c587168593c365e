"""Pipelined-shuffle scheduling: eager reduce-side pre-merge.

Copy of the JAX package's ``engine/premerge.py`` (the torch package imports
nothing of the JAX package).

The reference's cycle is barrier-synchronized — the server waits for the
last map job before inserting any reduce job (server.lua:186-234 →
249-329), and both executors here preserved that stall. Exoshuffle's
observation (PAPERS.md) is that shuffle work can start the moment map
outputs commit: while mappers still run, committed per-partition run
files are consolidated ("pre-merged") into a single spill run, so the
final reduce merges {spills + tail runs} instead of one run per mapper,
and most of the merge IO/CPU hides behind the map phase.

Golden-diff discipline is the design constraint. The barrier engines
merge a partition's runs in lexicographic run-name order and concatenate
equal-key value lists in that order (core/merge.py, and the C++ pass
mirrors it), so the reduce input — and therefore the task output — is a
pure function of that canonical order. A spill is byte-compatible iff

  1. it covers a CONTIGUOUS range of the canonical order (absent runs —
     mappers that emitted nothing for the partition — are transparent),
  2. it concatenates its inputs' values in canonical order internally,
  3. the final reduce file list interleaves spills and raw runs by
     canonical position.

Then for every key the concatenated value list is unchanged, and because
pre-merge only GROUPS values (never applies a combiner or reducer), the
reduce fold sees identical inputs and the result files are byte-identical
to the barrier path on every storage backend.

Spill naming carries the covered range so the file list can be rebuilt
from storage alone (crash/resume, and the local executor's handoff):
``<ns>.P<part>.SPILL-<a>-<b>`` covers canonical positions ``a..b`` of the
(zero-padded, see job.map_key_str) map-key order. The pattern shares no
``.M`` infix with raw runs, so barrier-mode discovery never picks a
spill up by accident.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Tuple

SPILL_TAG = "SPILL"

_RUN_RE_TMPL = r"^{ns}\.P(\d+)\.M(.+)$"
_SPILL_RE_TMPL = r"^{ns}\.P(\d+)\.SPILL-(\d+)-(\d+)$"


def run_name_re(result_ns: str) -> "re.Pattern":
    """Compiled matcher for raw run files ``<ns>.P<part>.M<mapkey>``."""
    return re.compile(_RUN_RE_TMPL.format(ns=re.escape(result_ns)))


def spill_name(result_ns: str, part: int, a: int, b: int) -> str:
    return f"{result_ns}.P{part}.{SPILL_TAG}-{a:05d}-{b:05d}"


def parse_spill_name(result_ns: str,
                     name: str) -> Optional[Tuple[int, int, int]]:
    """``(part, a, b)`` of a spill file, or None for any other name."""
    m = re.match(_SPILL_RE_TMPL.format(ns=re.escape(result_ns)), name)
    if not m:
        return None
    return int(m.group(1)), int(m.group(2)), int(m.group(3))


@dataclasses.dataclass
class SpillJob:
    """One pre-merge unit: consolidate ``files`` (canonical order) into
    the single sorted run ``name`` covering canonical positions a..b."""
    part: int
    seq: int
    a: int
    b: int
    positions: List[int]
    files: List[str]
    name: str


class PremergeTracker:
    """Decide which committed runs may pre-merge, and when.

    Per partition, every canonical position (one per map key, in run-name
    order) is in one of five states: UNKNOWN (map job not yet committed),
    ABSENT (committed, produced no run here), RUN (run present,
    unassigned), COVERED (inside a spill's range), or POISONED (a spill
    over it failed, or would take a name in ``avoid`` — its raw runs
    reduce directly, never re-spilled).
    ``take_eligible`` cuts maximal stretches of RUN positions bounded by
    UNKNOWN/COVERED/POISONED — ABSENT is transparent — into chunks of
    ``min_runs``..``max_runs`` runs. Contiguity over *decided* positions
    is what keeps spills byte-compatible (module docstring).

    Not thread-safe by itself; in-process callers hold their own lock.
    """

    def __init__(self, result_ns: str, map_keys: Iterable[str],
                 min_runs: int = 4, max_runs: int = 8,
                 avoid: Iterable[str] = ()):
        self.ns = result_ns
        # spill names an earlier iteration left behind that no sweep
        # could remove (a copy on an unreachable placement tag): a chunk
        # that would publish under one of them stays raw instead, so
        # discovery can ignore every such name this iteration
        self.avoid = frozenset(avoid)
        self.order: List[str] = sorted(str(k) for k in map_keys)
        self.pos: Dict[str, int] = {k: i for i, k in enumerate(self.order)}
        self.min_runs = max(2, int(min_runs))
        self.max_runs = max(self.min_runs, int(max_runs))
        self.committed: set = set()            # canonical positions decided
        self.runs: Dict[int, Dict[int, str]] = {}      # part -> pos -> name
        self.covered: Dict[int, Dict[int, int]] = {}   # part -> pos -> seq
        self.poisoned: Dict[int, set] = {}             # part -> positions
        self.spills: Dict[Tuple[int, int], SpillJob] = {}
        self.pending: set = set()                      # (part, seq) in flight
        self._seq = 0
        # per-partition scan cursor: the maximal prefix of TERMINAL
        # positions (covered | poisoned | committed-absent) — those can
        # never join a future stretch, so take_eligible skips them.
        # Keeps the in-process path (one scan per map commit, under the
        # executor's lock) amortized near-linear instead of
        # O(n_maps^2 x n_partitions) at reference fan-in (~2,000 jobs)
        self._stable: Dict[int, int] = {}

    # -- events -------------------------------------------------------------

    def note_map_committed(self, map_key: str,
                           runs_by_part: Dict[int, object]) -> None:
        """Map job ``map_key`` reached its terminal state; ``runs_by_part``
        lists the run files it left behind (empty for FAILED jobs —
        their partitions simply see it as absent). A value may be one
        run-file name (the staged shuffle) or an ordered LIST of files
        — a pushed map's inbox fragments + eviction tail (DESIGN §24):
        one canonical position then carries several files whose
        internal order is the map's own record order, so consolidating
        them in position order stays byte-compatible."""
        p = self.pos.get(str(map_key))
        if p is None or p in self.committed:
            return
        self.committed.add(p)
        for part, names in runs_by_part.items():
            if p in self.covered.get(part, {}):
                continue   # resume leftover: a spill already consumed it
            if isinstance(names, str):
                names = [names]
            if names:
                self.runs.setdefault(int(part), {})[p] = list(names)

    def note_existing_spill(self, part: int, a: int, b: int,
                            name: str) -> None:
        """Reconstruct a spill found on storage (server crash/resume)."""
        seq, self._seq = self._seq, self._seq + 1
        positions = list(range(a, b + 1))
        self.spills[(part, seq)] = SpillJob(part, seq, a, b, positions,
                                            [], name)
        cov = self.covered.setdefault(part, {})
        for p in positions:
            cov[p] = seq
        runmap = self.runs.get(part)
        if runmap:
            for p in positions:
                runmap.pop(p, None)

    def spill_done(self, part: int, seq: int) -> None:
        self.pending.discard((part, seq))

    def spill_failed(self, part: int, seq: int, spill_exists: bool) -> None:
        """A pre-merge job gave up. If its spill file exists anyway (the
        worker died between the atomic build and its status CAS), the
        output is whole — treat as done. Otherwise uncover the range and
        poison it: the raw runs reduce directly and are never retried."""
        self.pending.discard((part, seq))
        if spill_exists:
            return
        sp = self.spills.pop((part, seq), None)
        if sp is None:
            return
        cov = self.covered.get(part, {})
        for p in range(sp.a, sp.b + 1):
            if cov.get(p) == seq:
                del cov[p]
        self.poisoned.setdefault(part, set()).update(sp.positions)

    # -- scheduling ---------------------------------------------------------

    def take_eligible(self) -> List[SpillJob]:
        """Cut every currently-eligible stretch into pre-merge jobs and
        return them (their runs leave the RUN state atomically here)."""
        out: List[SpillJob] = []
        for part in list(self.runs):
            runmap = self.runs[part]
            if len(runmap) < self.min_runs:
                continue
            cov = self.covered.get(part, {})
            poi = self.poisoned.get(part, ())
            # advance the stable cursor over terminal positions, then
            # scan only the live suffix — positions before the cursor
            # hold no unassigned run and cannot start or feed a stretch
            lo = self._stable.get(part, 0)
            while lo < len(self.order) and lo not in runmap and (
                    lo in cov or lo in poi or lo in self.committed):
                lo += 1
            self._stable[part] = lo
            stretch: List[int] = []
            for p in range(lo, len(self.order) + 1):
                boundary = (p == len(self.order) or p in cov or p in poi
                            or p not in self.committed)
                if not boundary:
                    if p in runmap:
                        stretch.append(p)
                    continue   # ABSENT positions are transparent
                i = 0
                while len(stretch) - i >= self.min_runs:
                    n = min(self.max_runs, len(stretch) - i)
                    chunk = stretch[i:i + n]
                    i += n
                    if spill_name(self.ns, part, chunk[0],
                                  chunk[-1]) in self.avoid:
                        # its raw runs reduce directly
                        for p in chunk:
                            runmap.pop(p)
                        self.poisoned.setdefault(part, set()).update(chunk)
                        continue
                    out.append(self._make_spill(part, chunk, runmap))
                stretch = []
        return out

    def _make_spill(self, part: int, chunk: List[int],
                    runmap: Dict[int, List[str]]) -> SpillJob:
        seq, self._seq = self._seq, self._seq + 1
        a, b = chunk[0], chunk[-1]
        sp = SpillJob(part, seq, a, b, list(chunk),
                      [f for p in chunk for f in runmap.pop(p)],
                      spill_name(self.ns, part, a, b))
        cov = self.covered.setdefault(part, {})
        for p in range(a, b + 1):
            cov[p] = seq
        self.spills[(part, seq)] = sp
        self.pending.add((part, seq))
        return sp

    def pending_count(self) -> int:
        return len(self.pending)


def discover_pipelined(store, result_ns: str,
                       map_keys: Iterable[str],
                       push: bool = False,
                       replication: int = 1,
                       ignore: Iterable[str] = ()) -> Dict[int, List[str]]:
    """Partition → ordered reduce input list, rebuilt from storage alone.

    The pipelined analog of local.discover_partitions: spills slot in at
    the canonical position of their first covered run; raw runs sit at
    their map key's position; raw runs INSIDE a spill's range are
    leftovers of a pre-delete crash or a duplicate map re-run — the spill
    already carries their data, so they are dropped (and swept, best
    effort). The returned order is exactly the barrier merge order, so
    reduce output is byte-identical.

    With ``push`` (DESIGN §24) a map's position may carry several files
    — its manifest-named inbox fragments in seq order plus the eviction
    tail — resolved through the canonical-manifest gate (classic runs
    stay the fallback for push-off fleet members); orphan fragments no
    canonical lineage names are swept here, the one place every map is
    known terminal.

    Spills named in ``ignore`` are an earlier iteration's copies that
    the sweeps could not remove (the tracker's ``avoid``): never read,
    only swept again, best effort.
    """
    order = sorted(str(k) for k in map_keys)
    ignore = frozenset(ignore)
    run_re = run_name_re(result_ns)
    items: Dict[int, List[Tuple]] = {}
    covered: Dict[int, List[Tuple[int, int]]] = {}
    spills: Dict[int, List[Tuple[int, int, str]]] = {}
    for name in store.list(f"{result_ns}.P*.{SPILL_TAG}-*"):
        parsed = parse_spill_name(result_ns, name)
        if parsed is None:
            continue
        if name in ignore:
            try:
                store.remove(name)
            except Exception:
                pass
            continue
        part, a, b = parsed
        spills.setdefault(part, []).append((a, b, name))
    # overlapping spills: a zombie pre-merge worker surviving a server
    # crash/restart can publish a range the restarted server also
    # covered (its commit CAS fails, but the data-plane publish is not
    # gated on it). A NESTED overlap keeps the widest spill — it carries
    # a superset of the same runs' data — and sweeps the narrower; a
    # STAGGERED overlap cannot be de-duplicated at file granularity
    # (each spill uniquely holds some positions and duplicates others),
    # so it fails loudly instead of silently double-counting.
    for part, lst in spills.items():
        accepted: List[Tuple[int, int, str]] = []
        for a, b, name in sorted(lst, key=lambda t: (t[0], t[0] - t[1])):
            box = next(((a0, b0, n0) for a0, b0, n0 in accepted
                        if a <= b0 and a0 <= b), None)
            if box is None:
                accepted.append((a, b, name))
                continue
            a0, b0, n0 = box
            if a0 <= a and b <= b0:       # nested: widest already kept
                try:
                    store.remove(name)    # duplicate data; sweep
                except Exception:
                    pass
                continue
            raise RuntimeError(
                f"partition {part}: staggered overlapping spills "
                f"{n0!r} ({a0}-{b0}) and {name!r} ({a}-{b}) — cannot "
                "de-duplicate at file granularity; clear the stale "
                "spill files and re-run the iteration")
        for a, b, name in accepted:
            items.setdefault(part, []).append(((a, 0, 0, name), name))
            covered.setdefault(part, []).append((a, b))
    if push:
        from lua_mapreduce_tpu_torch.engine.push import (
            push_file_lists, sweep_unreferenced)
        lists, referenced = push_file_lists(store, result_ns, order,
                                            replication)
        for p, key in enumerate(order):
            for part, files in lists.get(key, {}).items():
                if any(a <= p <= b for a, b in covered.get(part, ())):
                    for f in files:     # consumed leftovers; sweep
                        try:
                            store.remove(f)
                        except Exception:
                            pass
                    continue
                items.setdefault(part, []).extend(
                    ((p, 1, i, f), f) for i, f in enumerate(files))
        sweep_unreferenced(store, result_ns, referenced, order)
    else:
        for name in store.list(f"{result_ns}.P*.M*"):
            m = run_re.match(name)
            if not m:
                continue
            part, key = int(m.group(1)), m.group(2)
            p = bisect.bisect_left(order, key)
            if any(a <= p <= b for a, b in covered.get(part, ())):
                try:
                    store.remove(name)   # consumed leftover; sweep
                except Exception:
                    pass
                continue
            items.setdefault(part, []).append(((p, 1, 0, name), name))
    return {part: [n for _, n in sorted(lst)] for part, lst in items.items()}


def utest() -> None:
    """Self-test: contiguity, transparency of absent runs, chunking,
    failure poisoning, and the disk-rebuilt reduce order."""
    ns = "r"
    keys = [f"{i:06d}" for i in range(10)]
    tr = PremergeTracker(ns, keys, min_runs=3, max_runs=4)

    def commit(i, parts=(0,)):
        tr.note_map_committed(keys[i],
                              {p: f"{ns}.P{p}.M{keys[i]}" for p in parts})

    commit(0), commit(2), commit(3)
    assert tr.take_eligible() == []          # 1 isolated by UNKNOWN pos 1
    commit(1, parts=())                      # absent everywhere: transparent
    (sp,) = tr.take_eligible()               # 0,[absent],2,3 is contiguous
    assert (sp.a, sp.b, sp.positions) == (0, 3, [0, 2, 3])
    assert sp.files == [f"r.P0.M{keys[i]}" for i in (0, 2, 3)]
    tr.spill_done(sp.part, sp.seq)
    assert tr.pending_count() == 0

    for i in (4, 5, 6, 7, 8, 9):
        commit(i)
    spills = tr.take_eligible()              # 6-stretch → chunks of 4 + none
    assert [len(s.positions) for s in spills] == [4]
    (s2,) = spills
    tr.spill_failed(s2.part, s2.seq, spill_exists=False)   # → poisoned
    assert tr.take_eligible() == []          # poisoned range never retried

    class _FakeStore:
        def __init__(self, names):
            self.names = set(names)

        def list(self, pattern):
            import fnmatch
            return sorted(n for n in self.names
                          if fnmatch.fnmatchcase(n, pattern))

        def remove(self, name):
            self.names.discard(name)

    # disk state: the done spill + poisoned raw runs + a tail run, plus a
    # leftover run inside the spill range (pre-delete crash) to be swept
    st = _FakeStore([sp.name] +
                    [f"r.P0.M{keys[i]}" for i in (2, 4, 5, 6, 7, 8, 9)])
    got = discover_pipelined(st, ns, keys)
    assert got == {0: [sp.name] + [f"r.P0.M{keys[i]}"
                                   for i in (4, 5, 6, 7, 8, 9)]}, got
    assert f"r.P0.M{keys[2]}" not in st.names   # swept
