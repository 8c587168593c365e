"""Deterministic replica placement for the shuffle data plane.

Copy of the JAX package's ``engine/placement.py``
(the torch package imports nothing of the JAX package).

Coded MapReduce (PAPERS.md) trades extra shuffle bytes for recovery
latency: when each intermediate partition lives in ``r`` places, losing
a worker or a storage target costs a failover read instead of a map
re-execution. This module is the *address book* of that trade — a pure,
deterministic mapping from a spill file name to the ``r`` locations its
copies occupy, shared by every producer (who fans the publish out),
every consumer (who fails over), and the scavenger (who reconstructs).

Placement model: the store's namespace is carved into ``NUM_TAGS``
virtual **placement targets** ("tags" — think racks, disks, or bucket
shards; the blackout fault kind in faults/plan.py kills exactly one of
them). A file's *primary* copy keeps its plain name and lives on the
tag hashed from that name; replica ``k`` (1 ≤ k < r) lives on tag
``(primary_tag + k) % NUM_TAGS`` under the name::

    ~<k>.<tag>~<original name>

Properties the rest of the system leans on:

- **deterministic** — every process computes the same addresses from
  the name alone (no placement metadata to coordinate or lose);
- **distinct targets** — the ``r`` copies of one file occupy ``r``
  different tags (requires ``r ≤ NUM_TAGS``), so any single-tag loss
  leaves ``r−1`` survivors;
- **glob-transparent** — replica names start with ``~``, so every
  existing discovery/cleanup glob (``<ns>.P*``...) sees primaries only;
  replica-aware listings go through :func:`replica_pattern`;
- **self-describing** — :func:`parse_replica` recovers ``(k, tag,
  base)`` from a replica name, and :func:`tag_of` answers "which
  target does this op touch" for primaries and replicas alike (the
  blackout kind's routing question).

``r == 1`` degenerates to the plain name and nothing else — the
replication layer is byte-for-byte absent from unreplicated runs.
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Optional, Tuple

# virtual placement targets (failure domains). 8 comfortably exceeds any
# sane replication factor while keeping single-tag blackouts meaningful
# (1/8 of primaries, plus every replica routed onto the dark tag).
NUM_TAGS = 8

_REPLICA_RE = re.compile(r"^~(\d+)\.(\d+)~(.+)$")

# erasure-coded stripe names (faults/coded.py, DESIGN §27) reuse the
# same self-describing shape with a distinct sigil: block ``i`` of a
# stripe lives at ``^<i>.<tag>^<base>`` on tag (primary_tag(base)+i) %
# NUM_TAGS — the replica formula, so k+m blocks occupy k+m DISTINCT
# tags and any single-tag loss costs at most one block per stripe. The
# per-stripe manifest is the ``M``-sigil variant. Construction of these
# names is coded.py's monopoly (lint rule LMR012); placement only
# PARSES them, because tag routing (the blackout kind's question) and
# logical-name stripping must work for every physical copy shape.
_BLOCK_RE = re.compile(r"^\^(\d+)\.(\d+)\^(.+)$")
_MANIFEST_RE = re.compile(r"^\^M\^(.+)$")


def check_replication(r) -> int:
    """Validate a replication factor: an int in [1, NUM_TAGS]."""
    r = int(r)
    if not (1 <= r <= NUM_TAGS):
        raise ValueError(f"replication factor {r} out of range "
                         f"[1, {NUM_TAGS}] (copies must land on distinct "
                         "placement targets)")
    return r


def resolve_replication(arg) -> int:
    """The engines' shared resolution order for the replication knob:
    explicit argument, else ``LMR_REPLICATION`` env, else 1 (off) —
    Server and LocalExecutor must agree on what one environment
    means."""
    if arg is None:
        import os
        arg = os.environ.get("LMR_REPLICATION") or 1
    return check_replication(arg)


def primary_tag(name: str) -> int:
    """The placement target of ``name``'s primary copy — a stable hash,
    NOT Python's salted ``hash()`` (every process must agree)."""
    h = hashlib.blake2b(name.encode("utf-8"), digest_size=4).digest()
    return int.from_bytes(h, "little") % NUM_TAGS


def replica_name(name: str, k: int) -> str:
    """The stored name of copy ``k`` of ``name`` (k=0 is the primary —
    the plain name itself)."""
    if k == 0:
        return name
    tag = (primary_tag(name) + k) % NUM_TAGS
    return f"~{k}.{tag}~{name}"


def replica_names(name: str, r: int) -> List[str]:
    """All ``r`` copy names of ``name``, primary first."""
    return [replica_name(name, k) for k in range(check_replication(r))]


def parse_replica(name: str) -> Optional[Tuple[int, int, str]]:
    """``(k, tag, base_name)`` of a replica name, or None for a plain
    (primary) name."""
    m = _REPLICA_RE.match(name)
    if not m:
        return None
    return int(m.group(1)), int(m.group(2)), m.group(3)


def parse_block(name: str) -> Optional[Tuple[int, int, str]]:
    """``(i, tag, base_name)`` of a coded-stripe block name, or None
    for anything else (plain names, replicas, stripe manifests)."""
    m = _BLOCK_RE.match(name)
    if not m:
        return None
    return int(m.group(1)), int(m.group(2)), m.group(3)


def base_name(name: str) -> str:
    """The logical (primary) name behind any physical copy name —
    replica, coded block, stripe manifest, or a replica OF a stripe
    manifest (stripped iteratively: ``~1.5~^M^f`` resolves to ``f``)."""
    while True:
        parsed = parse_replica(name)
        if parsed is not None:
            name = parsed[2]
            continue
        blk = parse_block(name)
        if blk is not None:
            name = blk[2]
            continue
        man = _MANIFEST_RE.match(name)
        if man is not None:
            name = man.group(1)
            continue
        return name


def tag_of(name: str) -> int:
    """Which placement target an op on ``name`` touches: the embedded
    tag of a replica or coded-block name, the hashed tag of anything
    else (primaries, stripe manifests)."""
    parsed = parse_replica(name)
    if parsed is not None:
        return parsed[1]
    blk = parse_block(name)
    if blk is not None:
        return blk[1]
    return primary_tag(name)


def replica_pattern(pattern: str) -> str:
    """The glob matching every replica of every name matching
    ``pattern`` — cleanup and replica-aware listings pair this with the
    plain pattern (primary globs never see replica names)."""
    return f"~*~{pattern}"


def utest() -> None:
    """Self-test: determinism, distinct tags, round-trip parsing,
    glob transparency, and the r=1 degenerate case."""
    import fnmatch

    name = "result.P3.M00000017"
    assert replica_names(name, 1) == [name]          # r=1: plain name only
    names = replica_names(name, 3)
    assert names[0] == name
    assert names == replica_names(name, 3)           # deterministic
    tags = [tag_of(n) for n in names]
    assert len(set(tags)) == 3                       # distinct targets
    assert tags[0] == primary_tag(name)
    for k, n in enumerate(names[1:], start=1):
        assert parse_replica(n) == (k, tags[k], name)
        assert base_name(n) == name
        # glob transparency: discovery/cleanup globs see primaries only
        assert not fnmatch.fnmatchcase(n, "result.P*")
        assert fnmatch.fnmatchcase(n, replica_pattern("result.P*.M*"))
    assert parse_replica(name) is None and base_name(name) == name

    # coded-stripe names (constructed ONLY by faults/coded.py — LMR012)
    # parse to the same tag-routing and logical-stripping answers
    from lua_mapreduce_tpu_torch.faults.coded import (Coding, block_names,
                                                      manifest_copies)
    blocks = block_names(name, Coding(4, 2))
    assert len({tag_of(n) for n in blocks}) == 6     # distinct targets
    for i, n in enumerate(blocks):
        assert parse_block(n) == (i, tag_of(n), name)
        assert base_name(n) == name
        assert not fnmatch.fnmatchcase(n, "result.P*")   # glob-transparent
    for n in manifest_copies(name, Coding(4, 2)):    # manifest + replicas
        assert parse_block(n) is None
        assert base_name(n) == name                  # iterative stripping
        assert not fnmatch.fnmatchcase(n, "result.P*")
    assert parse_block(name) is None

    # ~full-range factors still land on distinct tags
    assert len({tag_of(n) for n in replica_names(name, NUM_TAGS)}) \
        == NUM_TAGS
    for bad in (0, NUM_TAGS + 1):
        try:
            check_replication(bad)
        except ValueError:
            pass
        else:
            raise AssertionError(f"replication {bad} must be rejected")
