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
