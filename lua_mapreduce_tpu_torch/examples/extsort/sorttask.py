"""CloudSort-style external sort — the push shuffle's first-class
GB-scale scenario (Exoshuffle-CloudSort, PAPERS.md).

Copy of the repo-root ``examples/extsort/sorttask.py`` (the torch
package imports nothing of the JAX package's tree). Run it as
``TaskSpec(taskfn=M, mapfn=M, partitionfn=M, reducefn=M,
init_args={...})`` with ``M = "lua_mapreduce_tpu_torch.examples.extsort.
sorttask"``.

A synthetic uniform keyspace sort, single-module form: ``taskfn`` emits
one map job per keyspace slice (the job value is just ``(seed, n)`` —
no input files, records are generated deterministically from blake2b
counters, so multi-GB datasets cost zero corpus-build IO and every
re-execution regenerates identical bytes, the engine's duplicate-
execution assumption); ``mapfn`` materializes the slice's records —
16-hex-char keys uniform over the keyspace, opaque deterministic
payloads — and emits them; ``partitionfn`` RANGE-partitions on the key
prefix so partitions tile the keyspace in order; ``reducefn`` is the
identity fold (keys are unique by construction — flagged idempotent/
associative/commutative, so the merge's singleton fast path applies,
exactly a sort's shape: ALL the reduce work is the merge itself).

The sorted output is the concatenation of ``result.P0, result.P1, ...``
— each partition file is written in merged key order and the range
partitioning makes the partition sequence globally ordered.

``init(args)``: ``n_jobs``, ``records_per_job``, ``payload_bytes``,
``n_partitions``, ``seed``.
"""

import hashlib

_n_jobs = 8
_records_per_job = 1000
_payload = 84          # payload hex chars; ~100B/record with key+JSON
_n_parts = 8
_seed = 0


def init(args):
    global _n_jobs, _records_per_job, _payload, _n_parts, _seed
    _n_jobs = int(args.get("n_jobs", _n_jobs))
    _records_per_job = int(args.get("records_per_job", _records_per_job))
    _payload = int(args.get("payload_bytes", _payload))
    _n_parts = int(args.get("n_partitions", _n_parts))
    _seed = int(args.get("seed", _seed))


def taskfn(emit):
    for j in range(_n_jobs):
        emit(str(j), {"seed": _seed, "job": j, "n": _records_per_job})


def record(seed: int, job: int, i: int):
    """One deterministic record: blake2b makes the key uniform over the
    16^16 keyspace and unique per (seed, job, i); the payload is
    derived, incompressible-ish hex of the requested width."""
    h = hashlib.blake2b(f"{seed}:{job}:{i}".encode(), digest_size=8)
    key = h.hexdigest()
    body = hashlib.blake2b(h.digest(), digest_size=32).hexdigest()
    payload = (body * (_payload // len(body) + 1))[:_payload]
    return key, payload


def mapfn(key, value, emit):
    seed, job, n = value["seed"], value["job"], value["n"]
    for i in range(n):
        k, payload = record(seed, job, i)
        emit(k, payload)


def partitionfn(key):
    # range partition on the 16-bit key prefix: uniform keys spread
    # evenly AND the partition index is monotone in the key, so the
    # partition file sequence is the globally sorted output
    return (int(key[:4], 16) * _n_parts) >> 16


def reducefn(key, values):
    return values[0]


# keys are unique by construction: every group is a singleton, the
# identity fold is trivially associative/commutative/idempotent, and
# the flags license the merge's singleton fast path — a sort spends
# everything on the merge, nothing on the fold
reducefn.associative_reducer = True
reducefn.commutative_reducer = True
reducefn.idempotent_reducer = True


def total_bytes() -> int:
    """Approximate decoded dataset size (serialized record lines)."""
    k, p = record(_seed, 0, 0)
    line = len(f'["{k}",["{p}"]]') + 1
    return _n_jobs * _records_per_job * line
