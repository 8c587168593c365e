"""The port's push shuffle ≡ the JAX package's ``tests/test_push.py``:
knob resolution, the golden matrix with push off and on across {mem,
shared, object} × {barrier, pipelined} on both executors, the
memory-budget eviction regression, manifest gating (quarantine /
promote / backstop — the code paths a speculative clone takes, driven
directly: the port's workers open no duplicate lease yet), mixed
push-on/off fleets, the footer-cache purge and resume stickiness. Then
the cross-package checks: push manifests and inbox frames byte-equal
to the JAX package's for the same map, each package's reduce reading
the other's push files, and result bytes equal to the JAX package's
push runs."""

import re
import threading

import pytest

from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
from lua_mapreduce_tpu_torch.engine import push as push_mod
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.local import LocalExecutor, iter_results
from lua_mapreduce_tpu_torch.engine.server import Server
from lua_mapreduce_tpu_torch.engine.worker import Worker
from lua_mapreduce_tpu_torch.store.router import get_storage_from

CORPUS = {
    f"doc{i}": " ".join(f"w{(i * 11 + j) % 29}" for j in range(48))
    for i in range(8)
}
GOLDEN = {}
for _text in CORPUS.values():
    for _w in _text.split():
        GOLDEN[_w] = GOLDEN.get(_w, 0) + 1

_MOD = "tests._torch_push_wc"


def _install_module():
    import sys
    import types

    mod = sys.modules.get(_MOD)
    if mod is None:
        mod = types.ModuleType(_MOD)

        def taskfn(emit):
            for k, v in sorted(CORPUS.items()):
                emit(k, v)

        def mapfn(key, value, emit):
            for w in value.split():
                emit(w, 1)

        mod.taskfn = taskfn
        mod.mapfn = mapfn
        mod.partitionfn = lambda key: sum(key.encode()) % 4
        mod.reducefn = lambda key, values: sum(values)
        sys.modules[_MOD] = mod
    return mod


def _storage(tmp_path, backend, tag):
    return {"mem": f"mem:{tag}",
            "shared": f"shared:{tmp_path}/shared-{tag}",
            "object": f"object:{tmp_path}/object-{tag}"}[backend]


def _result_bytes(storage_spec, ns="result"):
    store = get_storage_from(storage_spec)
    keep = re.compile(rf"^{re.escape(ns)}\.P\d+$")
    return {n: "".join(store.lines(n)) for n in store.list(f"{ns}.P*")
            if keep.match(n)}


def _run_local(tmp_path, backend, pipeline, tag, push=False,
               budget_mb=None, replication=1):
    _install_module()
    spec = TaskSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                    reducefn=_MOD, init_args={"device": "cpu"},
                    storage=_storage(tmp_path, backend, tag))
    ex = LocalExecutor(spec, map_parallelism=3, pipeline=pipeline,
                       premerge_min_runs=2, push=push,
                       push_budget_mb=budget_mb, replication=replication)
    stats = ex.run()
    got = {k: v[0] for k, v in ex.results()}
    assert got == GOLDEN
    return _result_bytes(spec.storage), stats


# --- knob resolution ---------------------------------------------------------

def test_resolve_push_env_roundtrip(monkeypatch):
    assert push_mod.resolve_push(True) is True
    assert push_mod.resolve_push(None) is False
    monkeypatch.setenv("LMR_PUSH", "1")
    assert push_mod.resolve_push(None) is True
    monkeypatch.setenv("LMR_PUSH", "off")
    assert push_mod.resolve_push(None) is False
    monkeypatch.setenv("LMR_PUSH_BUDGET_MB", "2.5")
    assert push_mod.resolve_push_budget(None) == int(2.5 * 1024 * 1024)
    assert push_mod.resolve_push_budget(1) == 1024 * 1024
    monkeypatch.delenv("LMR_PUSH_BUDGET_MB")
    assert push_mod.resolve_push_budget(None) == \
        int(push_mod.DEFAULT_BUDGET_MB * 1024 * 1024)


def test_cli_parsers_accept_push_knobs():
    from lua_mapreduce_tpu_torch.cli.execute_server import \
        build_parser as server_parser
    from lua_mapreduce_tpu_torch.cli.execute_worker import \
        build_parser as worker_parser
    s = server_parser().parse_args(
        ["coord", "t", "m", "p", "r", "--push", "--push-budget-mb", "16"])
    assert s.push is True and s.push_budget_mb == 16.0
    s = server_parser().parse_args(["coord", "t", "m", "p", "r"])
    assert s.push is None            # None = LMR_PUSH env resolution
    w = worker_parser().parse_args(
        ["coord", "--push", "--push-budget-mb", "8"])
    assert w.push is True and w.push_budget_mb == 8.0


def test_worker_config_keys():
    w = Worker(MemJobStore(), name="push-cfg")
    w.configure(push=True, push_budget_mb=4.0)
    assert w._push_on() is True
    assert w._push_pool().budget == 4 * 1024 * 1024
    # unset worker follows the task document's fleet marker
    w2 = Worker(MemJobStore(), name="push-cfg2")
    assert w2._push_on() is False
    w2._task_push = True
    assert w2._push_on() is True


# --- the golden matrix: push off AND on, byte-identical ----------------------

@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["barrier", "pipelined"])
@pytest.mark.parametrize("backend", ["mem", "shared", "object"])
def test_push_golden_matrix_local(tmp_path, backend, pipeline):
    tag = f"pg-{backend}-{int(pipeline)}"
    off, _ = _run_local(tmp_path, backend, pipeline, tag + "-off")
    on, stats = _run_local(tmp_path, backend, pipeline, tag + "-on",
                           push=True)
    assert on == off, "push-on output differs from the staged path"
    assert stats.iterations[-1].push_frames > 0


def test_push_golden_replicated(tmp_path):
    # pushed frames ride the replication plane: r=2 stays byte-identical
    off, _ = _run_local(tmp_path, "mem", True, "pr-off")
    on, stats = _run_local(tmp_path, "mem", True, "pr-on", push=True,
                           replication=2)
    assert on == off
    assert stats.iterations[-1].push_frames > 0


def test_push_distributed_task_doc_deploy(tmp_path):
    """Server(push=True) deploys the marker through the task doc: stock
    workers follow it, output byte-identical to the staged twin, and
    the in-process pool's IterationStats carries the frame count."""
    _install_module()
    clean, _ = _run_local(tmp_path, "mem", False, "pd-off")
    spec = TaskSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                    reducefn=_MOD, init_args={"device": "cpu"},
                    storage=_storage(tmp_path, "mem", "pd-on"))
    store = MemJobStore()
    server = Server(store, poll_interval=0.01, pipeline=True,
                    premerge_min_runs=2, batch_k=2,
                    push=True).configure(spec)
    workers = [Worker(store).configure(max_iter=800, max_sleep=0.02)
               for _ in range(2)]
    threads = [threading.Thread(target=w.execute, daemon=True)
               for w in workers]
    for t in threads:
        t.start()
    stats = server.loop()
    for t in threads:
        t.join(timeout=30)
    got = {k: v[0] for k, v in iter_results(
        get_storage_from(spec.storage), "result")}
    assert got == GOLDEN
    assert _result_bytes(spec.storage) == clean
    it = stats.iterations[-1]
    assert it.push_frames > 0
    assert it.map.failed == 0 and it.reduce.failed == 0


def test_push_mixed_fleet(tmp_path):
    """One worker pinned push=False (a push-off fleet member) while the
    fleet default is push: manifested maps and classic runs interleave
    in canonical order — output stays byte-identical."""
    _install_module()
    clean, _ = _run_local(tmp_path, "mem", False, "mix-off")
    spec = TaskSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                    reducefn=_MOD, init_args={"device": "cpu"},
                    storage=_storage(tmp_path, "mem", "mix-on"))
    store = MemJobStore()
    server = Server(store, poll_interval=0.01, push=True,
                    batch_k=2).configure(spec)
    pusher = Worker(store, name="pusher").configure(max_iter=800,
                                                    max_sleep=0.02)
    classic = Worker(store, name="classic").configure(
        max_iter=800, max_sleep=0.02, push=False)
    threads = [threading.Thread(target=w.execute, daemon=True)
               for w in (pusher, classic)]
    for t in threads:
        t.start()
    server.loop()
    for t in threads:
        t.join(timeout=30)
    got = {k: v[0] for k, v in iter_results(
        get_storage_from(spec.storage), "result")}
    assert got == GOLDEN
    assert _result_bytes(spec.storage) == clean


# --- satellite: memory-budget eviction regression ----------------------------

def test_push_budget_eviction_regression(tmp_path):
    """A push run with the budget far below the working set must
    complete via eviction-to-staged — ``push_evictions > 0`` in
    IterationStats — with byte-identical output (the degrade-to-staged
    rung, never an OOM or a failure)."""
    off, _ = _run_local(tmp_path, "mem", True, "bud-off")
    on, stats = _run_local(tmp_path, "mem", True, "bud-on", push=True,
                           budget_mb=0.0001)   # ~100 bytes: constant
    assert on == off
    it = stats.iterations[-1]
    assert it.push_evictions > 0, \
        "budget below working set must evict, not buffer"


def test_buffer_pool_accounting():
    pool = push_mod.BufferPool(1000)
    pool.charge(600)
    assert not pool.over()
    pool.charge(600)
    assert pool.over() and pool.held == 1200
    pool.uncharge(900)
    assert pool.held == 300 and not pool.over()
    pool.uncharge(10_000)
    assert pool.held == 0              # floor at zero, never negative


# --- manifest gate: quarantine / promote / backstop --------------------------

def test_spec_lineage_quarantined_until_promoted():
    """A clone's pushes stay invisible — spec-tagged fragments + a spec
    manifest — until promote(); promote is publish-if-absent, so a
    canonical lineage published by the original always wins."""
    from lua_mapreduce_tpu_torch.store.memfs import MemStore
    store = MemStore()
    ns, key = "result", "00000003"
    # original execution: canonical lineage
    orig = push_mod.PushWriter(store, ns, key,
                               pool=push_mod.BufferPool(1 << 20))
    orig.add(0, "a", [1])
    orig.add(1, "b", [2])
    orig.finish()
    orig.close()
    # clone execution: different fragmentation, quarantined
    lin = push_mod.lineage_token("clone-worker")
    clone = push_mod.PushWriter(store, ns, key,
                                pool=push_mod.BufferPool(0),
                                lineage=lin)
    clone.add(0, "a", [1])
    clone.add(1, "b", [2])
    clone.finish()
    clone.close()
    man = push_mod.read_manifest(store, push_mod.manifest_name(ns, key))
    assert man["lineage"] == ""        # the original's lineage is visible
    # every visible file is canonical; the clone's files carry its tag
    visible = {f for files in
               push_mod.manifest_files_by_part(man).values()
               for f in files}
    assert all(f"-s{lin}" not in f for f in visible)
    # the original committed: promote must NOT flip the manifest
    assert push_mod.promote(store, ns, key, lin, 1) is False
    assert push_mod.read_manifest(
        store, push_mod.manifest_name(ns, key)) == man
    # discovery sweeps the losing clone's quarantined files
    parts = push_mod.discover_push(store, ns, [key])
    assert all(f"-s{lin}" not in f for files in parts.values()
               for f in files)
    leftover = [n for n in store.list(f"{ns}.P*.INBOX-*")
                if f"-s{lin}" in n]
    assert leftover == [], "losing clone's inbox must be swept"


def test_promote_gap_backstop():
    """The winning-clone-died-pre-promote gap: job committed, canonical
    manifest absent, spec manifest complete — ensure_canonical promotes
    it (deterministically) so the tracker/discovery never stall."""
    from lua_mapreduce_tpu_torch.store.memfs import MemStore
    store = MemStore()
    ns, key = "result", "00000009"
    lin = push_mod.lineage_token("dead-winner")
    clone = push_mod.PushWriter(store, ns, key,
                                pool=push_mod.BufferPool(1 << 20),
                                lineage=lin)
    clone.add(0, "k", [1])
    clone.finish()
    clone.close()
    assert push_mod.read_manifest(
        store, push_mod.manifest_name(ns, key)) is None
    man = push_mod.ensure_canonical(store, ns, key, 1)
    assert man is not None and man["lineage"] == lin
    assert store.exists(push_mod.manifest_name(ns, key))
    # idempotent: a second resolution reads the promoted canonical
    assert push_mod.ensure_canonical(store, ns, key, 1) == man


def test_backstop_never_promotes_dangling_lineage():
    """A losing clone's stale ``.s`` manifest whose fragments were
    already swept must NOT be backstop-promoted after the scavenger
    invalidates the canonical manifest — promoting a dangling lineage
    would wedge recovery on files nobody can regenerate under those
    names."""
    from lua_mapreduce_tpu_torch.store.memfs import MemStore
    store = MemStore()
    ns, key = "result", "00000011"
    lin = push_mod.lineage_token("losing-clone")
    clone = push_mod.PushWriter(store, ns, key,
                                pool=push_mod.BufferPool(1 << 20),
                                lineage=lin)
    clone.add(0, "k", [1])
    clone.finish()
    clone.close()
    # sweep the quarantined fragments (discovery's job), keep the stale
    # spec manifest, and leave no canonical (scavenger invalidated it)
    for n in store.list(f"{ns}.P*.INBOX-*"):
        store.remove(n)
    assert push_mod.ensure_canonical(store, ns, key, 1) is None
    assert not store.exists(push_mod.manifest_name(ns, key))
    # sweep_unreferenced drops a loser's .s manifest once a DIFFERENT
    # lineage is canonical (keeping the promote-gap case covered)
    orig = push_mod.PushWriter(store, ns, key,
                               pool=push_mod.BufferPool(1 << 20))
    orig.add(0, "k", [1])
    orig.finish()
    orig.close()
    _, referenced = push_mod.push_file_lists(store, ns, [key])
    push_mod.sweep_unreferenced(store, ns, referenced, [key])
    assert not store.exists(push_mod.manifest_name(ns, key, lin))


# --- satellite: SegmentReader parsed-footer cache ----------------------------

def test_footer_cache_purged_on_iteration_rollover():
    """Loop tasks reuse run/fragment names with NEW contents, and
    fixed-width records can reproduce the exact byte size — the
    engines' iteration-start cleanup purges the cache so a same-size
    rewrite can never serve a stale footer."""
    from lua_mapreduce_tpu_torch.core import segment
    from lua_mapreduce_tpu_torch.store.memfs import MemStore

    store = MemStore()

    def publish(keys):
        with segment.writer_for(store, "v2") as w:
            for k in keys:
                w.add(k, [0])
            w.build("r.P0.M00000001")

    publish([f"a{i:03d}" for i in range(50)])
    segment.SegmentReader(store, "r.P0.M00000001")      # cache fills
    publish([f"b{i:03d}" for i in range(50)])           # same byte size
    key = ("r.P0.M00000001", store.size("r.P0.M00000001"))
    assert key in store._jseg_footers                   # stale entry live
    segment.purge_footer_cache(store)                   # iteration hook
    assert key not in store._jseg_footers
    r = segment.SegmentReader(store, "r.P0.M00000001")
    assert [k for k, _ in r.iter_records()] == \
        [f"b{i:03d}" for i in range(50)]


# --- resume stickiness -------------------------------------------------------

def test_push_resume_sticky(tmp_path):
    """A resumed task keeps its push mode from the task doc (like the
    pipeline/replication rules): a crashed push run's data is visible
    only through manifests, which a push-off resume would never
    consult."""
    _install_module()
    spec = TaskSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                    reducefn=_MOD, init_args={"device": "cpu"},
                    storage=_storage(tmp_path, "mem", "resume"))
    store = MemJobStore()
    from lua_mapreduce_tpu_torch.core.constants import TaskStatus
    store.put_task({"_id": "unique", "status": TaskStatus.MAP.value,
                    "iteration": 1, "spec": spec.describe(),
                    "pipeline": False, "push": True, "batch_k": 1,
                    "segment_format": "v1", "replication": 1,
                    "speculation": 0.0})
    server = Server(store, poll_interval=0.01, push=False).configure(spec)
    w = Worker(store).configure(max_iter=800, max_sleep=0.02)
    t = threading.Thread(target=w.execute, daemon=True)
    t.start()
    server.loop()
    t.join(timeout=30)
    assert server.push is True, "resume must keep the task doc's push mode"
    got = {k: v[0] for k, v in iter_results(
        get_storage_from(spec.storage), "result")}
    assert got == GOLDEN


# --- cross-package checks ----------------------------------------------------

def _all_bytes(store):
    return {n: store.read_range(n, 0, store.size(n)) for n in store.list("*")}


def _push_one_map(writer_cls, pool_cls, store, replication, budget):
    """One map's output through a PushWriter: four partitions, enough
    records for several frames each under a small frame size."""
    w = writer_cls(store, "result", "00000004", replication=replication,
                   pool=pool_cls(budget), frame_bytes=4096)
    try:
        for part in range(4):
            for i in range(600):
                w.add(part, f"k{part}-{i:05d}", [i, f"v{i * 7 % 13}"])
        return w.finish()
    finally:
        w.close()


@pytest.mark.parametrize("replication", [1, 2, "4+1", "4+2"])
@pytest.mark.parametrize("budget", [1 << 20, 3000],
                         ids=["in-budget", "evicting"])
def test_push_files_byte_equal_to_jax(replication, budget):
    """The same map pushed by both packages publishes the same files —
    inbox frames, eviction tails, replica copies, stripe blocks, group
    stripes and the manifest — byte for byte."""
    from lua_mapreduce_tpu.engine import push as jax_push
    from lua_mapreduce_tpu.faults.coded import check_redundancy as jax_red
    from lua_mapreduce_tpu.store.memfs import MemStore as JaxMem
    from lua_mapreduce_tpu_torch.faults.coded import check_redundancy
    from lua_mapreduce_tpu_torch.store.memfs import MemStore

    jax_store, port_store = JaxMem(), MemStore()
    jax_man = _push_one_map(jax_push.PushWriter, jax_push.BufferPool,
                            jax_store, jax_red(replication), budget)
    port_man = _push_one_map(push_mod.PushWriter, push_mod.BufferPool,
                             port_store, check_redundancy(replication),
                             budget)
    assert port_man == jax_man
    want = _all_bytes(jax_store)
    assert len(want) > 4 and _all_bytes(port_store) == want
    if budget < 4096:
        assert any(n.endswith("T") or "T~" in n or "T^" in n
                   for n in want), "the small budget never evicted"


def _records_via(push, redundancy_of, reading_view, record_stream, store,
                 red):
    red = redundancy_of(red)
    view = reading_view(store, red)
    parts = push.discover_push(view, "result", ["00000004"],
                               replication=red)
    return {p: [rec for f in files for rec in record_stream(view, f)]
            for p, files in sorted(parts.items())}


@pytest.mark.parametrize("replication", [2, "4+2"])
def test_each_package_reads_the_others_push_files(tmp_path, replication):
    """Push files published by one package on ``shared:`` are discovered
    and read by the other's failover/decoding view, record for record,
    also with the primary copies (or a data block of every stripe)
    gone."""
    from lua_mapreduce_tpu.core.segment import record_stream as jax_rs
    from lua_mapreduce_tpu.engine import push as jax_push
    from lua_mapreduce_tpu.faults.coded import check_redundancy as jax_red
    from lua_mapreduce_tpu.faults.replicate import reading_view as jax_view
    from lua_mapreduce_tpu.store.router import get_storage_from as jax_get
    from lua_mapreduce_tpu_torch.core.segment import record_stream
    from lua_mapreduce_tpu_torch.faults.coded import check_redundancy
    from lua_mapreduce_tpu_torch.faults.replicate import reading_view

    want = {p: [(f"k{p}-{i:05d}", [i, f"v{i * 7 % 13}"])
                for i in range(600)] for p in range(4)}
    sides = {"jax": (jax_push, jax_red, jax_view, jax_rs, jax_get),
             "port": (push_mod, check_redundancy, reading_view,
                      record_stream, get_storage_from)}
    for writer, reader in (("jax", "port"), ("port", "jax")):
        wpush, wred, _, _, wget = sides[writer]
        root = f"shared:{tmp_path}/{writer}-{replication}"
        _push_one_map(wpush.PushWriter, wpush.BufferPool, wget(root),
                      wred(replication), 3000)
        rpush, rred, rview, rrs, rget = sides[reader]
        store = rget(root)
        assert _records_via(rpush, rred, rview, rrs, store,
                            replication) == want
        # lose the primaries (replication) or block 0 of every stripe
        for n in store.list("*"):
            if (n.startswith("result.P") and ".INBOX-" in n) or \
                    n.startswith("^0."):
                store.remove(n)
        assert _records_via(rpush, rred, rview, rrs, store,
                            replication) == want


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["barrier", "pipelined"])
@pytest.mark.parametrize("backend", ["mem", "shared", "object"])
def test_push_result_bytes_equal_jax(tmp_path, backend, pipeline):
    """The port's push run publishes the result files the JAX package's
    push run does, on every backend and shuffle mode."""
    from lua_mapreduce_tpu.engine.contract import TaskSpec as JaxSpec
    from lua_mapreduce_tpu.engine.local import LocalExecutor as JaxExecutor
    from lua_mapreduce_tpu.store.router import get_storage_from as jax_get

    _install_module()
    tag = f"pj-{backend}-{int(pipeline)}"
    jax_root = _storage(tmp_path, backend, tag + "-jax")
    JaxExecutor(JaxSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                        reducefn=_MOD, storage=jax_root),
                map_parallelism=3, pipeline=pipeline, premerge_min_runs=2,
                push=True).run()
    store = jax_get(jax_root)
    keep = re.compile(r"^result\.P\d+$")
    want = {n: "".join(store.lines(n)) for n in store.list("result.P*")
            if keep.match(n)}
    got, stats = _run_local(tmp_path, backend, pipeline, tag + "-port",
                            push=True)
    assert want and got == want
    assert stats.iterations[-1].push_frames > 0
