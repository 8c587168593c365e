"""SIGKILL churn of the port's multi-process pool ≡ the JAX package's
``tests/test_multiprocess_churn.py`` (:100, :205, :317): worker
processes over a FileJobStore run the Europarl-scale word count
(``examples/wordcount_big/bigtask``) while workers are SIGKILLed mid-map,
mid-reduce and mid-batch-lease, with and without a fault plan; the stale
requeue recovers every abandoned lease, no job FAILS, and the counts
equal a naive count. Each test runs twice: with the native C++ paths
(the native job index, and on ``shared:`` the native map and merges)
and with them off (``LMR_DISABLE_NATIVE=1`` in every process). The
stalled victims turn the native map/merge off for themselves, as the
JAX file's do: a native pass would bypass the stalled Python function.
Heavy-marked (run with ``--full``)."""

import os
import subprocess
import sys
import threading
import time
from collections import Counter

import pytest

from lua_mapreduce_tpu_torch import FileJobStore, Server, TaskSpec
from lua_mapreduce_tpu_torch.engine.local import iter_results
from lua_mapreduce_tpu_torch.store.router import get_storage_from

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SPLITS = 6
MOD = "examples.wordcount_big.bigtask"

pytestmark = [pytest.mark.heavy,
              pytest.mark.parametrize("native", [True, False],
                                      ids=["native", "python"])]


def _worker_code(coord, extra="", configure="max_iter=2000, max_sleep=0.05"):
    return (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"{extra}"
        "from lua_mapreduce_tpu_torch import FileJobStore, Worker\n"
        f"w = Worker(FileJobStore({coord!r})).configure({configure})\n"
        "w.execute()\n")


_STALL_MAP = (
    "import examples.wordcount_big.bigtask as bt\n"
    "import time\n"
    "def stall(k, v, emit):\n"
    "    print('CLAIMED', flush=True)\n"
    "    time.sleep(3600)\n"
    "bt.mapfn = stall\n"
    "import lua_mapreduce_tpu_torch.core.native_wcmap as nw\n"
    "nw.native_available = lambda: False\n")

_STALL_REDUCE = (
    "import examples.wordcount_big.bigtask as bt\n"
    "import time\n"
    "def stall(k, values):\n"
    "    print('RCLAIMED', flush=True)\n"
    "    time.sleep(3600)\n"
    "bt.reducefn = stall\n"
    "import lua_mapreduce_tpu_torch.core.native_merge as nm\n"
    "nm.native_available = lambda: False\n")

# batch-lease victim: the lease's first two map jobs run, the third
# wedges — the SIGKILL lands with executed-but-uncommitted jobs, a wedged
# one and an unstarted tail, each of which must return on its own
_STALL_MAP_MIDBATCH = (
    "import examples.wordcount_big.bigtask as bt\n"
    "import time\n"
    "_orig_mapfn = bt.mapfn\n"
    "_calls = [0]\n"
    "def stall(k, v, emit):\n"
    "    _calls[0] += 1\n"
    "    if _calls[0] >= 3:\n"
    "        print('CLAIMED', flush=True)\n"
    "        time.sleep(3600)\n"
    "    _orig_mapfn(k, v, emit)\n"
    "bt.mapfn = stall\n"
    "import lua_mapreduce_tpu_torch.core.native_wcmap as nw\n"
    "nw.native_available = lambda: False\n")


class _Pool:
    """The corpus, the task, the server's store and the spawned worker
    processes of one churn run."""

    def __init__(self, tmp_path, monkeypatch, native, storage, env=()):
        from examples.wordcount_big import corpus
        if not native:
            monkeypatch.setenv("LMR_DISABLE_NATIVE", "1")
        cdir = str(tmp_path / "corpus")
        corpus.build(cdir, n_splits=N_SPLITS)
        self.golden = Counter()
        for i in range(N_SPLITS):
            with open(corpus.split_path(cdir, i)) as f:
                self.golden.update(f.read().split())
        self.coord = str(tmp_path / "coord")
        self.store = FileJobStore(self.coord)
        self.storage = storage
        self.spec = TaskSpec(taskfn=MOD, mapfn=MOD, partitionfn=MOD,
                             reducefn=MOD,
                             init_args={"corpus_dir": cdir,
                                        "n_splits": N_SPLITS, "build": False,
                                        "device": "cpu"},
                             storage=storage)
        path = os.environ.get("PYTHONPATH", "")
        self.env = dict(os.environ, PYTHONPATH=REPO + (
            os.pathsep + path if path else ""), **dict(env))
        self.procs = []
        self._lock = threading.Lock()
        self._b_started = False

    def spawn(self, code, capture=False):
        p = subprocess.Popen(
            [sys.executable, "-c", code], env=self.env,
            stdout=subprocess.PIPE if capture else subprocess.DEVNULL,
            text=capture)
        self.procs.append(p)
        return p

    def once(self) -> bool:
        """True the first time only: wave B starts once, from the chaos
        thread or the watchdog."""
        with self._lock:
            if self._b_started:
                return False
            self._b_started = True
            return True

    def run(self, chaos, wave_b, **server_kw):
        t = threading.Thread(target=chaos, daemon=True)
        t.start()
        watchdog = threading.Timer(120, wave_b)   # victims wedged: still end
        watchdog.daemon = True
        watchdog.start()
        try:
            stats = Server(self.store, poll_interval=0.05,
                           **server_kw).configure(self.spec).loop()
        finally:
            watchdog.cancel()
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
            for p in self.procs:
                try:
                    p.wait(timeout=10)
                except Exception:
                    pass
        it = stats.iterations[-1]
        assert it.map.failed == 0 and it.reduce.failed == 0
        assert it.map.count == N_SPLITS
        got = {k: vs[0] for k, vs in
               iter_results(get_storage_from(self.storage), "result")}
        assert got == dict(self.golden)
        return stats


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["barrier", "pipelined"])
def test_nine_process_pool_survives_map_and_reduce_sigkill(
        tmp_path, monkeypatch, native, pipeline):
    """A map victim claims and stalls, is SIGKILLed; three map-only
    workers and a reduce victim start; the reduce victim claims, stalls,
    is SIGKILLed; four full workers finish. Nine worker processes on
    ``object:`` storage; the pipelined leg has pre_merge jobs live."""
    pool = _Pool(tmp_path, monkeypatch, native, f"object:{tmp_path}/obj")
    map_victim = pool.spawn(_worker_code(pool.coord, extra=_STALL_MAP),
                            capture=True)
    events = {}

    def wave_b():
        if not pool.once():
            return
        for p in (map_victim, events.get("rv")):
            if p is not None and p.poll() is None:
                p.kill()
        for _ in range(4):
            pool.spawn(_worker_code(pool.coord))

    def chaos():
        events["map"] = map_victim.stdout.readline().strip()
        time.sleep(0.2)
        map_victim.kill()
        for _ in range(3):
            pool.spawn(_worker_code(
                pool.coord, configure="max_iter=2000, max_sleep=0.05, "
                                      "phases=('map',)"))
        rv = pool.spawn(_worker_code(pool.coord, extra=_STALL_REDUCE),
                        capture=True)
        events["rv"] = rv
        events["reduce"] = rv.stdout.readline().strip()
        time.sleep(0.2)
        rv.kill()
        wave_b()

    pool.run(chaos, wave_b, stale_timeout_s=1.5, pipeline=pipeline,
             premerge_min_runs=2)
    assert events.get("map") == "CLAIMED", "map victim never claimed"
    assert events.get("reduce") == "RCLAIMED", "reduce victim never claimed"


def test_sigkill_churn_with_active_fault_plan_on_shared_store(
        tmp_path, monkeypatch, native):
    """SIGKILL churn and a seeded fault plan at once, on ``shared:``
    (where the native map and merges run): the stale requeue recovers
    the victim's lease, the retry layer absorbs every injected burst
    (max_per_key 2 < the retry budget), nothing FAILS."""
    plan = ("seed=19;transient=0.04;latency=0.03;error_after_write=0.2;"
            "latency_ms=1;max_per_key=2")
    monkeypatch.setenv("LMR_FAULT_PLAN", plan)
    pool = _Pool(tmp_path, monkeypatch, native, f"shared:{tmp_path}/spill",
                 env={"LMR_FAULT_PLAN": plan})
    victim = pool.spawn(_worker_code(pool.coord, extra=_STALL_MAP),
                        capture=True)

    def wave_b():
        if not pool.once():
            return
        if victim.poll() is None:
            victim.kill()
        for _ in range(3):
            # fast beats keep healthy leases fresh under injected latency
            # so the dead victim stays the only stale-requeue source
            pool.spawn(_worker_code(
                pool.coord, configure="max_iter=2000, max_sleep=0.05, "
                                      "heartbeat_s=0.25"))

    def chaos():
        victim.stdout.readline()        # CLAIMED
        time.sleep(0.2)
        wave_b()

    pool.run(chaos, wave_b, stale_timeout_s=2.5)
    assert any(d["repetitions"] > 0 for d in pool.store.jobs("map_jobs"))


def test_sigkill_mid_batch_lease_requeues_whole_lease(tmp_path, monkeypatch,
                                                      native):
    """A batch_k=8 worker leases the map jobs, runs two, wedges on the
    third and is SIGKILLed: every lease member returns to the pool on
    its own and a batched healthy pool re-runs them."""
    pool = _Pool(tmp_path, monkeypatch, native, f"object:{tmp_path}/obj")
    batch = ("max_iter=2000, max_sleep=0.05, batch_k=8, "
             "batch_lease_s=3600.0")
    victim = pool.spawn(_worker_code(pool.coord, extra=_STALL_MAP_MIDBATCH,
                                     configure=batch), capture=True)

    def wave_b():
        if not pool.once():
            return
        if victim.poll() is None:
            victim.kill()
        for _ in range(3):
            pool.spawn(_worker_code(pool.coord, configure=batch))

    def chaos():
        victim.stdout.readline()
        time.sleep(0.2)
        wave_b()

    pool.run(chaos, wave_b, stale_timeout_s=1.5, batch_k=8)
    assert any(d["repetitions"] > 0 for d in pool.store.jobs("map_jobs"))
