"""Cross-host pools on the port ≡ the JAX package's
``tests/test_distributed.py:271``: two disjoint worker pools, mappers
and a reducer with separate scratch directories and restricted phases,
exchange intermediate data only through the ``object:`` store; the
reduce job documents name their producers."""

import glob
import os
import subprocess
import sys

import pytest

from examples.wordcount.naive import naive_wordcount
from lua_mapreduce_tpu_torch import FileJobStore, Server, TaskSpec
from lua_mapreduce_tpu_torch.engine.worker import MAP_NS, RED_NS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = sorted(glob.glob(os.path.join(REPO, "examples", "wordcount",
                                       "*.py")))


@pytest.mark.heavy
def test_cross_host_pools_exchange_only_via_object_store(tmp_path):
    root = str(tmp_path / "coord")
    bucket = str(tmp_path / "bucket")
    store = FileJobStore(root)

    def pool_code(host: str, phases: str, scratch: str) -> str:
        return (
            "import os, tempfile\n"
            f"os.makedirs({scratch!r}, exist_ok=True)\n"
            f"tempfile.tempdir = {scratch!r}\n"   # host-local scratch
            "from lua_mapreduce_tpu_torch import FileJobStore, Worker\n"
            f"w = Worker(FileJobStore({root!r}), name={host!r}).configure(\n"
            f"    max_iter=300, max_sleep=0.05, phases=({phases!r},))\n"
            "w.execute()\n")
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path
                                              if path else ""))
    procs = [subprocess.Popen([sys.executable, "-c",
                               pool_code(host, phases,
                                         str(tmp_path / scratch))], env=env)
             for host, phases, scratch in (("mapper-a", "map", "hostA"),
                                           ("mapper-b", "map", "hostB"),
                                           ("reducer-c", "reduce", "hostC"))]
    try:
        spec = TaskSpec(taskfn="examples.wordcount.taskfn",
                        mapfn="examples.wordcount.mapfn",
                        partitionfn="examples.wordcount.partitionfn",
                        reducefn="examples.wordcount.reducefn",
                        combinerfn="examples.wordcount.reducefn",
                        init_args={"files": CORPUS, "device": "cpu"},
                        storage=f"object:{bucket}")
        stats = Server(store, poll_interval=0.05).configure(spec).loop()
    finally:
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
    from lua_mapreduce_tpu_torch.engine.local import iter_results
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    got = {k: v[0] for k, v in iter_results(
        get_storage_from(f"object:{bucket}"), "result")}
    assert got == naive_wordcount(CORPUS)
    it = stats.iterations[-1]
    assert it.map.failed == 0 and it.reduce.failed == 0
    assert {d["worker"] for d in store.jobs(MAP_NS)} <= {"mapper-a",
                                                        "mapper-b"}
    assert {d["worker"] for d in store.jobs(RED_NS)} == {"reducer-c"}
    for doc in store.jobs(RED_NS):
        assert doc["value"]["mappers"]
        assert set(doc["value"]["mappers"]) <= {"mapper-a", "mapper-b"}
