"""The sanitized run of ``test_torch_racecheck``, called by the port's
lock-order sanitizer in a child process::

    python lua_mapreduce_tpu_torch/utils/lockcheck.py REPORT \\
        torch_lockcheck_child:run ROOT

The sanitizer is installed before this module, and with it the port
package, is imported. ``run`` drives a small digits DP-SGD task through
a ``Server`` on a ``MemJobStore`` with two in-process workers, on
``shared:`` spill, pipelined, with speculation, the HA leader lease and
notify wakeups, on the CPU. Torch only: it never imports JAX.
"""

import threading

DIGITS = "lua_mapreduce_tpu_torch.examples.digits.mr_train"
ARGS = {"sizes": [32, 16, 10], "n_shards": 4, "bunch": 16, "max_steps": 3,
        "patience": 99, "seed": 4, "device": "cpu"}
ITERATIONS = 3


def spec(root):
    from lua_mapreduce_tpu_torch import TaskSpec
    return TaskSpec(**{f: DIGITS for f in ("taskfn", "mapfn", "partitionfn",
                                           "reducefn", "finalfn")},
                    init_args={**ARGS, "model_store": f"shared:{root}/model"},
                    storage=f"shared:{root}/spill")


def run(argv):
    """The pool over ``argv[0]``: the iterations, the map bodies and the
    threads started, by target."""
    from lua_mapreduce_tpu_torch import MemJobStore, Server, Worker
    started = {}
    real_start = threading.Thread.start

    def start(thread):
        name = getattr(thread._target, "__qualname__", None) or str(
            thread._target)
        started[name] = started.get(name, 0) + 1
        return real_start(thread)

    threading.Thread.start = start
    try:
        store = MemJobStore()
        server = Server(store, poll_interval=0.02, pipeline=True,
                        speculation=3.0, ha=True).configure(spec(argv[0]))
        workers = [Worker(store).configure(max_iter=2000, max_sleep=0.05)
                   for _ in range(2)]
        threads = [threading.Thread(target=w.execute, daemon=True)
                   for w in workers]
        for t in threads:
            t.start()
        stats = server.loop()
        for t in threads:
            t.join(timeout=60)
    finally:
        threading.Thread.start = real_start
    return {"iterations": len(stats.iterations),
            "bodies": sum(w.bodies.get("map", 0) for w in workers),
            "alive": sum(t.is_alive() for t in threads),
            "threads": started}
