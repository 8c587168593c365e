"""The port's CLI launchers (cli/execute_server, cli/execute_worker,
cli/remove_results): counterparts of tests/test_cli.py (not its v2
segment and LM tests), driven in-process and, through the word-count
example's shell scripts, as processes. Every flag of the JAX launchers
for a plane the port does not run yet parses and raises."""

import glob
import json
import os
import subprocess

import pytest

from examples.wordcount.naive import naive_wordcount
from lua_mapreduce_tpu_torch.cli import (execute_server, execute_worker,
                                         remove_results)
from lua_mapreduce_tpu_torch.core.serialize import load_record
from lua_mapreduce_tpu_torch.store.router import get_storage_from

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = sorted(glob.glob(os.path.join(REPO, "examples", "wordcount",
                                       "[a-z]*.py")))
SCRIPTS = os.path.join(REPO, "lua_mapreduce_tpu_torch", "examples",
                       "wordcount")


def _server_args(*extra):
    return ["mem",
            "examples/wordcount/taskfn.py",
            "examples/wordcount/mapfn",
            "examples.wordcount.partitionfn",
            "examples.wordcount.reducefn",
            "--finalfn", "examples.wordcount.finalfn",
            "--inline-workers", "2",
            "--poll", "0.02",
            "--init-arg", f"files={os.pathsep.join(CORPUS)}",
            "--init-arg", "device=cpu",
            "--quiet", *extra]


def test_execute_server_inline_workers():
    """Full word count through the server CLI with an in-process pool,
    slash-path module normalization included (execute_server.lua:37-39)."""
    import examples.wordcount.finalfn as finalfn
    finalfn.counts.clear()
    assert execute_server.main(_server_args()) == 0
    assert dict(finalfn.counts) == naive_wordcount(CORPUS)


def test_execute_server_batched_inline_workers():
    import examples.wordcount.finalfn as finalfn
    finalfn.counts.clear()
    assert execute_server.main(_server_args("--batch-k", "4")) == 0
    assert dict(finalfn.counts) == naive_wordcount(CORPUS)


def test_execute_worker_rejects_bad_phase():
    with pytest.raises(SystemExit):
        execute_worker.main(["/tmp/nowhere", "--phases", "bogus"])


def test_execute_server_strict_flag_parses():
    args = execute_server.build_parser().parse_args(
        ["mem", "a", "b", "c", "d", "--strict"])
    assert args.strict is True


def test_batch_k_flags_parse():
    """The server flag is the fleet default (task doc), the worker flag
    an explicit override (None = follow the doc)."""
    args = execute_server.build_parser().parse_args(
        ["mem", "a", "b", "c", "d", "--batch-k", "16"])
    assert args.batch_k == 16
    args = execute_worker.build_parser().parse_args(["/tmp/x"])
    assert args.batch_k is None and args.max_jobs is None
    args = execute_worker.build_parser().parse_args(
        ["/tmp/x", "--batch-k", "8", "--max-jobs", "40"])
    assert args.batch_k == 8 and args.max_jobs == 40


def test_remove_results_drops_store_and_files(tmp_path):
    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
    from lua_mapreduce_tpu_torch.coord.jobstore import make_job
    coord, spill = str(tmp_path / "coord"), str(tmp_path / "spill")
    store = FileJobStore(coord)
    store.insert_jobs("map_jobs", [make_job("k", 1)])
    store.put_task({"_id": "unique", "status": "MAP", "spec": {}})
    data = get_storage_from(f"shared:{spill}")
    b = data.builder()
    b.write("x\n")
    b.build("result.P0")
    assert remove_results.main([coord, "--storage", f"shared:{spill}",
                                "--yes"]) == 0
    assert store.get_task() is None
    assert sum(store.counts("map_jobs").values()) == 0
    assert data.list("result.P*") == []


def test_remove_results_aborts_without_confirmation(tmp_path, monkeypatch):
    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
    monkeypatch.setattr("builtins.input", lambda *_: "n")
    coord = str(tmp_path / "coord")
    FileJobStore(coord).put_task({"_id": "unique", "status": "MAP",
                                  "spec": {}})
    assert remove_results.main([coord]) == 1
    assert FileJobStore(coord).get_task() is not None


def _set_value(kw):
    """A command-line value that is not the flag's default (or off)."""
    if kw.get("action") == "store_true":
        return []
    if "choices" in kw:
        return [next(c for c in kw["choices"] if c != kw["default"])]
    return {int: ["3"], float: ["2.5"]}.get(kw.get("type"), ["x"])


# flags of the JAX launchers the port runs: each parses and is accepted
_PORTED_SERVER = (
    ("--pipeline", dict(action="store_true")),
    ("--premerge-min-runs", dict(type=int, default=4)),
    ("--premerge-max-runs", dict(type=int, default=8)),
    ("--segment-format", dict(choices=("v1", "v2"), default="v1")),
    ("--replication", dict(type=int, default=None)),
    ("--coding", dict(type=str, default=None)),
    ("--push", dict(action="store_true", default=None)),
    ("--push-budget-mb", dict(type=float, default=None)),
    ("--store-retries", dict(type=int, default=None)),
    ("--retry-base-ms", dict(type=float, default=None)),
    ("--trace", dict(action="store_true")),
    ("--profile", dict(default=None)),
    ("--speculation-factor", dict(type=float, default=None)),
    ("--speculation-cap", dict(type=int, default=2)),
)
_PORTED_WORKER = (
    ("--segment-format", dict(choices=("v1", "v2"), default=None)),
    ("--replication", dict(type=int, default=None)),
    ("--coding", dict(type=str, default=None)),
    ("--push", dict(action="store_true", default=None)),
    ("--push-budget-mb", dict(type=float, default=None)),
    ("--store-retries", dict(type=int, default=None)),
    ("--retry-base-ms", dict(type=float, default=None)),
    ("--trace", dict(action="store_true")),
    ("--profile", dict(default=None)),
)


def _check_ported(module, flag, args):
    p = module.build_parser()
    ns = p.parse_args(args)
    module.reject_trimmed(p, ns, module.TRIMMED)
    assert getattr(ns, execute_server._dest(flag)) != \
        p.get_default(execute_server._dest(flag))


@pytest.mark.parametrize("flag,kw", [(f, kw) for f, kw, *_ in
                                     execute_server.TRIMMED],
                         ids=[f for f, *_ in execute_server.TRIMMED])
def test_every_trimmed_server_flag_raises(flag, kw):
    with pytest.raises(NotImplementedError, match=f"{flag}.*A6b"):
        execute_server.main(["mem", "a", "b", "c", "d", flag,
                             *_set_value(kw)])


@pytest.mark.parametrize("flag,kw", _PORTED_SERVER,
                         ids=[f for f, _ in _PORTED_SERVER])
def test_every_ported_server_flag_is_accepted(flag, kw):
    _check_ported(execute_server, flag,
                  ["mem", "a", "b", "c", "d", flag, *_set_value(kw)])


@pytest.mark.parametrize("flag,kw", [(f, kw) for f, kw, *_ in
                                     execute_worker.TRIMMED],
                         ids=[f for f, *_ in execute_worker.TRIMMED])
def test_every_trimmed_worker_flag_raises(flag, kw, tmp_path):
    with pytest.raises(NotImplementedError, match=f"{flag}.*A6b"):
        execute_worker.main([str(tmp_path), flag, *_set_value(kw)])


@pytest.mark.parametrize("flag,kw", _PORTED_WORKER,
                         ids=[f for f, _ in _PORTED_WORKER])
def test_every_ported_worker_flag_is_accepted(flag, kw, tmp_path):
    _check_ported(execute_worker, flag,
                  [str(tmp_path), flag, *_set_value(kw)])


def test_trimmed_flags_at_their_off_value_pass():
    p = execute_server.build_parser()
    args = p.parse_args(["mem", "a", "b", "c", "d", "--replication", "1",
                         "--speculation-factor", "0"])
    execute_server.reject_trimmed(p, args, execute_server.TRIMMED)


def test_example_scripts_run_a_process_pool(tmp_path):
    """BASELINE config 1 through the port's CLI as processes: the word
    count example's server script and one worker process from its
    worker script over a shared coordination directory (the task on the
    CPU); the result files hold the naive count, and the worker's report
    names its jobs."""
    coord = str(tmp_path / "coord")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    report = str(tmp_path / "worker.json")
    worker = subprocess.Popen(
        ["sh", os.path.join(SCRIPTS, "execute_example_worker.sh"), coord,
         "--max-sleep", "0.05", "--max-iter", "600", "--report", report],
        cwd=REPO, env=env)
    try:
        out = subprocess.run(
            ["sh", os.path.join(SCRIPTS, "execute_example_server.sh"), coord,
             "--poll", "0.02", "--quiet", "--init-arg", "device=cpu"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        assert worker.wait(timeout=60) == 0
    finally:
        worker.kill()
    spill = get_storage_from(f"shared:{coord}/spill")
    got = {}
    for name in spill.list("result.P*"):
        for line in spill.lines(name):
            if line.strip():
                k, v = load_record(line.strip())
                got[k] = v[0]
    files = sorted(glob.glob(os.path.join(REPO, "examples", "wordcount",
                                          "*.py")))
    assert got == naive_wordcount(files)
    rep = json.load(open(report))
    assert rep["jobs"] >= len(files) and rep["rounds"]["commit"] > 0
    assert set(rep["launches"]) and not any(rep["launches"].values())
