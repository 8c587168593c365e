"""The kernel build's cache key: each library's name carries a hash of
its source, every shared header in ``csrc`` and the nvcc flags, so an
edited header rebuilds the libraries. No ``nvcc`` is needed: the test
reads target names only."""

import re
import shutil

import pytest

from lua_mapreduce_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    return dst


def test_sources_and_headers_exist():
    for src in _build.SOURCES.values():
        assert (_build.CSRC / src).is_file()
    assert (_build.CSRC / "gemm_sm90.cuh").is_file()


@pytest.mark.parametrize("name", ["matmul", "q8"])
def test_copy_of_csrc_keeps_the_target(csrc_copy, name):
    assert _build._target(name, csrc_copy) == _build._target(name)


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_edited_header_changes_every_target(csrc_copy, name):
    before = _build._target(name, csrc_copy)
    header = csrc_copy / "gemm_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build._target(name, csrc_copy)
    assert after != before
    assert after.name.startswith(f"lmr_{name}-")


def test_new_header_changes_the_target(csrc_copy):
    before = _build._target("matmul", csrc_copy)
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build._target("matmul", csrc_copy) != before


def test_edited_source_changes_only_its_target(csrc_copy):
    before = {n: _build._target(n, csrc_copy) for n in _build.SOURCES}
    src = csrc_copy / _build.SOURCES["pool"]
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: _build._target(n, csrc_copy) for n in _build.SOURCES}
    assert after["pool"] != before["pool"]
    assert {n: t for n, t in after.items() if n != "pool"} == \
        {n: t for n, t in before.items() if n != "pool"}


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_every_entry_point_has_a_signature(name):
    """Each function of a source's ``extern "C"`` block is bound with its
    argument types (``lmr_error_string``, common to all, is bound by
    ``_load`` itself): ctypes would pass an unbound pointer argument as a
    32-bit int."""
    text = (_build.CSRC / _build.SOURCES[name]).read_text()
    block = text[text.index('extern "C" {'):]
    entries = set(re.findall(r"^\w[\w\s\*]*?\b(lmr_\w+)\(", block, re.M))
    assert "lmr_error_string" in entries
    assert entries - {"lmr_error_string"} == set(_build._SIGNATURES[name])


FAKE_NVCC = """#!{python}
import os, sys, time
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(sys.argv[-1] + "\\n")
time.sleep(1.0)
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "w") as f:
    f.write("not a library")
"""

BUILD_IN_PROCESS = """
import sys
from pathlib import Path
from lua_mapreduce_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
targets = _build._build_missing()
print(sorted(_build.BUILD_REPORT["built"]), flush=True)
assert all(t.exists() for t in targets.values())
"""


def test_cold_processes_build_once(tmp_path):
    """Two cold processes build together: the flock on the build
    directory lets one run nvcc (a fake here, one line per source to a
    log) while the other waits and finds every library built."""
    import os
    import subprocess
    import sys

    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}",
               FAKE_NVCC_LOG=str(log),
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                           ""))
    build_dir = tmp_path / "kernels"
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_IN_PROCESS,
                               str(build_dir)], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    compiled = log.read_text().split()
    assert sorted(compiled) == sorted(str(_build.CSRC / s)
                                      for s in _build.SOURCES.values())
    assert sorted(o.strip() for o in outs) == \
        sorted(["[]", str(sorted(_build.SOURCES))])
    assert sorted(p.name for p in build_dir.glob("*.so")) == \
        sorted(_build._target(n).name for n in _build.SOURCES)


def test_warm_build_takes_no_lock(tmp_path, monkeypatch):
    """With every library present nothing is compiled and no lock file
    is made (a warm process pays one stat per source)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    for name in _build.SOURCES:
        _build._target(name).write_text("built")
    targets = _build._build_missing()
    assert _build.BUILD_REPORT["built"] == []
    assert set(targets) == set(_build.SOURCES)
    assert not (tmp_path / ".build.lock").exists()
