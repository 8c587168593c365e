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


PTXAS = """ptxas info    : Compiling entry function '_Z4goodv' for 'sm_90a'
ptxas info    : Function properties for _Z4goodv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z6spillsv' for 'sm_90a'
ptxas info    : Function properties for _Z6spillsv
    136 bytes stack frame, 128 bytes spill stores, 120 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas /tmp/x.ptx, line 9; warning : Potential Performance Loss: \
wgmma.mma_async instructions are serialized due to insufficient register \
resources for the wgmma pipeline in the function '_Z6serialv'
ptxas info    : Function properties for _Z6serialv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers
"""


def test_ptxas_functions_reads_registers_spills_and_serialisation():
    assert _build.ptxas_functions(PTXAS) == {
        "_Z4goodv": (168, 0, False), "_Z6spillsv": (168, 248, False),
        "_Z6serialv": (90, 0, True)}


def test_ptxas_serialisations_reads_each_reason():
    """Each serialised-wgmma notice's reason, by the function it names:
    C7512's (registers) and another (C7514's, accumulators read in
    flight) kept apart, so a gate can allow the one and not the
    other."""
    c7514 = ("ptxas info    : (C7514) Potential Performance Loss: "
             "wgmma.mma_async instructions are serialized due to non wgmma "
             "instructions reading accumulator registers of a wgmma between "
             "start and end of the pipeline stage in the function "
             "'_Z6serialv'\n")
    assert _build.ptxas_serialisations(PTXAS) == {"_Z6serialv": {
        "due to insufficient register resources for the wgmma pipeline"}}
    c7512 = ("ptxas info    : (C7512) Potential Performance Loss: "
             "wgmma.mma_async instructions are serialized due to "
             "insufficient register resources for the function "
             "'_Z6spillsv'\n")
    assert _build.ptxas_serialisations(c7512) == {
        "_Z6spillsv": {"due to insufficient register resources"}}
    got = _build.ptxas_serialisations(PTXAS + c7514)
    assert len(got["_Z6serialv"]) == 2
    assert any("reading accumulator registers" in x
               for x in got["_Z6serialv"])
    assert _build.ptxas_serialisations("") == {}


def test_each_library_keeps_its_ptxas_report(tmp_path, monkeypatch):
    """The build writes nvcc's output beside the library it made, so a
    later run that loads the library reads what ptxas said of it; a
    library without one is refused."""
    import sys
    fake = tmp_path / "nvcc"
    fake.write_text(f"""#!{sys.executable}
import sys
sys.stdout.write({PTXAS!r})
open(sys.argv[sys.argv.index("-o") + 1], "w").write("not a library")
""")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    (tmp_path / "kernels").mkdir()
    target = _build._target("flash")
    _build._compile({"flash": target})
    assert target.exists()
    assert _build.ptxas_log("flash") == PTXAS
    assert sorted(p.name for p in (tmp_path / "kernels").iterdir()) == \
        sorted([target.name, target.with_suffix(".ptxas.txt").name])
    target.with_suffix(".ptxas.txt").unlink()
    with pytest.raises(RuntimeError, match="no ptxas report"):
        _build.ptxas_log("flash")
