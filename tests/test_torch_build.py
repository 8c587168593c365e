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
