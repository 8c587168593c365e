"""The port's analysis CLI against the JAX package's.

``python -m lua_mapreduce_tpu_torch.analysis`` and ``python -m
lua_mapreduce_tpu.analysis`` run on the same fixtures: every command
(``lint``, ``deep``, ``conc``, ``protocol``, ``task``, ``rules``,
``callgraph``, ``all``) in every format it allows exits alike, and the
payloads are equal once paths and ``wall_s`` are taken out. The CLIs run
in this process (``main(argv)``); one run goes through ``python -m`` to
cover the module's entry point. The six CLI tests of the JAX package
(``tests/test_analysis.py``, ``test_deepcheck.py``,
``test_racecheck.py``) keep their names and assertions.
"""

import contextlib
import functools
import io
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from lua_mapreduce_tpu.analysis import __main__ as jax_cli
from lua_mapreduce_tpu_torch.analysis import __main__ as port_cli
from lua_mapreduce_tpu_torch.analysis import sarif

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(REPO, "lua_mapreduce_tpu_torch")
JAX_PKG = os.path.join(REPO, "lua_mapreduce_tpu")
CLIS = {"jax": jax_cli, "port": port_cli}
# the JAX stale-pragma test's protocol box (its seeded bug needs two
# workers, so at one it is reported missed), and a one-worker box whose
# seeded bug is re-found: the smallest boxes of the protocol suite
SMALL_BOX = ("--workers", "1", "--jobs", "1", "--batch-k", "1",
             "--seed-bug", "commit_skips_owner_cas")
FOUND_BOX = ("--workers", "1", "--jobs", "1", "--batch-k", "1",
             "--seed-bug", "scavenge_skips_lost_data")

ABBA = """\
    import threading

    class Pair:
        def __init__(self):
            self._a_lock = threading.Lock()
            self._b_lock = threading.Lock()

        def start(self):
            threading.Thread(target=self.ab, daemon=True).start()

        def ab(self):
            with self._a_lock:
                with self._b_lock:
                    pass

        def ba(self):
            with self._b_lock:
                with self._a_lock:
                    pass
    """

# findings for each pass: LMR005 (lint), a helper under a flock (deep),
# LMR028 (conc), and a stale pragma for the audit
FIXTURES = {
    "train/fx.py": """\
        def fine():
            return 1  # lmr: disable=LMR005

        def swallow():
            try:
                pass
            except BaseException:
                pass
        """,
    "coord/fx.py": """\
        import json, os, time

        class Idx:
            def claim(self):
                fd = self._open_locked()
                try:
                    return self._load_doc(fd)
                finally:
                    os.close(fd)

            def _load_doc(self, fd):
                doc = json.load(open('sidecar'))
                time.sleep(0.1)
                return doc
        """,
    "engine/fx.py": ABBA,
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_fixtures")
    for rel, src in FIXTURES.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return str(root)


@functools.lru_cache(maxsize=None)
def run(which, *argv):
    """(exit code, stdout, stderr) of one CLI's ``main(argv)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = CLIS[which].main(list(argv))
        except SystemExit as e:          # argparse's usage errors
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def both(*argv):
    """Both CLIs on ``argv``: equal exit codes; the port's run."""
    got, want = run("port", *argv), run("jax", *argv)
    assert got[0] == want[0], (got, want)
    return got, want


def _strip(value, roots):
    if isinstance(value, dict):
        return {k: _strip(v, roots) for k, v in value.items()
                if k != "wall_s"}
    if isinstance(value, list):
        return [_strip(v, roots) for v in value]
    if isinstance(value, str):
        for root in roots:
            value = value.replace(root, "<root>")
    return value


def same_json(got, want, *roots):
    a, b = json.loads(got[1]), json.loads(want[1])
    assert _strip(a, roots) == _strip(b, roots)
    return a


_SECONDS = re.compile(r"\b\d+(\.\d+)?s\b")


def same_text(got, want, *roots):
    a, b = got[1], want[1]
    for root in roots:
        a, b = a.replace(root, "<root>"), b.replace(root, "<root>")
    assert _SECONDS.sub("<s>", a) == _SECONDS.sub("<s>", b)


def same_sarif(got, want, *roots):
    doc = json.loads(got[1])
    sarif.validate_sarif(doc)
    assert _strip(doc["runs"][0]["results"], roots) == \
        _strip(json.loads(want[1])["runs"][0]["results"], roots)
    return doc


# --- the JAX package's six CLI tests ---------------------------------------

def test_cli_json_and_exit_codes(tmp_path):
    bad = tmp_path / "fx.py"
    bad.write_text("try:\n    pass\nexcept BaseException:\n    pass\n")
    got, want = both("lint", str(bad), "--fail-on-findings", "--format",
                     "json", "--baseline", "/nonexistent")
    assert got[0] == 1, got
    payload = same_json(got, want, str(tmp_path))
    assert payload["count"] == 1
    assert payload["findings"][0]["rule"] == "LMR005"
    got, _ = both("lint", str(bad), "--baseline", "/nonexistent")
    assert got[0] == 0
    # the catalog through the module's entry point
    r = subprocess.run(
        [sys.executable, "-m", "lua_mapreduce_tpu_torch.analysis", "rules"],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0 and "LMR001" in r.stdout


def test_cli_fail_on_stale_and_json_payload(tree):
    got, want = both("all", tree, "--fail-on-stale", "--format", "json",
                     "--baseline", "/nonexistent", *SMALL_BOX)
    assert got[0] == 1, got
    payload = same_json(got, want, tree)
    assert payload["stale_pragmas"][0]["rule"] == "LMR005"


def test_sarif_rejected_for_protocol():
    got, want = both("protocol", "--format", "sarif")
    assert got[0] == 2
    assert "sarif" in got[2] and "sarif" in want[2]


def test_task_cli_expect_verdicts():
    got, _ = both("task", "examples.wordcount", "--expect", "store-plane")
    assert got[0] == 0, got
    got, _ = both("task", "examples.wordcount", "--expect", "in-graph")
    assert got[0] == 1
    got, want = both("task", "examples.extsort.sorttask", "--expect",
                     "store-plane", "--expect-ingraph-fn", "--format",
                     "json")
    assert got[0] == 0, got
    payload = same_json(got, want, REPO)
    verdicts = {name: d["verdict"]
                for name, d in payload["tasks"][0]["functions"].items()}
    assert verdicts["reducefn"] == "in-graph"
    # the port's own copy of the task module gives the same verdicts
    own = run("port", "task",
                 "lua_mapreduce_tpu_torch.examples.extsort.sorttask",
                 "--expect", "store-plane", "--expect-ingraph-fn",
                 "--format", "json")
    assert own[0] == 0, own
    assert {n: d["verdict"] for n, d in json.loads(own[1])["tasks"][0][
        "functions"].items()} == verdicts


def test_cli_conc_gate_is_green_and_pins_the_seeded_races():
    got, want = both("conc", PORT_PKG, "--fail-on-findings", "--format",
                     "json")
    assert got[0] == 0, got
    payload = same_json(got, want, PORT_PKG)
    assert payload["count"] == 0
    conc = payload["conc"]
    assert conc["locks"] >= 20 and conc["spawn_sites"] >= 8
    assert conc["cycles"] == []
    assert conc["wall_s"] < 30.0
    seeded = {e["run"]: e["found"] for e in conc["seeded"]}
    assert seeded == {"seeded:dropped-lock-write": True,
                      "seeded:abba-deadlock": True}
    # the port's default paths are the port package
    default = run("port", "conc", "--fail-on-findings", "--format", "json")
    assert default[0] == 0
    assert _strip(json.loads(default[1]), ()) == _strip(payload, ())


def test_cli_conc_fails_on_a_raced_fixture_and_exports_sarif(tmp_path):
    p = tmp_path / "engine" / "fx.py"
    p.parent.mkdir(parents=True)
    p.write_text(textwrap.dedent(ABBA))
    got, _ = both("conc", str(tmp_path), "--fail-on-findings",
                  "--baseline", "/nonexistent")
    assert got[0] == 1, got
    assert "LMR028" in got[1]
    got, want = both("conc", str(tmp_path), "--format", "sarif",
                     "--baseline", "/nonexistent")
    assert got[0] == 0, got
    doc = same_sarif(got, want, str(tmp_path))
    assert any(res["ruleId"] == "LMR028"
               for res in doc["runs"][0]["results"])


# --- every command in every format it allows --------------------------------

MATRIX = [(cmd, fmt) for cmd in ("lint", "deep", "conc", "callgraph",
                                 "protocol", "all")
          for fmt in ("text", "json", "sarif")]


@pytest.mark.parametrize("cmd,fmt", MATRIX,
                         ids=[f"{c}-{f}" for c, f in MATRIX])
def test_command_parity_on_fixtures(tree, cmd, fmt):
    if cmd == "all":        # the stale-pragma test's run in each format
        args = ["all", tree, "--fail-on-stale", "--format", fmt,
                "--baseline", "/nonexistent", *SMALL_BOX]
    elif cmd == "protocol":
        args = ["protocol", "--format", fmt, *FOUND_BOX]
    else:
        args = [cmd, tree, "--format", fmt, "--baseline", "/nonexistent"]
        if cmd != "callgraph":
            args.append("--fail-on-findings")
    got, want = both(*args)
    if fmt == "sarif" and cmd not in ("lint", "deep", "conc"):
        assert got[0] == 2 and "sarif" in got[2]
        return
    if cmd in ("lint", "deep", "conc", "all"):
        assert got[0] == 1, got      # the fixtures' findings, a stale pragma
    else:
        assert got[0] == 0, got
    if fmt == "json":
        same_json(got, want, tree)
    elif fmt == "sarif":
        same_sarif(got, want, tree)
    else:
        same_text(got, want, tree)


@pytest.mark.parametrize("fmt", ["text", "json", "sarif"])
def test_task_parity_on_the_examples(fmt):
    specs = ("examples.wordcount", "examples.extsort.sorttask",
             "examples.loopsum", "no.such.module")
    got, want = both("task", *specs, "--format", fmt)
    assert got[0] == 1                   # no.such.module is invalid
    if fmt == "json":
        same_json(got, want, REPO)
    elif fmt == "sarif":
        same_sarif(got, want, REPO)
    else:
        same_text(got, want, REPO)


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_rules_parity(fmt):
    """The catalogs agree but for LMR007 and LMR017, which police the
    port's graph captures where the JAX package's police jit traces."""
    got, want = both("rules", "--format", fmt)
    assert got[0] == 0
    if fmt == "json":
        a, b = json.loads(got[1]), json.loads(want[1])
        assert [(r["id"], r["severity"]) for r in a] == \
            [(r["id"], r["severity"]) for r in b]
        assert [r for r in a if r["id"] not in ("LMR007", "LMR017")] == \
            [r for r in b if r["id"] not in ("LMR007", "LMR017")]
    else:
        keep = lambda out: [l for l in out.splitlines()    # noqa: E731
                            if not l.startswith(("LMR007", "LMR017"))
                            and "captur" not in l and "trace" not in l]
        assert keep(got[1]) == keep(want[1])


def test_usage_errors_exit_alike(tree):
    for argv in (("task",), ("lint", "--fail-on-stale"),
                 ("all", os.path.join(PORT_PKG, "engine"),
                  "--fail-on-stale"),
                 ("protocol", "--workers", "9")):
        got = run("port", *argv)
        want = run("jax", *[a.replace(PORT_PKG, JAX_PKG) for a in argv])
        assert got[0] == want[0] == 2, (argv, got, want)
