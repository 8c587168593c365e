"""SARIF 2.1.0 export for lint/deep/contract findings.

SARIF (Static Analysis Results Interchange Format) is the one shape
both CI annotators (GitHub code scanning) and editors (the SARIF viewer
extensions) already speak — emitting it means file:line findings land
as inline annotations with zero glue code.  This is the minimal valid
subset: one run, one driver, the full rule catalog (so viewers can show
the rationale for an id), one result per finding.

Copy of the JAX package's ``analysis/sarif.py``: :func:`to_sarif` over
any findings list, and ``python -m lua_mapreduce_tpu_torch.analysis
lint --format sarif`` et al.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

from lua_mapreduce_tpu_torch.analysis.lint import Finding, rule_catalog

SARIF_VERSION = "2.1.0"
_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
           "master/Schemata/sarif-schema-2.1.0.json")

_LEVELS = {"error": "error", "warning": "warning"}


def to_sarif(findings: Sequence[Finding],
             tool_name: str = "lmr-analyze") -> Dict:
    """Findings -> a SARIF 2.1.0 log dict (json.dumps-ready)."""
    rules = [{
        "id": r["id"],
        "shortDescription": {"text": r["title"]},
        "fullDescription": {"text": r["rationale"]},
        "defaultConfiguration": {
            "level": _LEVELS.get(r["severity"], "warning")},
    } for r in rule_catalog()]
    index = {r["id"]: i for i, r in enumerate(rules)}
    known = set(index)
    results: List[Dict] = []
    for f in findings:
        res = {
            "ruleId": f.rule,
            "level": _LEVELS.get(f.severity, "warning"),
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": max(1, f.line),
                               "startColumn": max(1, f.col + 1)},
                },
            }],
        }
        if f.rule in known:
            res["ruleIndex"] = index[f.rule]
        results.append(res)
    return {
        "$schema": _SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": tool_name,
                "informationUri":
                    "https://example.invalid/lua_mapreduce_tpu",
                "rules": rules,
            }},
            "results": results,
        }],
    }


def format_sarif(findings: Sequence[Finding]) -> str:
    return json.dumps(to_sarif(findings), indent=2)


def validate_sarif(doc: Dict) -> None:
    """Shape assertions over the subset we emit — the export test's
    oracle (mirrors trace/collect.py's validate_chrome role)."""
    assert doc["version"] == SARIF_VERSION
    assert isinstance(doc["runs"], list) and len(doc["runs"]) == 1
    run = doc["runs"][0]
    driver = run["tool"]["driver"]
    assert driver["name"]
    ids = [r["id"] for r in driver["rules"]]
    assert ids == sorted(ids) and len(ids) == len(set(ids))
    for res in run["results"]:
        assert res["level"] in ("error", "warning", "note")
        assert res["message"]["text"]
        loc = res["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"]
        assert loc["region"]["startLine"] >= 1
        if "ruleIndex" in res:
            assert driver["rules"][res["ruleIndex"]]["id"] == res["ruleId"]


def utest() -> None:
    fs = [Finding("LMR005", "error", "train/x.py", 7, 4, "swallowed"),
          Finding("LMR013", "error", "coord/y.py", 3, 0, "deep IO"),
          Finding("LMR022", "error", "task.py", 0, 0, "emit arity")]
    doc = to_sarif(fs)
    validate_sarif(doc)
    assert len(doc["runs"][0]["results"]) == 3
    # zero-line module findings clamp into SARIF's 1-based regions
    assert doc["runs"][0]["results"][2]["locations"][0][
        "physicalLocation"]["region"]["startLine"] == 1
    # catalog covers per-function, deep, and contract bands
    ids = {r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]}
    assert {"LMR001", "LMR013", "LMR020"} <= ids
    json.loads(format_sarif(fs))        # round-trips as JSON
