"""BENCHMARK.json keeps the naming rules, and every name it gives resolves
to a file; a new configuration, traffic mix or metric is found by adding
files and manifest entries alone."""
import hashlib
import json
import pathlib

import pytest

from darthbench import manifest

ROOT = pathlib.Path(__file__).resolve().parents[2]
MAN = manifest.load(ROOT)
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_manifest_keeps_the_naming_rules():
    assert set(MAN) == TOP_KEYS
    assert manifest.problems(MAN) == []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    text = [c["source"] for c in MAN["configs"]] + [
        e["why"] for e in MAN["configs"] + MAN["workloads"]] + [
        m["layer"] for m in MAN["per_layer"]] + MAN["command"]
    for t in text:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    names = {m["name"] for m in MAN["per_layer"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", ()):
            assert manifest.applies(e2e[m["moves"]], w)
    for w in MAN["workloads"]:
        assert len(manifest.metrics_for(MAN, w["name"], False)) >= 2
        assert manifest.metrics_for(MAN, w["name"], True)
    assert len(names) == len(MAN["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_name_of_a_cell_resolves_to_a_file(cell):
    w = manifest.cell(MAN, cell)
    cfg = manifest.config(MAN, w, ROOT)
    assert cfg["name"] == w["config"]
    assert manifest.traffic(w, ROOT)["kind"] in ("backlog", "open")
    assert callable(manifest.index_kind(cfg["index"]["kind"], ROOT).build)
    for trace in (False, True):
        for m in manifest.metrics_for(MAN, cell, trace):
            assert callable(manifest.reader(m["name"], ROOT))


def _digests(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted((root / "darthbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts
            and "tests" not in p.parts}


def test_new_config_traffic_and_metric_are_found_by_new_files(tmp_path):
    from darthbench.tests.conftest import make_tiny_root

    root = make_tiny_root(tmp_path)
    before = _digests(ROOT)
    after = _digests(root)
    for name, digest in before.items():
        assert after[name] == digest, f"{name} was edited"
    (root / "darthbench" / "metrics" / "probe_share.py").write_text(
        "def read(run, name):\n    return 42.0\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "probe_share.backlog", "unit": "%",
                             "better": "higher", "source": "device_trace",
                             "layer": "kernels", "moves": "qps",
                             "workloads": ["tiny-ivf-backlog"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    man = manifest.load(root)
    assert manifest.problems(man) == []
    cell = manifest.cell(man, "tiny-hnsw-backlog")
    assert manifest.config(man, cell, root)["index"]["kind"] == "hnsw"
    assert manifest.traffic(cell, root)["queue_per_slot"] == 2
    names = [m["name"] for m in manifest.metrics_for(man, "tiny-ivf-backlog",
                                                     True)]
    assert "probe_share.backlog" in names
    assert manifest.reader("probe_share.backlog", root)(None, "") == 42.0
    # a split metric without a file of its own reads through its family's
    assert manifest.reader("device_idle.open", root).__module__.endswith(
        "device_idle")


def test_names_outside_the_rules_are_reported():
    bad = json.loads(json.dumps(MAN))
    bad["workloads"][0]["name"] = "has space"
    bad["end_to_end"][0]["unit"] = "tokens per second"
    bad["per_layer"][0]["better"] = "more"
    found = manifest.problems(bad)
    assert len(found) == 3
