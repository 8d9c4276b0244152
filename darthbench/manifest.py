"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration and a traffic mix; a metric is named in
``end_to_end`` or ``per_layer``. Each resolves to a file of its own under
the checkout root:

* a configuration: the ``file`` its entry in ``configs`` gives;
* a traffic mix: ``darthbench/traffic/<traffic>.json``;
* an index kind (a configuration's ``index.kind``):
  ``darthbench/indexes/<kind>.py``;
* a metric: ``darthbench/metrics/<name>.py``, or for a split metric
  ``<family>.<suffix>`` the family's ``darthbench/metrics/<family>.py``.

So a later cell, mix, index kind or metric is added by new files and new
manifest entries; no file that is there needs an edit.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from typing import Any, Callable, Dict, List, Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = "darthbench"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")

_MODULES: Dict[str, Any] = {}


def load(root: pathlib.Path = ROOT) -> Dict[str, Any]:
    with open(pathlib.Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    names = ", ".join(w["name"] for w in manifest["workloads"])
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (has: {names})")


def config(manifest: Dict[str, Any], cell_: Dict[str, Any],
           root: pathlib.Path = ROOT) -> Dict[str, Any]:
    for c in manifest["configs"]:
        if c["name"] == cell_["config"]:
            with open(pathlib.Path(root) / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {cell_['config']!r} in BENCHMARK.json")


def traffic(cell_: Dict[str, Any], root: pathlib.Path = ROOT
            ) -> Dict[str, Any]:
    path = pathlib.Path(root) / PACKAGE / "traffic" / f"{cell_['traffic']}.json"
    with open(path) as f:
        return json.load(f)


def applies(metric: Dict[str, Any], cell_name: str) -> bool:
    """Whether a metric entry is reported in this cell: every cell where
    the entry has no ``workloads`` key, else the cells it lists."""
    return "workloads" not in metric or cell_name in metric["workloads"]


def metrics_for(manifest: Dict[str, Any], cell_name: str,
                trace: bool) -> List[Dict[str, Any]]:
    """The cell's end-to-end metrics (trace off) or per-layer ones (on)."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if applies(m, cell_name)]


def _module(path: pathlib.Path):
    key = str(path.resolve())
    if key not in _MODULES:
        tag = re.sub(r"\W", "_", f"{path.parent.name}_{path.stem}")
        spec = importlib.util.spec_from_file_location(
            f"{PACKAGE}_{tag}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def reader(name: str, root: pathlib.Path = ROOT
           ) -> Callable[[Any, str], Optional[float]]:
    """``read(run, name)`` of metric ``name``: its own file, or its
    family's (the part before the first dot)."""
    base = pathlib.Path(root) / PACKAGE / "metrics"
    for stem in (name, name.split(".", 1)[0]):
        path = base / f"{stem}.py"
        if path.exists():
            return _module(path).read
    raise FileNotFoundError(f"no reader for metric {name!r} under {base}")


def index_kind(kind: str, root: pathlib.Path = ROOT):
    """The module that builds the program's index and engine of a kind."""
    path = pathlib.Path(root) / PACKAGE / "indexes" / f"{kind}.py"
    if not path.exists():
        raise FileNotFoundError(f"no index kind {kind!r}: {path} is missing")
    return _module(path)


def problems(manifest: Dict[str, Any]) -> List[str]:
    """What in the manifest breaks the naming rules (empty when sound)."""
    out = []
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    groups = {"configs": manifest["configs"],
              "workloads": manifest["workloads"], "metrics": metrics}
    for group, entries in groups.items():
        seen = set()
        for e in entries:
            if not NAME_RE.match(e["name"]):
                out.append(f"{group}: bad name {e['name']!r}")
            if e["name"] in seen:
                out.append(f"{group}: {e['name']!r} twice")
            seen.add(e["name"])
    for w in manifest["workloads"]:
        for key in ("config", "traffic"):
            if not NAME_RE.match(w[key]):
                out.append(f"workload {w['name']}: bad {key} {w[key]!r}")
    for c in manifest["configs"]:
        for key in c["reduced"]:
            if not NAME_RE.match(key):
                out.append(f"config {c['name']}: bad reduced key {key!r}")
    for m in metrics:
        if not UNIT_RE.match(m["unit"]):
            out.append(f"metric {m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"metric {m['name']}: better {m['better']!r}")
        if m["source"] not in SOURCES:
            out.append(f"metric {m['name']}: source {m['source']!r}")
    return out
