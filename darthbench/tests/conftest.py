"""Fixtures of the benchmark's own tests (CPU, tiny sizes).

``tiny_root`` is a copy of the benchmark (``BENCHMARK.json`` and
``darthbench/``) in a temporary directory, with one small configuration
of each index kind, a small backlog and a small open mix, and cells that
use them added as new files and entries: what a later change that adds a
cell would do.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest
import torch

# The tests run in several worker processes: a few threads each, or the
# workers' thread pools spin against each other on small ops.
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CELLS = ("tiny-ivf-backlog", "tiny-hnsw-backlog", "tiny-ivf-open")


def _tiny_config(src: dict, name: str) -> dict:
    cfg = json.loads(json.dumps(src))
    cfg["name"] = name
    cfg["data"].update(n=3000, dim=16, clusters=24, learn=480)
    if cfg["index"]["kind"] == "ivf":
        cfg["index"].update(nlist=24, nprobe=24, iters=4)
    else:
        cfg["index"].update(ef=24, max_steps=120, ef_construction=24)
        cfg["correct"]["attainable_recall"] = 0.5
    cfg["server"].update(num_slots=8, max_engine_steps=4000)
    cfg["correct"]["recall_sample"] = 512
    return cfg


def make_tiny_root(dest: pathlib.Path) -> pathlib.Path:
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "darthbench", dest / "darthbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = dest / "darthbench"
    man = json.loads((dest / "BENCHMARK.json").read_text())
    # Every configuration file of the benchmark, also one that no cell of
    # BENCHMARK.json runs yet: each index kind gets its tiny copy.
    by_kind = {}
    for f in sorted((ROOT / "darthbench" / "configs").glob("*.json")):
        cfg = json.loads(f.read_text())
        by_kind.setdefault(cfg["index"]["kind"], cfg)
    for kind, cfg in by_kind.items():
        name = f"tiny-{kind}"
        path = f"darthbench/configs/{name}.json"
        (dest / path).write_text(json.dumps(_tiny_config(cfg, name)))
        man["configs"].append({"name": name, "source": cfg["source"],
                               "file": path, "reduced": [],
                               "why": "a CPU test configuration"})
    backlog = json.loads((bench / "traffic" / "hard-backlog.json").read_text())
    backlog.update(queue_per_slot=2, pool_queues=2)
    (bench / "traffic" / "tiny-backlog.json").write_text(json.dumps(backlog))
    opn = json.loads((bench / "traffic" / "mixed-open.json").read_text())
    opn["rate_qps"] = 60
    (bench / "traffic" / "tiny-open.json").write_text(json.dumps(opn))
    for name, cfg, mix in (("tiny-ivf-backlog", "tiny-ivf", "tiny-backlog"),
                           ("tiny-hnsw-backlog", "tiny-hnsw", "tiny-backlog"),
                           ("tiny-ivf-open", "tiny-ivf", "tiny-open")):
        man["workloads"].append({"name": name, "config": cfg,
                                 "traffic": mix, "chips": 1,
                                 "why": "a CPU test cell"})
    kind_of = {"tiny-ivf-open": "open"}
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            split = m["name"].split(".", 1)
            for cell in TINY_CELLS:
                kind = kind_of.get(cell, "backlog")
                if len(split) == 1 or split[1] == kind:
                    if m["name"] == "qps" and kind != "backlog":
                        continue
                    if m["name"] == "latency_p95_ms" and kind != "open":
                        continue
                    m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> pathlib.Path:
    return make_tiny_root(tmp_path_factory.mktemp("bench"))
