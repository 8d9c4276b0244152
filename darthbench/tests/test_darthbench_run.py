"""A tiny cell end to end on the CPU, traced and not, and the shape of the
result line; the command refuses to run without a card or without the
program."""
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

from darthbench import bench, manifest, run

ROOT = pathlib.Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["tiny-ivf-backlog", "tiny-hnsw-backlog",
                                  "tiny-ivf-open"])
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_end_to_end_on_the_cpu(tiny_root, cell, traced, capsys):
    result = bench.execute(tiny_root, cell, 2**31 + 7, 1.5, traced, "cpu",
                           time.time())
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert set(result) <= set(KEYS) | {"breakdown", "checks"}
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    man = manifest.load(tiny_root)
    wanted = {m["name"] for m in manifest.metrics_for(man, cell, traced)}
    assert set(result["metrics"]) <= wanted
    if not traced:
        assert set(result["metrics"]) == wanted
    else:
        assert {"build_s", "fit_s"} <= set(result["metrics"])
    for v in result["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert set(result["checks"]) == {"missing", "bad_rows", "dist_gap",
                                     "recall_short"}
    run.report(result)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert [line.split()[1] for line in tail] == list(result["checks"])


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "darthbench/run.py", "--workload",
         "ivf1024-hard-backlog", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_without_a_card_the_command_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_with_only_the_benchmark_files_the_command_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "darthbench", tmp_path / "darthbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _cli(tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
