"""The port's static gate (``repro_torch.analysis``) on the CPU.

Pure unit tests of the pad lint (synthetic sources, every flagged torch
form and every unflagged one) and of the recorder; each known-bad corpus
module detected with a file:line inside its own file; the gate over the
real tree and every registered entry point giving zero findings, in
process and through the CLI; and the host-sync limits equal to what the
serving loop makes at hosts 1 and 2. Imports no JAX.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the test lane runs six workers on a few cores.
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.analysis import (audits, corpus, manifest,  # noqa: E402
                                  padlint, runner)
from repro_torch.analysis.__main__ import _detect  # noqa: E402
from repro_torch.analysis.findings import (Finding,  # noqa: E402
                                           format_findings)
from repro_torch.analysis.registry import entry_points  # noqa: E402

SRC = runner.SRC_ROOT
CPU = torch.device("cpu")


def test_finding_location_and_format():
    f = Finding("p", "e", "msg", file="a/b.py", line=7)
    assert f.location() == "a/b.py:7"
    assert Finding("p", "e", "msg").location() == "e"
    assert Finding("p", "e", "msg", file="a/b.py").location() == "a/b.py"
    out = format_findings([f, Finding("q", "tree", "other")])
    assert out.splitlines()[0] == "a/b.py:7: [p/e] msg"
    assert out.splitlines()[1] == "tree: [q/tree] other"
    assert f.to_dict() == {"pass_name": "p", "entry": "e", "message": "msg",
                           "file": "a/b.py", "line": 7}


# -- pad-convention ----------------------------------------------------------

FLAGGED = {
    "torch.full": "a = torch.full((4,), -1, dtype=torch.int32)",
    "full fill_value=": "a = torch.full((4,), fill_value=float('inf'))",
    "np.full": "a = np.full((4,), -1, np.int64)",
    "full_like": "a = torch.full_like(x, math.inf)",
    "new_full": "a = x.new_full((4,), -1)",
    "fill_": "x.fill_(torch.inf)",
    "masked_fill": "a = x.masked_fill(x > 0, -1)",
    "masked_fill_": "x.masked_fill_(x > 0, value=np.inf)",
    "index_fill": "a = x.index_fill(0, i, -1)",
    "index_fill_": "x.index_fill_(0, i, float('inf'))",
    "where 2nd": "a = torch.where(x > 0, -1, x)",
    "where 3rd": "a = torch.where(x > 0, x, float('+inf'))",
    "F.pad": "a = F.pad(x, (0, 2), value=float('inf'))",
    "np.pad": "a = np.pad(x, 2, constant_values=np.inf)",
    "subscript": "x[i] = -1",
    "subscript inf": "x[i, 0] = math.inf",
}
UNFLAGGED = {
    "comparison": "ok = x < float('inf')",
    "float -1.0": "ok = torch.full((4,), -1.0)",
    "-inf": "ok = torch.where(x > 0, x, -torch.inf)",
    "-inf float": "ok = torch.full((4,), -float('inf'))",
    "arithmetic": "ok = x.add(-1)",
    "sub": "ok = x - 1",
    "constant": "ok = torch.full((4,), PAD_ID)",
    "subscript constant": "x[i] = PAD_SQNORM",
    "plain assign": "ok = -1",
    "where 1st": "ok = torch.where(-1 < x)",
    "waived": "ok = torch.full((4,), -1)  # padlint: ok",
    "waived above": "# padlint: ok — an epoch stamp\nok = np.full(4, -1)",
}


def _src(body):
    return "def f(x, i):\n" + "".join(f"    {ln}\n"
                                       for ln in body.splitlines())


@pytest.mark.parametrize("form", sorted(FLAGGED))
def test_padlint_flags_each_torch_form(form):
    fs = padlint.lint_source("src/repro_torch/index/fake.py",
                             _src(FLAGGED[form]))
    assert [(f.pass_name, f.line) for f in fs] == [("pad-convention", 2)]
    assert fs[0].file == "src/repro_torch/index/fake.py"
    assert "repro_torch.core.padding" in fs[0].message


@pytest.mark.parametrize("form", sorted(UNFLAGGED))
def test_padlint_leaves_each_non_pad_form(form):
    assert padlint.lint_source("fake.py", _src(UNFLAGGED[form])) == []


def test_padlint_unparseable_source_is_a_finding():
    fs = padlint.lint_source("bad.py", "def f(:\n")
    assert len(fs) == 1 and "unparseable" in fs[0].message


def test_padlint_scope_excludes_kernels(tmp_path):
    for sub in ("index", "mutate", "dist", "kernels", "serve"):
        d = tmp_path / "repro_torch" / sub
        d.mkdir(parents=True)
        (d / "m.py").write_text("import torch\nx = torch.full((2,), -1)\n")
    fs = padlint.lint_tree(str(tmp_path))
    assert sorted(os.path.basename(os.path.dirname(f.file)) for f in fs) \
        == ["dist", "index", "mutate"]


def test_tree_is_clean_after_the_waivers():
    assert padlint.lint_tree(SRC) == []
    assert runner.run_gate("cpu", tree_only=True) == []
    for path, text in (("mutate/monitor.py", "padlint: ok"),
                       ("mutate/index.py", "decrement count, not a pad")):
        with open(os.path.join(SRC, "repro_torch", path)) as f:
            assert text in f.read(), path


# -- the recorder ------------------------------------------------------------

def test_recorder_models_the_card_on_the_cpu():
    """Device values read on the host sync, host values do not; blocking
    host-to-device copies sync; ``.cpu().numpy()`` syncs once; transfer
    bytes count even where the devices coincide."""
    x = torch.arange(6, dtype=torch.float32)

    def work():
        host = torch.as_tensor(np.arange(4))          # host data, no device
        float(host.sum())                              # host read: no sync
        dev = torch.as_tensor(np.arange(4), device=CPU)  # H2D
        int(dev.sum())                                 # D2H
        x.cpu().numpy()                                # one D2H
        y = x.to(CPU)                                  # no-op, 24 bytes
        bool(y.any())                                  # D2H
        x[torch.tensor([1, 2])]                        # host index: H2D
        x[x > 2]                                       # mask: waits
        return host
    _, rec = audits.record(work, CPU)
    whats = [e.what for e in rec.syncs()]
    assert whats == ["as_tensor H2D", "__int__", "cpu D2H", "__bool__",
                     "__getitem__ host index", "__getitem__ mask"]
    assert [e.nbytes for e in rec.transfers()] == [24, 24]


def test_resident_bytes_counts_a_placed_store_by_its_shards():
    from repro_torch import dist
    from repro_torch.index import residency
    from repro_torch.launch import mesh as mesh_lib
    index = manifest._make_ivf(2048, 16, CPU, sq8=True)
    placed = dist.place_index(index, mesh_lib.make_search_mesh(3, CPU))
    got = residency.resident_bytes(placed)
    assert got["bucket_vecs"] == sum(t.numel() for t in placed.bucket_vecs)
    assert got["bucket_vecs"] >= residency.resident_bytes(
        index)["bucket_vecs"]


# -- the corpus and the gate -------------------------------------------------

CORPUS = ["cloned_store", "item_in_step", "raw_pad_literal",
          "resident_f32_payload", "rows_to_lead"]


def test_corpus_has_one_module_per_pass():
    import pkgutil
    names = sorted(m.name for m in pkgutil.iter_modules(corpus.__path__))
    assert names == CORPUS


@pytest.mark.parametrize("name", CORPUS)
def test_corpus_module_is_detected_with_its_anchor(name):
    import importlib
    mod = importlib.import_module(f"repro_torch.analysis.corpus.{name}")
    found = _detect(mod, os.path.abspath(mod.__file__), CPU)
    assert found and {f.pass_name for f in found} == {mod.EXPECT_PASS}
    assert any(os.path.basename(f.file or "") == f"{name}.py" and f.line
               for f in found), format_findings(found)


def test_gate_in_process_has_zero_findings():
    names = {ep.name for ep in entry_points()}
    assert names == {"kernels/l2_topk", "kernels/bucket_probe",
                     "dist/flat_search", "dist/ivf_probe_step",
                     "dist/hnsw_beam_step", "serve/chunks_ivf",
                     "serve/chunks_hnsw", "serve/chunks_traced",
                     "serve/sync_loop", "serve/cold_sharded"}
    findings = runner.run_gate("cpu")
    assert findings == [], format_findings(findings)


def test_cli_gate_and_selftest(tmp_path):
    out = tmp_path / "gate.json"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--gate",
         "--selftest", "--device", "cpu", "--json", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "analysis gate: OK" in proc.stdout
    assert proc.stdout.count("selftest ok:") == len(CORPUS)
    assert json.loads(out.read_text()) == {"findings": [],
                                           "selftest_errors": []}


def test_cli_needs_something_to_do():
    from repro_torch.analysis.__main__ import main
    with pytest.raises(SystemExit):
        main(["--device", "cpu"])


# -- host-sync limits --------------------------------------------------------

def test_sync_limits_are_the_loops_counts_at_hosts_1_and_2():
    """The manifest's limits are exactly the counts the serving loop
    makes: one active fetch in every chunk, the harvest fetches and the
    refill puts at boundaries where a slot finished; no kernel build."""
    counts = manifest.sync_loop_counts("cpu")
    assert sorted(counts) == sorted(manifest.SYNC_LIMITS)
    for name, row in counts.items():
        assert row["sites"] == manifest.SYNC_LIMITS[name], name
        assert row["nvcc_after_first_chunk"] == 0
    recs = manifest.sync_loop_recorders("cpu")
    for name, rec in recs.items():
        per_chunk = {}
        for e in rec.syncs():
            if e.site.key == manifest._ACTIVE:
                per_chunk[e.chunk] = per_chunk.get(e.chunk, 0) + 1
        assert set(per_chunk.values()) == {1}, name
        assert len(per_chunk) >= 8, name
        assert audits.host_syncs(name, rec, manifest.SYNC_LIMITS[name]) == []
        tight = dict(manifest.SYNC_LIMITS[name])
        tight[manifest._HARVEST] -= 1
        found = audits.host_syncs(name, rec, tight)
        assert [f.pass_name for f in found] == ["host-sync"]
        assert found[0].file.endswith("serve/engine.py") and found[0].line
