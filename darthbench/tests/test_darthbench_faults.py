"""The check refuses what it must: the reference put in the program's place
at a lower precision (the control), and a run whose timed path is broken
underneath, once for each fault a cell of this benchmark can have. (The
cells run on one card, so no exchange between cards can be left out.)"""
import time

import pytest
import torch

from darthbench import bench, reference


def _execute(root, cell, traced=False):
    return bench.execute(root, cell, 4242, 1.5, traced, "cpu", time.time())


def _break_window(monkeypatch, breaker):
    """Run ``breaker(system)`` once set-up is done, just before the window."""
    window = bench.window

    def broken(run, system, stretch=None):
        breaker(system)
        return window(run, system, stretch)

    monkeypatch.setattr(bench, "window", broken)


def test_a_sound_run_is_correct(tiny_root):
    assert _execute(tiny_root, "tiny-ivf-backlog")["correct"] is True


@pytest.mark.parametrize("cell", ["tiny-ivf-backlog", "tiny-hnsw-backlog"])
def test_the_control_in_the_programs_place_is_not_correct(
        tiny_root, monkeypatch, cell):
    served = bench.served

    def control(run, system):
        s = served(run, system)
        d, i = reference.exact_knn(system.coll.base, s.queries,
                                   s.ids.shape[1], matmul="bf16")
        s.ids, s.dists = i.numpy(), d.numpy()
        return s

    monkeypatch.setattr(bench, "served", control)
    result = _execute(tiny_root, cell)
    assert result["correct"] is False
    gap = result["checks"]["dist_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("cell", ["tiny-ivf-backlog", "tiny-hnsw-backlog"])
def test_a_step_that_returns_its_state_unchanged(tiny_root, monkeypatch,
                                                  cell):
    def breaker(system):
        eng = system.server.engine
        system.server.set_engine(eng._replace(step=lambda index, s: s))

    _break_window(monkeypatch, breaker)
    assert _execute(tiny_root, cell)["correct"] is False


def test_half_of_the_batch_left_out(tiny_root, monkeypatch):
    def breaker(system):
        serve = system.server.serve

        def half(queries, targets, **kw):
            results, stats = serve(queries, targets, **kw)
            return [r if j % 2 == 0 else None
                    for j, r in enumerate(results)], stats

        system.server.serve = half

    _break_window(monkeypatch, breaker)
    result = _execute(tiny_root, "tiny-ivf-backlog")
    assert result["correct"] is False
    assert result["checks"]["missing"]["value"] > 0


def test_an_answer_altered_in_the_probe_kernel(tiny_root, monkeypatch):
    from repro_torch.kernels import ops

    probe = ops.bucket_probe_slots

    def altered(q, vecs, sqn, ids, slot, active, *rest):
        d, i, cnt = probe(q, vecs, sqn, ids, slot, active, *rest)
        i = i.clone()
        i[:, 0] = torch.where(i[:, 0] >= 0, (i[:, 0] + 1) % ids.numel(),
                              i[:, 0])
        return d, i, cnt

    _break_window(monkeypatch,
                  lambda system: monkeypatch.setattr(ops, "bucket_probe_slots",
                                                     altered))
    assert _execute(tiny_root, "tiny-ivf-backlog")["correct"] is False


def test_an_answer_altered_in_the_beam_step(tiny_root, monkeypatch):
    import dataclasses

    def breaker(system):
        eng = system.server.engine
        step = eng.step

        def altered(index, s):
            s = step(index, s)
            ci = s.cand_i.clone()
            n = index.num_vectors
            ci[:, 0] = torch.where(ci[:, 0] >= 0, (ci[:, 0] + 1) % n,
                                   ci[:, 0])
            return dataclasses.replace(s, cand_i=ci)

        system.server.set_engine(eng._replace(step=altered))

    _break_window(monkeypatch, breaker)
    assert _execute(tiny_root, "tiny-hnsw-backlog")["correct"] is False


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_the_tf32_control_fails_and_the_program_passes_on_the_card(card):
    """At 200,000 x 128 on the card: the program's served answers keep
    within the IVF configuration's limit, the reference computed in TF32
    in its place does not."""
    import pathlib

    from darthbench import check, control, manifest

    root = pathlib.Path(__file__).resolve().parents[2]
    man = manifest.load(root)
    cell = manifest.cell(man, "ivf1024-hard-backlog")
    cfg = manifest.config(man, cell, root)
    cfg["data"] = dict(cfg["data"], n=200_000)
    cfg["server"] = dict(cfg["server"], num_slots=1024)
    run = bench.Run(cell=cell, config=cfg,
                    traffic=manifest.traffic(cell, root), seed=77,
                    seconds=3.0, traced=False, num_slots=1024)
    system = bench.serving(run, bench.prepare(run, card), card)
    bench.window(run, system)
    served = bench.served(run, system)
    program = check.compare(system.coll.base, served, cfg["correct"], 77)
    assert all(c["ok"] for c in program["checks"])
    ctrl = control.control_readings(system.coll.base, served,
                                    cfg["correct"], 77, 4096, "tf32")
    assert not all(c["ok"] for c in ctrl["checks"])


def test_a_predictor_that_stops_every_query_at_its_first_check(
        tiny_root, monkeypatch):
    from darthbench import control

    _break_window(monkeypatch, lambda system: system.server.set_predictor(
        control.StopAtFirstCheck()))
    result = _execute(tiny_root, "tiny-ivf-backlog")
    assert result["correct"] is False
    short = result["checks"]["recall_short"]
    assert short["value"] > short["limit"]
