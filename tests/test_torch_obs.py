"""The port's observability layer against the JAX reference's.

``stats``, ``metrics`` and ``explain`` are host code copied into the port:
on the same inputs they must give the reference's numbers, pages and
stories. The trajectory ring is a device tensor in the port: recorded
and drained, its rows must match the reference's ring. A traced serve
is a pure observer (equal to the untraced one) and closes every query
exactly once, with the reference's terminal reasons; a serve with a
metrics registry exports the reference's Prometheus page apart from
the wall-time samples. The serving launcher runs end to end on the CPU.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.obs import explain as ref_explain  # noqa: E402
from repro.obs import metrics as ref_metrics  # noqa: E402
from repro.obs import stats as ref_stats  # noqa: E402
from repro.obs import trace as ref_trace  # noqa: E402
from repro.serve import DarthServer as RefServer  # noqa: E402
from repro_torch.obs import explain, metrics, stats, trace  # noqa: E402
from repro_torch.serve import DarthServer  # noqa: E402

from test_torch_serve import SLOTS, SPS, carried  # noqa: E402,F401
from test_torch_serve import serve_both  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

SAMPLES = {"empty": [], "one": [3.0], "two": [1.0, 9.0],
           "nan": [np.nan, 2.0, 5.0, np.inf],
           "many": list(np.random.default_rng(0).normal(size=257))}


@pytest.mark.parametrize("name", list(SAMPLES))
def test_stats_equal_reference(name):
    xs = SAMPLES[name]
    for fn in ("p01", "p50", "p99", "summarize"):
        np.testing.assert_equal(getattr(stats, fn)(xs),
                                getattr(ref_stats, fn)(xs))
    for q in (0, 1, 25, 50, 75, 99, 100):
        np.testing.assert_equal(stats.percentile(xs, q),
                                ref_stats.percentile(xs, q))


def _drive_registry(mod):
    """The same declarations, samples and events on a registry of
    ``mod``; returns it."""
    reg = mod.serve_metrics(mod.MetricsRegistry())
    reg.counter("darth_queries_total").inc(5, outcome="completed")
    reg.counter("darth_queries_total").inc(2.5, outcome="shed")
    reg.counter("darth_refills_total").inc(3, host="1")
    reg.gauge("darth_engine_epoch").set(2)
    h = reg.histogram("darth_service_steps", edges=mod.STEP_EDGES)
    for v in (1, 3, 3, 70, 900):
        h.observe(v)
    reg.histogram("darth_custom_ms", "a custom family").observe(0.75,
                                                              host="0")
    reg.event("swap", step=12, epoch=1)
    reg.event("drift", worst_gap=0.125)
    return reg


def test_metrics_equal_reference(tmp_path):
    reg, ref = _drive_registry(metrics), _drive_registry(ref_metrics)
    assert reg.to_prometheus() == ref.to_prometheus()
    assert reg.events == ref.events
    assert reg.histogram("darth_service_steps").summary() == \
        ref.histogram("darth_service_steps").summary()
    assert metrics.serve_metrics(None) is None
    for r in (reg, ref):
        with pytest.raises(ValueError, match="cannot decrease"):
            r.counter("darth_queries_total").inc(-1)
        with pytest.raises(TypeError, match="already declared"):
            r.gauge("darth_queries_total")
    reg.write_events(str(tmp_path / "p.jsonl"), append=False)
    ref.write_events(str(tmp_path / "r.jsonl"), append=False)
    assert (tmp_path / "p.jsonl").read_text() == \
        (tmp_path / "r.jsonl").read_text()


@pytest.mark.parametrize("cap,admit,harvest,base", [
    (8, 0, 5, 0), (8, 2, 20, 0), (4, 9, 12, 4), (3, 1, 1, 0)])
def test_trajectory_ring_equals_reference(cap, admit, harvest, base):
    """Record r_pred after every step into both rings; rows agree to 1e-6
    after every step and so do the drained windows."""
    rng = np.random.default_rng(cap)
    slots = 5
    ring = trace.traj_init(slots, cap, "cpu")
    ref_ring = ref_trace.traj_init(slots, cap)
    for step in range(1, harvest - base + 1):
        rp = rng.random(slots).astype(np.float32)
        ring = trace.traj_record(ring, step, torch.as_tensor(rp))
        ref_ring = ref_trace.traj_record(ref_ring, jnp.int32(step),
                                         jnp.asarray(rp))
        np.testing.assert_allclose(ring.numpy(), np.asarray(ref_ring),
                                   atol=1e-6, rtol=0)
    for s in range(slots):
        got = trace.traj_window(ring[s].numpy(), admit, harvest, base)
        want = ref_trace.traj_window(np.asarray(ref_ring[s]), admit,
                                     harvest, base)
        assert got[1] == want[1]
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)


def test_tracer_contract_equals_reference(tmp_path):
    for mod in (trace, ref_trace):
        tr = mod.Tracer(str(tmp_path / f"{mod.__name__}.jsonl"), traj_cap=4,
                        label="unit")
        tr.begin()
        tr.event("admit", qid=0, host=0, step=0, slot=3)
        tr.terminal(0, "interval_met", host=0, step=4, r_pred=0.9)
        with pytest.raises(RuntimeError, match="exactly-once"):
            tr.terminal(0, "shed")
        with pytest.raises(ValueError, match="unknown termination"):
            tr.terminal(1, "timeout")
        tr.upgrade_terminal(0, step=6, r_pred=0.95)
        tr.finish()
        with pytest.raises(ValueError):
            mod.Tracer(traj_cap=0)
    assert trace.TERMINATION_REASONS == ref_trace.TERMINATION_REASONS
    got, want = (mod.load_trace(str(tmp_path / f"{mod.__name__}.jsonl"))
                 for mod in (trace, ref_trace))
    assert got == want and got[-1]["upgraded"] is True


def test_traced_serve_equals_untraced_with_reference_reasons(carried):
    """Tracing observes only: the port's traced serve returns its
    untraced results and counters; every qid has exactly one terminal,
    whose reason (and ndis) is the reference's."""
    ref_d, port_d, _, q, rts = carried
    (_, _, ref_tr), (res_t, st_t, tr) = serve_both(ref_d, port_d, q, rts,
                                                   hosts=2)
    (_, _, _), (res_u, st_u, _) = serve_both(ref_d, port_d, q, rts,
                                             hosts=2, traced=False)
    for a, b in zip(res_u, res_t):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    for name in ("completed", "engine_steps", "slot_steps", "refills",
                 "ndis_harvested"):
        assert getattr(st_t, name) == getattr(st_u, name)
    terms, ref_terms = tr.terminals(), ref_tr.terminals()
    assert sorted(terms) == list(range(q.shape[0]))
    assert sum(1 for s in tr.last_spans if s.kind == "terminal") == \
        q.shape[0]
    for qid, span in terms.items():
        assert span.attrs["reason"] == ref_terms[qid].attrs["reason"]
        assert span.attrs["ndis"] == ref_terms[qid].attrs["ndis"]
        traj = span.attrs["trajectory"]
        assert traj[-1] == pytest.approx(span.attrs["r_pred"], abs=1e-6)


def test_served_trajectory_outliving_ring_equals_reference(carried):
    """A ring of 2 columns: the drained windows are the reference's
    suffixes, flagged truncated alike."""
    ref_d, port_d, _, q, rts = carried
    out = []
    for srv_cls, tcls, d in ((RefServer, ref_trace.Tracer, ref_d),
                             (DarthServer, trace.Tracer, port_d)):
        tr = tcls(traj_cap=2)
        srv_cls(d.engine, d.trained.predictor, d.interval_for_target,
                num_slots=SLOTS, steps_per_sync=3, tracer=tr).serve(q, rts)
        out.append(tr.terminals())
    truncated = 0
    for qid, sp_r in out[0].items():
        sp_p = out[1][qid]
        np.testing.assert_allclose(sp_p.attrs["trajectory"],
                                   sp_r.attrs["trajectory"], atol=1e-6)
        assert sp_p.attrs.get("trajectory_truncated") == \
            sp_r.attrs.get("trajectory_truncated")
        truncated += bool(sp_p.attrs.get("trajectory_truncated"))
    assert truncated > 0


def assert_pages_equal(page, ref_page, n_queries):
    """Equal exposition pages, line for line, except the chunk-latency
    samples (wall time) and the sum of predicted recalls at harvest,
    which agree to the predictor's 1e-6 a query."""
    lines, ref_lines = page.splitlines(), ref_page.splitlines()
    assert len(lines) == len(ref_lines)
    for line, ref_line in zip(lines, ref_lines):
        name, _, value = line.rpartition(" ")
        ref_name, _, ref_value = ref_line.rpartition(" ")
        assert name == ref_name
        if name.startswith("darth_chunk_latency_ms"):
            continue
        if name.startswith("darth_harvest_recall_sum"):
            assert float(value) == pytest.approx(float(ref_value),
                                                 abs=1e-6 * n_queries)
            continue
        assert value == ref_value, line


def test_serve_metrics_page_equals_reference(carried):
    ref_d, port_d, _, q, rts = carried
    regs, completed = [], []
    for srv_cls, mod, d in ((RefServer, ref_metrics, ref_d),
                            (DarthServer, metrics, port_d)):
        reg = mod.MetricsRegistry()
        _, st = srv_cls(d.engine, d.trained.predictor,
                        d.interval_for_target, num_slots=SLOTS,
                        steps_per_sync=SPS, hosts=2,
                        metrics=reg).serve(q, rts)
        regs.append(reg)
        completed.append(st.completed)
    ref_reg, reg = regs
    assert reg.counter("darth_queries_total").value(outcome="completed") \
        == completed[1] == completed[0] == q.shape[0]
    assert reg.histogram("darth_chunk_latency_ms").count() == \
        ref_reg.histogram("darth_chunk_latency_ms").count() > 0
    page = reg.to_prometheus()
    assert "darth_chunk_latency_ms_count" in page
    assert_pages_equal(page, ref_reg.to_prometheus(), q.shape[0])


def test_explain_equals_reference(carried, tmp_path, capsys):
    """The same trace (the port's, traced through the reference's JSONL
    format) tells the same story through both packages' explain."""
    ref_d, port_d, _, q, rts = carried
    path = str(tmp_path / "trace.jsonl")
    tr = trace.Tracer(path, traj_cap=32, label="unit")
    DarthServer(port_d.engine, port_d.trained.predictor,
                port_d.interval_for_target, num_slots=SLOTS,
                steps_per_sync=SPS, tracer=tr).serve(q, rts)
    spans = tr.last_spans
    for qid in (None, 0, 5, 63):
        assert explain.explain(spans, qid=qid) == \
            ref_explain.explain(spans, qid=qid)
        assert explain.explain(path, qid=qid) == \
            ref_explain.explain(path, qid=qid)
    assert explain.summary(spans) == ref_explain.summary(spans)
    assert explain.query_story(spans, 5) == ref_explain.query_story(spans, 5)
    with pytest.raises(KeyError, match="no terminal span"):
        explain.query_story(spans, 999)
    assert explain.explain([]) == ref_explain.explain([])
    for argv in ([path, "--summary"], [path, "--qid", "5"], [path]):
        assert explain.main(argv) == 0
        got = capsys.readouterr().out
        assert ref_explain.main(argv) == 0
        assert got == capsys.readouterr().out
    # and as a module, the way a user runs it
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.explain",
                          path, "--qid", "5"], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("query 5:")


def test_serve_launcher_on_the_cpu(tmp_path):
    """python -m repro_torch.launch.serve --device cpu at a tiny size:
    build, fit, a traced serve over two host loops, and a recall line
    per declared target; the trace and the metrics land in --trace."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--n", "2000", "--dim", "16", "--learn", "200", "--queries", "64",
         "--nlist", "16", "--slots", "16", "--hosts", "2",
         "--trace", str(tmp_path), "--metrics"],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    for t in ("0.80", "0.90", "0.95"):
        rec = [ln for ln in lines if f"target {t}: mean recall" in ln]
        assert len(rec) == 1, out.stdout
        assert float(rec[0].split("mean recall ")[1].split()[0]) >= \
            float(t) - 0.03
    assert any("64 queries in" in ln for ln in lines)
    spans = [json.loads(ln) for ln in
             (tmp_path / "trace.jsonl").read_text().splitlines()]
    assert sum(s["kind"] == "terminal" for s in spans) == 64
    assert 'darth_queries_total{outcome="completed"} 64' in \
        (tmp_path / "metrics.prom").read_text()
