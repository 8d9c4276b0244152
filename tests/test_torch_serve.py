"""The port's slot-pool server against the JAX reference's.

Both servers get the reference's IVF index (integer vectors, rounded
centroids) and its fitted predictor and dists_Rt, carried across with
``repro_torch.convert``, and serve the same queries with the same mixed
targets. Every distance is then exact and the predictor's recalls agree
to 1e-6 (see ``tests/test_torch_darth.py``), so per query the served ids,
``ndis``, terminal reason and predictor calls must be EQUAL, distances
agree to float tolerance, and so must every ``ServeStats`` counter: at
hosts {1, 2, 4}, under difficulty tiers with boost, hedging, a bounded
queue and either overload policy, with a step-budget truncation, with a
host killed mid-serve and with a predictor hot swap mid-serve; and on a
graph built by the reference, through the HNSW beam loop. Both servers
run traced, so each query's ``ndis`` and its predicted-recall trajectory
are read from its terminal span. Finally the port's served results equal
the port's own ``darth_search`` run per query with per-query intervals.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the test lane runs six workers on a few cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import gbdt as ref_gbdt  # noqa: E402
from repro.core import api as ref_api  # noqa: E402
from repro.core import engines as ref_engines  # noqa: E402
from repro.core import training as ref_training  # noqa: E402
from repro.index import hnsw as ref_hnsw  # noqa: E402
from repro.index import ivf as ref_ivf  # noqa: E402
from repro.obs import trace as ref_trace  # noqa: E402
from repro.serve import DarthServer as RefServer  # noqa: E402
from repro.serve import TierConfig as RefTierConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api, darth_search, engines  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.serve import DarthServer, TierConfig  # noqa: E402

K, NLIST, SLOTS, SPS = 10, 16, 16, 2
COUNTERS = ("completed", "engine_steps", "slot_steps", "refills",
            "truncated", "ndis_harvested", "shed", "degraded", "hedged",
            "hedge_upgrades", "hedge_epoch_dropped", "swaps")


def clustered(seed, n=2000, n_learn=300, n_q=64):
    """Integer-valued clustered base, learn and query sets (D = 16)."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-12, 13, (24, 16))

    def draw(m, spread):
        return (centers[rng.integers(0, 24, m)]
                + rng.integers(-spread, spread + 1, (m, 16))
                ).astype(np.float32)
    return draw(n, 4), draw(n_learn, 6), draw(n_q, 6)


def mixed_targets(n):
    return np.random.default_rng(0).choice(
        [0.80, 0.90, 0.95, 0.99], n).astype(np.float32)


def fitted_pairs(ref_engine, engine, x, learn):
    """(reference Darth, port Darth) around the reference's fitted
    predictor and dists_Rt, and a second, smaller predictor fitted on the
    same step log (reference's, port's) for hot swaps."""
    _, gt = ref_training.ground_truth(jnp.asarray(learn), jnp.asarray(x), K)
    log = ref_training.generate_observations(ref_engine, jnp.asarray(learn),
                                             gt, batch=128)
    trained = ref_training.fit_predictor(
        log, cfg=ref_gbdt.GBDTConfig(num_trees=100, depth=6,
                                     min_child_weight=5.0))
    other = ref_training.fit_predictor(
        log, cfg=ref_gbdt.GBDTConfig(num_trees=30, depth=4,
                                     min_child_weight=5.0))
    ref_d = ref_api.Darth(make_engine=None, engine=ref_engine,
                          trained=trained)
    port_d = api.Darth(
        make_engine=None, engine=engine,
        trained=convert.trained_from_numpy(
            ref_gbdt.to_state_dict(trained.predictor.params),
            trained.dists_rt, "cpu"))
    port_other = convert.trained_from_numpy(
        ref_gbdt.to_state_dict(other.predictor.params), other.dists_rt,
        "cpu").predictor
    return ref_d, port_d, (other.predictor, port_other)


@pytest.fixture(scope="module")
def carried():
    """Reference IVF index + fitted predictor, the port's copies, queries
    and their mixed targets."""
    x, learn, q = clustered(4)
    ref_index = ref_ivf.build(x, nlist=NLIST, seed=0)
    ref_index = dataclasses.replace(ref_index,
                                    centroids=jnp.round(ref_index.centroids))
    index = convert.ivf_index_from_numpy(convert.fields_as_numpy(ref_index),
                                         "cpu")
    ref_d, port_d, swap = fitted_pairs(
        ref_engines.ivf_engine(ref_index, k=K, nprobe=NLIST),
        engines.ivf_engine(index, k=K, nprobe=NLIST), x, learn)
    return ref_d, port_d, swap, q, mixed_targets(q.shape[0])


def serve_both(ref_d, port_d, q, rts, *, traced=True, tiers=None,
               hook=None, **kw):
    """Serve q at rts through both servers, built alike from ``kw``
    (hosts, tiers as TierConfig kwargs) and run alike (max_engine_steps,
    kill_hosts; ``hook(side)`` builds each side's on_boundary callback).
    Returns ((results, stats, tracer) of the reference, ... of the
    port)."""
    run_kw = {name: kw.pop(name) for name in ("max_engine_steps",
                                              "kill_hosts") if name in kw}
    out = []
    for side, d, tcls, tiers_cls, srv_cls in (
            ("ref", ref_d, ref_trace.Tracer, RefTierConfig, RefServer),
            ("port", port_d, trace.Tracer, TierConfig, DarthServer)):
        tracer = tcls(traj_cap=64) if traced else None
        srv = srv_cls(d.engine, d.trained.predictor, d.interval_for_target,
                      num_slots=SLOTS, steps_per_sync=SPS, tracer=tracer,
                      tiers=None if tiers is None else tiers_cls(**tiers),
                      **kw)
        on_boundary = None if hook is None else hook(side)
        res, stats = srv.serve(q, rts, on_boundary=on_boundary, **run_kw)
        out.append((res, stats, tracer))
    return out


def assert_same_serve(ref_out, port_out):
    """Per query: the same result or None, equal ids, distances to float
    tolerance; equal ServeStats counters, per-host stats and tier stats;
    with tracers, the same terminal per query (reason, host, step,
    epoch, ndis, npred), r_pred and trajectory to 1e-6."""
    res_r, st_r, tr_r = ref_out
    res_p, st_p, tr_p = port_out
    assert len(res_r) == len(res_p)
    for qid, (a, b) in enumerate(zip(res_r, res_p)):
        assert (a is None) == (b is None), qid
        if a is None:
            continue
        np.testing.assert_array_equal(b[1], np.asarray(a[1]), err_msg=qid)
        np.testing.assert_allclose(b[0], np.asarray(a[0]), rtol=1e-6,
                                   atol=1e-4, err_msg=str(qid))
    for name in COUNTERS:
        assert getattr(st_p, name) == getattr(st_r, name), name
    for h_r, h_p in zip(st_r.hosts, st_p.hosts, strict=True):
        assert dataclasses.asdict(h_p) == dataclasses.asdict(h_r)
    assert sorted(st_p.tiers) == sorted(st_r.tiers)
    for name, t_r in st_r.tiers.items():
        a, b = dataclasses.asdict(st_p.tiers[name]), dataclasses.asdict(t_r)
        for field in ("recall_p50", "recall_p99"):
            np.testing.assert_allclose(a.pop(field), b.pop(field), atol=1e-6)
        np.testing.assert_equal(a, b)
    if tr_r is None:
        return
    terms_r, terms_p = tr_r.terminals(), tr_p.terminals()
    assert sorted(terms_p) == sorted(terms_r)
    for qid, sp_r in terms_r.items():
        sp_p = terms_p[qid]
        assert (sp_p.host, sp_p.step, sp_p.epoch) == \
            (sp_r.host, sp_r.step, sp_r.epoch), qid
        a, b = dict(sp_p.attrs), dict(sp_r.attrs)
        np.testing.assert_allclose(a.pop("r_pred", np.nan),
                                   b.pop("r_pred", np.nan), atol=1e-6)
        np.testing.assert_allclose(a.pop("trajectory", []),
                                   b.pop("trajectory", []), atol=1e-6)
        assert a == b, qid
    kinds_r = [(s.kind, s.qid, s.step) for s in tr_r.last_spans]
    assert [(s.kind, s.qid, s.step) for s in tr_p.last_spans] == kinds_r


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_serve_equals_reference(carried, hosts):
    ref_d, port_d, _, q, rts = carried
    ref_out, port_out = serve_both(ref_d, port_d, q, rts, hosts=hosts)
    assert_same_serve(ref_out, port_out)
    assert port_out[1].completed == q.shape[0]
    assert port_out[1].refills > 0
    reasons = {s.attrs["reason"] for s in port_out[2].terminals().values()}
    assert "interval_met" in reasons      # DARTH stopped queries early


@pytest.mark.parametrize("overload", ["degrade", "shed"])
def test_tiered_serve_equals_reference(carried, overload):
    """Boosted hard tier, hedging, a bounded queue, rebalancing."""
    ref_d, port_d, _, q, rts = carried
    tiers = dict(hard_quantile=0.6, hard_slot_fraction=0.25, boost=0.04,
                 hedge=True, hedge_boost=0.03, max_queue=28,
                 overload=overload, degrade_target=0.8, rebalance=True)
    ref_out, port_out = serve_both(ref_d, port_d, q, rts, hosts=2,
                                   tiers=tiers)
    assert_same_serve(ref_out, port_out)
    stats = port_out[1]
    assert stats.hedged > 0 and stats.hedge_upgrades > 0
    assert (stats.shed if overload == "shed" else stats.degraded) > 0


def test_truncated_serve_equals_reference(carried):
    ref_d, port_d, _, q, rts = carried
    ref_out, port_out = serve_both(ref_d, port_d, q, rts, hosts=2,
                                   max_engine_steps=6)
    assert_same_serve(ref_out, port_out)
    assert port_out[1].truncated > 0
    assert any(r is None for r in port_out[0])


def test_killed_host_serve_equals_reference(carried):
    ref_d, port_d, _, q, rts = carried
    ref_out, port_out = serve_both(ref_d, port_d, q, rts, hosts=2,
                                   kill_hosts={1: 4})
    assert_same_serve(ref_out, port_out)
    assert port_out[1].hosts[1].killed and port_out[1].hosts[1].abandoned


def test_predictor_swap_mid_serve_equals_reference(carried):
    """request_swap of another predictor at the first boundary past step
    4: admissions pause, the pool drains, the swap applies, the epoch
    moves and the rest is served by the new predictor."""
    ref_d, port_d, (ref_pred, port_pred), q, rts = carried

    def hook(side):
        pred = ref_pred if side == "ref" else port_pred

        def on_boundary(srv):
            if srv.boundary_step >= 4 and srv.engine_epoch == 0 \
                    and not srv.swap_pending:
                srv.request_swap(predictor=pred)
        return on_boundary

    ref_out, port_out = serve_both(ref_d, port_d, q, rts, hook=hook)
    assert_same_serve(ref_out, port_out)
    assert port_out[1].swaps == 1 and port_out[1].completed == q.shape[0]
    epochs = {s.epoch for s in port_out[2].terminals().values()}
    assert epochs == {0, 1}


@pytest.fixture(scope="module")
def carried_hnsw():
    """The same for a graph built by the reference (the beam loop)."""
    x, learn, q = clustered(7)
    ref_index = ref_hnsw.build(x, m=12, passes=1, ef_construction=32, seed=0)
    index = convert.hnsw_index_from_numpy(
        convert.fields_as_numpy(ref_index), "cpu")
    kw = dict(k=K, ef=48, max_steps=160)
    ref_d, port_d, _ = fitted_pairs(ref_engines.hnsw_engine(ref_index, **kw),
                                    engines.hnsw_engine(index, **kw), x,
                                    learn)
    return ref_d, port_d, q, mixed_targets(q.shape[0])


def test_hnsw_serve_equals_reference(carried_hnsw):
    ref_d, port_d, q, rts = carried_hnsw
    ref_out, port_out = serve_both(ref_d, port_d, q, rts, hosts=2)
    assert_same_serve(ref_out, port_out)
    assert port_out[1].completed == q.shape[0]


def test_served_results_equal_darth_search(carried):
    """Per-slot state never crosses slots: each served query's ids and
    ndis are darth_search's, run on the whole batch with the per-query
    intervals of its declared targets."""
    _, port_d, _, q, rts = carried
    tracer = trace.Tracer()
    results, stats = DarthServer(
        port_d.engine, port_d.trained.predictor, port_d.interval_for_target,
        num_slots=SLOTS, steps_per_sync=SPS, hosts=4,
        tracer=tracer).serve(q, rts)
    st = darth_search.darth_search(
        port_d.engine, torch.as_tensor(q), rts, port_d.trained.predictor,
        port_d.interval_for_target(rts))
    ids = port_d.engine.topk_i(st.inner).numpy()
    ndis = st.inner.ndis.numpy()
    terms = tracer.terminals()
    for qid, (_, got) in enumerate(results):
        np.testing.assert_array_equal(got, ids[qid])
        assert terms[qid].attrs["ndis"] == ndis[qid]
        assert terms[qid].attrs["npred"] == st.npred[qid]
    assert stats.ndis_harvested == int(ndis.sum())


def test_server_rejects_a_mesh_and_bad_requests(carried):
    _, port_d, _, q, rts = carried
    args = (port_d.engine, port_d.trained.predictor,
            port_d.interval_for_target)
    with pytest.raises(NotImplementedError, match="item 8"):
        DarthServer(*args, mesh=object())
    with pytest.raises(ValueError, match="split evenly"):
        DarthServer(*args, num_slots=10, hosts=4)
    srv = DarthServer(*args, num_slots=SLOTS)
    with pytest.raises(ValueError, match="declared recall"):
        srv.serve(q, rts[:5])
    with pytest.raises(ValueError):
        srv.serve(q, np.full(q.shape[0], 1.5, np.float32))
    with pytest.raises(ValueError, match="protocol"):
        srv.set_engine(engines.ivf_engine(port_d.engine.index, k=K + 1,
                                          nprobe=NLIST), contents_only=True)
