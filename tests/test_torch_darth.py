"""The port's DARTH driver against the JAX reference's.

With the reference's index (integer vectors, rounded centroids) and its
fitted predictor and dists_Rt carried across with ``repro_torch.convert``,
the port's per-query decisions must equal the reference's. The same holds
on a graph built by the reference, through the HNSW beam loop. Eagerly, the
features are equal bit for bit (they are summed left to right, as XLA's
CPU reduction does for rows of 10); inside the reference's jitted loop
XLA's sqrt may be 1 ulp off, and the GBDT's sum over 100 trees is taken
in another order, so predicted recalls agree to 1e-6 and the decisions
made from them (npred, early, steps, ids) are compared for equality.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the test lane runs six workers on a few cores, and
# torch's default pool (a thread per core in every worker) oversubscribes
# them, which made these tests many times slower there.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import gbdt as ref_gbdt  # noqa: E402
from repro.core import api as ref_api  # noqa: E402
from repro.core import darth_search as ref_ds  # noqa: E402
from repro.core import engines as ref_engines  # noqa: E402
from repro.core import features as ref_features  # noqa: E402
from repro.core import intervals as ref_intervals  # noqa: E402
from repro.core import training as ref_training  # noqa: E402
from repro.index import hnsw as ref_hnsw  # noqa: E402
from repro.index import ivf as ref_ivf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api, darth_search, engines, features  # noqa: E402
from repro_torch.core import intervals  # noqa: E402
from repro_torch.gbdt import infer  # noqa: E402

K, NLIST = 10, 16


def test_features_equal_reference():
    rng = np.random.default_rng(0)
    b = 64
    topk = np.sort(rng.integers(0, 400, (b, K)).astype(np.float32)
                   * rng.uniform(0.5, 2.0, (b, 1)).astype(np.float32), 1)
    cnt = rng.integers(0, K + 1, b)
    topk[np.arange(K)[None, :] >= cnt[:, None]] = np.inf
    ints = [rng.integers(0, 5000, b).astype(np.int32) for _ in range(3)]
    first = rng.uniform(0, 30, b).astype(np.float32)
    f_r = np.asarray(ref_features.extract(
        *(jnp.asarray(a) for a in ints), jnp.asarray(first),
        jnp.asarray(topk)))
    f_p = features.extract(*(torch.as_tensor(a) for a in ints),
                           torch.as_tensor(first), torch.as_tensor(topk))
    np.testing.assert_array_equal(f_p.numpy(), f_r)


def test_intervals_equal_reference():
    rp = np.linspace(0, 1, 11).astype(np.float32)
    rt = np.full(11, 0.9, np.float32)
    for d in (3.0, 180.5, 7000.0):
        p_r = ref_intervals.heuristic_params(d)
        p_p = intervals.heuristic_params(d)
        assert p_r == p_p
        np.testing.assert_array_equal(
            intervals.next_interval(p_p, torch.as_tensor(rt),
                                    torch.as_tensor(rp)).numpy(),
            np.asarray(ref_intervals.next_interval(p_r, jnp.asarray(rt),
                                                   jnp.asarray(rp))))
        assert intervals.static_params(d) == ref_intervals.static_params(d)
    arr = np.array([10.0, 500.0])
    for a, b in zip(intervals.heuristic_params(arr),
                    ref_intervals.heuristic_params(arr)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rng = np.random.default_rng(1)
    rec = np.sort(rng.random((12, 30)), 0).astype(np.float32)
    nd = np.cumsum(rng.integers(1, 50, (12, 30)), 0).astype(np.int32)
    valid = rng.random((12, 30)) < 0.9
    for t in (0.5, 0.9, 0.99):
        np.testing.assert_array_equal(
            intervals.dists_to_target(rec, nd, valid, t),
            ref_intervals.dists_to_target(rec, nd, valid, t))


def test_predict_equals_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2000, 11)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32) + 0.1 * x[:, 3]
    p = ref_gbdt.fit(x, y, ref_gbdt.GBDTConfig(num_trees=25, depth=5))
    pt = convert.gbdt_params_from_numpy(ref_gbdt.to_state_dict(p), "cpu")
    xq = rng.normal(size=(300, 11)).astype(np.float32)
    want = np.asarray(ref_gbdt.predict_efficient(p, jnp.asarray(xq)))
    for fn in (infer.predict, infer.predict_efficient):
        np.testing.assert_allclose(fn(pt, torch.as_tensor(xq)).numpy(),
                                   want, atol=1e-5)


def _clustered(seed):
    """Integer-valued clustered base, learn and query sets."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-12, 13, (24, 16))
    x = (centers[rng.integers(0, 24, 2000)]
         + rng.integers(-4, 5, (2000, 16))).astype(np.float32)
    learn = (centers[rng.integers(0, 24, 300)]
             + rng.integers(-6, 7, (300, 16))).astype(np.float32)
    q = (centers[rng.integers(0, 24, 48)]
         + rng.integers(-6, 7, (48, 16))).astype(np.float32)
    return x, learn, q


def _fitted_pair(ref_engine, engine, x, learn):
    """The reference's Darth fitted on ``ref_engine``, and the port's on
    ``engine`` around the same predictor and dists_Rt."""
    _, gt = ref_training.ground_truth(jnp.asarray(learn), jnp.asarray(x), K)
    log = ref_training.generate_observations(ref_engine, jnp.asarray(learn),
                                             gt, batch=128)
    trained = ref_training.fit_predictor(
        log, cfg=ref_gbdt.GBDTConfig(num_trees=100, depth=6,
                                     min_child_weight=5.0))
    ref_darth = ref_api.Darth(make_engine=None, engine=ref_engine,
                              trained=trained)
    port_darth = api.Darth(
        make_engine=None, engine=engine,
        trained=convert.trained_from_numpy(
            ref_gbdt.to_state_dict(trained.predictor.params),
            trained.dists_rt, "cpu"))
    return ref_darth, port_darth


@pytest.fixture(scope="module")
def carried():
    """Reference index + reference-fitted predictor, and the port's copies."""
    x, learn, q = _clustered(4)
    ref_index = ref_ivf.build(x, nlist=NLIST, seed=0)
    ref_index = dataclasses.replace(ref_index,
                                    centroids=jnp.round(ref_index.centroids))
    index = convert.ivf_index_from_numpy(convert.fields_as_numpy(ref_index),
                                         "cpu")
    return (*_fitted_pair(ref_engines.ivf_engine(ref_index, k=K, nprobe=NLIST),
                          engines.ivf_engine(index, k=K, nprobe=NLIST),
                          x, learn), q)


@pytest.fixture(scope="module")
def carried_hnsw():
    """The same for a graph built by the reference (the beam loop)."""
    x, learn, q = _clustered(7)
    ref_index = ref_hnsw.build(x, m=12, passes=1, ef_construction=32, seed=0)
    index = convert.hnsw_index_from_numpy(
        convert.fields_as_numpy(ref_index), "cpu")
    kw = dict(k=K, ef=48, max_steps=160)
    return (*_fitted_pair(ref_engines.hnsw_engine(ref_index, **kw),
                          engines.hnsw_engine(index, **kw), x, learn), q)


def _mixed(n):
    return np.resize(np.array([0.8, 0.9, 0.95, 0.99], np.float32), n)


def _assert_same_decisions(ref_darth, port_darth, q, target):
    rt = _mixed(q.shape[0]) if target == "mixed" else target
    _, i_r, st_r = ref_darth.search(jnp.asarray(q), rt)
    _, i_p, st_p = port_darth.search(q, rt)
    assert int(st_p.steps) == int(st_r.steps)
    np.testing.assert_array_equal(st_p.npred.numpy(), np.asarray(st_r.npred))
    np.testing.assert_array_equal(st_p.early.numpy(), np.asarray(st_r.early))
    np.testing.assert_allclose(st_p.r_pred.numpy(), np.asarray(st_r.r_pred),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))
    np.testing.assert_array_equal(st_p.inner.ndis.numpy(),
                                  np.asarray(st_r.inner.ndis))
    if target != "mixed":
        assert st_p.early.any()  # the predictor really stopped queries


@pytest.mark.parametrize("target", [0.8, 0.9, 0.95, "mixed"])
def test_darth_search_decisions_equal_reference(carried, target):
    _assert_same_decisions(*carried, target)


@pytest.mark.parametrize("target", [0.8, 0.9, 0.95, "mixed"])
def test_darth_search_hnsw_decisions_equal_reference(carried_hnsw, target):
    _assert_same_decisions(*carried_hnsw, target)


def test_plain_and_budget_search_equal_reference(carried):
    ref_darth, port_darth, q = carried
    s_r = ref_ds.plain_search(ref_darth.engine, jnp.asarray(q))
    s_p = darth_search.plain_search(port_darth.engine, torch.as_tensor(q))
    np.testing.assert_array_equal(s_p.topk_i.numpy(), np.asarray(s_r.topk_i))
    np.testing.assert_array_equal(s_p.ndis.numpy(), np.asarray(s_r.ndis))
    budget = np.linspace(50, 900, q.shape[0]).astype(np.float32)
    b_r = ref_ds.budget_search(ref_darth.engine, jnp.asarray(q), budget)
    b_p = darth_search.budget_search(port_darth.engine, torch.as_tensor(q),
                                     budget)
    for name in ("topk_i", "ndis", "ninserts", "probe_pos"):
        np.testing.assert_array_equal(getattr(b_p, name).numpy(),
                                      np.asarray(getattr(b_r, name)))
    for a, b in zip(port_darth.interval_for_target(_mixed(6)),
                    ref_darth.interval_for_target(_mixed(6))):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("bad", [0.0, 1.5, float("nan"), -0.1,
                                 [0.9, 0.9, 0.9], [[0.9] * 4], []])
def test_validate_targets_rejects_like_reference(bad):
    with pytest.raises(ValueError):
        ref_api.validate_targets(bad, 4)
    with pytest.raises(ValueError):
        api.validate_targets(bad, 4)


def test_validate_targets_accepts_like_reference():
    for good in (0.9, 1.0, [0.8, 0.9, 0.95, 1.0],
                 torch.tensor([0.5, 0.6, 0.7, 0.8])):
        ref_in = good.numpy() if isinstance(good, torch.Tensor) else good
        np.testing.assert_array_equal(api.validate_targets(good, 4),
                                      ref_api.validate_targets(ref_in, 4))
