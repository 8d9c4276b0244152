"""The port's competitors (REM, LAET), quality metrics and §4.1.5 predictor
baselines against the JAX reference.

Search parity runs on an IVF index built by the reference on integer-valued
data (centroids rounded) and carried across with ``repro_torch.convert``:
every distance is exact in f32, so REM's sweep and mapping, LAET's ids and
``ndis`` per query (with the reference's LAET regressor carried across)
and its tuned multipliers must be EQUAL. The metrics are a numpy copy and
must be equal bit for bit. The tree baselines grow equal trees on
integer targets (every histogram sum exact in any order, as in
``tests/test_torch_fit.py``); on float targets their held-out error is
held within 10 % of the reference's; the ridge fit agrees to rtol 1e-4.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the test lane runs six workers on a few cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import gbdt as ref_gbdt  # noqa: E402
from repro.core import baselines as ref_baselines  # noqa: E402
from repro.core import engines as ref_engines  # noqa: E402
from repro.core import metrics as ref_metrics  # noqa: E402
from repro.core import training as ref_training  # noqa: E402
from repro.index import flat as ref_flat  # noqa: E402
from repro.index import ivf as ref_ivf  # noqa: E402
from repro_torch import convert, gbdt  # noqa: E402
from repro_torch.core import baselines, engines, metrics  # noqa: E402
from repro_torch.gbdt import infer  # noqa: E402

from test_torch_serve import clustered  # noqa: E402

K, NLIST = 10, 25


@pytest.fixture(scope="module")
def setup():
    """Reference index (integer data, rounded centroids), the port's copy,
    both engines, the reference's step log on 256 learn queries, and
    validation and test queries with their ground truth."""
    x, learn, q = clustered(2, n=5000, n_learn=512, n_q=128)
    ref_index = ref_ivf.build(x, nlist=NLIST, seed=2)
    ref_index = dataclasses.replace(ref_index,
                                    centroids=jnp.round(ref_index.centroids))
    index = convert.ivf_index_from_numpy(convert.fields_as_numpy(ref_index),
                                         "cpu")
    ref_eng = ref_engines.ivf_engine(ref_index, k=K, nprobe=NLIST)
    eng = engines.ivf_engine(index, k=K, nprobe=NLIST)
    _, gt_learn = ref_flat.search(jnp.asarray(learn[:256]), jnp.asarray(x), K)
    log = ref_training.generate_observations(ref_eng, jnp.asarray(learn[:256]),
                                             gt_learn, batch=256)
    q_val = learn[256:384]
    _, gt_val = ref_flat.search(jnp.asarray(q_val), jnp.asarray(x), K)
    return dict(x=x, q=q, q_val=q_val, gt_val=np.array(gt_val),
                ref_index=ref_index, index=index, ref_eng=ref_eng, eng=eng,
                log=log)


def test_metrics_equal_reference():
    rng = np.random.default_rng(0)
    b, k, kw = 200, 10, 100
    wide = np.stack([rng.permutation(5000)[:kw] for _ in range(b)])
    true_i = wide[:, :k].astype(np.int32)
    found = np.where(rng.random((b, k)) < 0.7, true_i,
                     rng.integers(0, 5000, (b, k))).astype(np.int32)
    found[::7, -2:] = -1                           # empty slots
    true_d = np.sort(rng.gamma(2.0, 5.0, (b, k)), 1).astype(np.float32)
    found_d = (true_d * rng.uniform(1.0, 1.3, (b, k))).astype(np.float32)
    found_d[::7, -2:] = np.inf
    rec_r = ref_metrics.recall(found, true_i)
    np.testing.assert_array_equal(metrics.recall(found, true_i), rec_r)
    np.testing.assert_array_equal(metrics.rde(found_d, true_d),
                                  ref_metrics.rde(found_d, true_d))
    np.testing.assert_array_equal(metrics.nrs(found, wide),
                                  ref_metrics.nrs(found, wide))
    for rt in (0.8, 0.9, 0.95):
        assert metrics.rqut(rec_r, rt) == ref_metrics.rqut(rec_r, rt)
        assert metrics.error_stats(rec_r, rt) == \
            ref_metrics.error_stats(rec_r, rt)
        assert metrics.summarize(found_d, found, true_d, true_i, wide, rt) \
            == ref_metrics.summarize(found_d, found, true_d, true_i, wide, rt)


def test_rem_sweep_and_mapping_equal_reference(setup):
    s = setup
    grid, targets = [2, 4, 8, 16, 25], [0.8, 0.9, 0.99]
    ref_rem = ref_baselines.fit_rem(
        lambda p: ref_engines.ivf_engine(s["ref_index"], k=K, nprobe=p),
        jnp.asarray(s["q_val"]), jnp.asarray(s["gt_val"]), grid, targets)
    rem = baselines.fit_rem(
        lambda p: engines.ivf_engine(s["index"], k=K, nprobe=p),
        torch.as_tensor(s["q_val"]), torch.as_tensor(s["gt_val"]), grid,
        targets)
    assert rem.sweep == ref_rem.sweep
    assert rem.mapping == ref_rem.mapping
    assert rem.mapping[0.99] >= rem.mapping[0.9] >= rem.mapping[0.8]


def test_total_dists_to_final_equal_reference(setup):
    log = setup["log"]
    got = baselines._total_dists_to_final(log)
    np.testing.assert_array_equal(got, ref_baselines._total_dists_to_final(
        log))
    assert got.dtype == np.float64 and (got > 0).all()


@pytest.fixture(scope="module")
def laet_pair(setup):
    """The reference's fitted LAET and the port's LAET around the same
    regressor."""
    ref_laet = ref_baselines.fit_laet(setup["log"], n0=2)
    params = convert.gbdt_params_from_numpy(
        ref_gbdt.to_state_dict(ref_laet.params), "cpu")
    return ref_laet, baselines.LAET(params=params, n0=2, multipliers={})


@pytest.mark.parametrize("mult", [0.5, 1.0, 2.0])
def test_laet_search_equal_reference(setup, laet_pair, mult):
    s = setup
    ref_laet, laet = laet_pair
    q = s["q"][:64]
    st_r = ref_baselines.laet_search(ref_laet, s["ref_eng"], jnp.asarray(q),
                                     mult)
    st_p = baselines.laet_search(laet, s["eng"], torch.as_tensor(q), mult)
    np.testing.assert_array_equal(st_p.topk_i.numpy(),
                                  np.asarray(st_r.topk_i))
    np.testing.assert_array_equal(st_p.ndis.numpy(), np.asarray(st_r.ndis))
    np.testing.assert_array_equal(st_p.probe_pos.numpy(),
                                  np.asarray(st_r.probe_pos))
    assert (st_p.ndis > 0).all()


def test_tune_laet_equal_reference(setup, laet_pair):
    s = setup
    ref_laet, laet = laet_pair
    ref_t = ref_baselines.tune_laet(ref_laet, s["ref_eng"],
                                    jnp.asarray(s["q_val"]),
                                    jnp.asarray(s["gt_val"]),
                                    targets=[0.8, 0.9], steps=4)
    got = baselines.tune_laet(laet, s["eng"], torch.as_tensor(s["q_val"]),
                              torch.as_tensor(s["gt_val"]),
                              targets=[0.8, 0.9], steps=4)
    assert got.multipliers == ref_t.multipliers
    assert got.n0 == 2 and got.params is laet.params


def test_fit_laet_on_the_port(setup):
    """The port's own LAET fit (its GBDT on the same log): the regressor
    predicts log1p of the total distances at least as well as the
    reference's, within 10 %."""
    log = setup["log"]
    y = np.log1p(ref_baselines._total_dists_to_final(log))
    x = log.features[1]
    ref_laet = ref_baselines.fit_laet(log, n0=2)
    laet = baselines.fit_laet(log, n0=2, device="cpu")
    mse_r = float(np.mean((np.asarray(ref_gbdt.predict_efficient(
        ref_laet.params, jnp.asarray(x))) - y) ** 2))
    mse_p = float(np.mean((infer.predict_efficient(
        laet.params, torch.as_tensor(x)).numpy() - y) ** 2))
    assert mse_p <= 1.1 * mse_r + 1e-6, (mse_p, mse_r)


def _integer_regression(seed=5, n=3000):
    """Integer features (ties) and integer targets whose mean is an
    integer, so every gradient and histogram sum is an exact integer."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-20, 21, (n, 11)).astype(np.float32)
    x[:, 3] = rng.integers(0, 4, n)
    y = (np.sign(x[:, 0]) * 3 + (x[:, 1] > 5) * 2
         + rng.integers(-2, 3, n)).astype(np.float32)
    y[-1] -= float(y.sum()) % n          # the mean becomes an integer
    assert float(np.mean(y)).is_integer()
    return x, y


def _assert_params_equal(p, r):
    for name in ("feat", "thresh", "leaf", "base"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(r, name)),
                                      err_msg=name)


def test_random_forest_and_tree_equal_on_integer_targets():
    x, y = _integer_regression()
    rf_r = ref_gbdt.fit_random_forest(x, y, num_trees=6, depth=5, seed=3)
    rf_p = gbdt.fit_random_forest(x, y, num_trees=6, depth=5, seed=3,
                                  device="cpu")
    _assert_params_equal(rf_p, rf_r)
    assert (rf_p.feat >= 0).sum() > 20          # the trees really split
    dt_r = ref_gbdt.fit_decision_tree(x, y, depth=8)
    dt_p = gbdt.fit_decision_tree(x, y, depth=8, device="cpu")
    _assert_params_equal(dt_p, dt_r)
    assert dt_p.feat.shape == (1, 255)


def test_random_forest_and_tree_heldout_mse_within_ten_percent():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5000, 11)).astype(np.float32)
    y = (np.tanh(x[:, 0] + 0.5 * x[:, 1] * x[:, 2])
         + 0.05 * rng.normal(size=5000)).astype(np.float32)
    xh, yh = x[4000:], y[4000:]
    for fit_r, fit_p in (
            (lambda: ref_gbdt.fit_random_forest(x[:4000], y[:4000],
                                                num_trees=10, depth=6),
             lambda: gbdt.fit_random_forest(x[:4000], y[:4000], num_trees=10,
                                            depth=6, device="cpu")),
            (lambda: ref_gbdt.fit_decision_tree(x[:4000], y[:4000]),
             lambda: gbdt.fit_decision_tree(x[:4000], y[:4000],
                                            device="cpu"))):
        mse_r = float(np.mean((np.asarray(ref_gbdt.predict_efficient(
            fit_r(), jnp.asarray(xh))) - yh) ** 2))
        mse_p = float(np.mean((infer.predict_efficient(
            fit_p(), torch.as_tensor(xh)).numpy() - yh) ** 2))
        assert mse_p <= 1.1 * mse_r, (mse_p, mse_r)


def test_fit_linear_equal_reference():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3000, 11)) * rng.uniform(0.1, 50, 11)
         + rng.normal(size=11) * 10).astype(np.float32)
    y = (x @ rng.normal(size=11) + 3.0 + rng.normal(size=3000)
         ).astype(np.float32)
    ref = ref_gbdt.fit_linear(x, y)
    got = gbdt.fit_linear(x, y, device="cpu")
    assert isinstance(got, gbdt.LinearModel)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=1e-4)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(ref.b), rtol=1e-4)
    np.testing.assert_allclose(got.predict(torch.as_tensor(x)).numpy(),
                               np.asarray(ref.predict(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-3)
