"""The port's fit path (step logs, dists_Rt, GBDT) against the reference.

Binning is numpy in both packages and must be exact. Tree growth on
small-integer gradients makes every histogram sum exact in any order, so
the grown tree must be EQUAL. A full ``gbdt.fit`` on float targets is
held to the reference's held-out MSE within 10% instead: the port's
histogram sums (``index_add_``) are taken in another order than XLA's
``segment_sum``, so a near-tie split may go the other way.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import gbdt as ref_gbdt  # noqa: E402
from repro.core import engines as ref_engines  # noqa: E402
from repro.core import training as ref_training  # noqa: E402
from repro.gbdt import train as ref_train  # noqa: E402
from repro.index import ivf as ref_ivf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engines, training  # noqa: E402
from repro_torch.core import features as features_lib  # noqa: E402
from repro_torch.gbdt import infer  # noqa: E402
from repro_torch.gbdt import train  # noqa: E402


def _binned(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 11)).astype(np.float32)
    x[:, 3] = rng.integers(0, 5, n)          # heavy ties in one feature
    return x, train.compute_bin_edges(x, 64)


def test_bin_edges_and_bins_exact():
    x, edges = _binned()
    np.testing.assert_array_equal(edges, ref_train.compute_bin_edges(x, 64))
    xb_p = train.bin_data(torch.as_tensor(x), torch.as_tensor(edges),
                          chunk=1000)
    xb_r = ref_train.bin_data(jnp.asarray(x), jnp.asarray(edges))
    assert xb_p.dtype == torch.int32
    np.testing.assert_array_equal(xb_p.numpy(), np.asarray(xb_r))


@pytest.mark.parametrize("depth,mcw", [(6, 20.0), (3, 1.0)])
def test_grow_tree_equal_on_integer_gradients(depth, mcw):
    x, edges = _binned(1)
    xb = np.array(ref_train.bin_data(jnp.asarray(x), jnp.asarray(edges)))
    rng = np.random.default_rng(2)
    grad = rng.integers(-3, 4, x.shape[0]).astype(np.float32)
    grad += (x[:, 0] > 0.3) * 2.0
    w = rng.integers(1, 3, x.shape[0]).astype(np.float32)
    args = (depth, 64, 1.0, mcw, 0.1)
    out_r = ref_train._grow_tree(jnp.asarray(xb), jnp.asarray(grad),
                                 jnp.asarray(w), *args)
    out_p = train._grow_tree(torch.as_tensor(xb), torch.as_tensor(grad),
                             torch.as_tensor(w), *args)
    for name, a, b in zip(("feat", "thr", "leaf", "sample_val"), out_p,
                          out_r):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert (out_p[0] >= 0).sum() > 3  # the tree really split
    raw_p = train._bins_to_raw_thresholds(out_p[0], out_p[1],
                                          torch.as_tensor(edges))
    raw_r = ref_train._bins_to_raw_thresholds(out_r[0], out_r[1],
                                              jnp.asarray(edges))
    np.testing.assert_array_equal(raw_p.numpy(), np.asarray(raw_r))


def test_full_fit_heldout_mse_within_ten_percent():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6000, 11)).astype(np.float32)
    y = (np.tanh(x[:, 0] + 0.5 * x[:, 1] * x[:, 2])
         + 0.05 * rng.normal(size=6000)).astype(np.float32)
    cfg = train.GBDTConfig(num_trees=40, depth=5)
    p_r = ref_gbdt.fit(x[:5000], y[:5000],
                       ref_gbdt.GBDTConfig(**cfg._asdict()))
    p_p = train.fit(x[:5000], y[:5000], cfg, device="cpu")
    xh = x[5000:]
    mse_r = float(np.mean((np.asarray(ref_gbdt.predict_efficient(
        p_r, jnp.asarray(xh))) - y[5000:]) ** 2))
    mse_p = float(np.mean((infer.predict_efficient(
        p_p, torch.as_tensor(xh)).numpy() - y[5000:]) ** 2))
    assert mse_p <= 1.1 * mse_r, (mse_p, mse_r)


@pytest.fixture(scope="module")
def logs():
    rng = np.random.default_rng(6)
    centers = rng.integers(-12, 13, (16, 16))
    x = (centers[rng.integers(0, 16, 1200)]
         + rng.integers(-4, 5, (1200, 16))).astype(np.float32)
    learn = (centers[rng.integers(0, 16, 150)]
             + rng.integers(-6, 7, (150, 16))).astype(np.float32)
    ref_index = ref_ivf.build(x, nlist=12, seed=0)
    ref_index = dataclasses.replace(ref_index,
                                    centroids=jnp.round(ref_index.centroids))
    arrays = {f.name: np.asarray(getattr(ref_index, f.name))
              for f in dataclasses.fields(ref_index)
              if getattr(ref_index, f.name) is not None}
    index = convert.ivf_index_from_numpy(arrays, "cpu")
    _, gt_r = ref_training.ground_truth(jnp.asarray(learn), jnp.asarray(x), 10)
    _, gt_p = training.ground_truth(torch.as_tensor(learn),
                                    torch.as_tensor(x), 10)
    np.testing.assert_array_equal(gt_p.numpy(), np.asarray(gt_r))
    # batch 64 over 150 queries pads the tail batch (gt = -2)
    log_r = ref_training.generate_observations(
        ref_engines.ivf_engine(ref_index, k=10, nprobe=12),
        jnp.asarray(learn), gt_r, batch=64)
    log_p = training.generate_observations(
        engines.ivf_engine(index, k=10, nprobe=12), torch.as_tensor(learn),
        gt_p, batch=64)
    return log_r, log_p


def test_generate_observations_equal_reference(logs):
    """Recall, ndis, valid and the counter features are equal. The
    distance features agree to a few ulp: inside its jitted scan XLA's CPU
    sqrt is not correctly rounded (off by 1 ulp at times). The variance
    feature is E[d^2] - avg^2, a cancellation: its error is a few ulp of
    E[d^2] (~1.5e-5 at d ~ 16), not of the variance."""
    log_r, log_p = logs
    for name in ("features", "recall", "ndis", "valid"):
        a, b = getattr(log_p, name), getattr(log_r, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
    for name in ("recall", "ndis", "valid"):
        np.testing.assert_array_equal(getattr(log_p, name),
                                      getattr(log_r, name), err_msg=name)
    np.testing.assert_array_equal(log_p.features[..., :4],
                                  log_r.features[..., :4])
    var = features_lib.FEATURE_NAMES.index("var")
    other = [j for j in range(4, 11) if j != var]
    np.testing.assert_allclose(log_p.features[..., other],
                               log_r.features[..., other], rtol=2e-5)
    np.testing.assert_allclose(log_p.features[..., var],
                               log_r.features[..., var], rtol=0, atol=2e-4)


def test_dists_rt_equal_reference(logs):
    log_r, log_p = logs
    cfg = train.GBDTConfig(num_trees=3, depth=3, min_child_weight=5.0)
    tr_r = ref_training.fit_predictor(
        log_r, cfg=ref_gbdt.GBDTConfig(**cfg._asdict()))
    tr_p = training.fit_predictor(log_p, cfg=cfg, device="cpu")
    assert tr_p.dists_rt == tr_r.dists_rt
    assert tr_p.num_samples == tr_r.num_samples
    assert tr_p.metrics["mse"] <= 1.1 * tr_r.metrics["mse"] + 1e-6
