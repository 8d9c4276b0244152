"""The port's kernel entry points against the JAX reference's.

Inputs are made with numpy from a seed and handed to both packages. The
reference runs its Pallas kernels in interpret mode (``repro.kernels.ops``);
on the CPU the port runs the kernels' plain versions (``kernels/ref.py``).
Integer-valued vectors make every dot product exact in f32 whatever the
summation order, so ids, counts and the order of ties must be EQUAL;
float data is compared at 1e-3 (f32) and 0.3 (bf16) as in
tests/test_kernels.py. tests/test_torch_cuda.py holds each CUDA kernel
against its plain version on the card.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import gbdt as ref_gbdt  # noqa: E402
from repro.data import vectors as ref_vectors  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import vectors  # noqa: E402
from repro_torch.kernels import cuda, ops  # noqa: E402

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _t(a, dtype=None):
    a = np.asarray(a)
    return torch.as_tensor(a) if dtype is None else torch.as_tensor(
        a.astype(np.float32)).to(dtype)


def _np(a):
    return np.asarray(a.float() if a.dtype == torch.bfloat16 else a)


def test_make_dataset_bit_identical():
    a = vectors.make_dataset(n=500, d=8, num_learn=60, num_queries=20,
                             clusters=7, seed=3)
    b = ref_vectors.make_dataset(n=500, d=8, num_learn=60, num_queries=20,
                                 clusters=7, seed=3)
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(vectors.noisy_queries(a.queries, 0.5, seed=1),
                          ref_vectors.noisy_queries(b.queries, 0.5, seed=1))
    assert np.array_equal(vectors.ood_queries(8, 30, seed=2),
                          ref_vectors.ood_queries(8, 30, seed=2))


def _int_data(rng, b, n, d, dup=True):
    q = rng.integers(-8, 9, (b, d)).astype(np.float32)
    x = rng.integers(-8, 9, (n, d)).astype(np.float32)
    if dup and n >= 8:  # duplicated rows pin lowest-index-first ties
        x[n // 2:n // 2 + 3] = x[1]
        q[0] = x[1]
    return q, x


@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,n,d,k", [(5, 300, 16, 10), (3, 5, 16, 8),
                                     (9, 700, 7, 1)])
def test_l2_topk_matches_reference_exactly(dt, b, n, d, k):
    rng = np.random.default_rng(b * 1000 + n)
    q, x = _int_data(rng, b, n, d)
    d_r, i_r = ref_ops.l2_topk(jnp.asarray(q), jnp.asarray(x, JDT[dt]), k=k)
    d_p, i_p = ops.l2_topk(_t(q), _t(x, TDT[dt]), k=k)
    np.testing.assert_array_equal(_np(i_p), np.asarray(i_r))
    np.testing.assert_array_equal(_np(d_p), np.asarray(d_r))
    if n < k:  # empty slots carry (+inf, -1)
        assert (_np(i_p)[:, n:] == -1).all()
        assert np.isinf(_np(d_p)[:, n:]).all()


def test_l2_topk_sq8_bias_form_matches_reference():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    x8 = rng.integers(-127, 128, (400, 16)).astype(np.int8)
    scale = rng.uniform(0.01, 0.05, 16).astype(np.float32)
    offset = rng.normal(size=16).astype(np.float32)
    deq = x8.astype(np.float32) * scale + offset
    xsq = (deq ** 2).sum(1).astype(np.float32)
    qa = (q * scale).astype(np.float32)
    bias = ((q ** 2).sum(1, keepdims=True)
            - 2.0 * (q @ offset)[:, None]).astype(np.float32)
    d_r, i_r = ref_ops.l2_topk(jnp.asarray(qa), jnp.asarray(x8), k=10,
                               x_sqnorm=jnp.asarray(xsq),
                               bias=jnp.asarray(bias))
    d_p, i_p = ops.l2_topk(_t(qa), _t(x8), k=10, x_sqnorm=_t(xsq),
                           bias=_t(bias))
    np.testing.assert_allclose(_np(d_p), np.asarray(d_r), atol=1e-3)
    true = ((deq[None] - q[:, None]) ** 2).sum(2)
    np.testing.assert_allclose(_np(d_p), np.sort(true, 1)[:, :10],
                               rtol=1e-4, atol=1e-3)
    assert np.mean(_np(i_p) == np.asarray(i_r)) > 0.95


@pytest.mark.parametrize("dt,atol", [("f32", 1e-3), ("bf16", 0.3)])
def test_l2_topk_float_data_within_tolerance(dt, atol):
    rng = np.random.default_rng(11)
    q = rng.normal(size=(16, 64)).astype(np.float32)
    x = rng.normal(size=(1024, 64)).astype(np.float32)
    d_r, i_r = ref_ops.l2_topk(jnp.asarray(q, JDT[dt]),
                               jnp.asarray(x, JDT[dt]), k=10)
    d_p, i_p = ops.l2_topk(_t(q, TDT[dt]), _t(x, TDT[dt]), k=10)
    np.testing.assert_allclose(_np(d_p), np.asarray(d_r), atol=atol)
    if dt == "f32":
        assert np.mean(_np(i_p) == np.asarray(i_r)) > 0.99


def _probe_inputs(rng, b, c, d, k, dt):
    q = rng.integers(-8, 9, (b, d)).astype(np.float32)
    vecs = rng.integers(-8, 9, (b, c, d)).astype(np.float32)
    vecs[:, c // 2] = vecs[:, 1]                 # duplicated rows: ties
    ids = rng.integers(0, 10_000, (b, c)).astype(np.int32)
    ids[rng.random((b, c)) < 0.15] = -1          # pads and tombstones
    sqn = (vecs ** 2).sum(2).astype(np.float32)
    sqn[ids < 0] = np.inf
    bias = (q ** 2).sum(1, keepdims=True).astype(np.float32)
    # running top-k: real distances of some bucket rows (ties with the
    # bucket) followed by an empty +inf tail.
    full = sqn - 2 * np.einsum("bd,bcd->bc", q, vecs) + bias
    run_d = np.sort(full[:, :k] + rng.integers(0, 3, (b, k)), 1)
    run_d[:, k - 2:] = np.inf
    run_d = run_d.astype(np.float32)
    run_i = rng.integers(20_000, 30_000, (b, k)).astype(np.int32)
    run_i[:, k - 2:] = -1
    kth = run_d[:, -1:].copy()
    kth[::2] = np.median(full, axis=1, keepdims=True)[::2]
    if dt == "int8":
        vecs = vecs.astype(np.int8)
    return q, vecs, sqn, ids, bias, kth.astype(np.float32), run_d, run_i


@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,c,d,k", [(5, 64, 16, 7), (3, 40, 8, 10)])
def test_bucket_probe_matches_reference_exactly(dt, b, c, d, k):
    rng = np.random.default_rng(b * 100 + c)
    q, vecs, sqn, ids, bias, kth, run_d, run_i = _probe_inputs(
        rng, b, c, d, k, dt)
    d_r, i_r, c_r = ref_ops.bucket_probe(
        jnp.asarray(q), jnp.asarray(vecs, JDT[dt]), jnp.asarray(sqn),
        jnp.asarray(ids), jnp.asarray(bias), jnp.asarray(kth),
        jnp.asarray(run_d), jnp.asarray(run_i))
    d_p, i_p, c_p = ops.bucket_probe(
        _t(q), _t(vecs, TDT[dt]), _t(sqn), _t(ids), _t(bias), _t(kth),
        _t(run_d), _t(run_i))
    np.testing.assert_array_equal(_np(i_p), np.asarray(i_r))
    np.testing.assert_array_equal(_np(d_p), np.asarray(d_r))
    np.testing.assert_array_equal(_np(c_p), np.asarray(c_r))
    # the merge kept a running entry ahead of an equal bucket distance
    d_b, i_b = ops.bucket_topk(_t(q), _t(vecs, TDT[dt]), _t(sqn), _t(ids),
                               _t(run_d), _t(run_i))
    d_rb, i_rb = ref_ops.bucket_topk(
        jnp.asarray(q), jnp.asarray(vecs, JDT[dt]), jnp.asarray(sqn),
        jnp.asarray(ids), jnp.asarray(run_d), jnp.asarray(run_i))
    np.testing.assert_array_equal(_np(i_b), np.asarray(i_rb))


def test_bucket_probe_sq8_bias_form_matches_reference():
    rng = np.random.default_rng(5)
    b, c, d, k = 6, 48, 16, 10
    q = rng.normal(size=(b, d)).astype(np.float32)
    x8 = rng.integers(-127, 128, (b, c, d)).astype(np.int8)
    scale = rng.uniform(0.01, 0.05, d).astype(np.float32)
    offset = rng.normal(size=d).astype(np.float32)
    sqn = ((x8.astype(np.float32) * scale + offset) ** 2).sum(2)
    ids = np.arange(b * c, dtype=np.int32).reshape(b, c)
    qa = (q * scale).astype(np.float32)
    bias = ((q ** 2).sum(1, keepdims=True)
            - 2.0 * (q @ offset)[:, None]).astype(np.float32)
    run_d = np.full((b, k), np.inf, np.float32)
    run_i = np.full((b, k), -1, np.int32)
    kth = np.full((b, 1), np.inf, np.float32)
    out_r = ref_ops.bucket_probe(*(jnp.asarray(a) for a in (
        qa, x8, sqn, ids, bias, kth, run_d, run_i)))
    out_p = ops.bucket_probe(*(_t(a) for a in (
        qa, x8, sqn, ids, bias, kth, run_d, run_i)))
    np.testing.assert_allclose(_np(out_p[0]), np.asarray(out_r[0]),
                               atol=1e-3)
    np.testing.assert_array_equal(_np(out_p[2]), np.asarray(out_r[2]))


def test_bucket_probe_slots_gathers_and_masks_inactive():
    rng = np.random.default_rng(9)
    s, c, d, k, b = 6, 32, 16, 5, 4
    q, vecs, sqn, ids, bias, kth, run_d, run_i = _probe_inputs(
        rng, s, c, d, k, "f32")
    slot = np.array([4, 0, 4, 2], np.int32)
    active = np.array([True, False, True, True])
    qb, biasb, kthb = q[:b], bias[:b], kth[:b]
    rdb, rib = run_d[:b], run_i[:b]
    d_p, i_p, c_p = ops.bucket_probe_slots(
        _t(qb), _t(vecs), _t(sqn), _t(ids), _t(slot), _t(active),
        _t(biasb), _t(kthb), _t(rdb), _t(rib))
    d_r, i_r, c_r = ref_ops.bucket_probe(
        jnp.asarray(qb), jnp.asarray(vecs[slot]), jnp.asarray(sqn[slot]),
        jnp.asarray(ids[slot]), jnp.asarray(biasb), jnp.asarray(kthb),
        jnp.asarray(rdb), jnp.asarray(rib))
    a = active
    np.testing.assert_array_equal(_np(i_p)[a], np.asarray(i_r)[a])
    np.testing.assert_array_equal(_np(c_p)[a], np.asarray(c_r)[a])
    np.testing.assert_array_equal(_np(i_p)[~a], rib[~a])
    np.testing.assert_array_equal(_np(d_p)[~a], rdb[~a])
    assert (_np(c_p)[~a] == 0).all()


def _fitted_ensemble(trees=20, depth=4, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3000, 11)).astype(np.float32)
    y = (np.sin(x[:, 0]) + x[:, 1] * 0.3).astype(np.float32)
    return ref_gbdt.fit(x, y, ref_gbdt.GBDTConfig(num_trees=trees,
                                                  depth=depth)), rng


@pytest.mark.parametrize("trees,depth,b", [(20, 4, 37), (100, 6, 64)])
def test_gbdt_predict_matches_reference(trees, depth, b):
    p, rng = _fitted_ensemble(trees, depth)
    xq = rng.normal(size=(b, 11)).astype(np.float32)
    xq[0] = np.asarray(p.thresh)[0, 0]   # a row exactly on a threshold
    out_r = np.asarray(ref_ops.gbdt_predict(p, jnp.asarray(xq)))
    pt = convert.gbdt_params_from_numpy(ref_gbdt.to_state_dict(p), "cpu")
    out_p = ops.gbdt_predict(pt, _t(xq)).numpy()
    np.testing.assert_allclose(out_p, out_r, atol=1e-5)


def test_cpu_tensors_never_reach_the_cuda_wrappers():
    before = dict(cuda.LAUNCHES)
    rng = np.random.default_rng(0)
    q, x = _int_data(rng, 4, 50, 8)
    ops.l2_topk(_t(q), _t(x), k=3)
    assert cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.l2_topk(_t(q), _t(x), (_t(x) ** 2).sum(1), 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.gbdt_predict(_t(q), torch.zeros((1, 7), dtype=torch.int32),
                          torch.zeros((1, 7)), torch.zeros((1, 8)))


def test_build_names_by_source_hash_and_needs_nvcc(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    paths = {n: _build.library_path(n) for n in _build.KERNELS}
    assert len(set(paths.values())) == 3
    for name, path in paths.items():
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
        assert path == _build.library_path(name)  # stable for one source
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["gbdt_predict"])
