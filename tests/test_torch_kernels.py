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
# One intra-op thread: the test lane runs six workers on a few cores, and
# torch's default pool (a thread per core in every worker) oversubscribes
# them, which made these tests many times slower there.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import gbdt as ref_gbdt  # noqa: E402
from repro.data import vectors as ref_vectors  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import vectors  # noqa: E402
from repro_torch.kernels import cuda, ops, ref  # noqa: E402

# The GPU tests' l2_topk inputs, which the split-TF32 emulation below takes
# as they are (that module imports neither JAX nor the reference package).
import test_torch_cuda as gpu_cases  # noqa: E402

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


def _tf32(a):
    """cvt.rna.tf32.f32 on the CPU: f32 rounded to TF32's 10 stored
    mantissa bits, to nearest with ties away from zero (half of the 13
    dropped bits added to the magnitude, then the 13 bits cleared)."""
    bits = a.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32_l2_topk(q, x, xsq, k):
    """l2_topk.cu's arithmetic, emulated: each operand split as a = hi + lo
    (hi = tf32(a), lo = tf32(a - hi)), q.x taken as the three passes
    lo.hi + hi.lo + hi.hi in f32, then the top-k as the plain version
    selects it. Returns (dist, ids, x's lo part)."""
    qh = _tf32(q)
    ql = _tf32(q - qh)
    xf = x.float()
    xh = _tf32(xf)
    xl = _tf32(xf - xh)
    dot = ql @ xh.T + qh @ xl.T + qh @ xh.T
    dist = xsq[None, :] - 2.0 * dot
    b, n = dist.shape
    ids = torch.arange(n, dtype=torch.int32).expand(b, -1)
    d, i = ref.merge_topk(
        torch.cat([torch.full((b, k), float("inf")), dist], 1),
        torch.cat([torch.full((b, k), -1, dtype=torch.int32), ids], 1), k)
    return d, i, xl


def test_tf32_rounding_is_nearest_ties_away():
    ulp = 2.0 ** -10                    # TF32's spacing in [1, 2)
    a = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 3 * ulp / 2, 255.0, -2048.0, 2049.0])
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 255.0,
                         -2048.0, 2050.0])
    assert torch.equal(_tf32(a), want)


@pytest.mark.parametrize("case", list(gpu_cases.L2_INT_CASES))
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_l2_topk_split_tf32_integer_data_bit_equal(dt, case):
    """On the GPU test's integer inputs every value is exact in TF32 (its
    lo part is 0) and every partial sum is an integer below 2^24, so the
    three passes give the plain version's distances and ids bit for bit."""
    q, x = gpu_cases.l2_integer_inputs(dt, case)
    xsq = (x.float() ** 2).sum(1)
    assert torch.equal(_tf32(q), q) and torch.equal(_tf32(x.float()),
                                                    x.float())
    for k in (1, 10, 64):
        d_e, i_e, _ = _split_tf32_l2_topk(q, x, xsq, k)
        d_r, i_r = ref.l2_topk_ref(q, x, xsq, k)
        assert torch.equal(d_e, d_r) and torch.equal(i_e, i_r)
    assert int(i_e[0, 0]) == 17


@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,n,d,k", gpu_cases.L2_SHAPES)
def test_l2_topk_split_tf32_float_data_within_tolerance(dt, b, n, d, k):
    """On the GPU test's float inputs the three passes stay within that
    test's tolerance; bf16 and int8 codes have no lo part, so the kernel's
    two passes for them lose nothing."""
    q, x, xsq = gpu_cases.l2_float_inputs(dt, b, n, d, k)
    d_e, i_e, x_lo = _split_tf32_l2_topk(q, x, xsq, k)
    d_r, i_r = ref.l2_topk_ref(q, x, xsq, k)
    if dt != "f32":
        assert not x_lo.any()
    gpu_cases._close_ids(d_e, i_e, d_r, i_r, atol=1e-3 + 1e-5 * float(
        xsq[torch.isfinite(xsq)].max()))


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


def _merge_tiles_in_order(run_d, run_i, tiles, k):
    """The CUDA kernel's second pass, written out: per query, start from
    the running top-k and insert each tile's list, tile by tile and in list
    order, at position #(entries <= d); an entry at position k drops."""
    out_d, out_i = run_d.copy(), run_i.copy()
    for b in range(run_d.shape[0]):
        ld, li = list(run_d[b]), list(run_i[b])
        for td, ti in tiles:
            for d, i in zip(td[b], ti[b]):
                pos = sum(x <= d for x in ld)
                if pos < k:
                    ld, li = (ld[:pos] + [d] + ld[pos:])[:k], \
                        (li[:pos] + [i] + li[pos:])[:k]
        out_d[b], out_i[b] = ld, li
    return out_d, out_i


@pytest.mark.parametrize("tile", [7, 16, 64])
@pytest.mark.parametrize("k", [1, 5, 20])
def test_bucket_probe_tile_split_merges_to_the_single_pass(tile, k):
    """The invariant the CUDA kernel's tile split rests on: the k best of
    each column slice, filtered to d < the running k-th and merged in slice
    order by #(entries <= d) insertion, are the single pass's top-k, ties
    included; the per-slice counts sum to its count."""
    rng = np.random.default_rng(tile * 100 + k)
    b, c, d = 6, 150, 8
    q = rng.integers(-4, 5, (b, d)).astype(np.float32)
    vecs = rng.integers(-4, 5, (b, c, d)).astype(np.float32)
    for lo in range(tile, c, tile):   # equal rows across every boundary,
        vecs[:, lo - 1] = vecs[:, lo] = q   # at distance 0
    vecs[:, 3::11] = vecs[:, 2:3]     # more ties, inside and across slices
    ids = rng.integers(0, 10_000, (b, c)).astype(np.int32)
    ids[rng.random((b, c)) < 0.15] = -1
    ids[::2, tile:2 * tile] = -1      # a slice of tombstones only
    sqn = np.where(ids >= 0, (vecs ** 2).sum(2), np.inf).astype(np.float32)
    bias = (q ** 2).sum(1, keepdims=True).astype(np.float32)
    full = sqn - 2 * np.einsum("bd,bcd->bc", q, vecs) + bias
    run_d = np.sort(full[:, c - k:] + rng.integers(0, 2, (b, k)), 1)
    run_d[::3, 0] = 0                 # a running entry tied with the planted
    run_d[1::3, k // 2:] = np.inf
    run_d = run_d.astype(np.float32)
    run_i = rng.integers(20_000, 30_000, (b, k)).astype(np.int32)
    run_i[np.isinf(run_d)] = -1
    kth = np.median(full, axis=1, keepdims=True).astype(np.float32)
    args = [_t(a) for a in (q, vecs, sqn, ids, bias, kth, run_d, run_i)]
    want = [_np(a) for a in ref.bucket_probe_ref(*args)]

    empty_d = torch.full((b, k), float("inf"))
    empty_i = torch.full((b, k), -1, dtype=torch.int32)
    tiles, count = [], 0
    for lo in range(0, c, tile):
        sl = slice(lo, lo + tile)
        td, ti, tc = (_np(a) for a in ref.bucket_probe_ref(
            args[0], args[1][:, sl], args[2][:, sl], args[3][:, sl],
            args[4], args[5], empty_d, empty_i))
        keep = td < run_d[:, -1:]     # running entries win every tie
        tiles.append((np.where(keep, td, np.inf), np.where(keep, ti, -1)))
        count = count + tc
    got_d, got_i = _merge_tiles_in_order(run_d, run_i, tiles, k)
    np.testing.assert_array_equal(got_i, want[1])
    np.testing.assert_array_equal(got_d, want[0])
    np.testing.assert_array_equal(count, want[2])
    # the ties decided something: the top-k holds equal distances
    assert (np.diff(want[0], axis=1) == 0).any() or k == 1


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
