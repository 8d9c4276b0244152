"""Each CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA card and the CUDA toolkit's nvcc (the kernels
build at first use); elsewhere they skip. They import neither JAX nor the
reference package, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Integer-valued inputs make every dot product exact whatever the
summation order, so those cases must be EQUAL; float inputs agree to a
stated tolerance, and ids may differ only where distances tie within it.
"""
import contextlib
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import cuda, ops, ref  # noqa: E402

TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _close_ids(d_k, i_k, d_r, i_r, atol):
    finite = torch.isfinite(d_r)
    assert torch.equal(finite, torch.isfinite(d_k))
    assert torch.allclose(d_k[finite], d_r[finite], atol=atol, rtol=0)
    diff = i_k != i_r
    if diff.any():
        assert ((d_r[diff] - d_k[diff]).abs() <= atol).all()


# (queries, rows, width, k): ragged against the kernel's 128 x 128 block
# tile, a database below one tile, odd widths, several grid.y ranges, and
# k-means assignment (k = 1 against 1024 centroids) at a reduced batch.
L2_SHAPES = [(300, 5000, 128, 10), (70, 3000, 16, 1), (5, 20_000, 24, 64),
             (3, 7, 16, 10), (200, 100_000, 128, 10), (129, 1025, 24, 10),
             (257, 100, 40, 64), (4099, 1024, 128, 1)]
# Integer-valued data, exact in TF32 and in every f32 partial sum:
# (name, low, high (exclusive), queries, rows, width). int8 codes take the
# int8 range at SIFT's width.
L2_INT_CASES = {"-8..8": (-8, 9, 130, 9000, 40),
                "sift-0..255": (0, 256, 300, 60_000, 128)}


def l2_float_inputs(dt, b, n, d, k):
    """(q, x, x_sqnorm) on the CPU: normal data, int8 codes with a scaled
    query, and every 97th row at +inf (rows that must never win)."""
    rng = np.random.default_rng(n + k)
    q = torch.as_tensor(rng.normal(size=(b, d)), dtype=torch.float32)
    if dt == "int8":
        x = torch.as_tensor(rng.integers(-127, 128, (n, d))).to(torch.int8)
        q = q * 0.05
    else:
        x = torch.as_tensor(rng.normal(size=(n, d))).to(TDT[dt])
    xsq = (x.float() ** 2).sum(1)
    xsq[::97] = float("inf")
    return q, x, xsq


def l2_integer_inputs(dt, case):
    """(q, x) on the CPU, integer-valued, with rows equal to x[17] planted
    (q[0] among them), so the lowest row must come first on a tie."""
    lo, hi, b, n, d = L2_INT_CASES[case]
    if dt == "int8" and hi > 128:   # shifted into the int8 range
        lo, hi = lo - 128, hi - 128
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.integers(lo, hi, (b, d)), dtype=torch.float32)
    x = torch.as_tensor(rng.integers(lo, hi, (n, d))).to(TDT[dt])
    x[4000:4010] = x[17]            # duplicates: lowest row first
    x[n - 1] = x[17]                # and one in the last range
    q[0] = x[17].float()
    return q, x


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,n,d,k", L2_SHAPES)
def test_l2_topk_kernel_matches_plain(dev, dt, b, n, d, k):
    q, x, xsq = (t.to(dev) for t in l2_float_inputs(dt, b, n, d, k))
    before = cuda.LAUNCHES["l2_topk"]
    d_k, i_k = cuda.l2_topk(q, x, xsq, k)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["l2_topk"] == before + 1
    d_r, i_r = ref.l2_topk_ref(q, x, xsq, k)
    _close_ids(d_k, i_k, d_r, i_r, atol=1e-3 + 1e-5 * float(
        xsq[torch.isfinite(xsq)].max()))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(L2_INT_CASES))
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_l2_topk_kernel_integer_data_exact(dev, dt, case):
    q, x = (t.to(dev) for t in l2_integer_inputs(dt, case))
    xsq = (x.float() ** 2).sum(1)
    for k in (1, 10, 64):
        got = cuda.l2_topk(q, x, xsq, k)
        want = ref.l2_topk_ref(q, x, xsq, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    d, i = ops.l2_topk(q, x, k=5)
    assert i.is_cuda and int(i[0, 0]) == 17


# The k buckets of l2_topk.cu: 64 (the last k of the 128-query block) and
# 128 (64-query blocks), with k = 65 and 128 at their edges and k = 100,
# the evaluation's wide ground truth. (queries, rows, width) run ragged
# against both block shapes, over several grid.y ranges.
L2_WIDE_K = [64, 65, 100, 128]
L2_WIDE_SHAPES = [(300, 20_000, 128), (65, 3000, 24), (1000, 100_000, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "int8"])
@pytest.mark.parametrize("k", L2_WIDE_K)
@pytest.mark.parametrize("b,n,d", L2_WIDE_SHAPES)
def test_l2_topk_wide_k_matches_plain(dev, dt, k, b, n, d):
    q, x, xsq = (t.to(dev) for t in l2_float_inputs(dt, b, n, d, k))
    d_k, i_k = cuda.l2_topk(q, x, xsq, k)
    torch.cuda.synchronize()
    d_r, i_r = ref.l2_topk_ref(q, x, xsq, k)
    _close_ids(d_k, i_k, d_r, i_r, atol=1e-3 + 1e-5 * float(
        xsq[torch.isfinite(xsq)].max()))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(L2_INT_CASES))
@pytest.mark.parametrize("dt", ["f32", "int8"])
def test_l2_topk_wide_k_integer_data_exact(dev, dt, case):
    """Both k buckets on integer data: bit-equal to the plain version,
    the lowest row first on a tie; flat.search at k = 100 goes through
    the kernel."""
    from repro_torch.index import flat
    q, x = (t.to(dev) for t in l2_integer_inputs(dt, case))
    xsq = (x.float() ** 2).sum(1)
    for k in L2_WIDE_K:
        got = cuda.l2_topk(q, x, xsq, k)
        want = ref.l2_topk_ref(q, x, xsq, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if dt == "f32":
        before = cuda.LAUNCHES["l2_topk"]
        d, i = flat.search(q, x, 100)
        assert cuda.LAUNCHES["l2_topk"] == before + 1
        assert i.shape == (q.shape[0], 100) and int(i[0, 0]) == 17


def _probe_inputs(rng, b, c, d, k, dev, ties=False):
    q = rng.integers(-8, 9, (b, d)).astype(np.float32)
    vecs = rng.integers(-8, 9, (b, c, d)).astype(np.float32)
    vecs[:, c // 2] = vecs[:, 1]                 # duplicated rows: ties
    ids = rng.integers(0, 10_000, (b, c)).astype(np.int32)
    ids[rng.random((b, c)) < 0.15] = -1          # pads and tombstones
    if ties:
        # The kernel splits a bucket into tiles of cuda.probe_tile() rows:
        # plant rows equal to the query (distance 0, so they reach the top
        # k) on both sides of every tile boundary and inside the first tile.
        tile = cuda.probe_tile()
        for lo in range(tile, c, tile):
            vecs[:, lo - 1] = vecs[:, lo] = q
            ids[:, lo - 1:lo + 1] = rng.integers(0, 10_000, (b, 2))
        vecs[:, min(c, tile) * 2 // 3] = q
        if c > 2 * tile:
            ids[::2, tile:2 * tile] = -1             # a tile of tombstones
            ids[1::2, (c - 1) // tile * tile:] = -1  # a last tile of pads
    sqn = (vecs ** 2).sum(2).astype(np.float32)
    sqn[ids < 0] = np.inf
    bias = (q ** 2).sum(1, keepdims=True).astype(np.float32)
    full = sqn - 2 * np.einsum("bd,bcd->bc", q, vecs) + bias
    run_d = np.sort(full[:, :k] + rng.integers(0, 3, (b, k)), 1)
    if ties:
        run_d[1::3, 0] = 0                       # ties the planted rows
    run_d[:, k - 2:] = np.inf
    run_i = rng.integers(20_000, 30_000, (b, k)).astype(np.int32)
    run_i[:, k - 2:] = -1
    kth = run_d[:, -1:].copy()
    kth[::2] = np.median(full, axis=1, keepdims=True)[::2]
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in
                 (q, vecs, sqn, ids, bias, kth.astype(np.float32),
                  run_d.astype(np.float32), run_i))


# (cap, width, k, queries, share of them active, tile-boundary ties planted)
PROBE_CASES = {
    "200-128-10": (200, 128, 10, 40, 0.7, False),
    "2500-16-64": (2500, 16, 64, 40, 0.7, False),
    "33-7-5": (33, 7, 5, 40, 0.7, False),
    "1400-128-10": (1400, 128, 10, 40, 0.7, False),
    "768-24-10": (768, 24, 10, 40, 0.7, True),
    "1100-7-10": (1100, 7, 10, 40, 0.7, True),
    "1024-128-1": (1024, 128, 1, 40, 0.7, True),
    "1400-128-64-ties": (1400, 128, 64, 40, 0.7, True),
    "900-32-64-one-query": (900, 32, 64, 1, 1.0, True),
    "900-32-64-all-inactive": (900, 32, 64, 9, 0.0, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("c,d,k,b,share,ties", list(PROBE_CASES.values()),
                         ids=list(PROBE_CASES))
def test_bucket_probe_kernel_matches_plain(dev, dt, c, d, k, b, share, ties):
    rng = np.random.default_rng(c + d)
    s = 12
    q, vecs, sqn, ids, bias, kth, run_d, run_i = _probe_inputs(
        rng, s, c, d, k, dev, ties)
    vecs = vecs.to(TDT[dt])
    slot = torch.as_tensor(rng.integers(0, s, b), dtype=torch.int32,
                           device=dev)
    active = torch.as_tensor(rng.random(b) < share, device=dev)
    sl = slot.long()
    args = (q[sl].contiguous(), vecs, sqn, ids, slot, active,
            bias[sl].contiguous(), kth[sl].contiguous(),
            run_d[sl].contiguous(), run_i[sl].contiguous())
    got = cuda.bucket_probe_slots(*args)
    want = ref.bucket_probe_slots_ref(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[1][~active], args[9][~active])
    assert not got[2][~active].any()
    pre = (args[0], vecs[sl].contiguous(), sqn[sl].contiguous(),
           ids[sl].contiguous()) + args[6:]
    for g, w in zip(cuda.bucket_probe(*pre), ref.bucket_probe_ref(*pre)):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_bucket_probe_kernel_float_data(dev):
    rng = np.random.default_rng(3)
    s, c, d, k, b = 64, 1400, 128, 10, 256
    vecs = torch.as_tensor(rng.normal(size=(s, c, d)) * 4,
                           dtype=torch.float32, device=dev)
    ids = torch.arange(s * c, dtype=torch.int32, device=dev).reshape(s, c)
    ids[:, 1300:] = -1
    sqn = torch.where(ids >= 0, (vecs ** 2).sum(2), float("inf"))
    q = torch.as_tensor(rng.normal(size=(b, d)) * 4, dtype=torch.float32,
                        device=dev)
    bias = (q ** 2).sum(1, keepdim=True)
    run_d = torch.full((b, k), float("inf"), device=dev)
    run_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    slot = torch.as_tensor(rng.integers(0, s, b), dtype=torch.int32,
                           device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    args = (q, vecs, sqn, ids, slot, active, bias, run_d[:, -1:].contiguous(),
            run_d, run_i)
    got = cuda.bucket_probe_slots(*args)
    want = ref.bucket_probe_slots_ref(*args)
    _close_ids(got[0], got[1], want[0], want[1],
               atol=1e-3 + 1e-5 * float(sqn[ids >= 0].max()))
    assert torch.equal(got[2], want[2])


# (trees, depth, rows, features) and the path the launch plan takes there
# on an H100 (132 SMs): trees staged in shared memory, x staged, trees
# staged in more than one chunk. The main config (100 trees of depth 6, 11
# features) from one row to blocks looping over row tiles (and at 20,000
# rows, tiles of 256 rows with the trees split over 4 warps), a small
# ensemble, ensembles staged in chunks (few rows, and many rows with two
# tiles a block), trees too large for shared memory (read from device
# memory) and x rows too wide for their tile, alone and together.
GBDT_CASES = [(100, 6, 1, 11, 1, 1, 0), (100, 6, 37, 11, 1, 1, 0),
              (100, 6, 1000, 11, 1, 1, 0), (100, 6, 20_000, 11, 1, 1, 0),
              (100, 6, 70_000, 11, 1, 1, 0),
              (7, 3, 1000, 11, 1, 1, 0), (600, 6, 1000, 11, 1, 1, 1),
              (600, 6, 150_000, 11, 1, 1, 1), (20, 4, 70_000, 40, 1, 0, 0),
              (3, 15, 1000, 11, 0, 1, 0), (3, 15, 70_000, 40, 0, 0, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("t,depth,b,f,tree_smem,x_smem,chunked", GBDT_CASES)
def test_gbdt_kernel_matches_plain(dev, t, depth, b, f, tree_smem, x_smem,
                                   chunked):
    plan = cuda.gbdt_plan(b, f, t, depth)
    assert (plan["tree_smem"], plan["x_smem"], plan["nchunks"] > 1) == (
        tree_smem, x_smem, bool(chunked)), plan
    rng = np.random.default_rng(4)
    feat = rng.integers(-1, f, (t, 2 ** depth - 1)).astype(np.int32)
    thresh = rng.normal(size=(t, 2 ** depth - 1)).astype(np.float32)
    thresh[:, ::7] = np.inf
    leaf = (rng.normal(size=(t, 2 ** depth)) * 0.01).astype(np.float32)
    feat, thresh, leaf = (torch.as_tensor(a, device=dev)
                          for a in (feat, thresh, leaf))
    x = torch.as_tensor(rng.normal(size=(b, f)), dtype=torch.float32,
                        device=dev)
    x[0, 3] = thresh[0, 0] if torch.isfinite(thresh[0, 0]) else 0.0
    # A row exactly on the root's threshold of tree 0 goes left.
    x[-1, max(int(feat[0, 0]), 0)] = thresh[0, 0].clamp(max=1e30)
    got = cuda.gbdt_predict(x, feat, thresh, leaf)
    want = ref.gbdt_predict_ref(x, feat, thresh, leaf)
    assert torch.allclose(got, want, atol=1e-5, rtol=0)
    # No atomics: a second call on the same inputs is bit-equal.
    assert torch.equal(got, cuda.gbdt_predict(x, feat, thresh, leaf))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "int8"])
def test_bucket_probe_over_a_split_store(dev, dt):
    """The cold tier's probe: a store of S resident buckets, each query
    reading slot hot_map[bucket] where it is resident and active, keeping
    its list and counting 0 where its bucket is cold (as probe_step
    passes ``active & hot``)."""
    rng = np.random.default_rng(9)
    nlist, s, c, d, k, b = 48, 12, 600, 128, 10, 256
    q, vecs, sqn, ids, bias, kth, run_d, run_i = _probe_inputs(
        rng, s, c, d, k, dev, ties=True)
    vecs = vecs.to(TDT[dt])
    hot = rng.choice(nlist, s, replace=False)
    hot_map = torch.full((nlist,), -1, dtype=torch.int32, device=dev)
    hot_map[torch.as_tensor(hot, device=dev)] = torch.arange(
        s, dtype=torch.int32, device=dev)
    bucket = torch.as_tensor(rng.integers(0, nlist, b), device=dev)
    slot = hot_map[bucket]
    resident = slot >= 0
    slot = slot.clamp_min(0).contiguous()
    active = torch.as_tensor(rng.random(b) < 0.8, device=dev) & resident
    assert resident.any() and (~resident).any()
    row = torch.as_tensor(rng.integers(0, s, b), device=dev)
    args = (q[row].contiguous(), vecs, sqn, ids, slot, active,
            bias[row].contiguous(), kth[row].contiguous(),
            run_d[row].contiguous(), run_i[row].contiguous())
    got = cuda.bucket_probe_slots(*args)
    want = ref.bucket_probe_slots_ref(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[1][~active], args[9][~active])
    assert not got[2][~active].any()


@pytest.mark.gpu
@pytest.mark.parametrize("t,depth", [(1, 8), (40, 6)])
@pytest.mark.parametrize("b", [512, 1000, 20_000])
def test_gbdt_kernel_baseline_ensembles(dev, t, depth, b):
    """The model-selection baselines' shapes: a decision tree of depth 8
    and a 40-tree random forest of depth 6, at LAET's and the hold-out's
    row counts."""
    rng = np.random.default_rng(t + depth)
    feat = rng.integers(-1, 11, (t, 2 ** depth - 1)).astype(np.int32)
    thresh = rng.normal(size=(t, 2 ** depth - 1)).astype(np.float32)
    leaf = (rng.normal(size=(t, 2 ** depth)) / t).astype(np.float32)
    feat, thresh, leaf = (torch.as_tensor(a, device=dev)
                          for a in (feat, thresh, leaf))
    x = torch.as_tensor(rng.normal(size=(b, 11)), dtype=torch.float32,
                        device=dev)
    got = cuda.gbdt_predict(x, feat, thresh, leaf)
    want = ref.gbdt_predict_ref(x, feat, thresh, leaf)
    assert torch.allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros((4, 8), device=dev)
    x = torch.zeros((16, 8), device=dev)
    xsq = torch.zeros(16, device=dev)
    with pytest.raises(ValueError, match="range"):
        cuda.l2_topk(q, x, xsq, cuda.L2_MAX_K + 1)
    with pytest.raises(ValueError, match="range"):
        cuda.bucket_probe(q, x[None].expand(4, 16, 8).contiguous(),
                          xsq[None].expand(4, 16).contiguous(),
                          torch.zeros((4, 16), dtype=torch.int32, device=dev),
                          xsq[:4, None].contiguous(),
                          xsq[:4, None].contiguous(),
                          torch.zeros((4, 65), device=dev),
                          torch.zeros((4, 65), dtype=torch.int32, device=dev))
    with pytest.raises(TypeError):
        cuda.l2_topk(q.double(), x, xsq, 4)
    with pytest.raises(ValueError, match="contiguous"):
        cuda.l2_topk(q, x.t().contiguous().t(), xsq, 4)
    with pytest.raises(ValueError):
        cuda.l2_topk(q, x.cpu(), xsq, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [0, 256])
def test_hnsw_build_and_search_on_the_card_equal_the_cpu(dev, width):
    """hnsw.build -> search on the card against the same on the CPU. On
    SIFT-range integers every distance is exact in f32 (the card's matmuls
    stay f32: TF32 is off), so the graphs and the searches must be equal,
    with the exact visited bitmap and with the hashed filter (width 256)."""
    from repro_torch.index import hnsw
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (3000, 32)).astype(np.float32)
    x[10:14] = x[3]                 # duplicates: ties
    q = rng.integers(0, 256, (40, 32)).astype(np.float32)
    q[0] = x[3]
    kw = dict(m=12, ef_construction=32, passes=2, chunk=1024, seed=0)
    g_dev = hnsw.build(x, device=dev, **kw)
    g_cpu = hnsw.build(x, device="cpu", **kw)
    for name in ("neighbors", "entry", "route_ids", "sqnorm"):
        assert torch.equal(getattr(g_dev, name).cpu(), getattr(g_cpu, name))
    out_dev = hnsw.search(g_dev, torch.as_tensor(q, device=dev), k=10, ef=64,
                          visited_width=width)
    out_cpu = hnsw.search(g_cpu, torch.as_tensor(q), k=10, ef=64,
                          visited_width=width)
    for a, b in zip(out_dev[:2], out_cpu[:2]):
        assert torch.equal(a.cpu(), b)
    for name in ("ndis", "ninserts", "nstep", "visited"):
        assert torch.equal(getattr(out_dev[2], name).cpu(),
                           getattr(out_cpu[2], name))


@pytest.fixture(scope="module")
def served_on_card():
    """A small IVF index built on the card from integer data (every
    distance exact), a Darth fitted there, the queries and mixed targets,
    and darth_search's per-query ids and ndis in batches of the pool's
    16 slots (so every device call has the server's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.core import api, darth_search, engines
    from repro_torch.index import ivf
    rng = np.random.default_rng(4)
    centers = rng.integers(-12, 13, (24, 16))

    def draw(m, spread):
        return (centers[rng.integers(0, 24, m)]
                + rng.integers(-spread, spread + 1, (m, 16))
                ).astype(np.float32)
    x, learn, q = draw(4000, 4), draw(600, 6), draw(100, 6)
    rts = np.random.default_rng(0).choice([0.8, 0.9, 0.95, 0.99],
                                          100).astype(np.float32)
    index = ivf.build(x, nlist=16, seed=0, device="cuda")
    d = api.Darth(make_engine=lambda **kw: engines.ivf_engine(index, **kw),
                  engine=engines.ivf_engine(index, k=10, nprobe=16))
    d.fit(learn, x)
    qd = torch.as_tensor(q, device="cuda")
    ids, ndis = [], []
    for lo in range(0, q.shape[0], 16):
        sel = np.resize(np.arange(lo, min(lo + 16, q.shape[0])), 16)
        st = darth_search.darth_search(
            d.engine, qd[torch.as_tensor(sel, device="cuda")], rts[sel],
            d.trained.predictor, d.interval_for_target(rts[sel]))
        keep = min(16, q.shape[0] - lo)
        ids.append(d.engine.topk_i(st.inner)[:keep].cpu().numpy())
        ndis.append(st.inner.ndis[:keep].cpu().numpy())
    return d, q, rts, np.concatenate(ids), np.concatenate(ndis)


@pytest.mark.gpu
@pytest.mark.parametrize("hosts,traced", [(1, False), (4, False), (1, True),
                                          (4, True)])
def test_darth_server_on_the_card_equals_darth_search(served_on_card, hosts,
                                                      traced):
    """DarthServer on the card returns, per query, the ids (and, read from
    the traced terminal spans, the ndis) of darth_search with per-query
    intervals, through the kernels."""
    from repro_torch.obs import Tracer
    from repro_torch.serve import DarthServer
    d, q, rts, ids, ndis = served_on_card
    tracer = Tracer() if traced else None
    before = dict(cuda.LAUNCHES)
    results, stats = DarthServer(
        d.engine, d.trained.predictor, d.interval_for_target, num_slots=16,
        steps_per_sync=2, hosts=hosts, tracer=tracer).serve(q, rts)
    assert all(cuda.LAUNCHES[k] > before[k]
               for k in ("bucket_probe", "gbdt_predict"))
    assert stats.completed == q.shape[0] and stats.refills > 0
    for qid, (_, got) in enumerate(results):
        np.testing.assert_array_equal(got, ids[qid])
    assert stats.ndis_harvested == int(ndis.sum())
    if traced:
        terms = tracer.terminals()
        assert sorted(terms) == list(range(q.shape[0]))
        assert [terms[i].attrs["ndis"] for i in range(q.shape[0])] == \
            ndis.tolist()
        assert any(t.attrs["reason"] == "interval_met"
                   for t in terms.values())


@pytest.mark.gpu
def test_delta_ring_write_and_tombstone_on_the_card(dev):
    """A write padded with slot -1 drops the pad rows on the card as on the
    CPU (never onto the last slot); a tombstone masks only named slots and
    leaves the ring it was given as it was."""
    from repro_torch import mutate
    rng = np.random.default_rng(3)
    vecs = rng.integers(-9, 10, (6, 8)).astype(np.float32)
    slots = np.array([0, 5, -1, 15, -1, 2], np.int32)    # 15 = last slot
    ids = np.array([10, 11, -1, 12, -1, 13], np.int32)
    got = mutate.delta.write(mutate.make_delta(16, 8, device=dev), slots,
                             vecs, ids)
    want = mutate.delta.write(mutate.make_delta(16, 8, device="cpu"), slots,
                              vecs, ids)
    dead = np.array([5, -1, 15, -1], np.int32)
    got2, want2 = (mutate.delta.tombstone(got, dead),
                   mutate.delta.tombstone(want, dead))
    for a, b in ((got, want), (got2, want2)):
        for name in ("vecs", "ids", "sqnorm"):
            assert torch.equal(getattr(a, name).cpu(), getattr(b, name))
    assert int(got.ids[15]) == 12 and int(got.ids[14]) == -1
    assert int(mutate.delta.live_count(got2)) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 10, 64])
def test_delta_topk_on_the_card_equals_the_cpu(dev, k):
    """delta_topk through the l2_topk kernel over a ring that holds empty
    and tombstoned rows (sqnorm +inf): those rows never enter, live and
    ninserts are equal, distances and ids agree to phase 3's tolerance
    (1e-3 + 1e-5 x the largest sqnorm; ids may differ only on ties within
    it). Float data, as the delta scan serves it."""
    from repro_torch import mutate
    rng = np.random.default_rng(k)
    cap, d = 4096, 32
    n = 2500
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    slots = rng.permutation(cap)[:n].astype(np.int32)
    ids = np.arange(1000, 1000 + n, dtype=np.int32)
    dead = slots[::3].copy()
    ring = {}
    for where in (dev, "cpu"):
        r = mutate.delta.write(mutate.make_delta(cap, d, device=where),
                               slots, vecs, ids)
        ring[where] = mutate.delta.tombstone(r, dead)
    q = rng.normal(size=(300, d)).astype(np.float32)
    before = cuda.LAUNCHES["l2_topk"]
    got = mutate.delta.delta_topk(ring[dev], torch.as_tensor(q, device=dev),
                                  k)
    assert cuda.LAUNCHES["l2_topk"] == before + 1
    want = mutate.delta.delta_topk(ring["cpu"], torch.as_tensor(q), k)
    tol = 1e-3 + 1e-5 * float(ring["cpu"].sqnorm[
        torch.isfinite(ring["cpu"].sqnorm)].max())
    _close_ids(got[0].cpu(), got[1].cpu(), want[0], want[1], tol)
    assert int(got[2]) == int(want[2]) == n - dead.size
    assert torch.equal(got[3].cpu(), want[3])
    dead_ids = set(ids[np.isin(slots, dead)].tolist())
    assert not (set(got[1].cpu().numpy().ravel().tolist()) & dead_ids)
    assert (got[1] >= 0).all()


@pytest.mark.gpu
def test_mask_ivf_slots_with_a_repeated_bucket_on_the_card(dev):
    """Deleting several slots of one bucket lowers its size by the count
    (a scatter-add: probe_step's ndis reads these sizes), tombstones the
    slots and never writes the index it was given."""
    from repro_torch.index import ivf
    from repro_torch.mutate.index import _mask_ivf_slots, _pad_idx
    x = np.random.default_rng(5).integers(-8, 9, (3000, 16)).astype(
        np.float32)
    index = ivf.build(x, nlist=8, seed=0, device=dev)
    sizes = index.bucket_sizes.clone()
    b = np.array([2, 2, 2, 5, 2], np.int64)
    s = np.array([0, 1, 3, 0, 4], np.int64)
    out = _mask_ivf_slots(index, _pad_idx(b), _pad_idx(s))
    want = sizes.clone()
    want[2] -= 4
    want[5] -= 1
    assert torch.equal(out.bucket_sizes, want)
    assert torch.equal(index.bucket_sizes, sizes)
    assert (out.bucket_ids[2, [0, 1, 3, 4]] == -1).all()
    assert torch.isinf(out.bucket_sqnorm[5, 0])
    assert (index.bucket_ids[2, [0, 1, 3, 4]] >= 0).all()
    assert out.bucket_vecs is index.bucket_vecs


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ivf", "hnsw"])
def test_empty_delta_wrapper_on_the_card_is_the_base_engine(dev, kind):
    """With an empty ring, the mutable wrapper on the card returns the base
    engine's distances, ids, ndis and ninserts bit for bit (the delta scan
    runs, and its +inf rows change nothing)."""
    from repro_torch import mutate
    from repro_torch.core import darth_search, engines
    from repro_torch.index import hnsw, ivf
    rng = np.random.default_rng(6)
    x = rng.integers(0, 256, (4000, 32)).astype(np.float32)
    q = torch.as_tensor(rng.integers(0, 256, (64, 32)).astype(np.float32),
                        device=dev)
    if kind == "ivf":
        base = engines.ivf_engine(ivf.build(x, nlist=16, seed=0, device=dev),
                                  k=10, nprobe=16)
    else:
        base = engines.hnsw_engine(
            hnsw.build(x, m=12, ef_construction=32, passes=1, device=dev),
            k=10, ef=48)
    mut = mutate.MutableIndex(base.index, capacity=256)
    assert mut.delta.device == base.index.device
    wrap = engines.mutable_engine(base, mut.delta)
    before = cuda.LAUNCHES["l2_topk"]
    s_w = darth_search.plain_search(wrap, q)
    assert cuda.LAUNCHES["l2_topk"] == before + 1
    s_b = darth_search.plain_search(base, q)
    assert torch.equal(wrap.topk_d(s_w), base.topk_d(s_b))
    assert torch.equal(wrap.topk_i(s_w), base.topk_i(s_b))
    assert torch.equal(s_w.ndis, s_b.ndis)
    assert torch.equal(s_w.ninserts, s_b.ninserts)


def _fit_log(rows=200_000, feats=11, seed=3):
    """A recall-predictor training set of a step log's shape: 11 features,
    recall in [0, 1]."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, feats)).astype(np.float32)
    y = 1.0 / (1.0 + np.exp(-(x @ rng.normal(size=feats))))
    y = np.clip(y + 0.05 * rng.normal(size=rows), 0.0, 1.0)
    return x, y.astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["kmeans", "gbdt", "random_forest"])
def test_fit_and_kmeans_repeat_bit_for_bit_on_the_card(dev, what):
    """Two runs on the same inputs give the same bits: k-means centroids
    (200,000 x 128 rows into 1024 clusters) and every tree's feat, thresh
    and leaf of a GBDT (the fit's settings) and of a random forest on a
    200,000-row, 11-feature log. Float index_add_ on the card adds in no
    fixed order, which made these differ from call to call."""
    if what == "kmeans":
        from repro_torch.data import vectors
        from repro_torch.index import kmeans
        ds = vectors.make_dataset(n=200_000, d=128, num_learn=0,
                                  num_queries=0, clusters=1024, seed=0)
        x = torch.as_tensor(ds.base, device=dev)
        assert torch.equal(kmeans.kmeans(x, 1024), kmeans.kmeans(x, 1024))
        return
    from repro_torch.gbdt import train as gbdt_train
    x, y = _fit_log()
    fit = (gbdt_train.fit if what == "gbdt"
           else gbdt_train.fit_random_forest)
    a, b = fit(x, y, device=dev), fit(x, y, device=dev)
    for name in ("feat", "thresh", "leaf", "base"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2, 4, 7])
def test_sharded_flat_search_on_the_card_equals_flat_search(dev, shards):
    """Every shard on cuda:0 (N = 200,000 rows, which 7 does not divide):
    the ids, and the distances, equal flat.search's bit for bit, since
    each pair's distance is computed the same way whatever the shard; each
    shard launches l2_topk once a query chunk."""
    from repro_torch.dist import collectives
    from repro_torch.index import flat
    from repro_torch.launch import mesh as mesh_lib
    rng = np.random.default_rng(shards)
    x = torch.as_tensor(rng.normal(size=(200_000, 128)).astype(np.float32),
                        device=dev)
    x[150_000:150_005] = x[17]           # ties across shard boundaries
    q = torch.as_tensor(rng.normal(size=(1500, 128)).astype(np.float32),
                        device=dev)
    q[0] = x[17]
    mesh = mesh_lib.make_search_mesh(shards, "cuda:0")
    want = flat.search(q, x, 10)
    before = cuda.LAUNCHES["l2_topk"]
    got = collectives.sharded_flat_search(q, x, 10, mesh)
    assert cuda.LAUNCHES["l2_topk"] == before + 2 * shards
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.gpu
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 4, 7])
def test_sharded_probe_step_on_the_card_equals_probe_step(dev, shards,
                                                          quantize):
    """Per step, the sharded probe step over a placed index (every shard
    on cuda:0) equals ivf.probe_step in every field, bit for bit; a third
    of the queries stop at step 2, as DARTH stops them."""
    from repro_torch import dist
    from repro_torch.core import engines
    from repro_torch.dist import collectives
    from repro_torch.index import ivf
    from repro_torch.launch import mesh as mesh_lib
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(64, 64)) * 4
    x = (centers[rng.integers(0, 64, 60_000)]
         + rng.normal(size=(60_000, 64))).astype(np.float32)
    qn = (centers[rng.integers(0, 64, 300)]
          + rng.normal(size=(300, 64))).astype(np.float32)
    index = ivf.build(x, nlist=64, seed=0, quantize=quantize, device=dev)
    mesh = mesh_lib.make_search_mesh(shards, "cuda:0")
    placed = dist.place_index(index, mesh)
    step = collectives.make_sharded_probe_step(mesh)
    q = torch.as_tensor(qn, device=dev)
    s1 = ivf.init_state(index, q, k=10, nprobe=12)
    s2 = collectives.make_sharded_ivf_init(mesh)(placed, q, k=10, nprobe=12)
    stop = torch.as_tensor(np.arange(300) % 3 == 0, device=dev)
    for t in range(13):
        if t == 2:
            s1 = engines.set_active(s1, s1.active & ~stop)
            s2 = engines.set_active(s2, s2.active & ~stop)
        before = cuda.LAUNCHES["bucket_probe"]
        s1 = ivf.probe_step(index, s1)
        s2 = step(placed, s2)
        assert cuda.LAUNCHES["bucket_probe"] == before + 1 + shards
        for name in ("topk_d", "topk_i", "ndis", "ninserts", "probe_pos",
                     "active"):
            assert torch.equal(getattr(s1, name), getattr(s2, name)), \
                (t, name)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [0, 4096])
@pytest.mark.parametrize("shards", [1, 2, 4, 7])
def test_sharded_beam_step_on_the_card_equals_beam_step(dev, shards, width):
    """Per step, on float data, the sharded beam step over a placed graph
    (every shard on cuda:0) equals hnsw.beam_step in every field, bit for
    bit, with the exact bitmap and the hashed filter (S = 7 does not
    divide a power-of-two width and must raise); a third of the queries
    stop at step 4. Each shard's gather keeps beam_step's [B, M, D]
    shape, so its product rounds alike."""
    from repro_torch import dist
    from repro_torch.core import engines
    from repro_torch.dist import collectives
    from repro_torch.index import hnsw
    from repro_torch.launch import mesh as mesh_lib
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(32, 48)) * 4
    x = (centers[rng.integers(0, 32, 20_001)]
         + rng.normal(size=(20_001, 48))).astype(np.float32)
    qn = (centers[rng.integers(0, 32, 200)]
          + rng.normal(size=(200, 48))).astype(np.float32)
    graph = hnsw.build(x, m=12, ef_construction=32, passes=1, seed=0,
                       device=dev)
    mesh = mesh_lib.make_search_mesh(shards, "cuda:0")
    placed = dist.place_index(graph, mesh)
    init = collectives.make_sharded_hnsw_init(mesh)
    step = collectives.make_sharded_beam_step(mesh)
    q = torch.as_tensor(qn, device=dev)
    if width % shards:
        with pytest.raises(ValueError, match="not divisible"):
            init(placed, q, ef=64, visited_width=width)
        return
    s1 = hnsw.init_state(graph, q, ef=64, visited_width=width)
    s2 = init(placed, q, ef=64, visited_width=width)
    stop = torch.as_tensor(np.arange(200) % 3 == 0, device=dev)
    fields = ("cand_d", "cand_i", "cand_exp", "first_nn", "active", "ndis",
              "ninserts", "nstep")
    t = 0
    while bool(s1.active.any()):
        if t == 4:
            s1 = engines.set_active(s1, s1.active & ~stop)
            s2 = engines.set_active(s2, s2.active & ~stop)
        s1 = hnsw.beam_step(graph, s1, k=10)
        s2 = step(placed, s2, k=10)
        for name in fields:
            assert torch.equal(getattr(s1, name), getattr(s2, name)), \
                (t, name)
        t += 1
    assert t > 20 and not s2.active.any()
    vis = torch.cat(s2.visited, 1)
    assert torch.equal(vis[:, :s1.visited.shape[1]], s1.visited)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ivf", "hnsw"])
def test_placed_mutable_view_on_the_card_equals_its_engine(dev, kind):
    """After a burst, plain_search through mutable_engine over the view
    placed at 3 shards on cuda:0 equals the unsharded mutable engine's,
    bit for bit, and returns no deleted id."""
    from repro_torch import dist, mutate
    from repro_torch.core import darth_search, engines
    from repro_torch.data import vectors
    from repro_torch.index import hnsw, ivf
    from repro_torch.launch import mesh as mesh_lib
    ds = vectors.make_dataset(n=20_000, d=32, num_learn=10, num_queries=200,
                              clusters=64, seed=0)
    if kind == "ivf":
        base = ivf.build(ds.base, nlist=64, seed=0, device=dev)
        kw = dict(k=10, nprobe=16)
    else:
        base = hnsw.build(ds.base, m=12, ef_construction=32, passes=1,
                          seed=0, device=dev)
        kw = dict(k=10, ef=64)
    mut = mutate.MutableIndex(base, capacity=1024)
    mut.apply(vectors.mutation_stream(ds, 0.05, 0.02, drift=0.3, steps=4,
                                      seed=1))
    mesh = mesh_lib.make_search_mesh(3, "cuda:0")
    view = dist.place_index(mut.view(), mesh)
    if kind == "ivf":
        single = engines.ivf_engine(mut.base, **kw)
        sharded = engines.sharded_ivf_engine(view.base, mesh, **kw)
    else:
        single = engines.hnsw_engine(mut.base, **kw)
        sharded = engines.sharded_hnsw_engine(view.base, mesh, **kw)
    single = engines.mutable_engine(single, mut.delta)
    sharded = engines.mutable_engine(sharded, view.delta)
    q = torch.as_tensor(ds.queries, device=dev)
    s1 = darth_search.plain_search(single, q)
    s2 = darth_search.plain_search(sharded, q)
    assert torch.equal(single.topk_i(s1), sharded.topk_i(s2))
    assert torch.equal(single.topk_d(s1), sharded.topk_d(s2))
    assert torch.equal(s1.ndis, s2.ndis)
    dead = torch.as_tensor(mut.deleted_ids, device=dev)
    assert not torch.isin(sharded.topk_i(s2), dead).any()


@pytest.fixture(scope="module")
def cold_on_card():
    """An IVF index built on the card from float data, a Darth fitted
    there, queries and mixed targets, for the cold tier under a mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.core import api, engines
    from repro_torch.index import ivf
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(64, 32)) * 4

    def draw(m):
        return (centers[rng.integers(0, 64, m)]
                + rng.normal(size=(m, 32))).astype(np.float32)
    x, learn, q = draw(30_000), draw(512), draw(300)
    rts = np.random.default_rng(0).choice([0.8, 0.9, 0.95],
                                          300).astype(np.float32)
    index = ivf.build(x, nlist=64, seed=0, device="cuda")
    d = api.Darth(make_engine=lambda **kw: engines.ivf_engine(index, **kw),
                  engine=engines.ivf_engine(index, k=10, nprobe=64))
    d.fit(learn, x)
    return index, d, q, rts


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4])
def test_cold_tier_staging_into_a_placed_store_on_the_card(cold_on_card,
                                                           shards):
    """plan + prefetch at 16 of 64 buckets (lookahead 4, staging 8): the
    tier staging into a store placed at S shards on cuda:0 serves, per
    query, the ids, ndis and decisions of the single-device tier, with
    equal prefetch, eviction and miss counts, through the kernels."""
    from repro_torch import dist
    from repro_torch.core import engines
    from repro_torch.dist import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.obs import Tracer
    from repro_torch.serve import DarthServer, cold
    index, d, q, rts = cold_on_card
    mesh = mesh_lib.make_search_mesh(shards, "cuda:0")

    def serve(placed):
        tier = cold.make_cold_tier(index, hot_slots=16)
        store = tier.plan(q, nprobe=64, first=4)
        if placed:
            store = dist.place_index(store, mesh)
            eng = engines.sharded_ivf_engine(store, mesh, k=10, nprobe=64)
        else:
            eng = engines.ivf_engine(store, k=10, nprobe=64)
        tracer = Tracer()
        srv = DarthServer(eng, d.trained.predictor, d.interval_for_target,
                          num_slots=32, steps_per_sync=4, tracer=tracer,
                          mesh=mesh if placed else None)
        res, stats = srv.serve(q, rts, on_boundary=tier.on_boundary)
        return res, stats, tracer.terminals(), tier

    want = serve(False)
    before = dict(cuda.LAUNCHES)
    got = serve(True)
    assert all(cuda.LAUNCHES[k] > before[k]
               for k in ("bucket_probe", "gbdt_predict"))
    assert isinstance(got[3].store, sharding.PlacedIVFIndex)
    assert got[3].prefetches > 0 and got[1].completed == q.shape[0]
    for name in ("prefetches", "evictions", "misses"):
        assert getattr(got[3], name) == getattr(want[3], name), name
    for (_, a), (_, b) in zip(want[0], got[0]):
        np.testing.assert_array_equal(b, a)
    for qid, span in want[2].items():
        for key in ("ndis", "npred", "reason"):
            assert got[2][qid].attrs.get(key) == span.attrs.get(key), key


# The LM serving path: the card against the port's CPU path on the same
# weights, at the CPU parity tests' small widths and tolerances
# (tests/test_torch_models.py, tests/test_torch_moe.py): hidden states
# within 2^-4, logits within 0.01 (0.05 for MoE, where a near-tied gate
# may route a token to another expert: at most two token rows beyond).
LM_SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                d_ff=128, vocab_size=256, head_dim=16)
MOE_SMALL = dict(num_experts=4, experts_per_token=2, moe_d_ff=64)


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["glm4-9b", "starcoder2-3b",
                                  "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
def test_lm_forward_and_decode_on_the_card_equal_the_cpu(dev, arch):
    from repro_torch import configs
    from repro_torch.models import model_zoo
    cfg = configs.get_config(arch)
    moe = cfg.family == "moe"
    cfg = cfg.scaled(**LM_SMALL, **(MOE_SMALL if moe else {}))
    cpu = model_zoo.init_params(cfg, seed=0, device="cpu")
    card = _tree_to(cpu, dev)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)), dtype=torch.int32)
    logit_atol = 0.05 if moe else 0.01
    h_cpu, _, m_cpu = model_zoo.forward(cfg, cpu, {"tokens": toks})
    h_card, _, m_card = model_zoo.forward(cfg, card, {"tokens": toks.to(dev)})
    off = ((h_card.float().cpu() - h_cpu.float()).abs() > 2.0 ** -4).any(-1)
    assert int(off.sum()) <= (2 if moe else 0)
    assert set(m_card) == set(m_cpu)
    torch.testing.assert_close(
        model_zoo.prefill(cfg, card, {"tokens": toks.to(dev)}).cpu(),
        model_zoo.prefill(cfg, cpu, {"tokens": toks}), rtol=0,
        atol=logit_atol)
    c_cpu = model_zoo.make_cache(cfg, 2, 8, device="cpu")
    c_card = model_zoo.make_cache(cfg, 2, 8, device=dev)
    for t in range(6):
        l_cpu, c_cpu = model_zoo.decode_step(cfg, cpu, c_cpu,
                                             toks[:, t:t + 1], t)
        l_card, c_card = model_zoo.decode_step(cfg, card, c_card,
                                               toks[:, t:t + 1].to(dev), t)
        torch.testing.assert_close(l_card.cpu(), l_cpu, rtol=0,
                                   atol=logit_atol)


# The ssm (rwkv6), hybrid (zamba2) and audio (whisper) families at their
# registered widths and a reduced depth (rwkv6 2 of 32 layers; zamba2 7
# of 38, one group of 6 and a tail of 1; whisper all 6 + 6), on the card
# against the port's CPU path on the same weights: prefill's logits and
# four decode steps', each within FAMILY_LOGIT_ATOL. Beside
# them a control, printed (-s): the card's run again with TF32 matmuls
# allowed, a card path of lower precision in the f32 einsums. On an
# NVIDIA H100 (700 W) the sound runs read 0.0416 / 0.0508 / 0.0125 and
# the control 0.0447 / 0.0536 / 0.0131: FAMILY_LOGIT_ATOL lies between
# zamba2's two, but bf16 rounding sets the logits' gap, so the logits see
# the f32 einsums barely. The recurrence alone sees them:
# test_chunked_linear_attention_on_the_card_equals_the_cpu holds it to
# LINEAR_ATTN_REL of its largest value (sound 1.2e-6 / 2.0e-6, the TF32
# control 5.1e-4 / 5.6e-4).
FAMILY_DEPTH = {"rwkv6-3b": {"num_layers": 2},
                "zamba2-1.2b": {"num_layers": 7}, "whisper-base": {}}
FAMILY_LOGIT_ATOL = 0.052
LINEAR_ATTN_REL = 1e-4


@contextlib.contextmanager
def _tf32():
    """TF32 matmuls allowed inside (the control), off again after."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _family_logits(cfg, params, batch, device):
    """prefill's last logits on ``batch``, then four decode steps' logits
    from an empty cache, on ``device``; and the cache's dtypes."""
    from repro_torch.models import model_zoo
    on = {k: v.to(device) for k, v in batch.items()}
    out = [model_zoo.prefill(cfg, params, on).float().cpu()]
    cache = model_zoo.make_cache(cfg, 1, 8, device=device)
    for t in range(4):
        logits, cache = model_zoo.decode_step(cfg, params, cache,
                                              on["tokens"][:, t:t + 1], t)
        out.append(logits.float().cpu())
    return torch.stack(out), {p: a.dtype for p, a in model_zoo.leaves(cache)}


@pytest.mark.gpu
@pytest.mark.parametrize("strict", [True, False])
def test_chunked_linear_attention_on_the_card_equals_the_cpu(dev, strict):
    """The recurrence's f32 einsums alone (B 2 x T 256, 8 heads of 64),
    the card against the CPU within LINEAR_ATTN_REL of the output's
    largest value; a TF32 control printed beside it (-s)."""
    from repro_torch.models import linear_attn
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 256, 8, 64), generator=gen)
               for _ in range(3))
    log_w = -torch.exp(torch.randn((2, 256, 8, 64), generator=gen) * 0.5
                       - 0.5)
    kw = {"u": torch.full((8, 64), 0.5)} if strict else {}

    def run(device):
        y, s = linear_attn.chunked_linear_attention(
            *(a.to(device) for a in (q, k, v, log_w)),
            **{n: a.to(device) for n, a in kw.items()})
        return torch.cat([y.flatten(), s.flatten()]).cpu()

    want, got = run("cpu"), run(dev)
    with _tf32():
        control = run(dev)
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    control_err = float((control - want).abs().max()) / scale
    print(f"chunked linear attention (strict {strict}): card vs CPU "
          f"{err:.3e} relative, TF32 control {control_err:.3e}, limit "
          f"{LINEAR_ATTN_REL}")
    assert err <= LINEAR_ATTN_REL


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(FAMILY_DEPTH))
def test_lm_families_on_the_card_equal_the_cpu(dev, arch):
    from repro_torch import configs
    from repro_torch.models import model_zoo
    cfg = configs.get_config(arch).scaled(**FAMILY_DEPTH[arch])
    cpu = model_zoo.init_params(cfg, seed=0, device="cpu")
    card = _tree_to(cpu, dev)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (1, 16)),
                                       dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = torch.as_tensor(rng.normal(size=(
            1, cfg.frontend_len, cfg.frontend_dim))).to(torch.bfloat16)
    want, want_dtypes = _family_logits(cfg, cpu, batch, "cpu")
    got, got_dtypes = _family_logits(cfg, card, batch, dev)
    with _tf32():
        control, _ = _family_logits(cfg, card, batch, dev)
    err = float((got - want).abs().max())
    control_err = float((control - want).abs().max())
    print(f"{arch} at {cfg.num_layers} layers: card vs CPU {err:.6f}, "
          f"TF32 control {control_err:.6f}, limit {FAMILY_LOGIT_ATOL}")
    assert got_dtypes == want_dtypes
    assert err <= FAMILY_LOGIT_ATOL


@pytest.mark.gpu
def test_rag_example_on_the_card_meets_every_target_through_the_kernels(dev):
    """rag_serve.main on the card at the example's own corpus and LM:
    every kernel runs and each declared target is met within 0.03 over
    512 requests (the example's 64 give a mean whose standard error,
    ~0.04, exceeds 0.03). At a smaller corpus the spread of the mean
    over LM seeds reaches the tolerance, in the reference's runs too."""
    from repro_torch.examples import rag_serve
    cuda.reset_launches()
    out = rag_serve.main(n_req=512, device="cuda")
    assert all(n > 0 for n in cuda.LAUNCHES.values()), cuda.LAUNCHES
    for target, rec in out["recall"].items():
        assert rec >= target - 0.03, (target, rec)
    assert out["stats"].completed == 512
    assert len(out["generated"]) == rag_serve.NEW_TOKENS


# ---------------------------------------------------------------------------
# Training: each family's gradients, an Adafactor step and the restart
# contract on the card.
# ---------------------------------------------------------------------------

# The small widths of tests/conftest.py's small_config, per family.
TRAIN_SMALL = {
    "smollm-360m": {}, "internvl2-26b": dict(frontend_len=4,
                                             frontend_dim=32),
    "qwen3-moe-30b-a3b": MOE_SMALL,
    "rwkv6-3b": dict(num_heads=4, num_kv_heads=4, head_dim=16, ssm_state=16),
    "zamba2-1.2b": dict(num_layers=5, attn_every=2, ssm_state=16,
                        num_kv_heads=4),
    "whisper-base": dict(encoder_layers=2, frontend_len=8, frontend_dim=32)}
# The card's gradients against the CPU's, each leaf's largest error
# relative to its largest value (the worst leaf). As shipped the blocks
# compute in bf16 and round differently on the two devices, as the
# reference's jitted and eager runs do (0.0098-0.064 on the CPU,
# tests/test_torch_grads.py): on an NVIDIA H100 (700 W) the six families
# read 8.4e-4 (zamba2) to 7.0e-3 (whisper) and their TF32 controls 7.4e-3
# to 3.7e-2, whisper's within 5 % of its sound reading: bf16 sets the gap,
# so TRAIN_GRAD_REL bounds the gap and sees no precision fault. The same
# model computing in f32 (model_zoo.COMPUTE) does: 6.8e-7 (qwen3-moe) to
# 4.7e-6 (rwkv6) sound, 8.8e-4 (whisper) to 3.0e-3 (zamba2) with TF32;
# TRAIN_F32_GRAD_REL lies 10x above the largest sound reading and 17x
# below the smallest control, and the test asserts the control fails it.
TRAIN_GRAD_REL = 0.02
TRAIN_F32_GRAD_REL = 5e-5


def _train_batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                dtype=torch.int32)
             for k in ("tokens", "labels")}
    if cfg.family in ("vlm", "audio"):
        key = "patches" if cfg.family == "vlm" else "frames"
        batch[key] = torch.as_tensor(rng.normal(size=(
            b, cfg.frontend_len, cfg.frontend_dim))).to(torch.bfloat16)
    return batch


def _worst_rel(got, want):
    from repro_torch.models import model_zoo
    g, w = dict(model_zoo.leaves(got)), dict(model_zoo.leaves(want))
    return max(float((g[k].float().cpu() - w[k].float()).abs().max())
               / max(float(w[k].float().abs().max()), 1e-30) for k in w)


@contextlib.contextmanager
def _compute_f32():
    """The LM computes in f32 inside (``model_zoo.COMPUTE``), bf16 after."""
    from repro_torch.models import model_zoo
    was, model_zoo.COMPUTE = model_zoo.COMPUTE, torch.float32
    try:
        yield
    finally:
        model_zoo.COMPUTE = was


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(TRAIN_SMALL))
def test_family_grads_on_the_card_equal_the_cpu(dev, arch):
    from repro_torch import configs
    from repro_torch.models import model_zoo
    from repro_torch.train import step
    cfg = configs.get_config(arch).scaled(**{**LM_SMALL,
                                             **TRAIN_SMALL[arch]})
    cpu = model_zoo.init_params(cfg, seed=0, device="cpu")
    card = _tree_to(cpu, dev)
    batch = _train_batch(cfg)
    on = {k: v.to(dev) for k, v in batch.items()}
    l_cpu, _, g_cpu = step.grads_of(cfg, cpu, batch, attn_chunk=8)
    l_card, _, g_card = step.grads_of(cfg, card, on, attn_chunk=8)
    with _tf32():
        l_ctl, _, g_ctl = step.grads_of(cfg, card, on, attn_chunk=8)
    err, control = _worst_rel(g_card, g_cpu), _worst_rel(g_ctl, g_cpu)
    with _compute_f32():
        _, _, f_cpu = step.grads_of(cfg, cpu, batch, attn_chunk=8)
        _, _, f_card = step.grads_of(cfg, card, on, attn_chunk=8)
        with _tf32():
            _, _, f_ctl = step.grads_of(cfg, card, on, attn_chunk=8)
    f_err, f_control = _worst_rel(f_card, f_cpu), _worst_rel(f_ctl, f_cpu)
    print(f"{arch} grads: card vs CPU {err:.4e} (worst leaf, relative), "
          f"TF32 control {control:.4e}; loss {float(l_card):.6f} vs "
          f"{float(l_cpu):.6f} (control {float(l_ctl):.6f}); limit "
          f"{TRAIN_GRAD_REL}. In f32: {f_err:.4e}, TF32 control "
          f"{f_control:.4e}, limit {TRAIN_F32_GRAD_REL}")
    assert abs(float(l_card) - float(l_cpu)) <= 1e-3
    assert err <= TRAIN_GRAD_REL
    assert f_err <= TRAIN_F32_GRAD_REL
    assert f_control > TRAIN_F32_GRAD_REL, "the f32 gate cannot see TF32"


@pytest.mark.gpu
def test_flash_attention_backward_on_the_card_equals_the_cpu(dev):
    """The backward's f32 products alone (B 2 x S 256, 4 heads of 64,
    chunks of 64): card vs CPU within 1e-5 of each gradient's largest
    value; a TF32 control printed beside it (-s)."""
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn((2, 256, 4, 64), generator=gen)
                     for _ in range(4))

    def grads(device):
        ins = [a.to(device).requires_grad_(True) for a in (q, k, v)]
        out = layers.flash_attention(*ins, True, 0, 64)
        return [g.cpu() for g in torch.autograd.grad(out, ins,
                                                     dout.to(device))]

    want, got = grads("cpu"), grads(dev)
    with _tf32():
        control = grads(dev)
    err = max(float((a - b).abs().max()) / float(b.abs().max())
              for a, b in zip(got, want))
    control_err = max(float((a - b).abs().max()) / float(b.abs().max())
                      for a, b in zip(control, want))
    print(f"flash_attention backward: card vs CPU {err:.3e}, TF32 control "
          f"{control_err:.3e}")
    assert err <= 1e-5


@pytest.mark.gpu
def test_adafactor_step_on_the_card(dev):
    """kimi at small width (bf16 parameters, Adafactor): one train step
    on the card against the CPU's (loss, gradient norm), and the update
    alone on identical gradients within 4 ulps (the bf16 parameters and
    moment within one bf16 ulp)."""
    from repro_torch import configs
    from repro_torch.models import model_zoo
    from repro_torch.optim import adafactor_init, adafactor_update
    from repro_torch.train import step
    cfg = configs.get_config("kimi-k2-1t-a32b").scaled(**LM_SMALL,
                                                       **MOE_SMALL)
    assert step.optimizer_for(cfg) == "adafactor"
    cpu = model_zoo.init_params(cfg, seed=0, device="cpu")
    card = _tree_to(cpu, dev)
    batch = _train_batch(cfg)
    init, train_step = step.make_train_step(cfg, peak_lr=1e-2,
                                            warmup_steps=0)
    _, s_cpu, m_cpu = train_step(cpu, init(cpu), batch)
    _, s_card, m_card = train_step(card, init(card), {
        k: v.to(dev) for k, v in batch.items()})
    assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) <= 1e-3
    assert abs(float(m_card["grad_norm"]) / float(m_cpu["grad_norm"])
               - 1) <= 0.02
    assert s_card["leaves"]["embed"]["m"].dtype == torch.bfloat16
    assert s_card["step"].device.type == torch.device(dev).type
    assert int(s_card["step"]) == 1
    _, _, g = step.grads_of(cfg, cpu, batch)
    lr = torch.tensor(1e-2)
    p_cpu, st_cpu = adafactor_update(g, adafactor_init(cpu), cpu, lr)
    p_card, st_card = adafactor_update(_tree_to(g, dev), adafactor_init(card),
                                       card, lr.to(dev))
    for (path, a), (_, b) in zip(model_zoo.leaves(p_card),
                                 model_zoo.leaves(p_cpu)):
        torch.testing.assert_close(a.cpu().float(), b.float(), rtol=2 ** -7,
                                   atol=0, msg=str(path))
    for (path, a), (_, b) in zip(model_zoo.leaves(st_card),
                                 model_zoo.leaves(st_cpu)):
        if a.dtype == torch.float32:
            torch.testing.assert_close(a.cpu(), b, rtol=4 * 2 ** -23,
                                       atol=0, msg=str(path))


# The restart runs in a process of its own: cuBLAS repeats bit for bit
# under torch.use_deterministic_algorithms only with a fixed workspace
# (CUBLAS_WORKSPACE_CONFIG), which it reads when a process makes its first
# handle; the other tests keep cuBLAS's default workspace.
_RESTART_RUNS = """
import sys, torch
from repro_torch.examples import train_lm
from repro_torch.train import SimulatedFailure, train
root = sys.argv[1]
cfg, b, s = train_lm.example_config()
kw = dict(steps=8, global_batch=b, seq_len=s, ckpt_every=4, peak_lr=1e-3,
          log_every=1, device="cuda")
torch.use_deterministic_algorithms(True)
runs = [train(cfg, ckpt_dir=f"{root}/u{i}", **kw) for i in range(2)]
try:
    train(cfg, ckpt_dir=f"{root}/i", fail_at=6, **kw)
except SimulatedFailure:
    runs.append(train(cfg, ckpt_dir=f"{root}/i", **kw))
torch.save([{k: r[k] for k in ("history", "params", "opt_state")}
            for r in runs], f"{root}/runs.pt")
"""


@pytest.mark.gpu
def test_training_restart_on_the_card_is_bit_exact(dev, tmp_path):
    """The example's config (4 layers, d_model 256, vocab 4096, B 8 x S
    128) under torch.use_deterministic_algorithms: 8 steps straight,
    against a failure at step 6 and a resume from step 4's checkpoint;
    the losses and the final parameters and optimizer state equal bit for
    bit, and so do two uninterrupted runs."""
    from repro_torch.models import model_zoo
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.pathsep.join(
                   [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", _RESTART_RUNS,
                           str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    runs = torch.load(tmp_path / "runs.pt")
    assert len(runs) == 3, "no SimulatedFailure at step 6"
    ref, res = runs[0], runs[2]
    by_step = {m["step"]: m for m in ref["history"]}
    assert [m["step"] for m in res["history"]] == [4, 5, 6, 7]
    assert runs[1]["history"] == ref["history"]
    for m in res["history"]:
        assert m == by_step[m["step"]], m["step"]
    for other in runs[1:]:
        for key in ("params", "opt_state"):
            for (path, a), (_, b) in zip(model_zoo.leaves(other[key]),
                                         model_zoo.leaves(ref[key])):
                assert torch.equal(a, b), (key, path)


# The LM's multi-device tooling on the card: each check opens a world of
# one NCCL rank, so it runs in a process of its own (the test process
# keeps no default process group).
_HOST_MESH = """
import json, sys, torch
from repro_torch import ckpt, configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as launch
from repro_torch.models import model_zoo
from repro_torch.train import train
root, job = sys.argv[1], sys.argv[2]
cfg, b, s = launch.reduced(configs.get_config("smollm-360m"), 0.1), 8, 128
out = {}
if job == "launcher":
    plain = train(cfg, steps=6, global_batch=b, seq_len=s, ckpt_dir=root + "/p",
                  ckpt_every=3, peak_lr=1e-3, log_every=1, device="cuda")
    args = ["--arch", "smollm-360m", "--steps", "6", "--global-batch", str(b),
            "--seq-len", str(s), "--ckpt-every", "3", "--peak-lr", "1e-3",
            "--scale", "0.1", "--device", "cuda", "--ckpt-dir", root + "/m"]
    res = launch.main(args)
    pl, ml = dict(model_zoo.leaves(plain["params"])), dict(model_zoo.leaves(res["params"]))
    out = {"mesh": res["mesh"],
           "losses_equal": [m["loss"] for m in plain["history"]]
                           == [r["loss"] for r in res["steps"]],
           "params_equal": all(torch.equal(pl[k], ml[k]) for k in pl)}
else:
    tree = {"w": torch.randn(6, 10, device="cuda"),
            "h": torch.randn(4, 3, device="cuda").to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32, device="cuda")}
    ckpt.save(root + "/c", 1, tree)
    with launch.world_of_one("cuda"):
        mesh = mesh_lib.make_host_mesh("cuda")
        back, meta = ckpt.restore(root + "/c", tree, shardings=mesh)
        out = {"mesh": mesh_lib.describe(mesh),
               "equal": all(torch.equal(back[k].full_tensor(), tree[k])
                            for k in tree),
               "dtypes": all(back[k].dtype == tree[k].dtype for k in tree),
               "placements": sorted({str(v.placements) for v in back.values()})}
        ckpt.save(root + "/d", 2, back)
        _, meta2 = ckpt.restore(root + "/d", tree)
        out["saved_placements"] = meta2["shardings"]
print(json.dumps(out))
"""


def _host_mesh_job(job, tmp_path):
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", _HOST_MESH, str(tmp_path),
                           job], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    import json
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
def test_launcher_on_the_host_mesh_on_the_card_equals_the_plain_loop(
        dev, tmp_path):
    """The launcher in a world of one NCCL rank runs on the (1, 1) host
    mesh: 6 steps of smollm-360m at ``--scale 0.1`` (B 8 x S 128), its
    losses and final parameters equal the loop's without a mesh bit for
    bit."""
    out = _host_mesh_job("launcher", tmp_path)
    assert out["mesh"] == "mesh(1, 1) axes=('data', 'model')"
    assert out["losses_equal"] and out["params_equal"], out


@pytest.mark.gpu
def test_restore_onto_the_host_mesh_on_the_card(dev, tmp_path):
    """A checkpoint of card tensors (f32, bf16, int32) restored through
    ``restore(shardings=<the host mesh>)``: DTensors on the (1, 1) mesh,
    replicated, bit-equal and of the saved dtypes; saved again, each
    leaf's placement record names the mesh's axes and sizes."""
    out = _host_mesh_job("restore", tmp_path)
    assert out["equal"] and out["dtypes"], out
    assert out["placements"] == ["(Replicate(), Replicate())"], out
    for key, spec in (("w", [None, None]), ("h", [None, None]),
                      ("step", [])):
        assert out["saved_placements"][key] == {
            "spec": spec, "mesh_axes": ["data", "model"],
            "mesh_shape": [1, 1]}, out
