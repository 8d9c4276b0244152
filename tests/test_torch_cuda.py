"""Each CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA card and the CUDA toolkit's nvcc (the kernels
build at first use); elsewhere they skip. They import neither JAX nor the
reference package, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Integer-valued inputs make every dot product exact whatever the
summation order, so those cases must be EQUAL; float inputs agree to a
stated tolerance, and ids may differ only where distances tie within it.
"""
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


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,n,d,k", [(300, 5000, 128, 10), (70, 3000, 16, 1),
                                     (5, 20_000, 24, 64), (3, 7, 16, 10),
                                     (200, 100_000, 128, 10)])
def test_l2_topk_kernel_matches_plain(dev, dt, b, n, d, k):
    rng = np.random.default_rng(n + k)
    q = torch.as_tensor(rng.normal(size=(b, d)), dtype=torch.float32,
                        device=dev)
    if dt == "int8":
        x = torch.as_tensor(rng.integers(-127, 128, (n, d)), device=dev
                            ).to(torch.int8)
        q = q * 0.05
    else:
        x = torch.as_tensor(rng.normal(size=(n, d)), device=dev).to(TDT[dt])
    xsq = (x.float() ** 2).sum(1)
    xsq[::97] = float("inf")        # rows that must never win
    before = cuda.LAUNCHES["l2_topk"]
    d_k, i_k = cuda.l2_topk(q, x, xsq, k)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["l2_topk"] == before + 1
    d_r, i_r = ref.l2_topk_ref(q, x, xsq, k)
    _close_ids(d_k, i_k, d_r, i_r, atol=1e-3 + 1e-5 * float(
        xsq[torch.isfinite(xsq)].max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_l2_topk_kernel_integer_data_exact(dev, dt):
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.integers(-8, 9, (130, 40)), dtype=torch.float32,
                        device=dev)
    x = torch.as_tensor(rng.integers(-8, 9, (9000, 40)), device=dev).to(
        TDT[dt])
    x[4000:4010] = x[17]            # duplicates: lowest row first
    q[0] = x[17].float()
    xsq = (x.float() ** 2).sum(1)
    for k in (1, 10, 64):
        got = cuda.l2_topk(q, x, xsq, k)
        want = ref.l2_topk_ref(q, x, xsq, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    d, i = ops.l2_topk(q, x, k=5)
    assert i.is_cuda and int(i[0, 0]) == 17


def _probe_inputs(rng, b, c, d, k, dev):
    q = rng.integers(-8, 9, (b, d)).astype(np.float32)
    vecs = rng.integers(-8, 9, (b, c, d)).astype(np.float32)
    vecs[:, c // 2] = vecs[:, 1]                 # duplicated rows: ties
    ids = rng.integers(0, 10_000, (b, c)).astype(np.int32)
    ids[rng.random((b, c)) < 0.15] = -1          # pads and tombstones
    sqn = (vecs ** 2).sum(2).astype(np.float32)
    sqn[ids < 0] = np.inf
    bias = (q ** 2).sum(1, keepdims=True).astype(np.float32)
    full = sqn - 2 * np.einsum("bd,bcd->bc", q, vecs) + bias
    run_d = np.sort(full[:, :k] + rng.integers(0, 3, (b, k)), 1)
    run_d[:, k - 2:] = np.inf
    run_i = rng.integers(20_000, 30_000, (b, k)).astype(np.int32)
    run_i[:, k - 2:] = -1
    kth = run_d[:, -1:].copy()
    kth[::2] = np.median(full, axis=1, keepdims=True)[::2]
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in
                 (q, vecs, sqn, ids, bias, kth.astype(np.float32),
                  run_d.astype(np.float32), run_i))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("c,d,k", [(200, 128, 10), (2500, 16, 64),
                                   (33, 7, 5), (1400, 128, 10)])
def test_bucket_probe_kernel_matches_plain(dev, dt, c, d, k):
    rng = np.random.default_rng(c + d)
    s, b = 12, 40
    q, vecs, sqn, ids, bias, kth, run_d, run_i = _probe_inputs(
        rng, s, c, d, k, dev)
    vecs = vecs.to(TDT[dt])
    slot = torch.as_tensor(rng.integers(0, s, b), dtype=torch.int32,
                           device=dev)
    active = torch.as_tensor(rng.random(b) < 0.7, device=dev)
    sl = slot.long()
    args = (q[sl].contiguous(), vecs, sqn, ids, slot, active,
            bias[sl].contiguous(), kth[sl].contiguous(),
            run_d[sl].contiguous(), run_i[sl].contiguous())
    got = cuda.bucket_probe_slots(*args)
    want = ref.bucket_probe_slots_ref(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
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


@pytest.mark.gpu
def test_gbdt_kernel_matches_plain(dev):
    rng = np.random.default_rng(4)
    t, depth, f = 100, 6, 11
    feat = rng.integers(-1, f, (t, 2 ** depth - 1)).astype(np.int32)
    thresh = rng.normal(size=(t, 2 ** depth - 1)).astype(np.float32)
    thresh[:, ::7] = np.inf
    leaf = (rng.normal(size=(t, 2 ** depth)) * 0.01).astype(np.float32)
    feat, thresh, leaf = (torch.as_tensor(a, device=dev)
                          for a in (feat, thresh, leaf))
    for b in (1, 37, 1000):
        x = torch.as_tensor(rng.normal(size=(b, f)), dtype=torch.float32,
                            device=dev)
        x[0, 3] = thresh[0, 0] if torch.isfinite(thresh[0, 0]) else 0.0
        got = cuda.gbdt_predict(x, feat, thresh, leaf)
        want = ref.gbdt_predict_ref(x, feat, thresh, leaf)
        assert torch.allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros((4, 8), device=dev)
    x = torch.zeros((16, 8), device=dev)
    xsq = torch.zeros(16, device=dev)
    with pytest.raises(ValueError, match="range"):
        cuda.l2_topk(q, x, xsq, 65)
    with pytest.raises(TypeError):
        cuda.l2_topk(q.double(), x, xsq, 4)
    with pytest.raises(ValueError, match="contiguous"):
        cuda.l2_topk(q, x.t().contiguous().t(), xsq, 4)
    with pytest.raises(ValueError):
        cuda.l2_topk(q, x.cpu(), xsq, 4)
