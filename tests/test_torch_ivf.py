"""The port's IVF index against the JAX reference.

Search parity runs on an index built by the reference and carried across
with ``repro_torch.convert``. Its vectors are integers in [-8, 8] and its
centroids are rounded to integers, so every distance (centroid ranking
included) is exact in f32 and the probe sequences must be EQUAL, ties
included. Build parity is measured as quality: the port's k-means cannot
reproduce ``jax.random``.
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

from repro.core import engines as ref_engines  # noqa: E402
from repro.index import flat as ref_flat  # noqa: E402
from repro.index import ivf as ref_ivf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engines  # noqa: E402
from repro_torch.data import vectors  # noqa: E402
from repro_torch.index import flat, ivf  # noqa: E402

FIELDS = ("topk_i", "topk_d", "ndis", "ninserts", "probe_pos", "active")


def _carried_index(quantize, n=1500, d=16, nlist=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 9, (n, d)).astype(np.float32)
    x[100:104] = x[7]                    # duplicates: ties inside buckets
    ref = ref_ivf.build(x, nlist=nlist, seed=0, quantize=quantize)
    ref = dataclasses.replace(ref, centroids=jnp.round(ref.centroids))
    q = rng.integers(-8, 9, (24, d)).astype(np.float32)
    q[0] = x[7]
    return x, q, ref, convert.ivf_index_from_numpy(
        convert.fields_as_numpy(ref), "cpu")


def _compare(sr, sp, exact):
    for name in FIELDS:
        a = np.asarray(getattr(sr, name))
        b = getattr(sp, name).numpy()
        if exact or name in ("ndis", "probe_pos", "active"):
            np.testing.assert_array_equal(b, a, err_msg=name)
        elif name == "topk_d":
            np.testing.assert_allclose(b, a, atol=1e-3, err_msg=name)
        else:  # SQ8 near-ties may swap an id or an insert
            assert np.mean(b == a) > 0.95, name


@pytest.mark.parametrize("quantize", [False, True])
def test_probe_steps_match_reference(quantize):
    x, q, ref, port = _carried_index(quantize)
    k, nprobe = 10, 6
    sr = ref_ivf.init_state(ref, jnp.asarray(q), k=k, nprobe=nprobe)
    sp = ivf.init_state(port, torch.as_tensor(q), k=k, nprobe=nprobe)
    np.testing.assert_array_equal(sp.probe_order.numpy(),
                                  np.asarray(sr.probe_order))
    np.testing.assert_array_equal(sp.first_nn.numpy(),
                                  np.asarray(sr.first_nn))
    for step in range(nprobe + 1):
        if step == 2:  # DARTH stops some queries: they keep their state
            stop = np.arange(q.shape[0]) % 3 == 0
            sr = ref_engines.set_active(sr, sr.active & ~jnp.asarray(stop))
            sp = engines.set_active(sp, sp.active & ~torch.as_tensor(stop))
        sr = ref_ivf.probe_step(ref, sr)
        sp = ivf.probe_step(port, sp)
        _compare(sr, sp, exact=not quantize)
    assert not sp.active.any()


def test_search_matches_reference():
    x, q, ref, port = _carried_index(False, seed=1)
    d_r, i_r, s_r = ref_ivf.search(ref, jnp.asarray(q), k=10, nprobe=5)
    d_p, i_p, s_p = ivf.search(port, torch.as_tensor(q), k=10, nprobe=5)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))
    np.testing.assert_array_equal(d_p.numpy(), np.asarray(d_r))
    np.testing.assert_array_equal(s_p.ndis.numpy(), np.asarray(s_r.ndis))


def test_pack_buckets_and_quantize_bit_identical():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(700, 12)).astype(np.float32)
    assign = rng.integers(0, 9, 700)
    lo, hi = x.min(0), x.max(0)
    scale = np.maximum((hi - lo) / 254.0, 1e-12).astype(np.float32)
    offset = ((hi + lo) / 2.0).astype(np.float32)
    out_p = ivf.quantize_sq8(x * 1.1, scale, offset)
    out_r = ref_ivf.quantize_sq8(x * 1.1, scale, offset)
    assert out_p[2] == out_r[2] > 0
    for a, b in zip(out_p[:2], out_r[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ids = rng.permutation(700).astype(np.int32)
    for store, deq in ((x, x), out_p[:2]):
        packed_p = ivf.pack_buckets(store, deq, ids, assign, 9, cap_round=8)
        packed_r = ref_ivf.pack_buckets(store, deq, ids, assign, 9,
                                        cap_round=8)
        for a, b in zip(packed_p, packed_r):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_port_build_recall_matches_reference_build():
    """Same dataset, nprobe = nlist / 8 (nprobe = nlist would be
    exhaustive and reach 1.0 in both)."""
    ds = vectors.make_dataset(n=4000, d=16, num_learn=0, num_queries=300,
                              clusters=128, center_scale=1.5, seed=0)
    nlist, nprobe = 32, 4
    gt = np.asarray(ref_flat.search(jnp.asarray(ds.queries),
                                    jnp.asarray(ds.base), 10)[1])
    ref = ref_ivf.build(ds.base, nlist=nlist, seed=0)
    rec_r = float(ref_flat.recall_at_k(ref_ivf.search(
        ref, jnp.asarray(ds.queries), k=10, nprobe=nprobe)[1],
        jnp.asarray(gt)).mean())
    port = ivf.build(ds.base, nlist=nlist, seed=0, device="cpu")
    assert port.num_vectors == ds.base.shape[0]
    assert port.bucket_vecs.dtype == torch.float32
    rec_p = float(flat.recall_at_k(ivf.search(
        port, torch.as_tensor(ds.queries), k=10, nprobe=nprobe)[1],
        torch.as_tensor(gt)).mean())
    assert rec_r < 0.99  # the cut is not exhaustive
    assert abs(rec_p - rec_r) <= 0.02, (rec_p, rec_r)
    port8 = ivf.build(ds.base, nlist=nlist, seed=0, quantize=True,
                      device="cpu")
    assert port8.quantized
