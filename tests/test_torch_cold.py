"""The port's IVF cold bucket tier against the JAX reference's.

Indexes are built by the reference on integer-valued data (centroids
rounded), carried across with ``repro_torch.convert``: every distance is
exact in f32, so the split store, the probe steps over it, the tier's
hot sets and a served run with the boundary prefetcher must be EQUAL —
ids, ``ndis``, terminal reasons, ``ServeStats`` and the tier's prefetch,
eviction and miss counters. The reference's calibrated recall margins
fail on this box (ROADMAP Queue 3), so the last test asserts only their
ordering, on the port's own build: plan >= static, plan + prefetch >=
plan.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the test lane runs six workers on a few cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import api as ref_api  # noqa: E402
from repro.core import engines as ref_engines  # noqa: E402
from repro.index import ivf as ref_ivf  # noqa: E402
from repro.obs import MetricsRegistry as RefRegistry  # noqa: E402
from repro.serve import cold as ref_cold  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api, engines  # noqa: E402
from repro_torch.data import vectors  # noqa: E402
from repro_torch.index import flat, ivf, residency  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serve import DarthServer, cold  # noqa: E402

from test_torch_ivf import _compare  # noqa: E402
from test_torch_serve import (assert_same_serve, clustered,  # noqa: E402
                              fitted_pairs, mixed_targets, serve_both)

K = 10
COLD = ("prefetches", "evictions", "misses")


def _int_index(quantize, nlist=16, n=1500, d=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 9, (n, d)).astype(np.float32)
    x[100:104] = x[7]                    # duplicates: ties inside buckets
    ref = ref_ivf.build(x, nlist=nlist, seed=0, quantize=quantize)
    ref = dataclasses.replace(ref, centroids=jnp.round(ref.centroids))
    q = rng.integers(-8, 9, (24, d)).astype(np.float32)
    q[0] = x[7]
    return x, q, ref


def _carry(ref_index):
    return convert.ivf_index_from_numpy(convert.fields_as_numpy(ref_index),
                                        "cpu")


HOT = np.asarray([0, 3, 7, 11, 12, 15], np.int32)


def test_split_index_bit_equal():
    _, _, ref = _int_index(False)
    got = cold.split_index(_carry(ref), HOT)
    want = ref_cold.split_index(ref, HOT)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)
    with pytest.raises(ValueError, match="unique"):
        cold.split_index(_carry(ref), np.asarray([1, 1], np.int32))
    with pytest.raises(ValueError, match="hot_slots"):
        cold.make_cold_tier(_carry(ref), hot_slots=0)


@pytest.mark.parametrize("quantize", [False, True])
def test_probe_steps_over_a_split_store_equal_reference(quantize):
    """init_state ranks all nlist centroids; every probe_step over the
    split store equals the reference's: a cold bucket is skipped (the
    position advances, ndis and ninserts stay), a hot one is scanned
    through its slot."""
    _, q, ref = _int_index(quantize)
    ref_store = ref_cold.split_index(ref, HOT)
    store = _carry(ref_store)
    sr = ref_ivf.init_state(ref_store, jnp.asarray(q), k=5,
                            nprobe=ref.nlist)
    sp = ivf.init_state(store, torch.as_tensor(q), k=5, nprobe=ref.nlist)
    np.testing.assert_array_equal(sp.probe_order.numpy(),
                                  np.asarray(sr.probe_order))
    for _ in range(ref.nlist):
        sr = ref_ivf.probe_step(ref_store, sr)
        sp = ivf.probe_step(store, sp)
        _compare(sr, sp, exact=not quantize)
    assert not sp.active.any()


def test_skip_honesty():
    """A full sweep over a split store returns exactly the top-k of the
    resident buckets' rows, and counts exactly the resident rows. (Equal
    distances may come in another order: the sweep keeps the bucket
    probed first, flat search the lower row.)"""
    x, q, ref = _int_index(False)
    store = cold.split_index(_carry(ref), HOT)
    d, i, st = ivf.search(store, torch.as_tensor(q), k=K, nprobe=ref.nlist)
    sizes = store.bucket_sizes.numpy()
    assert (st.ndis.numpy() == sizes[HOT].sum()).all()
    rows = store.bucket_ids[store.bucket_ids >= 0].sort().values
    fd, fi = flat.search(torch.as_tensor(q), torch.as_tensor(x[rows]), K)
    np.testing.assert_array_equal(d.numpy(), fd.numpy())
    want, got = rows[fi.long()].numpy(), i.numpy()
    assert set(got.ravel()) <= set(rows.tolist())
    inside = fd.numpy() < fd.numpy()[:, -1:]    # ranks not tied with k-th
    for r in range(q.shape[0]):
        assert set(got[r][inside[r]]) == set(want[r][inside[r]]), r


def test_cold_tier_and_plan_hot_sets_equal_reference():
    ds = vectors.make_dataset(n=2000, d=16, num_learn=64, num_queries=64,
                              clusters=32, cluster_std=1.0, seed=0)
    ref = ref_ivf.build(np.round(ds.base * 4), nlist=32, seed=0)
    ref = dataclasses.replace(ref, centroids=jnp.round(ref.centroids))
    qi = np.round(ds.queries * 4)
    tr = ref_cold.make_cold_tier(ref, hot_slots=24, staging=6)
    tp = cold.make_cold_tier(_carry(ref), hot_slots=24, staging=6)
    for name in ("hot_map", "slot_bucket", "pinned"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(tr, name))
    np.testing.assert_array_equal(tp.store.bucket_vecs.numpy(),
                                  np.asarray(tr.store.bucket_vecs))
    sr, sp = tr.plan(qi, nprobe=12, first=2), tp.plan(qi, nprobe=12, first=2)
    for name in ("hot_map", "slot_bucket"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(tr, name))
    for f in ("bucket_vecs", "bucket_ids", "bucket_sqnorm", "hot_map"):
        np.testing.assert_array_equal(getattr(sp, f).numpy(),
                                      np.asarray(getattr(sr, f)), err_msg=f)


@pytest.fixture(scope="module")
def carried_cold():
    """A reference IVF index on integer data, its fitted predictor and
    dists_Rt, the port's copies, queries and mixed targets."""
    x, learn, q = clustered(5)
    ref_index = ref_ivf.build(x, nlist=32, seed=0)
    ref_index = dataclasses.replace(ref_index,
                                    centroids=jnp.round(ref_index.centroids))
    index = _carry(ref_index)
    ref_d, port_d, _ = fitted_pairs(
        ref_engines.ivf_engine(ref_index, k=K, nprobe=12),
        engines.ivf_engine(index, k=K, nprobe=12), x, learn)
    return ref_index, index, ref_d, port_d, q, mixed_targets(q.shape[0])


@pytest.mark.parametrize("hosts", [1, 2])
def test_cold_serve_with_prefetch_equals_reference(carried_cold, hosts):
    """Serving over a 20-of-32 store with the boundary prefetcher: the
    same ids, ndis and terminal reasons per query, the same ServeStats,
    and the same prefetches, evictions and misses, each also in the
    darth_cold_* metric families."""
    ref_index, index, ref_d, port_d, q, rts = carried_cold
    tiers = {"ref": ref_cold.make_cold_tier(ref_index, hot_slots=20,
                                            metrics=RefRegistry()),
             "port": cold.make_cold_tier(index, hot_slots=20,
                                         metrics=MetricsRegistry())}
    ref_c = ref_api.Darth(make_engine=None, trained=ref_d.trained,
                          engine=ref_engines.ivf_engine(
                              tiers["ref"].store, k=K, nprobe=12))
    port_c = api.Darth(make_engine=None, trained=port_d.trained,
                       engine=engines.ivf_engine(tiers["port"].store, k=K,
                                                 nprobe=12))
    ref_out, port_out = serve_both(ref_c, port_c, q, rts, hosts=hosts,
                                   hook=lambda side: tiers[side].on_boundary)
    assert_same_serve(ref_out, port_out)
    assert port_out[1].completed == q.shape[0]
    for name in COLD:
        assert getattr(tiers["port"], name) == getattr(tiers["ref"], name)
    tier = tiers["port"]
    assert tier.prefetches > 0 and tier.evictions > 0
    assert len(tier.stage_seconds) > 0
    for name, fam in (("prefetches", "darth_cold_prefetch_total"),
                      ("evictions", "darth_cold_evictions_total"),
                      ("misses", "darth_cold_miss_total")):
        assert tier.metrics.counter(fam).value() == getattr(tier, name)
    assert "darth_cold_prefetch_total" in tier.metrics.to_prometheus()


def test_prefetch_over_a_mutable_view_equals_reference(carried_cold):
    """Through the mutable wrapper (an empty delta ring), the tier swaps
    the view's base at each staging boundary, and the serve equals the
    reference's, counters included."""
    from repro import mutate as ref_mutate
    from repro_torch import mutate
    ref_index, index, ref_d, port_d, q, rts = carried_cold
    tiers = {"ref": ref_cold.make_cold_tier(ref_index, hot_slots=20),
             "port": cold.make_cold_tier(index, hot_slots=20)}
    ref_eng = ref_engines.ivf_engine(tiers["ref"].store, k=K, nprobe=12)
    eng = engines.ivf_engine(tiers["port"].store, k=K, nprobe=12)
    ref_c = ref_api.Darth(make_engine=None, trained=ref_d.trained,
                          engine=ref_engines.mutable_engine(
                              ref_eng, ref_mutate.MutableIndex(
                                  tiers["ref"].store, capacity=64).delta))
    port_c = api.Darth(make_engine=None, trained=port_d.trained,
                       engine=engines.mutable_engine(
                           eng, mutate.MutableIndex(
                               tiers["port"].store, capacity=64).delta))
    ref_out, port_out = serve_both(ref_c, port_c, q, rts, hosts=2,
                                   hook=lambda side: tiers[side].on_boundary)
    assert_same_serve(ref_out, port_out)
    for name in COLD:
        assert getattr(tiers["port"], name) == getattr(tiers["ref"], name)
    assert tiers["port"].prefetches > 0


def _recall(ids, gt):
    return float(flat.recall_at_k(torch.as_tensor(ids), gt).mean())


def test_plan_and_prefetch_order_on_the_ports_build():
    """The reference test's recipe (SQ8 store of 64 buckets, 40 resident,
    queries whose nearest bucket is outside the 40 most populated) on
    the port's own build and fit: plan >= static and plan + prefetch >=
    plan, with no calibrated margin."""
    ds = vectors.make_dataset(n=2000, d=16, num_learn=64, num_queries=64,
                              clusters=32, cluster_std=1.0, seed=0)
    index = residency.quantize_ivf(ivf.build(ds.base, nlist=64, seed=0,
                                             device="cpu"))
    d = api.Darth(make_engine=lambda **kw: engines.ivf_engine(index, **kw),
                  engine=engines.ivf_engine(index, k=K, nprobe=12))
    d.fit(ds.learn, ds.base)
    q = torch.as_tensor(ds.queries)
    order, _ = ivf.rank_centroids(index.centroids, q,
                                  (q * q).sum(1, keepdim=True), 1)
    sizes = index.bucket_sizes.numpy()
    lowpop = set(np.argsort(-sizes, kind="stable")[40:].tolist())
    sel = np.asarray([i for i, b in enumerate(order[:, 0].tolist())
                      if b in lowpop])
    assert sel.size >= 8, sel.size           # the drifted slice is real
    qd = ds.queries[sel]
    _, gt = flat.search(torch.as_tensor(qd), torch.as_tensor(ds.base), K)
    rts = np.full((sel.size,), 0.9, np.float32)

    def run(plan, prefetch):
        tier = cold.make_cold_tier(index, hot_slots=40)
        store = tier.plan(qd, nprobe=12, first=2) if plan else tier.store
        server = DarthServer(engines.ivf_engine(store, k=K, nprobe=12),
                             d.trained.predictor, d.interval_for_target,
                             num_slots=16, steps_per_sync=2)
        res, stats = server.serve(
            qd, rts, on_boundary=tier.on_boundary if prefetch else None)
        assert stats.completed == sel.size
        return _recall(np.stack([r[1] for r in res]), gt), tier

    rec_static, _ = run(False, False)
    rec_plan, _ = run(True, False)
    rec_full, tier = run(True, True)
    assert tier.prefetches > 0
    assert rec_plan >= rec_static, (rec_static, rec_plan)
    assert rec_full >= rec_plan, (rec_plan, rec_full)
