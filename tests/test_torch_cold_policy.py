"""Where the cold tier's recall comes from, at ``chip_smoke.py`` phase 8's
settings: 64 slots, 4 steps a chunk, nprobe = nlist, a quarter of the
buckets resident, lookahead 4, staging 8, ``plan`` seeding from the
first 4 probes, targets drawn from 0.80 / 0.90 / 0.95, on all queries
and on the drifted slice (rank-1 bucket outside the most populated).

The collection is a reduced one (8,000 rows of width 16 in 64 lists) on
integer data, built by the reference and carried across, so every
distance is exact and both packages must serve EQUAL ids, counters and
prefetch / eviction / miss counts in every mode. Whatever recall the
prefetcher gains or loses at these settings is then the policy's, not
the port's (ROADMAP Queue 3 item 2); each case prints its recall.
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
from repro.serve import DarthServer as RefServer  # noqa: E402
from repro.serve import cold as ref_cold  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api, engines  # noqa: E402
from repro_torch.data import vectors  # noqa: E402
from repro_torch.index import flat, ivf  # noqa: E402
from repro_torch.serve import DarthServer, cold  # noqa: E402

from test_torch_serve import fitted_pairs  # noqa: E402

K, NLIST, HOT = 10, 64, 16                 # a quarter of the buckets
SLOTS, SPS, LOOKAHEAD, STAGING, FIRST = 64, 4, 4, 8, 4
STATS = ("completed", "engine_steps", "slot_steps", "refills",
         "ndis_harvested")


@pytest.fixture(scope="module")
def policy_cell():
    ds = vectors.make_dataset(n=8000, d=16, num_learn=400, num_queries=192,
                              clusters=NLIST, seed=0)
    x, learn, q = (np.round(a * 4).astype(np.float32)
                   for a in (ds.base, ds.learn, ds.queries))
    ref = ref_ivf.build(x, nlist=NLIST, seed=0)
    ref = dataclasses.replace(ref, centroids=jnp.round(ref.centroids))
    index = convert.ivf_index_from_numpy(convert.fields_as_numpy(ref),
                                         "cpu")
    ref_d, port_d, _ = fitted_pairs(
        ref_engines.ivf_engine(ref, k=K, nprobe=NLIST),
        engines.ivf_engine(index, k=K, nprobe=NLIST), x, learn)
    rts = np.random.default_rng(0).choice([0.80, 0.90, 0.95],
                                          q.shape[0]).astype(np.float32)
    qt = torch.as_tensor(q)
    order, _ = ivf.rank_centroids(index.centroids, qt,
                                  (qt * qt).sum(1, keepdim=True), 1)
    sizes = index.bucket_sizes.numpy()
    top = set(np.argsort(-sizes, kind="stable")[:HOT].tolist())
    drifted = np.asarray([i for i, b in enumerate(order[:, 0].tolist())
                          if b not in top])
    _, gt = flat.search(qt, torch.as_tensor(x), K)
    return ref, index, ref_d, port_d, q, rts, drifted, gt


@pytest.mark.parametrize("mode", ["static", "plan", "plan_prefetch"])
@pytest.mark.parametrize("qset", ["all", "drifted"])
def test_cold_policy_serves_equal_reference(policy_cell, qset, mode):
    ref, index, ref_d, port_d, q, rts, drifted, gt = policy_cell
    sel = np.arange(q.shape[0]) if qset == "all" else drifted
    assert sel.size >= 16, sel.size          # the drifted slice is real
    qs, rt = q[sel], rts[sel]
    out = {}
    for side, tier_mod, idx, d, api_mod, eng_mod, srv_cls in (
            ("ref", ref_cold, ref, ref_d, ref_api, ref_engines, RefServer),
            ("port", cold, index, port_d, api, engines, DarthServer)):
        tier = tier_mod.make_cold_tier(idx, hot_slots=HOT,
                                       lookahead=LOOKAHEAD, staging=STAGING)
        store = (tier.store if mode == "static"
                 else tier.plan(qs, nprobe=NLIST, first=FIRST))
        darth = api_mod.Darth(make_engine=None, trained=d.trained,
                              engine=eng_mod.ivf_engine(store, k=K,
                                                        nprobe=NLIST))
        srv = srv_cls(darth.engine, darth.trained.predictor,
                      darth.interval_for_target, num_slots=SLOTS,
                      steps_per_sync=SPS)
        res, stats = srv.serve(qs, rt, on_boundary=(
            tier.on_boundary if mode == "plan_prefetch" else None))
        out[side] = (np.stack([np.asarray(r[1]) for r in res]), stats,
                     (tier.prefetches, tier.evictions, tier.misses))
    (ids_r, st_r, cnt_r), (ids_p, st_p, cnt_p) = out["ref"], out["port"]
    np.testing.assert_array_equal(ids_p, ids_r)
    for name in STATS:
        assert getattr(st_p, name) == getattr(st_r, name), name
    assert cnt_p == cnt_r
    assert st_p.completed == sel.size
    if mode == "plan_prefetch":
        assert cnt_p[0] > 0                  # the prefetcher staged buckets
    recall = float(flat.recall_at_k(torch.as_tensor(ids_p),
                                    gt[torch.as_tensor(sel)]).mean())
    print(f"[cold policy] {qset} {mode}: recall {recall:.4f} ndis "
          f"{st_p.ndis_harvested / sel.size:.1f} prefetches/evictions/"
          f"misses {cnt_p}")
