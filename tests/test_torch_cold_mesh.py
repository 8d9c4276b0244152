"""A live cold tier under a mesh against the JAX reference's single-device
tier.

The port's ``ColdTier`` stages into a placed store (``dist.place_index``
of its device store, each bucket slot's cap split over S shards): at
every boundary it writes the staged bucket's rows into slot ``sl`` of
every shard, refreshes each host group's view and hands the server a
placed store of the same mesh. The oracle is the reference's
single-device ``ColdTier`` on the same carried index (its mesh paths
fail under this container's jax). The data are integers and the
centroids rounded, so every distance is exact whatever the shard's cap
slice: per query the served ids, ``ndis``, terminal reason, ``npred``
and predicted recalls must EQUAL the reference's, and so must the
tier's prefetch, eviction and miss counts, at S in {1, 2, 3, 4} (the cap
is odd, so S = 2, 3 and 4 pad it), on the 2 x 2 serve mesh, in the three
modes (static, plan, plan + prefetch), and through a placed mutable view.
Every device is the CPU here.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the test lane runs six workers on a few cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import gbdt as ref_gbdt  # noqa: E402
from repro import mutate as ref_mutate  # noqa: E402
from repro.core import api as ref_api  # noqa: E402
from repro.core import engines as ref_engines  # noqa: E402
from repro.core import training as ref_training  # noqa: E402
from repro.index import ivf as ref_ivf  # noqa: E402
from repro.obs import trace as ref_trace  # noqa: E402
from repro.serve import DarthServer as RefServer  # noqa: E402
from repro.serve import cold as ref_cold  # noqa: E402
from repro_torch import convert, dist, mutate  # noqa: E402
from repro_torch.core import api, engines  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.serve import DarthServer, cold  # noqa: E402

from test_torch_serve import (SLOTS, SPS, assert_same_serve,  # noqa: E402
                              clustered, mixed_targets)

K, NLIST, NPROBE, HOT, FIRST = 10, 32, 12, 20, 2
COLD = ("prefetches", "evictions", "misses")
MODES = ("static", "plan", "plan_prefetch")


@pytest.fixture(scope="module")
def carried():
    """The reference's index on integer data (odd cap, rounded
    centroids), the port's copy, one fitted predictor in both packages'
    form, the queries and their mixed targets."""
    x, learn, q = clustered(7, n_learn=200)
    ref = ref_ivf.build(x, nlist=NLIST, seed=0, cap_round=1)
    ref = dataclasses.replace(ref, centroids=jnp.round(ref.centroids))
    cap = ref.bucket_vecs.shape[1]
    assert cap % 2 and cap % 3, f"cap {cap}: S = 2, 3 and 4 must pad it"
    index = convert.ivf_index_from_numpy(convert.fields_as_numpy(ref), "cpu")
    eng = ref_engines.ivf_engine(ref, k=K, nprobe=NPROBE)
    _, gt = ref_training.ground_truth(jnp.asarray(learn), jnp.asarray(x), K)
    log = ref_training.generate_observations(eng, jnp.asarray(learn), gt,
                                             batch=128)
    trained = ref_training.fit_predictor(
        log, cfg=ref_gbdt.GBDTConfig(num_trees=40, depth=5,
                                     min_child_weight=5.0))
    port = convert.trained_from_numpy(
        ref_gbdt.to_state_dict(trained.predictor.params), trained.dists_rt,
        "cpu")
    return {"ref": ref, "index": index,
            "ref_darth": ref_api.Darth(make_engine=None, engine=eng,
                                       trained=trained),
            "darth": api.Darth(make_engine=None, engine=None, trained=port),
            "q": q, "rts": mixed_targets(q.shape[0])}


def _ref_serve(c, mode, hosts, mutable=False):
    tier = ref_cold.make_cold_tier(c["ref"], hot_slots=HOT)
    store = (tier.store if mode == "static"
             else tier.plan(c["q"], nprobe=NPROBE, first=FIRST))
    eng = ref_engines.ivf_engine(store, k=K, nprobe=NPROBE)
    if mutable:
        eng = ref_engines.mutable_engine(
            eng, ref_mutate.MutableIndex(store, capacity=64).delta)
    d = c["ref_darth"]
    tracer = ref_trace.Tracer(traj_cap=64)
    srv = RefServer(eng, d.trained.predictor, d.interval_for_target,
                    num_slots=SLOTS,
                    steps_per_sync=SPS, hosts=hosts, tracer=tracer)
    res, stats = srv.serve(c["q"], c["rts"], on_boundary=(
        tier.on_boundary if mode == "plan_prefetch" else None))
    return (res, stats, tracer), tier


@pytest.fixture(scope="module")
def reference(carried):
    """The reference's single-device serve per (mode, hosts, mutable),
    run once each."""
    return functools.lru_cache(maxsize=None)(
        functools.partial(_ref_serve, carried))


def _port_serve(c, mode, mesh, hosts, *, place_first=False, mutable=False):
    """The port's tier under ``mesh``. ``place_first`` places the tier's
    store before ``plan`` (which then returns a placed store); otherwise
    the caller places the store the tier handed out, and the tier adopts
    the placement from the server at the first boundary."""
    tier = cold.make_cold_tier(c["index"], hot_slots=HOT)
    if place_first:
        tier.store = dist.place_index(tier.store, mesh)
    store = (tier.store if mode == "static"
             else tier.plan(c["q"], nprobe=NPROBE, first=FIRST))
    if isinstance(store, sharding.PlacedIVFIndex):
        assert store.mesh == mesh
    else:
        store = dist.place_index(store, mesh)
    eng = engines.sharded_ivf_engine(store, mesh, k=K, nprobe=NPROBE)
    if mutable:
        view = dist.place_index(
            mutate.MutableIndex(tier.store, capacity=64).view(), mesh)
        eng = engines.mutable_engine(
            engines.sharded_ivf_engine(view.base, mesh, k=K, nprobe=NPROBE),
            view.delta)
    d = c["darth"]
    tracer = trace.Tracer(traj_cap=64)
    srv = DarthServer(eng, d.trained.predictor, d.interval_for_target,
                      num_slots=SLOTS, steps_per_sync=SPS, mesh=mesh,
                      hosts=hosts, tracer=tracer)
    res, stats = srv.serve(c["q"], c["rts"], on_boundary=(
        tier.on_boundary if mode == "plan_prefetch" else None))
    return (res, stats, tracer), tier, srv


def _assert_like_reference(ref_out, ref_tier, out, tier, srv, mesh, mode):
    assert_same_serve(ref_out, out)
    assert out[1].completed == len(out[0])
    for name in COLD:
        assert getattr(tier, name) == getattr(ref_tier, name), name
    np.testing.assert_array_equal(tier.hot_map, ref_tier.hot_map)
    np.testing.assert_array_equal(tier.slot_bucket, ref_tier.slot_bucket)
    if mode != "plan_prefetch":
        return
    assert tier.prefetches > 0 and len(tier.stage_seconds) > 0
    # the server serves the tier's store, placed on the same mesh
    placed = getattr(srv.engine.index, "base", srv.engine.index)
    assert placed is tier.store and placed.mesh == mesh
    np.testing.assert_array_equal(placed.hot_map.numpy(), tier.hot_map)


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_cold_tier_on_a_search_mesh_equals_reference(carried, reference,
                                                     shards):
    """At S shards, in each mode, per query and per counter."""
    mesh = mesh_lib.make_search_mesh(shards, "cpu")
    for mode in MODES:
        ref_out, ref_tier = reference(mode, 1)
        out, tier, srv = _port_serve(carried, mode, mesh, 1,
                                     place_first=mode == "plan")
        _assert_like_reference(ref_out, ref_tier, out, tier, srv, mesh,
                               mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("hosts", [1, 2])
def test_cold_tier_on_a_serve_mesh_equals_reference(carried, reference,
                                                    hosts, mode):
    """On the 2 x 2 serve mesh, one host loop or two (against the
    reference's serve with as many host loops): both host groups' views
    are refreshed at every boundary and keep sharing the one device's
    tensors."""
    mesh = mesh_lib.make_serve_mesh(2, 2, "cpu")
    ref_out, ref_tier = reference(mode, hosts)
    out, tier, srv = _port_serve(carried, mode, mesh, hosts,
                                 place_first=mode == "plan")
    assert len(srv._group_index) == 2
    _assert_like_reference(ref_out, ref_tier, out, tier, srv, mesh, mode)
    store = srv.engine.index
    assert mode == "static" or store is tier.store
    assert len(store.host_views) == 2
    for h, view in enumerate(store.host_views):
        assert sharding.host_index(store, h) is view
        assert view.mesh == mesh.host(h)
        np.testing.assert_array_equal(view.hot_map.numpy(), tier.hot_map)
        for name in ("bucket_vecs", "bucket_ids", "bucket_sqnorm"):
            for a, b in zip(getattr(view, name), getattr(store, name)):
                assert a is b


def test_cold_tier_through_a_placed_mutable_view_equals_reference(
        carried, reference):
    """A placed mutable view (empty delta ring) at S = 2: the tier swaps
    the view's base for its placed store at each staging boundary."""
    mesh = mesh_lib.make_search_mesh(2, "cpu")
    ref_out, ref_tier = reference("plan_prefetch", 2, True)
    out, tier, srv = _port_serve(carried, "plan_prefetch", mesh, 2,
                                 mutable=True)
    _assert_like_reference(ref_out, ref_tier, out, tier, srv, mesh,
                           "plan_prefetch")
    assert hasattr(srv.engine.index, "delta")


@pytest.mark.parametrize("shards", [3, 4])
def test_plan_under_a_mesh_and_the_padded_host_copy(carried, shards):
    """plan() on a placed store returns a store placed on the same mesh,
    equal shard for shard to placing the unplaced tier's plan, with the
    same seed order; the host copy is padded once to the placed cap, and
    one staging writes every shard's slice of the slot."""
    c = carried
    mesh = mesh_lib.make_search_mesh(shards, "cpu")
    flat_tier = cold.make_cold_tier(c["index"], hot_slots=HOT)
    want = dist.place_index(flat_tier.plan(c["q"], nprobe=NPROBE,
                                           first=FIRST), mesh)
    tier = cold.make_cold_tier(c["index"], hot_slots=HOT)
    cap = tier.host_vecs.shape[1]
    tier.store = dist.place_index(tier.store, mesh)
    got = tier.plan(c["q"], nprobe=NPROBE, first=FIRST)
    assert isinstance(got, sharding.PlacedIVFIndex) and got.mesh == mesh
    assert got is tier.store
    np.testing.assert_array_equal(tier.slot_bucket, flat_tier.slot_bucket)
    for name in ("bucket_vecs", "bucket_ids", "bucket_sqnorm"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            assert torch.equal(a, b), name
    for name in ("hot_map", "centroids", "bucket_sizes"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    padded = got.cap
    assert padded % shards == 0 and padded > cap
    assert tier.host_vecs.shape[1] == padded
    assert (tier.host_ids[:, cap:] == -1).all()
    assert torch.isinf(tier.host_sqn[:, cap:]).all()
    assert (tier.host_vecs[:, cap:] == 0).all()
    # one slot's staging lands every shard's slice of the bucket's rows
    bk = int(np.where(tier.hot_map < 0)[0][0])
    for name, t, lo, hi in tier._targets():
        t[0].copy_({"bucket_vecs": tier.host_vecs,
                    "bucket_ids": tier.host_ids,
                    "bucket_sqnorm": tier.host_sqn}[name][bk, lo:hi])
    ids = torch.cat([t[0] for t in tier.store.bucket_ids])
    np.testing.assert_array_equal(ids[:cap].numpy(),
                                  c["index"].bucket_ids[bk].numpy())
    assert len(tier._targets()) == 3 * shards
