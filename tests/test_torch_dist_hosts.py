"""A mutable view under a mesh and the serve mesh's ``"hosts"`` axis.

A placed mutable view (IVF or HNSW base, after an insert/delete burst)
is held to the JAX reference's single-device ``mutable_engine``, before
and after a compaction pushed through ``refresh_placed_view``: both
packages get the same integer collection and the same rounded
``mutation_stream`` events, so every distance is exact and ids, ndis and
ninserts must be EQUAL (the reference's own mesh tests fail under this
container's jax; it states that its sharded mutable engines equal the
single-device ones, ``tests/test_dist_mutate.py``).

The server over a serve mesh steps each host group's slots on that
group's devices against the global index; per-slot state never crosses
slots, so a query's result cannot depend on the host group that served
it (reference README, "Multi-host slot pool"). It is held to the
single-controller server over the unsharded engine, per query and per
counter, at hosts 1, 2 and 4, for the sharded IVF and HNSW engines bare
and under ``mutable_engine``. Every device is the CPU here.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the test lane runs six workers on a few cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import mutate as ref_mutate  # noqa: E402
from repro.core import darth_search as ref_ds  # noqa: E402
from repro.core import engines as ref_engines  # noqa: E402
from repro.index import hnsw as ref_hnsw  # noqa: E402
from repro.index import ivf as ref_ivf  # noqa: E402
from repro_torch import convert, dist, mutate  # noqa: E402
from repro_torch.core import api, darth_search, engines  # noqa: E402
from repro_torch.data import vectors  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.index import hnsw  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.serve import DarthServer  # noqa: E402

K, NLIST, CAP, N, EF = 10, 16, 512, 1501, 48
SLOTS, SPS = 16, 2
CPU = torch.device("cpu")


def int_dataset(seed=5, n=N):
    """Integer-valued clustered base, learn and query sets (D = 16)."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-12, 13, (24, 16))

    def draw(m, spread):
        return (centers[rng.integers(0, 24, m)]
                + rng.integers(-spread, spread + 1, (m, 16))
                ).astype(np.float32)
    return vectors.VectorDataset(base=draw(n, 4), learn=draw(200, 6),
                                 queries=draw(40, 6), name="int")


def int_events(ds):
    """mutation_stream(0.2, 0.1, drift 0.3) with rounded insert vectors."""
    return [e._replace(vecs=np.round(e.vecs).astype(np.float32))
            if e.kind == "insert" else e
            for e in vectors.mutation_stream(ds, 0.2, 0.1, drift=0.3,
                                             steps=4, seed=3)]


@pytest.fixture(scope="module")
def ds():
    return int_dataset()


@pytest.fixture(scope="module")
def bases(ds):
    """{kind: (reference base, port base)}: IVF built by the reference
    (odd cap, centroids rounded) and carried across; the HNSW graph built
    by both packages, equal on integer data."""
    ref = ref_ivf.build(ds.base, nlist=NLIST, seed=0, cap_round=1)
    ref = dataclasses.replace(ref, centroids=jnp.round(ref.centroids))
    out = {"ivf": (ref, convert.ivf_index_from_numpy(
        convert.fields_as_numpy(ref), "cpu"))}
    kw = dict(m=8, passes=1, ef_construction=32, seed=0)
    out["hnsw"] = (ref_hnsw.build(ds.base, **kw),
                   hnsw.build(ds.base, device="cpu", **kw))
    return out


def engine_kw(kind):
    return dict(k=K, nprobe=NLIST) if kind == "ivf" else dict(k=K, ef=EF)


def family(kind, index, mesh=None):
    """The single-device or sharded engine of ``kind`` over ``index``."""
    if mesh is None:
        make = engines.ivf_engine if kind == "ivf" else engines.hnsw_engine
        return make(index, **engine_kw(kind))
    make = (engines.sharded_ivf_engine if kind == "ivf"
            else engines.sharded_hnsw_engine)
    return make(index, mesh, **engine_kw(kind))


def ref_family(kind, index):
    make = (ref_engines.ivf_engine if kind == "ivf"
            else ref_engines.hnsw_engine)
    return make(index, **engine_kw(kind))


def assert_plain_equal(ref_eng, eng, q):
    s_r = ref_ds.plain_search(ref_eng, jnp.asarray(q))
    s_p = darth_search.plain_search(eng, torch.as_tensor(q))
    np.testing.assert_array_equal(eng.topk_i(s_p).numpy(),
                                  np.asarray(ref_eng.topk_i(s_r)))
    np.testing.assert_array_equal(eng.topk_d(s_p).numpy(),
                                  np.asarray(ref_eng.topk_d(s_r)))
    for name in ("ndis", "ninserts"):
        np.testing.assert_array_equal(getattr(s_p, name).numpy(),
                                      np.asarray(getattr(s_r, name)))


# -- a mutable view under a mesh ----------------------------------------------

@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("kind", ["ivf", "hnsw"])
def test_placed_mutable_view_equals_reference(ds, bases, kind, shards):
    """After the burst, the placed view (delta ring untouched, whole on
    the lead device) serves plain_search equal to the reference's
    single-device mutable engine; after compact() and
    refresh_placed_view, equal again."""
    ref_base, base = bases[kind]
    events = int_events(ds)
    ref_mut = ref_mutate.MutableIndex(ref_base, capacity=CAP)
    ref_mut.apply(events)
    mut = mutate.MutableIndex(base, capacity=CAP)
    mut.apply(events)
    assert len(mut.deleted_ids) and mut.num_delta
    mesh = mesh_lib.make_search_mesh(shards, "cpu")
    view = dist.place_index(mut.view(), mesh)
    assert view.base.mesh == mesh and view.base.num_shards == shards
    for f in ("vecs", "ids", "sqnorm"):
        assert getattr(view.delta, f) is getattr(mut.delta, f)
    eng = engines.mutable_engine(family(kind, view.base, mesh), view.delta)
    assert eng.name == f"{kind}-sharded+delta"
    ref_eng = ref_engines.mutable_engine(ref_family(kind, ref_mut.base),
                                         ref_mut.delta)
    assert_plain_equal(ref_eng, eng, ds.queries)

    ref_mut.compact()
    mut.compact()
    kept = dist.refresh_placed_view(view, mesh, delta=mut.delta)
    assert kept.base is view.base        # a None component is not re-placed
    view = dist.refresh_placed_view(kept, mesh, base=mut.base)
    assert view.delta is kept.delta
    eng = mutate.refresh_view(eng, base=view.base, delta=view.delta)
    ref_eng = ref_engines.mutable_engine(ref_family(kind, ref_mut.base),
                                         ref_mut.delta)
    assert_plain_equal(ref_eng, eng, ds.queries)
    with pytest.raises(TypeError, match="MutableIndexView"):
        dist.refresh_placed_view(view.base, mesh, base=mut.base)


# -- the serve mesh -----------------------------------------------------------

def test_serve_mesh_axes_devices_and_host_groups(monkeypatch):
    mesh = mesh_lib.make_serve_mesh(2, 2, "cpu")
    assert mesh.axis_names == ("hosts", "model")
    assert mesh.shape == {"hosts": 2, "model": 2} and mesh.num_hosts == 2
    assert mesh.devices == (CPU,) * 4 and mesh.lead == CPU
    assert mesh.host_meshes() == (mesh_lib.make_search_mesh(2, "cpu"),) * 2
    assert sharding.shard_count(mesh) == 2
    assert mesh_lib.describe(mesh) == \
        "mesh(2, 2) axes=('hosts', 'model') on cpu"
    assert mesh_lib.make_serve_mesh(3, 0, "cpu").sizes == (3, 1)
    with pytest.raises(ValueError, match="hosts must be"):
        mesh_lib.make_serve_mesh(0, 1, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = mesh_lib.make_serve_mesh(2, 2, "cuda")
    assert cards.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert cards.host(1).devices == (torch.device("cuda", 2),
                                     torch.device("cuda", 3))
    assert mesh_lib.make_serve_mesh(2, 0, "cuda").sizes == (2, 2)
    with pytest.raises(ValueError, match="needs 6 CUDA devices"):
        mesh_lib.make_serve_mesh(2, 3, "cuda")
    assert mesh_lib.make_serve_mesh(4, 2, "cuda:1").devices == (
        torch.device("cuda", 1),) * 8


def test_slot_sharding_and_constrain_slots():
    mesh = mesh_lib.make_serve_mesh(4, 1, "cpu")
    assert sharding.slot_sharding(mesh, 16) == tuple(
        slice(h * 4, (h + 1) * 4) for h in range(4))
    # the axis does not divide the slots, or there is none: replication
    assert sharding.slot_sharding(mesh, 15) == (slice(0, 15),)
    assert sharding.slot_sharding(None, 8) == (slice(0, 8),)
    assert sharding.slot_sharding(mesh_lib.make_search_mesh(2, "cpu"),
                                  8) == (slice(0, 8),)
    x = torch.arange(32).reshape(16, 2)
    parts = sharding.constrain_slots((x, torch.tensor(7)), mesh, 16)
    assert len(parts) == 4
    for h, (a, b) in enumerate(parts):
        assert torch.equal(a, x[h * 4:(h + 1) * 4]) and int(b) == 7
    assert torch.equal(sharding.constrain_slots(x, mesh, 15)[0], x)


@pytest.mark.parametrize("kind", ["ivf", "hnsw"])
def test_place_index_on_a_serve_mesh_keeps_the_index_global(bases, kind):
    """Every host group reads the same shards: on one device they are the
    same tensors, so no second copy of the store is made."""
    _, base = bases[kind]
    mesh = mesh_lib.make_serve_mesh(2, 3, "cpu")
    placed = dist.place_index(base, mesh)
    assert placed.mesh == mesh and placed.num_shards == 3
    assert len(placed.host_views) == 2
    name = "bucket_vecs" if kind == "ivf" else "vectors"
    for h, view in enumerate(placed.host_views):
        assert view.mesh == mesh.host(h)
        assert sharding.host_index(placed, h) is view
        for a, b in zip(getattr(view, name), getattr(placed, name)):
            assert a is b
    single = dist.place_index(base, mesh_lib.make_search_mesh(3, "cpu"))
    for a, b in zip(getattr(placed, name), getattr(single, name)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="host group 1"):
        sharding.host_index(single, 1)


@pytest.fixture(scope="module")
def fitted(ds, bases):
    """Each kind's Darth, fitted by the port on the unsharded engine."""
    out = {}
    for kind in ("ivf", "hnsw"):
        d = api.Darth(make_engine=None, engine=family(kind, bases[kind][1]))
        d.fit(ds.learn, ds.base, batch=128)
        out[kind] = d
    return out


def _mixed(n):
    return np.resize(np.array([0.8, 0.9, 0.95, 0.99], np.float32), n)


def _serve(engine, darth, q, mesh=None, kill_hosts=None, **kw):
    srv = DarthServer(engine, darth.trained.predictor,
                      darth.interval_for_target, num_slots=SLOTS,
                      steps_per_sync=SPS, mesh=mesh, **kw)
    res, stats = srv.serve(q, _mixed(q.shape[0]), kill_hosts=kill_hosts)
    return res, stats, srv


def _engines(kind, bases, ds, mutable, mesh):
    """(single-controller engine, engine over ``mesh``) of ``kind``."""
    base = bases[kind][1]
    if not mutable:
        return (family(kind, base),
                family(kind, dist.place_index(base, mesh), mesh))
    mut = mutate.MutableIndex(base, capacity=CAP)
    mut.apply(int_events(ds))
    view = dist.place_index(mut.view(), mesh)
    return (engines.mutable_engine(family(kind, mut.base), mut.delta),
            engines.mutable_engine(family(kind, view.base, mesh),
                                   view.delta))


def _assert_same(a, b):
    (res_a, st_a, _), (res_b, st_b, _) = a, b
    assert [r is None for r in res_a] == [r is None for r in res_b]
    for ra, rb in zip(res_a, res_b):
        if ra is not None:
            np.testing.assert_array_equal(rb[0], ra[0])
            np.testing.assert_array_equal(rb[1], ra[1])
    for name in ("completed", "truncated", "engine_steps", "slot_steps",
                 "refills", "ndis_harvested"):
        assert getattr(st_b, name) == getattr(st_a, name), name
    assert [dataclasses.astuple(h) for h in st_b.hosts] == \
        [dataclasses.astuple(h) for h in st_a.hosts]


@pytest.mark.parametrize("mutable", [False, True])
@pytest.mark.parametrize("kind", ["ivf", "hnsw"])
def test_server_over_a_hosts_mesh_equals_single_controller(ds, bases,
                                                           fitted, kind,
                                                           mutable):
    """Per query and per counter: at hosts H in {1, 2, 4} over a (H, 2)
    serve mesh, the server equals the single-controller server at the
    same H over the unsharded engine, and every query's result equals the
    hosts-1 single-controller run's. Traced at H = 2: the terminal spans
    (ndis, npred, early) are equal too."""
    darth = fitted[kind]
    first = None
    for hosts in (1, 2, 4):
        mesh = mesh_lib.make_serve_mesh(hosts, 2, "cpu")
        single, sharded = _engines(kind, bases, ds, mutable, mesh)
        traced = hosts == 2
        want = _serve(single, darth, ds.queries, hosts=hosts,
                      tracer=Tracer() if traced else None)
        got = _serve(sharded, darth, ds.queries, mesh=mesh, hosts=hosts,
                     tracer=Tracer() if traced else None)
        assert len(got[2]._group_index) == hosts
        assert got[1].completed == ds.queries.shape[0]
        _assert_same(want, got)
        if traced:
            tw, tg = want[2].tracer.terminals(), got[2].tracer.terminals()
            assert sorted(tg) == sorted(tw)
            for qid, sp in tw.items():
                for key in ("ndis", "npred", "reason", "host"):
                    assert tg[qid].attrs.get(key) == sp.attrs.get(key), key
        if first is None:
            first = want[0]
        for ra, rb in zip(first, got[0]):
            np.testing.assert_array_equal(rb[1], ra[1])


def test_killed_host_group_keeps_its_accounting(ds, bases, fitted):
    """kill_hosts on a (2, 2) serve mesh: the same completed, truncated
    and abandoned queries as the single-controller server, and every
    query is served, truncated or abandoned: none is dropped silently."""
    mesh = mesh_lib.make_serve_mesh(2, 2, "cpu")
    single, sharded = _engines("ivf", bases, ds, False, mesh)
    want = _serve(single, fitted["ivf"], ds.queries, hosts=2,
                  kill_hosts={1: 4})
    got = _serve(sharded, fitted["ivf"], ds.queries, mesh=mesh, hosts=2,
                 kill_hosts={1: 4})
    _assert_same(want, got)
    st = got[1]
    assert st.hosts[1].killed and st.hosts[1].abandoned
    served = sum(r is not None for r in got[0])
    assert served == st.completed + st.truncated
    assert served + sum(h.abandoned for h in st.hosts) == \
        ds.queries.shape[0]


def test_server_on_a_hosts_mesh_serves_its_global_index(ds, bases, fitted):
    """The (2, 2) mesh's placement, not host group 0's sub-mesh one, is
    what the server takes; a hosts axis that does not divide the slots
    falls back to one group on the lead device."""
    darth = fitted["ivf"]
    mesh = mesh_lib.make_serve_mesh(2, 2, "cpu")
    args = (darth.trained.predictor, darth.interval_for_target)
    sub = dist.place_index(bases["ivf"][1], mesh.host(0))
    with pytest.raises(ValueError, match="not placed"):
        DarthServer(family("ivf", sub, mesh), *args, mesh=mesh)
    _, eng = _engines("ivf", bases, ds, False, mesh)
    srv = DarthServer(eng, *args, num_slots=15, mesh=mesh)
    assert len(srv._group_index) == 1
    res, stats = srv.serve(ds.queries, _mixed(ds.queries.shape[0]))
    assert stats.completed == ds.queries.shape[0]
