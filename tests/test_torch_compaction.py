"""The port's compaction — synchronous, background and through the slot-pool
server — against the JAX reference's.

As in ``tests/test_torch_mutate.py``, both packages get the same
integer-valued collection and the same rounded ``mutation_stream`` events.
Every distance is exact in f32, so the compacted shadow must equal the
reference's field by field, bit for bit (IVF f32 and SQ8 on the
reference's index carried across; HNSW on each package's own build, equal
on integer data, whose fold draws numpy's randomness in the reference's
order), after the same number of ticks. After compaction, search through
the wrapper equals a from-scratch search over the compacted index. The
online contracts: a background rebuild equals the synchronous compact, a
delete during the rebuild is re-tombstoned in the shadow, an insert during
it survives live in the ring, and a drained swap in the middle of a serve
changes no result.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the test lane runs six workers on a few cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import mutate as ref_mutate  # noqa: E402
from repro.index import hnsw as ref_hnsw  # noqa: E402
from repro.index import ivf as ref_ivf  # noqa: E402
from repro_torch import convert, mutate  # noqa: E402
from repro_torch.core import api, darth_search, engines  # noqa: E402
from repro_torch.data import vectors  # noqa: E402
from repro_torch.index import hnsw  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serve import DarthServer  # noqa: E402

K, NLIST, CAP = 10, 16, 512
FIELDS = {"ivf": ("centroids", "bucket_vecs", "bucket_ids", "bucket_sqnorm",
                  "bucket_sizes", "scale", "offset"),
          "hnsw": ("vectors", "neighbors", "sqnorm", "entry", "route_ids")}


def int_dataset(seed=5, n=2000, n_learn=128, n_q=64):
    """Integer-valued clustered base, learn and query sets (D = 16)."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-12, 13, (24, 16))

    def draw(m, spread):
        return (centers[rng.integers(0, 24, m)]
                + rng.integers(-spread, spread + 1, (m, 16))
                ).astype(np.float32)
    return vectors.VectorDataset(base=draw(n, 4), learn=draw(n_learn, 6),
                                 queries=draw(n_q, 6), name="int")


def int_events(ds, steps=4, seed=3):
    """mutation_stream(0.2, 0.1, drift 0.3) with rounded insert vectors."""
    return [e._replace(vecs=np.round(e.vecs).astype(np.float32))
            if e.kind == "insert" else e
            for e in vectors.mutation_stream(ds, 0.2, 0.1, drift=0.3,
                                             steps=steps, seed=seed)]


@pytest.fixture(scope="module")
def ds():
    return int_dataset()


@pytest.fixture(scope="module")
def bases(ds):
    """{kind: (reference base, port base)}: IVF f32 and SQ8 built by the
    reference (centroids rounded) and carried across; the HNSW graph built
    by both packages."""
    out = {}
    for name, quantize in (("ivf", False), ("ivf_sq8", True)):
        ref = ref_ivf.build(ds.base, nlist=NLIST, seed=0, quantize=quantize)
        ref = dataclasses.replace(ref, centroids=jnp.round(ref.centroids))
        out[name] = (ref, convert.ivf_index_from_numpy(
            convert.fields_as_numpy(ref), "cpu"))
    kw = dict(m=8, passes=1, ef_construction=32, seed=0)
    ref = ref_hnsw.build(ds.base, **kw)
    port = hnsw.build(ds.base, device="cpu", **kw)
    np.testing.assert_array_equal(port.neighbors.numpy(),
                                  np.asarray(ref.neighbors))
    out["hnsw"] = (ref, port)
    return out


def kind_of(name):
    return "ivf" if name.startswith("ivf") else "hnsw"


def assert_base_equal(port_base, ref_base, kind):
    for f in FIELDS[kind]:
        a = getattr(port_base, f).numpy()
        b = np.asarray(getattr(ref_base, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f"base.{f}")


def engine_for(kind, base, delta):
    eng = (engines.ivf_engine(base, k=K, nprobe=NLIST) if kind == "ivf"
           else engines.hnsw_engine(base, k=K, ef=64))
    return eng if delta is None else engines.mutable_engine(eng, delta)


def drain_ticks(mut):
    """Begin a compaction and tick it to the end; returns the tick count."""
    mut.begin_compaction(seed=1)
    while not mut.compact_tick():
        pass
    ticks = mut.compaction_ticks
    mut.swap_compaction()
    return ticks


@pytest.mark.parametrize("name", ["ivf", "ivf_sq8", "hnsw"])
def test_compaction_shadow_equals_reference(ds, bases, name):
    """After the burst, the compacted base equals the reference's field by
    field and bit for bit, after as many ticks; the SQ8 fold counts the
    delta values clamped to the frozen range. Then the wrapper over the
    compacted base (empty ring) equals a from-scratch search over it."""
    kind = kind_of(name)
    ref_base, port_base = bases[name]
    ref_mut = ref_mutate.MutableIndex(ref_base, capacity=CAP)
    port_mut = mutate.MutableIndex(port_base, capacity=CAP)
    reg = MetricsRegistry()
    port_mut.attach_metrics(reg)
    events = int_events(ds)
    ref_mut.apply(events)
    port_mut.apply(events)
    dead = set(port_mut.deleted_ids.tolist())

    assert drain_ticks(port_mut) == drain_ticks(ref_mut) >= 3
    assert_base_equal(port_mut.base, ref_mut.base, kind)
    assert port_mut.num_delta == 0 and port_mut.version == ref_mut.version
    np.testing.assert_array_equal(port_mut.delta.ids.numpy(),
                                  np.asarray(ref_mut.delta.ids))
    split = set(port_mut.compaction_seconds)
    assert split == ({"read", "assign", "pack", "upload"} if kind == "ivf"
                     else {"read", "repair", "link"})
    kinds = [e["kind"] for e in reg.events]
    assert kinds[0] == "compact_begin" and kinds[-1] == "compact_swap"
    if name == "ivf_sq8":
        assert reg.counter("darth_sq8_clipped_total").value() > 0

    live_ids, _ = port_mut.live_vectors()
    if kind == "ivf":
        bi = port_mut.base.bucket_ids.numpy()
        stored = set(bi[bi >= 0].tolist())
        assert stored == set(live_ids.tolist())
    else:
        sq = port_mut.base.sqnorm.numpy()
        nbr = port_mut.base.neighbors.numpy()
        rows = np.fromiter(dead, np.int64)
        assert np.isposinf(sq[rows]).all() and (nbr[rows] == -1).all()
        stored = set(np.nonzero(np.isfinite(sq))[0].tolist())
    assert not (stored & dead)

    q = torch.as_tensor(ds.queries)
    base_eng = engine_for(kind, port_mut.base, None)
    wrap = engine_for(kind, port_mut.base, port_mut.delta)
    s_b = darth_search.plain_search(base_eng, q)
    s_w = darth_search.plain_search(wrap, q)
    assert torch.equal(wrap.topk_d(s_w), base_eng.topk_d(s_b))
    assert torch.equal(wrap.topk_i(s_w), base_eng.topk_i(s_b))
    assert torch.equal(s_w.ndis, s_b.ndis)
    assert torch.equal(s_w.ninserts, s_b.ninserts)
    assert not (set(wrap.topk_i(s_w).numpy().ravel().tolist()) & dead)


def test_insert_nodes_equals_reference(bases, ds):
    """hnsw.insert_nodes links appended rows exactly as the reference's,
    chunk by chunk (one yield per chunk), on integer data."""
    ref_g, port_g = bases["hnsw"]
    rng = np.random.default_rng(9)
    n_new = 150
    new = np.round(ds.base[rng.integers(0, 2000, n_new)]
                   + rng.normal(size=(n_new, 16)) * 2).astype(np.float32)
    x = np.concatenate([np.asarray(ref_g.vectors), new])
    nbr = np.concatenate([np.asarray(ref_g.neighbors),
                          np.full((n_new, ref_g.degree), -1, np.int32)])
    rows = np.arange(2000, 2000 + n_new)[::-1].copy()   # not ascending
    grown_r = dataclasses.replace(
        ref_g, vectors=jnp.asarray(x), sqnorm=jnp.asarray((x ** 2).sum(1)),
        neighbors=jnp.asarray(nbr))
    grown_p = dataclasses.replace(
        port_g, vectors=torch.as_tensor(x),
        sqnorm=torch.as_tensor((x ** 2).sum(1)),
        neighbors=torch.as_tensor(nbr))
    out_r = ref_hnsw.insert_nodes(grown_r, rows, ef_construction=32,
                                  chunk=64)
    gen = hnsw.insert_nodes_steps(grown_p, rows, ef_construction=32, chunk=64)
    ticks = 0
    while True:
        try:
            next(gen)
            ticks += 1
        except StopIteration as stop:
            out_p = stop.value
            break
    assert ticks == 3
    np.testing.assert_array_equal(out_p.neighbors.numpy(),
                                  np.asarray(out_r.neighbors))
    assert (out_p.neighbors.numpy()[rows] >= 0).any(1).all()
    with pytest.raises(ValueError, match="f32"):
        hnsw.insert_nodes(dataclasses.replace(
            grown_p, vectors=grown_p.vectors.to(torch.int8),
            scale=torch.ones(16), offset=torch.zeros(16)), rows)


# --- background compaction ----------------------------------------------------

def twins(ds, bases, name):
    base = bases[name][1]
    a = mutate.MutableIndex(base, capacity=CAP)
    b = mutate.MutableIndex(base, capacity=CAP)
    events = int_events(ds)
    a.apply(events)
    b.apply(events)
    return a, b


@pytest.mark.parametrize("name", ["ivf", "hnsw"])
def test_background_rebuild_equals_sync_compact(ds, bases, name):
    """Ticking the job and swapping gives the base the synchronous
    compact() gives: they drain the same generator."""
    sync, bg = twins(ds, bases, name)
    sync.compact(seed=1)
    bg.begin_compaction(seed=1)
    assert bg.compacting
    ticks = 0
    while not bg.compact_tick():
        ticks += 1
    assert ticks >= 3
    bg.swap_compaction()
    assert not bg.compacting
    assert_base_equal(bg.base, sync.base, kind_of(name))
    assert torch.equal(bg.delta.ids, sync.delta.ids)
    assert bg.num_delta == 0 and bg.num_live == sync.num_live


def test_compaction_job_api_contract(ds, bases):
    mut = mutate.MutableIndex(bases["ivf"][1], capacity=64)
    mut.insert(ds.queries[:8])
    with pytest.raises(RuntimeError, match="no compaction"):
        mut.compact_tick()
    with pytest.raises(RuntimeError, match="no compaction"):
        mut.swap_compaction()
    mut.begin_compaction()
    with pytest.raises(RuntimeError, match="already in progress"):
        mut.begin_compaction()
    with pytest.raises(RuntimeError, match="not finished"):
        mut.swap_compaction()
    while not mut.compact_tick():
        pass
    mut.swap_compaction()
    assert mut.num_delta == 0


@pytest.mark.parametrize("name", ["ivf", "hnsw"])
def test_mid_rebuild_delete_is_retombstoned_in_shadow(ds, bases, name):
    """A delete landing while the rebuild runs hides the id from the
    active view at once and is re-applied to the shadow at the swap, as
    the reference does: both shadows are equal."""
    kind = kind_of(name)
    ref_mut = ref_mutate.MutableIndex(bases[name][0], capacity=CAP)
    _, mut = twins(ds, bases, name)
    ref_mut.apply(int_events(ds))
    delta_id = int(next(iter(mut._delta_slot)))
    base_id = 7
    assert base_id not in set(mut.deleted_ids.tolist())
    for m in (ref_mut, mut):
        m.begin_compaction(seed=1)
        m.compact_tick()                       # snapshot taken, job running
        assert m.delete([base_id, delta_id]) == 2
    meng = engine_for(kind, mut.base, mut.delta)
    ws = darth_search.plain_search(meng, torch.as_tensor(ds.queries))
    assert not ({base_id, delta_id}
                & set(meng.topk_i(ws).numpy().ravel().tolist()))
    for m in (ref_mut, mut):
        while not m.compact_tick():
            pass
        m.swap_compaction()
    assert_base_equal(mut.base, ref_mut.base, kind)
    live_ids, _ = mut.live_vectors()
    assert not ({base_id, delta_id} & set(live_ids.tolist()))
    if kind == "ivf":
        assert mut._bucket_of[base_id] == -1


def test_mid_rebuild_insert_survives_in_ring(ds, bases):
    """Ids inserted after begin_compaction were never snapshotted: they
    stay live in the ring across the swap, in the slots the reference
    gives them, and their slots are not freed with the folded ones."""
    ref_mut = ref_mutate.MutableIndex(bases["ivf"][0], capacity=64)
    mut = mutate.MutableIndex(bases["ivf"][1], capacity=64)
    for m in (ref_mut, mut):
        folded = m.insert(ds.queries[:8])
        m.begin_compaction()
        m.compact_tick()
        late = m.insert(ds.queries[8:11])
        while not m.compact_tick():
            pass
        m.swap_compaction()
    assert mut.num_delta == 3
    assert mut._delta_slot == ref_mut._delta_slot
    np.testing.assert_array_equal(mut.delta.ids.numpy(),
                                  np.asarray(ref_mut.delta.ids))
    assert int(mutate.delta.live_count(mut.delta)) == 3
    bi = mut.base.bucket_ids.numpy()
    stored = set(bi[bi >= 0].tolist())
    assert set(folded.tolist()) <= stored
    assert not (set(late.tolist()) & stored)
    meng = engine_for("ivf", mut.base, mut.delta)
    ws = darth_search.plain_search(meng, torch.as_tensor(ds.queries[8:11]))
    np.testing.assert_array_equal(meng.topk_i(ws).numpy()[:, 0], late)
    mut.compact()
    assert mut.num_delta == 0
    bi = mut.base.bucket_ids.numpy()
    assert set(late.tolist()) <= set(bi[bi >= 0].tolist())


# --- the drained atomic swap in the serving loop ---------------------------------

@pytest.fixture(scope="module")
def served(ds, bases):
    """A mutable IVF index after the burst and a Darth fitted through its
    wrapper by the port."""
    mut = mutate.MutableIndex(bases["ivf"][1], capacity=CAP)
    mut.apply(int_events(ds))

    def make_engine(**kw):
        return engines.mutable_engine(engines.ivf_engine(mut.base, **kw),
                                      mut.delta)
    d = api.Darth(make_engine=make_engine,
                  engine=make_engine(k=K, nprobe=NLIST))
    live_ids, live_vecs = mut.live_vectors()
    d.fit(ds.learn, live_vecs, ids=live_ids, batch=64)
    return mut, d


@pytest.mark.parametrize("hosts", [1, 2])
def test_drained_swap_mid_serve_matches_no_swap(ds, served, hosts):
    """request_swap of an engine over the same contents is invisible to
    results: admissions pause, the pool drains, the swap applies at an
    empty boundary, and every query's distances, ids and ndis are
    unchanged."""
    mut, d = served
    rts = np.random.default_rng(0).choice(
        [0.8, 0.9, 0.95], ds.queries.shape[0]).astype(np.float32)

    def run(swap_at):
        server = DarthServer(d.engine, d.trained.predictor,
                             d.interval_for_target, num_slots=8,
                             steps_per_sync=2, hosts=hosts)
        seen = {"n": 0}

        def on_boundary(srv):
            seen["n"] += 1
            if seen["n"] == swap_at and not srv.swap_pending:
                srv.request_swap(
                    mutate.refresh_view(srv.engine, delta=mut.delta),
                    contents_only=True)
        return server.serve(ds.queries, rts,
                            on_boundary=on_boundary if swap_at else None)

    plain, st0 = run(0)
    swapped, st1 = run(2)
    assert st0.swaps == 0 and st1.swaps == 1
    assert st1.completed == ds.queries.shape[0]
    assert st1.ndis_harvested == st0.ndis_harvested
    for a, b in zip(plain, swapped):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_background_compaction_through_serve_boundaries(ds, bases, served):
    """The launcher's online path on one server: events land at
    boundaries as contents-only refreshes, the rebuild ticks in the
    background, and the folded base hot-swaps mid-serve; every query
    completes, the base equals a synchronous rebuild of a twin, and once
    the fold has swapped in no tombstoned id surfaces."""
    _, d = served
    base = bases["ivf"][1]
    mut = mutate.MutableIndex(base, capacity=CAP)
    twin = mutate.MutableIndex(base, capacity=CAP)
    events = int_events(ds, steps=2)
    twin.apply(events)
    twin.compact()
    server = DarthServer(engine_for("ivf", mut.base, mut.delta),
                         d.trained.predictor, d.interval_for_target,
                         num_slots=4, steps_per_sync=2)
    ev = list(events)
    state = {"swapped": False}

    def on_boundary(srv):
        if srv.swap_pending or state["swapped"]:
            return
        if ev:
            e = ev.pop(0)
            mut.apply([e])
            srv.set_engine(mutate.refresh_view(
                srv.engine, base=mut.base if e.kind == "delete" else None,
                delta=mut.delta), contents_only=True)
        elif not mut.compacting:
            mut.begin_compaction()
        elif mut.compact_tick():
            mut.swap_compaction()
            srv.request_swap(engine_for("ivf", mut.base, mut.delta),
                             contents_only=True)
            state["swapped"] = True

    rts = np.full((ds.queries.shape[0],), 0.9, np.float32)
    results, stats = server.serve(ds.queries, rts, on_boundary=on_boundary)
    assert stats.completed == ds.queries.shape[0]
    assert all(r is not None for r in results)
    assert state["swapped"] and stats.swaps == 1
    assert not ev and not mut.compacting
    assert_base_equal(mut.base, twin.base, "ivf")
    assert mut.num_delta == 0
    results2, stats2 = server.serve(ds.queries, rts)
    assert stats2.completed == ds.queries.shape[0]
    dead = set(mut.deleted_ids.tolist())
    for r in results2:
        assert not (dead & set(r[1].ravel().tolist()))
