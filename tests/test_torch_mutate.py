"""The port's streaming mutable index against the JAX reference's.

Both packages get the same integer-valued collection (the reference's IVF
index carried across with ``repro_torch.convert``, centroids rounded; the
HNSW graph built by each package, equal on integer data) and the same
``mutation_stream`` events, their insert vectors rounded to integers. Every
distance is then exact in f32 whatever the summation order, so ring-slot
placement, tombstones, ``bucket_sizes``, ids, ``ndis``/``ninserts``/
``nstep`` and DARTH's decisions must be EQUAL after each event and after a
20 % insert / 10 % delete burst; distances agree to 1e-5 (the reference's
own parity tolerance), predicted recalls to 1e-6 (the GBDT sums its 100
trees in another order, ``tests/test_torch_darth.py``). No recall constant
calibrated on a seed is reused: achieved recall is compared with the
reference's, not with a number.
"""
import dataclasses
import os
import subprocess
import sys

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
from repro.dist import collectives as ref_collectives  # noqa: E402
from repro.index import hnsw as ref_hnsw  # noqa: E402
from repro.index import ivf as ref_ivf  # noqa: E402
from repro_torch import convert, mutate  # noqa: E402
from repro_torch.core import api, darth_search, engines  # noqa: E402
from repro_torch.data import vectors  # noqa: E402
from repro_torch.dist import collectives  # noqa: E402
from repro_torch.index import hnsw  # noqa: E402

K, NLIST, CAP = 10, 16, 512
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def int_dataset(seed=4, n=2000, n_learn=200, n_q=64):
    """Integer-valued clustered base, learn and query sets (D = 16)."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-12, 13, (24, 16))

    def draw(m, spread):
        return (centers[rng.integers(0, 24, m)]
                + rng.integers(-spread, spread + 1, (m, 16))
                ).astype(np.float32)
    return vectors.VectorDataset(base=draw(n, 4), learn=draw(n_learn, 6),
                                 queries=draw(n_q, 6), name="int")


def int_events(ds, ins=0.2, dels=0.1, steps=4, seed=3):
    """The launcher's workload (mutation_stream, drift 0.3) with its insert
    vectors rounded to integers."""
    return [e._replace(vecs=np.round(e.vecs).astype(np.float32))
            if e.kind == "insert" else e
            for e in vectors.mutation_stream(ds, ins, dels, drift=0.3,
                                             steps=steps, seed=seed)]


def ivf_pair(ds):
    """(reference IVF index with rounded centroids, the port's copy)."""
    ref = ref_ivf.build(ds.base, nlist=NLIST, seed=0)
    ref = dataclasses.replace(ref, centroids=jnp.round(ref.centroids))
    return ref, convert.ivf_index_from_numpy(convert.fields_as_numpy(ref),
                                             "cpu")


def hnsw_pair(ds):
    """(reference graph, the port's own build of it: equal on integers)."""
    kw = dict(m=8, passes=1, ef_construction=32, seed=0)
    ref = ref_hnsw.build(ds.base, **kw)
    port = hnsw.build(ds.base, device="cpu", **kw)
    np.testing.assert_array_equal(port.neighbors.numpy(),
                                  np.asarray(ref.neighbors))
    return ref, port


def base_engines(kind, ref_base, port_base):
    if kind == "ivf":
        kw = dict(k=K, nprobe=NLIST)
        return (ref_engines.ivf_engine(ref_base, **kw),
                engines.ivf_engine(port_base, **kw))
    kw = dict(k=K, ef=48, max_steps=160)
    return (ref_engines.hnsw_engine(ref_base, **kw),
            engines.hnsw_engine(port_base, **kw))


def mutable_pair(kind, ref_mut, port_mut):
    r, p = base_engines(kind, ref_mut.base, port_mut.base)
    return (ref_engines.mutable_engine(r, ref_mut.delta),
            engines.mutable_engine(p, port_mut.delta))


def assert_bookkeeping_equal(ref_mut, port_mut):
    """Host maps, ring contents and base tombstones equal."""
    assert port_mut.version == ref_mut.version
    assert port_mut.num_live == ref_mut.num_live
    assert port_mut.num_delta == ref_mut.num_delta
    assert port_mut._cursor == ref_mut._cursor
    assert port_mut._delta_slot == ref_mut._delta_slot
    assert port_mut._slot_id == ref_mut._slot_id
    np.testing.assert_array_equal(np.sort(port_mut.deleted_ids),
                                  np.sort(ref_mut.deleted_ids))
    for name in ("vecs", "ids", "sqnorm"):
        np.testing.assert_array_equal(
            getattr(port_mut.delta, name).numpy(),
            np.asarray(getattr(ref_mut.delta, name)), err_msg=f"delta.{name}")
    if port_mut.kind == "ivf":
        np.testing.assert_array_equal(port_mut._bucket_of, ref_mut._bucket_of)
        np.testing.assert_array_equal(port_mut._slot_of, ref_mut._slot_of)
        names = ("bucket_ids", "bucket_sizes", "bucket_sqnorm")
    else:
        names = ("sqnorm",)
    for name in names:
        np.testing.assert_array_equal(
            getattr(port_mut.base, name).numpy(),
            np.asarray(getattr(ref_mut.base, name)), err_msg=f"base.{name}")


# --- delta ring and merge -----------------------------------------------------

def test_delta_write_with_pad_slots_equals_reference():
    """A write padded with slot -1 (the host's fixed-length writes) drops
    the pad rows: -1 must not land on the last slot, as a torch index
    would put it. A tombstone with -1 pads masks only the named slots."""
    rng = np.random.default_rng(0)
    vecs = rng.integers(-9, 10, (6, 4)).astype(np.float32)
    slots = np.array([0, 3, -1, 7, -1, 2], np.int32)   # 7 = last slot
    ids = np.array([100, 101, -1, 102, -1, 103], np.int32)
    r = ref_mutate.delta.write(ref_mutate.make_delta(8, 4), jnp.asarray(slots),
                               jnp.asarray(vecs), jnp.asarray(ids))
    p = mutate.delta.write(mutate.make_delta(8, 4, device="cpu"), slots, vecs,
                           ids)
    for name in ("vecs", "ids", "sqnorm"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(r, name)))
    assert int(p.ids[7]) == 102 and int(p.ids[6]) == -1
    dead = np.array([3, -1, -1, 7], np.int32)
    r = ref_mutate.delta.tombstone(r, jnp.asarray(dead))
    p2 = mutate.delta.tombstone(p, dead)
    for name in ("vecs", "ids", "sqnorm"):
        np.testing.assert_array_equal(getattr(p2, name).numpy(),
                                      np.asarray(getattr(r, name)))
    assert int(p.ids[3]) == 101       # the given ring is never written
    assert int(mutate.delta.live_count(p2)) == int(
        ref_mutate.delta.live_count(r)) == 2


@pytest.mark.parametrize("k", [1, 3, 8])
def test_delta_topk_after_tombstone_equals_reference(k):
    """delta_topk over a ring holding empty and tombstoned slots: ids,
    live and ninserts equal, distances within 1e-5; a k above the live
    count leaves (+inf, -1) slots."""
    rng = np.random.default_rng(1)
    cap, d = 16, 8
    vecs = rng.integers(-5, 6, (9, d)).astype(np.float32)
    vecs[4] = vecs[1]                           # a tie: lower slot first
    slots = np.array([0, 2, 3, 5, 6, 9, 11, 12, 15], np.int32)
    ids = np.arange(500, 509, dtype=np.int32)
    r = ref_mutate.delta.write(ref_mutate.make_delta(cap, d),
                               jnp.asarray(slots), jnp.asarray(vecs),
                               jnp.asarray(ids))
    p = mutate.delta.write(mutate.make_delta(cap, d, device="cpu"), slots,
                           vecs, ids)
    dead = np.array([3, 11, -1], np.int32)
    r = ref_mutate.delta.tombstone(r, jnp.asarray(dead))
    p = mutate.delta.tombstone(p, dead)
    q = rng.integers(-5, 6, (12, d)).astype(np.float32)
    q[0] = vecs[1]
    out_r = ref_mutate.delta.delta_topk(r, jnp.asarray(q), k)
    out_p = mutate.delta.delta_topk(p, torch.as_tensor(q), k)
    np.testing.assert_allclose(out_p[0].numpy(), np.asarray(out_r[0]),
                               atol=1e-5, rtol=0)
    for a, b in zip(out_p[1:], out_r[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not (set(out_p[1].numpy().ravel()) & {502, 506})


def test_merge_topk_equals_reference_on_ties_and_inf():
    """Rows full of equal distances and of +inf: the lower column first on
    a tie (lax.top_k's order), +inf candidates masked back to id -1."""
    rng = np.random.default_rng(2)
    d = rng.integers(0, 4, (40, 24)).astype(np.float32)
    d[rng.random(d.shape) < 0.4] = np.inf
    d[0] = np.inf
    d[1] = 2.0
    i = rng.integers(0, 1000, d.shape).astype(np.int32)
    for k in (1, 10, 24):
        d_r, i_r = ref_collectives.merge_topk(jnp.asarray(d), jnp.asarray(i),
                                              k)
        d_p, i_p = collectives.merge_topk(torch.as_tensor(d),
                                          torch.as_tensor(i), k)
        np.testing.assert_array_equal(d_p.numpy(), np.asarray(d_r))
        np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))


def test_mutable_engine_requires_capacity_ge_k():
    ds = int_dataset(n=300, n_learn=0, n_q=4)
    _, index = ivf_pair(ds)
    with pytest.raises(ValueError, match="delta capacity"):
        engines.mutable_engine(engines.ivf_engine(index, k=10, nprobe=4),
                               mutate.make_delta(4, 16, device="cpu"))


# --- MutableIndex bookkeeping -------------------------------------------------

@pytest.fixture(scope="module")
def ds():
    return int_dataset()


@pytest.fixture(scope="module")
def ivf_indexes(ds):
    return ivf_pair(ds)


@pytest.fixture(scope="module")
def hnsw_indexes(ds):
    return hnsw_pair(ds)


def test_bookkeeping_equals_reference_event_by_event_ivf(ds, ivf_indexes):
    """The launcher's burst event by event, then a small ring driven
    through wrap, reuse of dead slots and a delete of a just-inserted id,
    and a delete that hits one bucket several times: after every event the
    ring, the host maps, bucket_ids, bucket_sqnorm and bucket_sizes are
    the reference's."""
    ref_idx, port_idx = ivf_indexes
    ref_mut = ref_mutate.MutableIndex(ref_idx, capacity=CAP)
    port_mut = mutate.MutableIndex(port_idx, capacity=CAP)
    for ev in int_events(ds):
        ref_mut.apply([ev])
        port_mut.apply([ev])
        assert_bookkeeping_equal(ref_mut, port_mut)
    # a delete hitting one bucket several times (and unknown / repeated
    # ids, which are no-ops)
    bi = np.asarray(ref_mut.base.bucket_ids)
    b = int(np.argmax((bi >= 0).sum(1)))
    same = bi[b][bi[b] >= 0][:5].tolist()
    assert len(same) == 5
    sizes = port_mut.base.bucket_sizes.clone()
    kill = same + same[:2] + [10 ** 6, -3]
    assert port_mut.delete(kill) == ref_mut.delete(kill) == 5
    assert_bookkeeping_equal(ref_mut, port_mut)
    assert int(sizes[b] - port_mut.base.bucket_sizes[b]) == 5

    small_r = ref_mutate.MutableIndex(ref_idx, capacity=4)
    small_p = mutate.MutableIndex(port_idx, capacity=4)
    q = ds.queries
    for op in (("ins", q[:3]), ("del", [2000, 2001]), ("ins", q[3:6]),
               ("del", [2005]), ("ins", q[6:7]), ("del", [2002, 7, 8]),
               ("ins", q[7:8])):
        for mut in (small_r, small_p):
            if op[0] == "ins":
                mut.insert(op[1])
            else:
                mut.delete(op[1])
        assert_bookkeeping_equal(small_r, small_p)
    with pytest.raises(RuntimeError, match="delta tier full"):
        small_p.insert(q[:2])


def test_bookkeeping_equals_reference_event_by_event_hnsw(ds, hnsw_indexes):
    ref_idx, port_idx = hnsw_indexes
    ref_mut = ref_mutate.MutableIndex(ref_idx, capacity=CAP)
    port_mut = mutate.MutableIndex(port_idx, capacity=CAP)
    for ev in int_events(ds):
        ref_mut.apply([ev])
        port_mut.apply([ev])
        assert_bookkeeping_equal(ref_mut, port_mut)


def test_delete_never_writes_the_index_it_was_given(ds, ivf_indexes,
                                                    hnsw_indexes):
    """Snapshot isolation: delete builds a new base from clones, so a
    compaction's begin-time snapshot and an older served view stay as they
    were; the vectors themselves are shared, never copied."""
    for base in (ivf_indexes[1], hnsw_indexes[1]):
        before = {f.name: getattr(base, f.name).clone()
                  for f in dataclasses.fields(base)
                  if isinstance(getattr(base, f.name), torch.Tensor)}
        mut = mutate.MutableIndex(base, capacity=64)
        view = mut.view()
        mut.insert(ds.queries[:4])
        mut.delete([0, 1, 2, 3, 2000])
        for name, t in before.items():
            assert torch.equal(getattr(base, name), t), name
            assert torch.equal(getattr(view.base, name), t), name
        assert mut.base is not base
        stored = "bucket_vecs" if hasattr(base, "bucket_vecs") else "vectors"
        assert getattr(mut.base, stored) is getattr(base, stored)
        assert int((view.delta.ids >= 0).sum()) == 0


# --- the mutable engine after a burst -------------------------------------------

def _live_gt_ref(ref_mut, q):
    live_ids, live_vecs = ref_mut.live_vectors()
    _, rows = ref_training.ground_truth(jnp.asarray(q),
                                        jnp.asarray(live_vecs), K)
    rows = np.asarray(rows)
    return np.where(rows >= 0, live_ids[np.maximum(rows, 0)], -1
                    ).astype(np.int32)


def burst_pair(kind, ds, indexes):
    """Twin mutable indexes after the 20 % / 10 % burst, the reference's
    Darth fitted through its mutable engine against live ground truth,
    and the port's around the same predictor and dists_Rt."""
    ref_idx, port_idx = indexes
    ref_mut = ref_mutate.MutableIndex(ref_idx, capacity=CAP)
    port_mut = mutate.MutableIndex(port_idx, capacity=CAP)
    events = int_events(ds)
    ref_mut.apply(events)
    port_mut.apply(events)
    ref_eng, port_eng = mutable_pair(kind, ref_mut, port_mut)
    live_ids, live_vecs = ref_mut.live_vectors()
    ref_d = ref_api.Darth(make_engine=None, engine=ref_eng)
    trained = ref_d.fit(jnp.asarray(ds.learn), jnp.asarray(live_vecs),
                        ids=live_ids, batch=128)
    port_d = api.Darth(
        make_engine=None, engine=port_eng,
        trained=convert.trained_from_numpy(
            ref_gbdt.to_state_dict(trained.predictor.params),
            trained.dists_rt, "cpu"))
    return ref_mut, port_mut, ref_d, port_d


@pytest.fixture(scope="module")
def ivf_burst(ds, ivf_indexes):
    return burst_pair("ivf", ds, ivf_indexes)


@pytest.fixture(scope="module")
def hnsw_burst(ds, hnsw_indexes):
    return burst_pair("hnsw", ds, hnsw_indexes)


def _mixed(n):
    return np.resize(np.array([0.8, 0.9, 0.95], np.float32), n)


def assert_same_search(ref_d, port_d, port_mut, q, target):
    rt = _mixed(q.shape[0]) if target == "mixed" else target
    d_r, i_r, st_r = ref_d.search(jnp.asarray(q), rt)
    d_p, i_p, st_p = port_d.search(q, rt)
    assert int(st_p.steps) == int(st_r.steps)
    for name in ("npred", "early"):
        np.testing.assert_array_equal(getattr(st_p, name).numpy(),
                                      np.asarray(getattr(st_r, name)))
    np.testing.assert_allclose(st_p.r_pred.numpy(), np.asarray(st_r.r_pred),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_r), atol=1e-5,
                               rtol=0)
    for name in ("ndis", "ninserts"):
        np.testing.assert_array_equal(getattr(st_p.inner, name).numpy(),
                                      np.asarray(getattr(st_r.inner, name)))
    np.testing.assert_array_equal(
        port_d.engine.nstep(st_p.inner).numpy(),
        np.asarray(ref_d.engine.nstep(st_r.inner)))
    dead = set(port_mut.deleted_ids.tolist())
    assert not (set(i_p.numpy().ravel().tolist()) & dead)
    return i_p.numpy(), st_p


@pytest.mark.parametrize("target", [0.8, 0.9, 0.95, "mixed"])
def test_burst_search_equals_reference_ivf(ivf_burst, ds, target):
    ref_mut, port_mut, ref_d, port_d = ivf_burst
    ids, st = assert_same_search(ref_d, port_d, port_mut, ds.queries, target)
    if target != "mixed":
        assert st.early.any()          # the predictor really stopped queries


@pytest.mark.parametrize("target", [0.8, 0.9, 0.95, "mixed"])
def test_burst_search_equals_reference_hnsw(hnsw_burst, ds, target):
    ref_mut, port_mut, ref_d, port_d = hnsw_burst
    assert_same_search(ref_d, port_d, port_mut, ds.queries, target)


@pytest.mark.parametrize("kind", ["ivf", "hnsw"])
def test_inserted_vectors_find_themselves(kind, ivf_burst, hnsw_burst):
    """A live delta vector used as a query finds its own global id at
    distance 0 through the wrapper (at rank 0 unless a base row holds the
    same integer vector: the base's candidates come first on a tie); the
    live ground truth equals the reference's."""
    ref_mut, port_mut, _, port_d = ivf_burst if kind == "ivf" else hnsw_burst
    ids = np.array(sorted(port_mut._delta_slot)[:16])
    slots = [port_mut._delta_slot[i] for i in ids]
    q = port_mut.delta.vecs[slots]
    inner = darth_search.plain_search(port_d.engine, q)
    d, i = port_d.engine.topk_d(inner), port_d.engine.topk_i(inner).numpy()
    rank = (i == ids[:, None]).argmax(1)
    assert (i == ids[:, None]).any(1).all()
    assert (d.numpy()[np.arange(16), rank] == 0).all()
    assert (rank == 0).mean() > 0.5
    np.testing.assert_array_equal(
        port_mut.live_ground_truth(q.numpy(), K),
        _live_gt_ref(ref_mut, q.numpy()))


@pytest.mark.parametrize("kind", ["ivf", "hnsw"])
def test_empty_delta_wrapper_is_the_base_engine(kind, ds, ivf_indexes,
                                                hnsw_indexes, ivf_burst,
                                                hnsw_burst):
    """With an empty ring the wrapper is bit for bit the base engine:
    plain search (distances, ids, ndis, ninserts, nstep) and, with the
    same predictor, every DARTH decision."""
    _, base = ivf_indexes if kind == "ivf" else hnsw_indexes
    port_d = (ivf_burst if kind == "ivf" else hnsw_burst)[3]
    mut = mutate.MutableIndex(base, capacity=64)
    _, base_eng = base_engines(kind, base, base)
    wrap = engines.mutable_engine(base_eng, mut.delta)
    q = torch.as_tensor(ds.queries)
    s_b = darth_search.plain_search(base_eng, q)
    s_w = darth_search.plain_search(wrap, q)
    assert torch.equal(wrap.topk_d(s_w), base_eng.topk_d(s_b))
    assert torch.equal(wrap.topk_i(s_w), base_eng.topk_i(s_b))
    for name in ("ndis", "ninserts"):
        assert torch.equal(getattr(s_w, name), getattr(s_b, name))
    assert torch.equal(wrap.nstep(s_w), base_eng.nstep(s_b))
    d_b = api.Darth(make_engine=None, engine=base_eng,
                    trained=port_d.trained)
    d_w = api.Darth(make_engine=None, engine=wrap, trained=port_d.trained)
    rt = _mixed(q.shape[0])
    out_b, out_w = d_b.search(q, rt), d_w.search(q, rt)
    assert torch.equal(out_b[0], out_w[0]) and torch.equal(out_b[1], out_w[1])
    for name in ("r_pred", "npred", "early"):
        assert torch.equal(getattr(out_b[2], name), getattr(out_w[2], name))
    assert out_b[2].steps == out_w[2].steps


def test_merge_memo_never_outlives_a_step(ds, ivf_burst):
    """The memoized merge lives on one state: a step and a set_active
    build new states, which merge afresh."""
    port_d = ivf_burst[3]
    eng = port_d.engine
    ws = eng.init(eng.index, torch.as_tensor(ds.queries[:8]))
    first = eng.topk_i(ws).clone()
    assert "_merged_topk" in ws.__dict__
    ws2 = eng.step(eng.index, ws)
    assert "_merged_topk" not in ws2.__dict__
    ws3 = engines.set_active(ws2, torch.zeros_like(ws2.active))
    assert "_merged_topk" not in ws3.__dict__
    assert torch.equal(eng.topk_i(ws), first)
    assert ws2.delta_d is ws.delta_d       # carried, never rewritten


# --- monitor -----------------------------------------------------------------

def test_drift_report_equals_reference(ds, ivf_burst):
    """drift() on the same replay (served ids, targets, epoch) gives the
    reference's per-target achieved recall, counts and verdict; a refit
    drops the ring."""
    ref_mut, port_mut, ref_d, port_d = ivf_burst
    targets = (0.8, 0.9, 0.95)
    rt = _mixed(ds.queries.shape[0])
    _, ids, _ = port_d.search(ds.queries, rt)
    ids = ids.numpy()
    ids[::3, 0] = -1                           # some misses
    ref_mon = ref_mutate.RecalibrationMonitor(ref_mut, ref_d, targets=targets,
                                              capacity=48)
    port_mon = mutate.RecalibrationMonitor(port_mut, port_d, targets=targets,
                                           capacity=48)
    for mon in (ref_mon, port_mon):
        assert mon.drift().num_queries == 0
        mon.observe(ds.queries, rt, ids)      # wraps the 48-entry ring
    rep_r, rep_p = ref_mon.drift(), port_mon.drift()
    assert rep_p.achieved == rep_r.achieved
    assert rep_p.counts == rep_r.counts
    assert rep_p.num_queries == rep_r.num_queries == 48
    assert rep_p.worst_gap == rep_r.worst_gap
    assert rep_p.drifted == rep_r.drifted


def test_recalibrate_trainlog_equals_reference(ds, ivf_indexes):
    """recalibrate refits through Darth.fit(ids=) against the live set
    mapped to global ids: the step log equals the reference's (ndis,
    valid and the counters equal, recall to one ulp, firstNN and the
    distance features to a few ulp, as tests/test_torch_fit.py states),
    the refit predictor is hot-swapped
    into the server and the replay ring is dropped."""
    from repro_torch.core import features as features_lib
    from repro_torch.serve import DarthServer
    ref_mut = ref_mutate.MutableIndex(ivf_indexes[0], capacity=CAP)
    port_mut = mutate.MutableIndex(ivf_indexes[1], capacity=CAP)
    events = int_events(ds)
    ref_mut.apply(events)
    port_mut.apply(events)
    ref_eng, port_eng = mutable_pair("ivf", ref_mut, port_mut)
    ref_d = ref_api.Darth(make_engine=None, engine=ref_eng)
    port_d = api.Darth(make_engine=None, engine=port_eng)
    ref_mon = ref_mutate.RecalibrationMonitor(ref_mut, ref_d)
    port_mon = mutate.RecalibrationMonitor(port_mut, port_d)
    learn = ds.learn[:128]
    port_mon.observe(ds.queries[:8], 0.9, np.zeros((8, K), np.int64))
    ref_mon.recalibrate(learn, batch=64)
    server = DarthServer(port_eng, lambda f: torch.zeros(f.shape[0]),
                         port_d.interval_for_target, num_slots=8)
    port_mon.recalibrate(learn, batch=64, server=server)
    assert port_mon.recalibrations == 1
    assert port_mon.drift().num_queries == 0
    assert server.predictor is port_d.trained.predictor
    assert set(port_mon.refit_seconds) == {"live_set", "ground_truth",
                                           "observations", "gbdt"}
    log_r, log_p = ref_d._last_log, port_d._last_log
    for name in ("ndis", "valid"):
        np.testing.assert_array_equal(getattr(log_p, name),
                                      getattr(log_r, name))
    np.testing.assert_allclose(log_p.recall, log_r.recall, rtol=0,
                               atol=np.spacing(np.float32(1.0)))
    # the counters are equal; firstNN and the distance statistics agree
    # to a few ulp (XLA's jitted CPU sqrt is at times 1 ulp off)
    np.testing.assert_array_equal(log_p.features[..., :3],
                                  log_r.features[..., :3])
    var = features_lib.FEATURE_NAMES.index("var")
    other = [j for j in range(3, 11) if j != var]
    np.testing.assert_allclose(log_p.features[..., other],
                               log_r.features[..., other], rtol=2e-5)
    np.testing.assert_allclose(log_p.features[..., var],
                               log_r.features[..., var], rtol=0, atol=2e-4)


# --- launcher ----------------------------------------------------------------

@pytest.mark.parametrize("online", [False, True])
def test_launcher_mutation_flags_on_the_cpu(online):
    """The launcher's mutation workload at a small size: the reference's
    phase lines, each with a mean-recall line per target. The refit is
    forced (--recal-threshold -1) so the recalibration phase always runs."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
           "cpu", "--n", "2000", "--dim", "16", "--learn", "200",
           "--queries", "64", "--nlist", "16", "--slots", "16",
           "--mutations", "0.2,0.1", "--drift", "0.3",
           "--recal-threshold", "-1"]
    if online:
        cmd.append("--online-compact")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    text = out.stdout
    phases = (["pre-mutation", "online-mutation", "post-swap"] if online
              else ["pre-mutation", "post-burst", "post-recalibration",
                    "post-compaction"])
    for label in phases:
        for t in ("0.80", "0.90", "0.95"):
            assert f"[serve] {label}: target {t}: mean recall" in text, label
    assert "[serve] mutable index: delta capacity 512" in text
    if online:
        assert "[serve] online mutation stream: 8 events" in text
        assert "atomic swap(s) mid-serve" in text
    else:
        assert "[serve] mutation burst applied:" in text
        assert "RECALIBRATING" in text
        assert "[serve] compaction folded delta into base" in text
