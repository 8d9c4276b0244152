"""The port's sharded HNSW search against the JAX reference's
single-device functions.

The reference's own mesh tests fail under this container's jax, and the
reference states that its sharded beam step equals the single-device one
on any shard count (``dist/collectives.py:421-428``,
``index/hnsw.py:555-562``). So the placed graph's sharded step,
``search_sharded`` and the plain, budget and DARTH searches over
``sharded_hnsw_engine`` are held to the reference's ``beam_step``,
``search`` and searches over ``hnsw_engine``. Every shard of a mesh
lives on the CPU here. The graph has n = 1501 rows, odd and 1 mod 4, so
S = 2, 3 and 4 all pad; it is built by the reference and carried
across. Vectors are integers, so
distances are exact and ids, ties included, must be EQUAL.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the test lane runs six workers on a few cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import gbdt as ref_gbdt  # noqa: E402
from repro.core import api as ref_api  # noqa: E402
from repro.core import darth_search as ref_ds  # noqa: E402
from repro.core import engines as ref_engines  # noqa: E402
from repro.core import training as ref_training  # noqa: E402
from repro.index import hnsw as ref_hnsw  # noqa: E402
from repro.index import residency as ref_residency  # noqa: E402
from repro_torch import convert, dist  # noqa: E402
from repro_torch.core import api, darth_search, engines  # noqa: E402
from repro_torch.dist import collectives  # noqa: E402
from repro_torch.index import hnsw  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402

K, EF, N = 10, 32, 1501
SHARDS = [1, 2, 3, 4]
WIDTH = 128            # a hashed filter: a power of two below N
STATE_FIELDS = ("cand_i", "cand_d", "cand_exp", "active", "ndis",
                "ninserts", "nstep")


def cpu_mesh(shards):
    return mesh_lib.make_search_mesh(shards, "cpu")


def _clustered(seed, n=N):
    """Integer-valued clustered base, learn and query sets."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-12, 13, (24, 16))
    x = (centers[rng.integers(0, 24, n)]
         + rng.integers(-4, 5, (n, 16))).astype(np.float32)
    x[100:104] = x[7]                    # duplicates: ties in the frontier
    learn = (centers[rng.integers(0, 24, 300)]
             + rng.integers(-6, 7, (300, 16))).astype(np.float32)
    q = (centers[rng.integers(0, 24, 32)]
         + rng.integers(-6, 7, (32, 16))).astype(np.float32)
    q[0] = x[7]
    return x, learn, q


@pytest.fixture(scope="module")
def graph():
    """The reference's graph (and its SQ8 form) and the port's copies."""
    x, learn, q = _clustered(3)
    ref = ref_hnsw.build(x, m=8, passes=1, ef_construction=32, seed=0)
    ref8 = ref_residency.quantize_hnsw(ref)
    port = {False: convert.hnsw_index_from_numpy(
        convert.fields_as_numpy(ref), "cpu"),
        True: convert.hnsw_index_from_numpy(
            convert.fields_as_numpy(ref8), "cpu")}
    return x, learn, q, {False: ref, True: ref8}, port


# -- placement ---------------------------------------------------------------

@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("shards", SHARDS)
def test_place_index_pads_and_splits_the_rows(graph, shards, quantize):
    _, _, _, _, port = graph
    index = port[quantize]
    placed = dist.place_index(index, cpu_mesh(shards))
    m = -(-N // shards)
    assert shards == 1 or N % shards, "a row count S divides tests no pad"
    assert (placed.num_shards, placed.rows, placed.num_vectors) == (
        shards, m, m * shards)
    for name, pad in (("vectors", 0), ("neighbors", -1),
                      ("sqnorm", float("inf"))):
        parts = getattr(placed, name)
        assert all(p.is_contiguous() and p.shape[0] == m for p in parts)
        whole = torch.cat(parts, 0)
        assert torch.equal(whole[:N], getattr(index, name))
        assert (whole[N:] == pad).all()
    rids = index.route_ids.long()
    assert torch.equal(placed.route_ids, index.route_ids)
    assert torch.equal(placed.route_vecs, index.vectors[rids].float())
    assert torch.equal(placed.route_sqnorm, index.sqnorm[rids])
    assert torch.equal(placed.entry, index.entry)
    for name in ("scale", "offset"):
        a, b = getattr(placed, name), getattr(index, name)
        assert (a is None and b is None) or torch.equal(a, b)
    assert (placed.degree, placed.quantized, placed.device, placed.mesh) == (
        index.degree, quantize, torch.device("cpu"), cpu_mesh(shards))


# -- the sharded beam step ----------------------------------------------------

def _compare(sr, sp, exact):
    for name in STATE_FIELDS:
        a = np.asarray(getattr(sr, name))
        b = getattr(sp, name).numpy()
        if exact or name in ("ndis", "nstep", "active"):
            np.testing.assert_array_equal(b, a, err_msg=name)
        elif name == "cand_d":
            np.testing.assert_allclose(b, a, atol=1e-3, err_msg=name)
        else:  # SQ8 near-ties may swap an id or an insert
            assert np.mean(b == a) > 0.95, name
    # XLA's jitted CPU sqrt is at times 1 ulp off (tests/test_torch_hnsw.py)
    np.testing.assert_allclose(sp.first_nn.numpy(), np.asarray(sr.first_nn),
                               rtol=1e-6)
    vis = torch.cat(sp.visited, 1).numpy()
    want = np.asarray(sr.visited)
    np.testing.assert_array_equal(vis[:, :want.shape[1]], want)
    assert not vis[:, want.shape[1]:].any()


@pytest.mark.parametrize("quantize,width", [(False, 0), (False, WIDTH),
                                            (True, 0)])
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_beam_steps_equal_reference(graph, shards, quantize, width):
    """Step by step, with some queries stopped at step 4: every state
    field of the sharded step equals the reference's beam_step, and the
    visited blocks joined and cut to N equal its visited structure."""
    _, _, q, ref, port = graph
    ref, port = ref[quantize], port[quantize]
    mesh = cpu_mesh(shards)
    placed = dist.place_index(port, mesh)
    init = collectives.make_sharded_hnsw_init(mesh)
    step = collectives.make_sharded_beam_step(mesh)
    if width and width % shards:
        with pytest.raises(ValueError, match="not divisible"):
            init(placed, torch.as_tensor(q), ef=EF, visited_width=width)
        return
    sr = ref_hnsw.init_state(ref, jnp.asarray(q), ef=EF, visited_width=width)
    sp = init(placed, torch.as_tensor(q), ef=EF, visited_width=width)
    assert len(sp.visited) == shards
    _compare(sr, sp, exact=not quantize)
    steps = 0
    while bool(sr.active.any()):
        if steps == 4:
            stop = np.arange(q.shape[0]) % 3 == 0
            sr = dataclasses.replace(sr, active=sr.active & ~jnp.asarray(stop))
            sp = engines.set_active(sp, sp.active & ~torch.as_tensor(stop))
        sr = ref_hnsw.beam_step(ref, sr, k=K)
        sp = step(placed, sp, k=K)
        _compare(sr, sp, exact=not quantize)
        steps += 1
    assert steps > 20 and not sp.active.any()


def test_sharded_beam_step_needs_its_placed_graph(graph):
    _, _, q, _, port = graph
    mesh = cpu_mesh(2)
    step = collectives.make_sharded_beam_step(mesh)
    init = collectives.make_sharded_hnsw_init(mesh)
    s = hnsw.init_state(port[False], torch.as_tensor(q), ef=EF)
    with pytest.raises(ValueError, match="place_index"):
        step(port[False], s, k=K)
    with pytest.raises(ValueError, match="place_index"):
        init(dist.place_index(port[False], cpu_mesh(3)), torch.as_tensor(q),
             ef=EF)
    with pytest.raises(ValueError, match="make_sharded_hnsw_init"):
        step(dist.place_index(port[False], mesh), s, k=K)


@pytest.mark.parametrize("width", [0, WIDTH])
@pytest.mark.parametrize("shards", [2, 4])
def test_search_sharded_equals_reference(graph, shards, width):
    _, _, q, ref, port = graph
    mesh = cpu_mesh(shards)
    d_r, i_r, s_r = ref_hnsw.search(ref[False], jnp.asarray(q), k=K, ef=EF,
                                    visited_width=width)
    d_p, i_p, s_p = hnsw.search_sharded(dist.place_index(port[False], mesh),
                                        torch.as_tensor(q), k=K, ef=EF,
                                        mesh=mesh, visited_width=width)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))
    np.testing.assert_array_equal(d_p.numpy(), np.asarray(d_r))
    for name in ("ndis", "ninserts", "nstep", "active"):
        np.testing.assert_array_equal(getattr(s_p, name).numpy(),
                                      np.asarray(getattr(s_r, name)))


# -- the searches over the sharded engine ----------------------------------

ENGINE_KW = dict(k=K, ef=48, max_steps=160)


@pytest.fixture(scope="module")
def carried(graph):
    """The reference's Darth fitted on hnsw_engine over the f32 graph, and
    the port's copy of its predictor and dists_Rt. The routing sample is
    R = 64, small against a search's distances, so DARTH predicts."""
    x, learn, q, ref, port = graph
    ref_engine = ref_engines.hnsw_engine(ref[False], **ENGINE_KW)
    _, gt = ref_training.ground_truth(jnp.asarray(learn), jnp.asarray(x), K)
    log = ref_training.generate_observations(ref_engine, jnp.asarray(learn),
                                             gt, batch=128)
    trained = ref_training.fit_predictor(
        log, cfg=ref_gbdt.GBDTConfig(num_trees=100, depth=6,
                                     min_child_weight=5.0))
    ref_darth = ref_api.Darth(make_engine=None, engine=ref_engine,
                              trained=trained)
    port_trained = convert.trained_from_numpy(
        ref_gbdt.to_state_dict(trained.predictor.params), trained.dists_rt,
        "cpu")
    return ref_darth, port[False], port_trained, x, learn, q


def _sharded_darth(index, trained, shards, **kw):
    mesh = cpu_mesh(shards)
    placed = dist.place_index(index, mesh)
    return api.Darth(make_engine=None, trained=trained,
                     engine=engines.sharded_hnsw_engine(
                         placed, mesh, **ENGINE_KW, **kw)), mesh


def _mixed(n):
    return np.resize(np.array([0.8, 0.9, 0.95, 0.99], np.float32), n)


@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("target", [0.8, 0.9, 0.95, "mixed"])
def test_darth_over_sharded_hnsw_engine_equals_reference(carried, target,
                                                         shards):
    ref_darth, index, trained, _, _, q = carried
    port_darth, _ = _sharded_darth(index, trained, shards)
    assert port_darth.engine.name == "hnsw-sharded"
    assert port_darth.engine.max_steps == ref_darth.engine.max_steps
    rt = _mixed(q.shape[0]) if target == "mixed" else target
    _, i_r, st_r = ref_darth.search(jnp.asarray(q), rt)
    _, i_p, st_p = port_darth.search(q, rt)
    assert int(st_p.steps) == int(st_r.steps)
    for name in ("npred", "early"):
        np.testing.assert_array_equal(getattr(st_p, name).numpy(),
                                      np.asarray(getattr(st_r, name)))
    np.testing.assert_allclose(st_p.r_pred.numpy(), np.asarray(st_r.r_pred),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))
    for name in ("ndis", "ninserts", "nstep"):
        np.testing.assert_array_equal(getattr(st_p.inner, name).numpy(),
                                      np.asarray(getattr(st_r.inner, name)))
    assert st_p.npred.any()              # DARTH predicted on this graph
    if target != "mixed":
        assert st_p.early.any()          # and stopped queries


@pytest.mark.parametrize("width", [0, WIDTH])
def test_plain_and_budget_over_sharded_hnsw_equal_reference(carried, width):
    ref_darth, index, trained, _, _, q = carried
    ref_engine = ref_engines.hnsw_engine(ref_darth.engine.index,
                                         visited_width=width, **ENGINE_KW)
    port_darth, _ = _sharded_darth(index, trained, 4, visited_width=width)
    s_r = ref_ds.plain_search(ref_engine, jnp.asarray(q))
    s_p = darth_search.plain_search(port_darth.engine, torch.as_tensor(q))
    for name in ("cand_i", "cand_d", "ndis", "nstep"):
        np.testing.assert_array_equal(getattr(s_p, name).numpy(),
                                      np.asarray(getattr(s_r, name)))
    budget = np.linspace(80, 600, q.shape[0]).astype(np.float32)
    b_r = ref_ds.budget_search(ref_engine, jnp.asarray(q), budget)
    b_p = darth_search.budget_search(port_darth.engine, torch.as_tensor(q),
                                     budget)
    for name in ("cand_i", "ndis", "ninserts", "nstep"):
        np.testing.assert_array_equal(getattr(b_p, name).numpy(),
                                      np.asarray(getattr(b_r, name)))


def test_fit_through_a_mesh_on_hnsw(carried):
    """Darth.fit(mesh=) over the sharded HNSW engine logs the TrainLog of
    the unsharded fit over hnsw_engine, bit for bit, and fits the same
    trees."""
    _, index, _, x, learn, _ = carried
    plain = api.Darth(make_engine=None,
                      engine=engines.hnsw_engine(index, **ENGINE_KW))
    sharded, mesh = _sharded_darth(index, None, 3)
    plain.fit(learn, x, batch=128)
    sharded.fit(learn, x, batch=128, mesh=mesh)
    for name in ("features", "recall", "ndis", "valid"):
        np.testing.assert_array_equal(getattr(sharded._last_log, name),
                                      getattr(plain._last_log, name),
                                      err_msg=name)
    for name in ("feat", "thresh", "leaf", "base"):
        assert torch.equal(getattr(sharded.trained.predictor.params, name),
                           getattr(plain.trained.predictor.params, name))
    assert sharded.trained.dists_rt == plain.trained.dists_rt


def test_difficulty_scores_route_over_a_placed_graph(graph):
    """The tiers' admission scan reads a placed graph's routing sample
    (gathered at placement) as it reads the graph's own."""
    from repro_torch.serve import difficulty
    _, _, q, _, port = graph
    placed = dist.place_index(port[False], cpu_mesh(3))
    np.testing.assert_array_equal(
        difficulty.difficulty_scores(placed, q),
        difficulty.difficulty_scores(port[False], q))
