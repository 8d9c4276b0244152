"""The port's sharded search against the JAX reference's single-device
functions.

The reference's own mesh tests fail under this container's jax, and the
reference states that its sharded functions equal the single-device ones
on any shard count (``dist/collectives.py:93-96,255-258``,
``index/ivf.py:308-310``). So every sharded path of the port is held to
the reference's single-device function: the flat search to
``flat.search``, the probe step to ``ivf.probe_step``, the DARTH driver
over ``sharded_ivf_engine`` to ``darth_search`` over ``ivf_engine``.
The shards of a mesh all live on the CPU here (``make_search_mesh(S,
"cpu")``), as the reference's forced host devices share one CPU. Vectors
are integers and centroids rounded, so distances are exact and ids, ties
included, must be EQUAL.
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

from repro import gbdt as ref_gbdt  # noqa: E402
from repro.core import api as ref_api  # noqa: E402
from repro.core import engines as ref_engines  # noqa: E402
from repro.core import training as ref_training  # noqa: E402
from repro.index import flat as ref_flat  # noqa: E402
from repro.index import ivf as ref_ivf  # noqa: E402
from repro.serve import cold as ref_cold  # noqa: E402
from repro_torch import convert, dist, mutate  # noqa: E402
from repro_torch.core import api, darth_search, engines, training  # noqa: E402
from repro_torch.dist import collectives  # noqa: E402
from repro_torch.index import hnsw, ivf  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.serve import DarthServer, cold  # noqa: E402

K, NLIST = 10, 16
SHARDS = [1, 2, 3, 4]
FIELDS = ("topk_i", "topk_d", "ndis", "ninserts", "probe_pos", "active")


def cpu_mesh(shards):
    return mesh_lib.make_search_mesh(shards, "cpu")


# -- mesh rules --------------------------------------------------------------

def test_every_shard_on_one_named_device():
    m = cpu_mesh(3)
    assert m.axis_names == ("model",) and m.shape == {"model": 3}
    assert m.devices == (torch.device("cpu"),) * 3
    assert m.lead == torch.device("cpu")
    assert cpu_mesh(0).shape == {"model": 1}
    assert mesh_lib.describe(m) == "mesh(3,) axes=('model',) on cpu"


def test_cuda_mesh_spreads_over_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh_lib.make_search_mesh(2, "cuda").devices == (
        torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh_lib.make_search_mesh(0, "cuda").shape == {"model": 3}
    assert mesh_lib.make_search_mesh(4, "cuda:1").devices == (
        torch.device("cuda", 1),) * 4


@pytest.mark.parametrize("count,shards,device", [
    (1, 2, "cuda"), (0, 0, "cuda"), (0, 1, "cuda"), (2, 1, "cuda:2")])
def test_mesh_refuses_too_few_cards(monkeypatch, count, shards, device):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    with pytest.raises(ValueError):
        mesh_lib.make_search_mesh(shards, device)


def test_serve_mesh_over_hosts_raises():
    """A serve mesh over hosts, once refused, is the ("hosts", "model")
    mesh; a mesh whose devices do not fill its sizes still raises."""
    mesh = mesh_lib.make_serve_mesh(2, 1, "cpu")
    assert mesh.axis_names == ("hosts", "model") and mesh.sizes == (2, 1)
    assert mesh.host(1) == cpu_mesh(1)
    assert mesh_lib.make_serve_mesh(1, 2, "cpu").host(0) == cpu_mesh(2)
    with pytest.raises(ValueError):
        mesh_lib.SearchMesh(("model",), (2,), (torch.device("cpu"),))


# -- placement ---------------------------------------------------------------

def _int_data(n=1500, d=16, nq=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 9, (n, d)).astype(np.float32)
    x[100:104] = x[7]                    # duplicates: ties inside buckets
    q = rng.integers(-8, 9, (nq, d)).astype(np.float32)
    q[0] = x[7]
    return x, q


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("shards", SHARDS)
def test_place_index_pads_and_splits_the_cap(shards, quantize):
    x, _ = _int_data()
    index = ivf.build(x, nlist=NLIST, seed=0, cap_round=1, quantize=quantize,
                      device="cpu")
    assert index.cap % 12, "a cap every shard count divides tests no pad"
    placed = dist.place_index(index, cpu_mesh(shards))
    m = -(-index.cap // shards)
    assert placed.num_shards == shards and placed.cap == m * shards
    for name, pad in (("bucket_vecs", 0), ("bucket_ids", -1),
                      ("bucket_sqnorm", float("inf"))):
        parts = getattr(placed, name)
        assert all(p.is_contiguous() and p.shape[1] == m for p in parts)
        whole = torch.cat(parts, 1)
        assert torch.equal(whole[:, :index.cap], getattr(index, name))
        assert (whole[:, index.cap:] == pad).all()
    for name in ("centroids", "bucket_sizes", "scale", "offset"):
        assert torch.equal(getattr(placed, name), getattr(index, name))
    assert (placed.nlist, placed.dim, placed.num_vectors, placed.quantized,
            placed.device, placed.hot_map) == (
        index.nlist, index.dim, index.num_vectors, quantize,
        torch.device("cpu"), None)


def test_place_index_refuses_what_is_not_ported():
    """A mutable view, an HNSW graph and a hosts mesh, once refused, are
    placed; what is not an index still raises TypeError."""
    x, _ = _int_data(n=300)
    index = ivf.build(x, nlist=4, seed=0, device="cpu")
    mut = mutate.MutableIndex(index, capacity=16)
    view = dist.place_index(mut.view(), cpu_mesh(2))
    assert view.base.num_shards == 2 and view.delta.ids is mut.delta.ids
    graph = hnsw.build(x, m=4, ef_construction=8, passes=1, device="cpu")
    placed = dist.place_index(graph, cpu_mesh(2))
    assert placed.num_vectors == 300 and placed.num_shards == 2
    hosts = mesh_lib.SearchMesh(("hosts", "model"), (1, 2),
                                (torch.device("cpu"),) * 2)
    assert dist.place_index(index, hosts).mesh == hosts
    with pytest.raises(TypeError, match="place_index takes"):
        dist.place_index(x, cpu_mesh(2))


# -- sharded flat search -----------------------------------------------------

# (rows, k, chunk): rows no shard count divides, fewer rows a shard than
# k, and several query chunks.
FLAT_CASES = {"uneven": (1001, 10, 1024), "rows_below_k": (22, 10, 1024),
              "chunked_k1": (157, 1, 16)}


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", list(FLAT_CASES))
def test_sharded_flat_search_equals_reference(shards, case):
    n, k, chunk = FLAT_CASES[case]
    rng = np.random.default_rng(n)
    x = rng.integers(-8, 9, (n, 16)).astype(np.float32)
    x[n // 2:n // 2 + 5] = x[3]          # duplicate rows: ties
    x[-1] = x[3]
    q = rng.integers(-8, 9, (37, 16)).astype(np.float32)
    q[0] = x[3]
    d_r, i_r = ref_flat.search(jnp.asarray(q), jnp.asarray(x), k)
    d_p, i_p = collectives.make_sharded_flat_search(cpu_mesh(shards), k,
                                                    chunk=chunk)(q, x)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_r), atol=1e-5,
                               rtol=0)


# -- the sharded probe step --------------------------------------------------

def _carried_index(quantize, hot=None, seed=0):
    """The reference's index (odd cap, rounded centroids) and the port's
    copy, optionally split to a cold-tier store on the ``hot`` buckets."""
    x, q = _int_data(seed=seed)
    ref = ref_ivf.build(x, nlist=NLIST, seed=0, cap_round=1,
                        quantize=quantize)
    ref = dataclasses.replace(ref, centroids=jnp.round(ref.centroids))
    port = convert.ivf_index_from_numpy(convert.fields_as_numpy(ref), "cpu")
    if hot is not None:
        ref, port = ref_cold.split_index(ref, hot), cold.split_index(port, hot)
    return x, q, ref, port


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


HOT = np.asarray([0, 3, 7, 11, 12, 15], np.int32)
STORES = {"f32": (False, None), "sq8": (True, None), "split_f32": (False, HOT)}


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("store", list(STORES))
def test_sharded_probe_steps_equal_reference(store, shards):
    """Step by step, with some queries stopped by DARTH at step 2: the
    placed index's sharded step equals the reference's single-device
    probe_step in top-k, ndis, ninserts, probe_pos and active."""
    quantize, hot = STORES[store]
    _, q, ref, port = _carried_index(quantize, hot)
    mesh = cpu_mesh(shards)
    placed = dist.place_index(port, mesh)
    step = collectives.make_sharded_probe_step(mesh)
    init = collectives.make_sharded_ivf_init(mesh)
    nprobe = 6
    sr = ref_ivf.init_state(ref, jnp.asarray(q), k=K, nprobe=nprobe)
    sp = init(placed, torch.as_tensor(q), k=K, nprobe=nprobe)
    for t in range(nprobe + 1):
        if t == 2:
            stop = np.arange(q.shape[0]) % 3 == 0
            sr = ref_engines.set_active(sr, sr.active & ~jnp.asarray(stop))
            sp = engines.set_active(sp, sp.active & ~torch.as_tensor(stop))
        sr = ref_ivf.probe_step(ref, sr)
        sp = step(placed, sp)
        _compare(sr, sp, exact=not quantize)
    assert not sp.active.any()


def test_sharded_probe_step_needs_its_placed_index():
    _, q, _, port = _carried_index(False)
    mesh = cpu_mesh(2)
    step = collectives.make_sharded_probe_step(mesh)
    s = ivf.init_state(port, torch.as_tensor(q), k=K, nprobe=4)
    with pytest.raises(ValueError, match="place_index"):
        step(port, s)
    with pytest.raises(ValueError, match="place_index"):
        step(dist.place_index(port, cpu_mesh(3)), s)


@pytest.mark.parametrize("shards", SHARDS)
def test_search_sharded_equals_reference(shards):
    _, q, ref, port = _carried_index(False, seed=1)
    mesh = cpu_mesh(shards)
    d_r, i_r, s_r = ref_ivf.search(ref, jnp.asarray(q), k=K, nprobe=NLIST)
    d_p, i_p, s_p = ivf.search_sharded(dist.place_index(port, mesh),
                                       torch.as_tensor(q), k=K, nprobe=NLIST,
                                       mesh=mesh)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))
    np.testing.assert_array_equal(d_p.numpy(), np.asarray(d_r))
    for name in ("ndis", "ninserts", "probe_pos"):
        np.testing.assert_array_equal(getattr(s_p, name).numpy(),
                                      np.asarray(getattr(s_r, name)))


# -- DARTH over the sharded engine -------------------------------------------

def _clustered(seed):
    """Integer-valued clustered base, learn and query sets."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-12, 13, (24, 16))
    x = (centers[rng.integers(0, 24, 2000)]
         + rng.integers(-4, 5, (2000, 16))).astype(np.float32)
    learn = (centers[rng.integers(0, 24, 300)]
             + rng.integers(-6, 7, (300, 16))).astype(np.float32)
    q = (centers[rng.integers(0, 24, 48)]
         + rng.integers(-6, 7, (48, 16))).astype(np.float32)
    return x, learn, q


@pytest.fixture(scope="module")
def carried():
    """The reference's index and its Darth fitted on ivf_engine; the
    port's copy of the index and of the predictor and dists_Rt."""
    x, learn, q = _clustered(4)
    ref_index = ref_ivf.build(x, nlist=NLIST, seed=0, cap_round=1)
    ref_index = dataclasses.replace(ref_index,
                                    centroids=jnp.round(ref_index.centroids))
    ref_engine = ref_engines.ivf_engine(ref_index, k=K, nprobe=NLIST)
    _, gt = ref_training.ground_truth(jnp.asarray(learn), jnp.asarray(x), K)
    log = ref_training.generate_observations(ref_engine, jnp.asarray(learn),
                                             gt, batch=128)
    trained = ref_training.fit_predictor(
        log, cfg=ref_gbdt.GBDTConfig(num_trees=100, depth=6,
                                     min_child_weight=5.0))
    ref_darth = ref_api.Darth(make_engine=None, engine=ref_engine,
                              trained=trained)
    index = convert.ivf_index_from_numpy(convert.fields_as_numpy(ref_index),
                                         "cpu")
    port_trained = convert.trained_from_numpy(
        ref_gbdt.to_state_dict(trained.predictor.params), trained.dists_rt,
        "cpu")
    return ref_darth, index, port_trained, x, learn, q


def _sharded_darth(index, trained, shards):
    mesh = cpu_mesh(shards)
    placed = dist.place_index(index, mesh)
    return api.Darth(make_engine=None, trained=trained,
                     engine=engines.sharded_ivf_engine(placed, mesh, k=K,
                                                       nprobe=NLIST)), mesh


def _mixed(n):
    return np.resize(np.array([0.8, 0.9, 0.95, 0.99], np.float32), n)


@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("target", [0.8, 0.9, 0.95, "mixed"])
def test_darth_over_sharded_engine_equals_reference(carried, target, shards):
    ref_darth, index, trained, _, _, q = carried
    port_darth, _ = _sharded_darth(index, trained, shards)
    assert port_darth.engine.name == "ivf-sharded"
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
    for name in ("ndis", "ninserts", "probe_pos"):
        np.testing.assert_array_equal(getattr(st_p.inner, name).numpy(),
                                      np.asarray(getattr(st_r.inner, name)))
    if target != "mixed":
        assert st_p.early.any()  # the predictor really stopped queries


def test_budget_search_over_sharded_engine_equals_reference(carried):
    from repro.core import darth_search as ref_ds
    ref_darth, index, trained, _, _, q = carried
    port_darth, _ = _sharded_darth(index, trained, 3)
    budget = np.linspace(50, 900, q.shape[0]).astype(np.float32)
    b_r = ref_ds.budget_search(ref_darth.engine, jnp.asarray(q), budget)
    b_p = darth_search.budget_search(port_darth.engine, torch.as_tensor(q),
                                     budget)
    for name in ("topk_i", "ndis", "ninserts", "probe_pos"):
        np.testing.assert_array_equal(getattr(b_p, name).numpy(),
                                      np.asarray(getattr(b_r, name)))


@pytest.mark.parametrize("shards", [2, 3])
def test_ground_truth_and_fit_through_a_mesh(carried, shards):
    """ground_truth(mesh=) equals the unsharded scan, and Darth.fit(mesh=)
    over the sharded engine logs the TrainLog of the unsharded fit over
    ivf_engine, bit for bit, and fits the same trees."""
    _, index, _, x, learn, _ = carried
    mesh = cpu_mesh(shards)
    q_t, x_t = torch.as_tensor(learn), torch.as_tensor(x)
    for a, b in zip(training.ground_truth(q_t, x_t, K),
                    training.ground_truth(q_t, x_t, K, mesh=mesh)):
        assert torch.equal(a, b)
    plain = api.Darth(make_engine=None,
                      engine=engines.ivf_engine(index, k=K, nprobe=NLIST))
    sharded, _ = _sharded_darth(index, None, shards)
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


# -- the server and the launcher ---------------------------------------------

def _serve(darth, q, rts, **kw):
    return DarthServer(darth.engine, darth.trained.predictor,
                       darth.interval_for_target, num_slots=16,
                       steps_per_sync=2, **kw).serve(q, rts)


@pytest.mark.parametrize("shards", [1, 4])
def test_server_over_a_mesh_equals_single_device(carried, shards):
    _, index, trained, _, _, q = carried
    rts = _mixed(q.shape[0])
    single = api.Darth(make_engine=None, trained=trained,
                       engine=engines.ivf_engine(index, k=K, nprobe=NLIST))
    sharded, mesh = _sharded_darth(index, trained, shards)
    res_1, st_1 = _serve(single, q, rts)
    res_s, st_s = _serve(sharded, q, rts, mesh=mesh)
    assert st_s.completed == q.shape[0] and st_s.refills > 0
    for a, b in zip(res_1, res_s):
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
    for name in ("engine_steps", "slot_steps", "ndis_harvested", "refills"):
        assert getattr(st_s, name) == getattr(st_1, name), name


def test_server_refuses_a_hosts_mesh_or_an_unplaced_index(carried):
    """A hosts mesh, once refused, serves an index placed on it (equal
    per query to the single-controller server); an index not placed on
    the server's mesh still raises."""
    _, index, trained, _, _, q = carried
    sharded, mesh = _sharded_darth(index, trained, 2)
    args = (sharded.engine, trained.predictor, sharded.interval_for_target)
    hosts = mesh_lib.SearchMesh(("hosts", "model"), (2, 1),
                                (torch.device("cpu"),) * 2)
    with pytest.raises(ValueError, match="not placed"):
        DarthServer(*args, mesh=hosts)
    on_hosts = api.Darth(make_engine=None, trained=trained,
                         engine=engines.sharded_ivf_engine(
                             dist.place_index(index, hosts), hosts, k=K,
                             nprobe=NLIST))
    rts = _mixed(q.shape[0])
    res_h, _ = _serve(on_hosts, q, rts, mesh=hosts, hosts=2)
    res_1, _ = _serve(sharded, q, rts, mesh=mesh)
    for a, b in zip(res_1, res_h):
        np.testing.assert_array_equal(b[1], a[1])
    with pytest.raises(ValueError, match="not placed"):
        DarthServer(*args, mesh=cpu_mesh(3))
    single = engines.ivf_engine(index, k=K, nprobe=NLIST)
    with pytest.raises(ValueError, match="not placed"):
        DarthServer(single, trained.predictor, sharded.interval_for_target,
                    mesh=mesh)


LAUNCH = ["--device", "cpu", "--n", "2000", "--dim", "16", "--learn", "200",
          "--queries", "64", "--nlist", "16", "--slots", "16"]


def _launch(monkeypatch, capsys, extra):
    import sys

    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", ["serve"] + LAUNCH + extra)
    serve.main()
    return capsys.readouterr().out.splitlines()


def test_launcher_shards_end_to_end(monkeypatch, capsys):
    """--shards 2 on the CPU serves every query with the unsharded run's
    recall per target, through the sharded engine and ground truth."""
    plain = _launch(monkeypatch, capsys, [])
    sharded = _launch(monkeypatch, capsys, ["--shards", "2"])
    assert any("mesh(2,)" in line for line in sharded)
    assert any("sharded ground truth" in line for line in sharded)

    def recalls(lines):
        return [line.split(": ", 1)[1] for line in lines
                if "mean recall" in line]
    assert len(recalls(sharded)) == 3
    assert recalls(sharded) == recalls(plain)


@pytest.mark.parametrize("extra,piece", [
    (["--engine", "hnsw"], "slice 3.3"), (["--hosts", "2"], "slice 3.4"),
    (["--mutations", "0.2,0.1", "--online-compact"], "slice 3.4")])
def test_launcher_shards_refuses_what_is_not_ported(monkeypatch, capsys,
                                                    extra, piece):
    """--shards 2 with --engine hnsw, --hosts 2 or --mutations (online
    compaction), each once refused and ported by ROADMAP's ``piece``,
    gives the unsharded run's recall per target in every phase, on the
    mesh it prints (the hosts axis at --hosts 2)."""
    plain = _launch(monkeypatch, capsys, extra)
    sharded = _launch(monkeypatch, capsys, ["--shards", "2"] + extra)
    mesh = "mesh(2, 2)" if "--hosts" in extra else "mesh(2,)"
    assert any(mesh in line for line in sharded), piece

    def recalls(lines):
        return [line.split(": ", 1)[1] for line in lines
                if "mean recall" in line]
    assert len(recalls(sharded)) >= 3, piece
    assert recalls(sharded) == recalls(plain), piece
