"""The registered entry points: every code path the gate runs.

Each build function makes a small instance of a REAL code path from random data
(the passes need the program's behaviour, not recall): the fused
kernels' calls, the sharded flat search, IVF and HNSW steps, the
DarthServer chunks on a 2 x 2 serve mesh, a cold tier staging into a
placed store, and the host-sync loop. Every mesh is made on the one
device the gate runs on (its shards share it), so the same manifest runs
on the CPU and on one card. A mirror of ``repro.analysis.manifest``
where the port has a counterpart; ``serve/cold_sharded`` is new.
"""
from __future__ import annotations

import warnings
from typing import Dict, List

import numpy as np
import torch

from repro_torch.analysis import audits
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import SIZES, Built, register
from repro_torch.core import engines as engines_lib
from repro_torch.core.intervals import IntervalParams
from repro_torch.core.padding import pad_dists, pad_ids
from repro_torch.core.predictor import RecallPredictor
from repro_torch.dist import collectives as dist_collectives
from repro_torch.dist import sharding as sharding_lib
from repro_torch.gbdt.model import GBDTParams
from repro_torch.index import hnsw as hnsw_lib
from repro_torch.index import ivf as ivf_lib
from repro_torch.index import residency as residency_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs import trace as obs_trace

K = 10          # top-k of every step
NPROBE = 8      # IVF probes
BATCH = 8       # query / slot batch
SHARDS = (2, 3)  # the sharded steps' shard counts (3 pads every cap)
#: Fixed hashed-visited width for the beam-step entry: N-independent, a
#: power of two (the beam step's hashed filter needs S | W; 3 does not
#: divide it, so S = 3 runs the exact bitmap).
VISITED_W = 512


def _make_ivf(n: int, d: int, device, *, nlist: int = 32, seed: int = 0,
              sq8: bool = False) -> ivf_lib.IVFIndex:
    """Random vectors in random buckets, through the real bucket layout
    (``pack_buckets``); sq8 runs the real residency quantizer."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    assign = rng.integers(0, nlist, size=n)
    bv, bi, bsq, sizes = ivf_lib.pack_buckets(
        x, x, np.arange(n, dtype=np.int32), assign, nlist)

    def t(v):
        return torch.as_tensor(v, device=device)
    index = ivf_lib.IVFIndex(
        centroids=t(rng.normal(size=(nlist, d)).astype(np.float32)),
        bucket_vecs=t(bv), bucket_ids=t(bi), bucket_sqnorm=t(bsq),
        bucket_sizes=t(sizes), scale=t(np.ones((d,), np.float32)),
        offset=t(np.zeros((d,), np.float32)))
    return residency_lib.quantize_ivf(index) if sq8 else index


def _make_hnsw(n: int, d: int, device, *, m: int = 8, seed: int = 0,
               sq8: bool = False) -> hnsw_lib.HNSWIndex:
    """Random vectors and a random adjacency (graph quality does not
    matter to the passes); sq8 runs the real residency quantizer."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)

    def t(v):
        return torch.as_tensor(v, device=device)
    index = hnsw_lib.HNSWIndex(
        vectors=t(x), sqnorm=t((x ** 2).sum(axis=1)),
        neighbors=t(rng.integers(0, n, size=(n, m)).astype(np.int32)),
        entry=t(np.asarray(0, np.int32)),
        route_ids=t(np.arange(64, dtype=np.int32)))
    return residency_lib.quantize_hnsw(index) if sq8 else index


def _queries(d: int, device, *, b: int = BATCH, seed: int = 1
             ) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32),
                           device=device)


def _interval_for_target(r_t) -> IntervalParams:
    """Fixed intervals: the passes need interval plumbing, not tuning."""
    r_t = np.atleast_1d(np.asarray(r_t, np.float32))
    return IntervalParams(ipi=np.full(r_t.shape, 24.0, np.float32),
                          mpi=np.full(r_t.shape, 4.0, np.float32))


def _predictor(device) -> RecallPredictor:
    """A 3-tree ensemble of depth 2 whose nodes send every row left to a
    leaf of 0: the whole inference program, r_pred 0, so the serves drain
    by engine exhaustion and exercise refills."""
    def t(v):
        return torch.as_tensor(v, device=device)
    return RecallPredictor(GBDTParams(
        feat=t(np.full((3, 3), -1, np.int32)),  # -1: a node with no split
        thresh=t(np.zeros((3, 3), np.float32)),
        leaf=t(np.zeros((3, 4), np.float32)),
        base=t(np.asarray(0.0, np.float32))))


# ---------------------------------------------------------------------------
# Fused kernels
# ---------------------------------------------------------------------------

@register("kernels/l2_topk", resident_sq8=True)
def l2_topk(size: str, device) -> Built:
    """The fused flat top-k in the SQ8 asymmetric form: int8 codes,
    dequantized sqnorms and an explicit per-query bias."""
    n, d = SIZES[size]
    dev = audits.one_device(device)
    rng = np.random.default_rng(2)
    codes = torch.as_tensor(rng.integers(-127, 128, size=(n, d)).astype(
        np.int8), device=dev)
    xsq = (codes.float() ** 2).sum(1)
    q = _queries(d, dev)
    bias = (q * q).sum(1, keepdim=True)
    return Built(steps={"l2_topk": lambda: kernel_ops.l2_topk(
        q, codes, k=K, x_sqnorm=xsq, bias=bias)}, payloads={"codes": codes})


@register("kernels/bucket_probe", resident_sq8=True)
def bucket_probe(size: str, device) -> Built:
    """The fused IVF probe over int8 bucket codes (the SQ8-resident
    store's rows), read by slot from the whole store."""
    n, d = SIZES[size]
    dev = audits.one_device(device)
    index = _make_ivf(n, d, dev, sq8=True)
    q = _queries(d, dev)
    slot = torch.arange(BATCH, device=dev, dtype=torch.int32)
    act = torch.ones((BATCH,), dtype=torch.bool, device=dev)
    bias = (q * q).sum(1, keepdim=True)
    run_d, run_i = pad_dists((BATCH, K), dev), pad_ids((BATCH, K), dev)
    return Built(steps={"bucket_probe": lambda: kernel_ops.bucket_probe_slots(
        q * index.scale, index.bucket_vecs, index.bucket_sqnorm,
        index.bucket_ids, slot, act, bias, run_d[:, -1:].contiguous(),
        run_d, run_i)}, payloads={"store": index})


# ---------------------------------------------------------------------------
# Sharded search steps
# ---------------------------------------------------------------------------

@register("dist/flat_search")
def flat_search(size: str, device) -> Built:
    """The sharded exact flat k-NN over a row-sharded database."""
    n, d = SIZES[size]
    dev = audits.one_device(device)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                        device=dev)
    q = _queries(d, dev)
    steps = {}
    for s in SHARDS:
        fn = dist_collectives.make_sharded_flat_search(
            mesh_lib.make_search_mesh(s, dev), K)
        steps[f"S{s}:search"] = lambda fn=fn: fn(q, x)
    return Built(steps=steps)


@register("dist/ivf_probe_step", resident_sq8=True)
def ivf_probe_step(size: str, device) -> Built:
    """The sharded IVF init and probe step over a cap-sharded SQ8 store
    (the default serving residency); the placements of it, of the f32
    store and of a mutable view."""
    from repro_torch import mutate
    n, d = SIZES[size]
    dev = audits.one_device(device)
    index = _make_ivf(n, d, dev, sq8=True)
    f32 = _make_ivf(n, d, dev)
    view = mutate.MutableIndex(f32, capacity=64).view()
    q = _queries(d, dev)
    out = Built(payloads={"index": index})
    for s in SHARDS:
        mesh = mesh_lib.make_search_mesh(s, dev)
        placed = sharding_lib.place_index(index, mesh)
        eng = engines_lib.sharded_ivf_engine(placed, mesh, k=K,
                                             nprobe=NPROBE)
        st = eng.init(placed, q)
        out.steps[f"S{s}:init"] = lambda e=eng, p=placed: e.init(p, q)
        out.steps[f"S{s}:step"] = lambda e=eng, p=placed, st=st: e.step(
            p, st)
        out.payloads[f"placed S{s}"] = placed
        out.placements += [
            (f"sq8 S{s}", index, placed),
            (f"f32 S{s}", f32, sharding_lib.place_index(f32, mesh)),
            (f"mutable view S{s}", view,
             sharding_lib.place_index(view, mesh))]
    return out


@register("dist/hnsw_beam_step", resident_sq8=True)
def hnsw_beam_step(size: str, device) -> Built:
    """The sharded HNSW init and beam step over a row-sharded SQ8 graph,
    with the fixed-width hashed visited filter where S divides it."""
    n, d = SIZES[size]
    dev = audits.one_device(device)
    index = _make_hnsw(n, d, dev, sq8=True)
    q = _queries(d, dev)
    out = Built(payloads={"index": index})
    for s in SHARDS:
        mesh = mesh_lib.make_search_mesh(s, dev)
        placed = sharding_lib.place_index(index, mesh)
        width = VISITED_W if VISITED_W % s == 0 else 0
        init = dist_collectives.make_sharded_hnsw_init(mesh)
        step = dist_collectives.make_sharded_beam_step(mesh)
        st = init(placed, q, ef=16, visited_width=width)
        out.steps[f"S{s}:init"] = lambda i=init, p=placed, w=width: i(
            p, q, ef=16, visited_width=w)
        out.steps[f"S{s}:step"] = lambda f=step, p=placed, st=st: f(
            p, st, k=K)
        out.payloads[f"placed S{s}"] = placed
        out.placements.append((f"sq8 S{s}", index, placed))
    return out


# ---------------------------------------------------------------------------
# DarthServer chunks
# ---------------------------------------------------------------------------

def _serve_chunks(kind: str, size: str, device, *, traced: bool = False
                  ) -> Built:
    """The server's init and run chunks on the 2 x 2 serve mesh (every
    device the same), each host group stepping its slots against its
    view of the placed index."""
    from repro_torch.serve import DarthServer
    n, d = SIZES[size]
    dev = audits.one_device(device)
    mesh = mesh_lib.make_serve_mesh(2, 2, dev)
    if kind == "ivf":
        index = _make_ivf(n, d, dev)
        placed = sharding_lib.place_index(index, mesh)
        eng = engines_lib.sharded_ivf_engine(placed, mesh, k=K,
                                             nprobe=NPROBE)
    else:
        index = _make_hnsw(n, d, dev)
        placed = sharding_lib.place_index(index, mesh)
        eng = engines_lib.sharded_hnsw_engine(placed, mesh, k=K, ef=16,
                                              max_steps=32)
    server = DarthServer(
        eng, _predictor(dev), _interval_for_target, num_slots=BATCH,
        steps_per_sync=2, mesh=mesh, hosts=2,
        tracer=obs_trace.Tracer(traj_cap=16) if traced else None)
    rt = np.full((BATCH,), 0.9, np.float32)
    p = _interval_for_target(rt)
    q_dev = server._put(_queries(d, "cpu").numpy())
    rt_dev, ipi_dev, mpi_dev = (server._put(a) for a in (rt, p.ipi, p.mpi))
    pool = server._init_pool(q_dev, ipi_dev, mpi_dev)

    def run_chunk():
        return [server._run_chunk(ix, st, traj, *inp)
                for ix, (st, traj), inp in zip(
                    server._group_index, pool, zip(rt_dev, ipi_dev,
                                                   mpi_dev))]
    return Built(
        steps={"init_chunk": lambda: server._init_pool(q_dev, ipi_dev,
                                                       mpi_dev),
               "run_chunk": run_chunk},
        placements=[("serve mesh", index, placed)])


@register("serve/chunks_ivf")
def serve_chunks_ivf(size: str, device) -> Built:
    """The server's chunks around the sharded IVF engine."""
    return _serve_chunks("ivf", size, device)


@register("serve/chunks_hnsw")
def serve_chunks_hnsw(size: str, device) -> Built:
    """The server's chunks around the sharded HNSW engine."""
    return _serve_chunks("hnsw", size, device)


@register("serve/chunks_traced")
def serve_chunks_traced(size: str, device) -> Built:
    """The TRACED chunks (the predicted-recall trajectory ring rides the
    chunk state): the ring must not move index rows either."""
    return _serve_chunks("ivf", size, device, traced=True)


@register("serve/cold_sharded")
def cold_sharded(size: str, device) -> Built:
    """A cold tier (half of 32 buckets resident, plan + prefetch) served
    on the 2 x 2 serve mesh: the staged store stays split (no copy per
    shard or host group), and a probe step over it moves [B, k]."""
    from repro_torch.serve import DarthServer, cold
    n, d = SIZES[size]
    dev = audits.one_device(device)
    index = _make_ivf(n, d, dev)
    mesh = mesh_lib.make_serve_mesh(2, 2, dev)
    tier = cold.make_cold_tier(index, hot_slots=16, lookahead=4,
                               staging=4)
    q = _queries(d, "cpu", b=3 * BATCH, seed=5).numpy()
    store = tier.plan(q, nprobe=NPROBE, first=2)
    placed = sharding_lib.place_index(store, mesh)
    eng = engines_lib.sharded_ivf_engine(placed, mesh, k=K, nprobe=NPROBE)
    server = DarthServer(eng, _predictor(dev), _interval_for_target,
                         num_slots=BATCH, steps_per_sync=2, mesh=mesh,
                         hosts=2)
    server.serve(q, np.full((q.shape[0],), 0.9, np.float32),
                 on_boundary=tier.on_boundary)
    out = Built(placements=[("cold store", store, tier.store)])
    if not (isinstance(tier.store, sharding_lib.PlacedIVFIndex)
            and tier.prefetches):
        out.findings.append(Finding(
            "cold-sharded", "serve/cold_sharded",
            f"the tier staged {tier.prefetches} bucket(s) into a "
            f"{type(tier.store).__name__}: the entry checks nothing"))
    staged = tier.store
    st = eng.init(staged, torch.as_tensor(q[:BATCH], device=dev))
    out.steps["probe_step"] = lambda: eng.step(staged, st)
    return out


# ---------------------------------------------------------------------------
# host-sync: the serving loop (executable)
# ---------------------------------------------------------------------------

_ACTIVE = "serve/engine.py:_serve > serve/engine.py:_fetch"
_HARVEST = "serve/engine.py:state_slices > serve/engine.py:_fetch"
_INPUTS = "serve/engine.py:<genexpr> > serve/engine.py:_put"
_REFILL = "serve/engine.py:_serve > serve/engine.py:_put"
_GROUPS = "dist/sharding.py:constrain_slots > dist/sharding.py:cut"

#: The most host syncs any one chunk of the sync loop made at each call
#: site (caller > site), measured on this tree with
#: ``sync_loop_counts("cpu")``; a chunk above its site's limit, or a sync
#: at a site not listed, is a finding. The card's counts equal these
#: (``chip_smoke.py`` phase 11). Per chunk: the ``active`` fetch (one
#: per distinct device), and at a boundary where a slot finished the
#: harvest fetches (top-k ids and distances, ndis; with a tracer also
#: r_pred, the early mask, npred and the trajectory ring) and the
#: refill's host-to-device puts (the new queries, the slot mask and the
#: occupancy; the targets and intervals; at hosts 2 one put per host
#: group of each, through ``constrain_slots``).
SYNC_LIMITS: Dict[str, Dict[str, int]] = {
    "hosts1_shards2": {_ACTIVE: 1, _HARVEST: 3, _INPUTS: 3, _REFILL: 3},
    "hosts1_shards2_traced": {_ACTIVE: 1, _HARVEST: 7, _INPUTS: 3,
                              _REFILL: 3},
    "hosts2_shards2": {_ACTIVE: 1, _HARVEST: 3, _GROUPS: 12},
    "hosts2_shards2_traced": {_ACTIVE: 1, _HARVEST: 7, _GROUPS: 12},
}


def _sync_configs():
    for hosts in (1, 2):
        for traced in (False, True):
            yield f"hosts{hosts}_shards2{'_traced' if traced else ''}", \
                hosts, traced


def sync_loop_recorders(device, *, sync_debug: bool = False
                        ) -> Dict[str, audits.Recorder]:
    """The reference's retrace-loop workload on the port: a serve of
    mixed targets with 3x more queries than slots (refills) and a
    contents-only engine swap from ``on_boundary``, then a second serve
    with other target values, through the sharded IVF engine on a
    (hosts, 2) serve mesh, hosts 1 and 2, untraced and traced. Returns
    each configuration's recorder (counting only inside the serves, one
    bucket per chunk), with ``nvcc_after_first_chunk`` set to the
    kernel builds that started after the first chunk."""
    from repro_torch.kernels import _build
    from repro_torch.serve import DarthServer
    n, d = SIZES["small"]
    dev = audits.one_device(device)
    rng = np.random.default_rng(5)
    q = rng.normal(size=(3 * BATCH, d)).astype(np.float32)
    rt = np.tile(np.asarray([0.8, 0.9, 0.95], np.float32),
                 BATCH)[:3 * BATCH]
    out = {}
    for name, hosts, traced in _sync_configs():
        rec = audits.Recorder(dev, sync_debug=sync_debug)
        rec.counting = False
        rec.nvcc_after_first_chunk = 0
        with rec:
            index = _make_ivf(n, d, dev)
            mesh = mesh_lib.make_serve_mesh(hosts, 2, dev)
            placed = sharding_lib.place_index(index, mesh)

            def engine():
                return engines_lib.sharded_ivf_engine(placed, mesh, k=K,
                                                      nprobe=NPROBE)
            server = DarthServer(
                engine(), _predictor(dev), _interval_for_target,
                num_slots=BATCH, steps_per_sync=2, mesh=mesh, hosts=hosts,
                tracer=obs_trace.Tracer(traj_cap=16) if traced else None)
            run = server._run_chunk
            runs = [0]

            def run_chunk(ix, *a):
                if ix is server._group_index[0]:
                    rec.chunk += 1
                    runs[0] += 1
                return run(ix, *a)
            server._run_chunk = run_chunk
            done = []

            def mutate_once(srv):
                if not done:
                    done.append(True)
                    srv.set_engine(engine(), contents_only=True)
            nvcc = _build._nvcc

            def counted_nvcc():
                if runs[0] > 1:
                    rec.nvcc_after_first_chunk += 1
                return nvcc()
            _build._nvcc = counted_nvcc
            if sync_debug:
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as outside:
                    warnings.simplefilter("always")
                    rec.counting = True
                    rec.chunk += 1
                    server.serve(q, rt, on_boundary=mutate_once)
                    rec.chunk += 1
                    server.serve(q[:BATCH],
                                 np.full((BATCH,), 0.85, np.float32))
                    rec.counting = False
                rec.debug_unattributed = sum(
                    audits.SYNC_WARNING in str(w.message) for w in outside)
            finally:
                rec.counting = False
                _build._nvcc = nvcc
                if sync_debug:
                    torch.cuda.set_sync_debug_mode(mode)
        out[name] = rec
    return out


def sync_loop_counts(device, *, sync_debug: bool = False) -> Dict[str, dict]:
    """Per configuration: the most syncs one chunk made at each site
    (``sites``), the loop's total syncs and chunks, and with
    ``sync_debug`` the syncs the sync debug mode reported."""
    out = {}
    for name, rec in sync_loop_recorders(device,
                                         sync_debug=sync_debug).items():
        row = {"sites": audits.sync_counts(rec), "total": len(rec.syncs()),
               "chunks": rec.chunk,
               "nvcc_after_first_chunk": rec.nvcc_after_first_chunk}
        if sync_debug:
            row["debug_sites"] = audits.sync_counts(rec, debug=True)
            row["debug_total"] = (sum(n for _, _, n, _ in rec.debug_syncs)
                                  + rec.debug_unattributed)
        out[name] = row
    return out


@register("serve/sync_loop", check=True)
def sync_loop(device) -> List[Finding]:
    """Host syncs per chunk by call site against ``SYNC_LIMITS``, and no
    kernel build after the first chunk."""
    out: List[Finding] = []
    for name, rec in sync_loop_recorders(device).items():
        entry = f"serve/sync_loop:{name}"
        out += audits.host_syncs(entry, rec, SYNC_LIMITS.get(name, {}))
        if rec.nvcc_after_first_chunk:
            out.append(Finding(
                "host-sync", entry,
                f"{rec.nvcc_after_first_chunk} kernel build(s) started nvcc "
                f"after the first chunk"))
    return out
