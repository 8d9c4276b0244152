"""One run of one cell: set-up, the measured window, the check, the result.

Set-up (``setup_s``, from process start to the first timed query): the
collection and the learn set are made on the device from the
configuration's data seed, the cell's queries from the run's seed; the
index is built and ``Darth.fit`` runs on the learn set
(what a user pays to stand a deployment up); the server is made and one
warm-up serve call runs on the cell's own pool size, so that every kernel
is built and loaded and every shape of the window has run once.

The window drives ``repro_torch.serve.DarthServer.serve``, the entry users
serve through, as the traffic's kind says (``backlog`` or ``open``). After
it closes, the peak memory is read, the program's state is freed and the
plain reference checks what the window served (``check``).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import pathlib
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from darthbench import (check, data, harvest, manifest, profiling, roofline,
                        traffic)

TRACE_START = 1.0 / 3.0    # the traced stretch opens a third into the window
TRACE_SECONDS = 3.0        # and closes at the first boundary past this
WARM_STREAM, STREAM = 3, 1


def host_probe() -> float:
    """Seconds of a fixed pure-Python loop: how fast the host runs the
    interpreter now (a host-bound window moves with it)."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc += i * i
    return time.perf_counter() - t0


def log(msg: str) -> None:
    print(f"[darthbench] {msg}", file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Call:
    start: float             # seconds into the window
    end: float
    n: int                   # queries offered
    stats: Any               # repro_torch.serve.ServeStats
    results: List[Any]       # what serve returned, per offered query
    rows: np.ndarray         # the offered queries' rows in the stream
    ndis: Optional[np.ndarray] = None   # per offered query, at harvest


@dataclasses.dataclass
class Run:
    """What a run recorded; the metric readers (``metrics/*.py``) read it."""
    cell: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    traced: bool
    num_slots: int
    setup_s: float = math.nan
    build_s: float = math.nan
    fit_s: float = math.nan
    fit_split: Dict[str, float] = dataclasses.field(default_factory=dict)
    calls: List[Call] = dataclasses.field(default_factory=list)
    window_s: float = math.nan       # first call's start to last call's end
    attempted: int = 0
    completed: int = 0
    failed: int = 0
    latencies_ms: Optional[np.ndarray] = None   # open loop, per request
    lag_s: List[float] = dataclasses.field(default_factory=list)
    summary: Optional[profiling.Summary] = None
    least_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    peaks: Optional[Dict[str, float]] = None
    collection_rows: int = 0         # ndis of a query that searched all
    tally: Optional[harvest.Tally] = None

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


@dataclasses.dataclass
class System:
    coll: data.Collection
    built: Dict[str, Any]
    darth: Any
    server: Any
    stream: traffic.Stream


def prepare(run: Run, device) -> System:
    """The collection, the index and the DARTH fit (no server yet)."""
    from repro_torch.core import api

    cfg = run.config
    coll = data.make_collection(cfg["data"], device)
    sync(device)
    t0 = time.time()
    kind = manifest.index_kind(cfg["index"]["kind"])
    # The build and the fit draw from the data set's seed, as the data do
    # (``data``): every run seed builds and fits the same deployment.
    data_seed = int(cfg["data"]["seed"])
    built = kind.build(cfg["index"], coll.base, k=int(cfg["k"]),
                       seed=data_seed, device=device)
    sync(device)
    run.build_s = time.time() - t0
    log(f"index built in {run.build_s:.3f} s: {built['info']}")
    make = built["make_engine"]
    darth = api.Darth(make_engine=make, engine=make(**built["engine_kw"]))
    t0 = time.time()
    darth.fit(coll.learn, coll.base, targets=tuple(cfg["darth"]["targets"]),
              seed=data_seed)
    sync(device)
    run.fit_s = time.time() - t0
    run.fit_split = dict(darth.fit_seconds)
    log(f"fit in {run.fit_s:.3f} s: split {run.fit_split}, "
        f"mse {darth.trained.metrics['mse']:.6f}")
    return System(coll=coll, built=built, darth=darth, server=None,
                  stream=None)


def serving(run: Run, system: System, device) -> System:
    """The server on ``run.num_slots`` slots, the cell's query stream, and
    one warm-up serve call on the same pool."""
    from repro_torch.serve import DarthServer

    mix, srv, darth = run.traffic, run.config["server"], system.darth
    server = DarthServer(darth.engine, darth.trained.predictor,
                         darth.interval_for_target,
                         num_slots=run.num_slots,
                         steps_per_sync=int(srv["steps_per_sync"]))
    if run.kind == "backlog":
        queue = int(mix["queue_per_slot"]) * run.num_slots
        stream = traffic.make_stream(mix, system.coll, run.seed,
                                     queue * int(mix["pool_queues"]), STREAM)
    elif run.kind == "open":
        due = traffic.arrivals(mix, run.seed, run.seconds)
        stream = traffic.make_stream(mix, system.coll, run.seed,
                                     traffic.arrival_bound(mix, run.seconds),
                                     STREAM)
        stream = traffic.Stream(queries=stream.queries[:due.size],
                                host=stream.host[:due.size],
                                targets=stream.targets[:due.size],
                                kinds=stream.kinds[:due.size], due=due)
    else:
        raise ValueError(f"traffic kind {run.kind!r}: backlog or open")
    warm = traffic.make_stream(mix, system.coll, run.seed,
                               run.num_slots + run.num_slots // 4 + 1,
                               WARM_STREAM)
    server.serve(warm.host, warm.targets,
                 max_engine_steps=int(srv["max_engine_steps"]))
    sync(device)
    return dataclasses.replace(system, server=server, stream=stream)


def _settle() -> None:
    """Collect once and move every live object out of the collector's
    reach: what the harness keeps of each call (the results, for the check
    after the window) then costs the window no collection."""
    gc.collect()
    gc.freeze()


def _ndis(run: Run, n: int) -> Optional[np.ndarray]:
    return None if run.tally is None else run.tally.take(n)


def _hook(stretch: Optional[profiling.Stretch], t_start: float
          ) -> Optional[Callable]:
    if stretch is None:
        return None
    return lambda _server: stretch.poll(time.perf_counter() - t_start)


def backlog_window(run: Run, system: System,
                   stretch: Optional[profiling.Stretch]) -> None:
    """Serve calls back to back, each on the next queue of the pool, until
    ``seconds`` have passed; the last call runs to its end."""
    mix, st = run.traffic, system.stream
    queue = int(mix["queue_per_slot"]) * run.num_slots
    steps = int(run.config["server"]["max_engine_steps"])
    npool = int(mix["pool_queues"])
    t_start = time.perf_counter()
    hook = _hook(stretch, t_start)
    i = 0
    while True:
        lo = (i % npool) * queue
        s0 = time.perf_counter() - t_start
        results, stats = system.server.serve(
            st.host[lo:lo + queue], st.targets[lo:lo + queue],
            max_engine_steps=steps, on_boundary=hook)
        s1 = time.perf_counter() - t_start
        run.calls.append(Call(s0, s1, queue, stats, results,
                              np.arange(lo, lo + queue), _ndis(run, queue)))
        gc.freeze()
        if stretch is not None:
            stretch.poll(s1)
        i += 1
        if s1 >= run.seconds:
            break
    run.window_s = run.calls[-1].end - run.calls[0].start


def open_window(run: Run, system: System,
                stretch: Optional[profiling.Stretch]) -> None:
    """The drain loop: whenever the previous call returns, serve whatever
    has arrived; sleep to the next due time when nothing has. Arrivals
    stop at ``seconds``; the loop then drains what has arrived. A
    request's latency runs from its due time to the return of its call."""
    st = system.stream
    due = st.due
    steps = int(run.config["server"]["max_engine_steps"])
    lat = np.full(due.size, np.nan)
    t_start = time.perf_counter()
    hook = _hook(stretch, t_start)
    i = 0
    while i < due.size:
        now = time.perf_counter() - t_start
        j = int(np.searchsorted(due, now, side="right"))
        if j == i:
            time.sleep(max(0.0, due[i] - now))
            run.lag_s.append(time.perf_counter() - t_start - due[i])
            continue
        results, stats = system.server.serve(
            st.host[i:j], st.targets[i:j], max_engine_steps=steps,
            on_boundary=hook)
        s1 = time.perf_counter() - t_start
        lat[i:j] = (s1 - due[i:j]) * 1e3
        run.calls.append(Call(now, s1, j - i, stats, results,
                              np.arange(i, j), _ndis(run, j - i)))
        gc.freeze()
        if stretch is not None:
            stretch.poll(s1)
        i = j
    run.latencies_ms = lat
    run.window_s = run.calls[-1].end - run.calls[0].start


def window(run: Run, system: System,
           stretch: Optional[profiling.Stretch] = None) -> None:
    """The cell's measured window, as its traffic kind says; a traced
    stretch the window ended inside is closed with it."""
    _settle()
    try:
        if run.kind == "backlog":
            backlog_window(run, system, stretch)
        else:
            open_window(run, system, stretch)
    finally:
        gc.unfreeze()
    if stretch is not None:
        stretch.close()
    run.attempted = sum(c.n for c in run.calls)
    run.completed = sum(c.stats.completed for c in run.calls)


def served(run: Run, system: System) -> check.Served:
    rows = np.concatenate([c.rows for c in run.calls])
    k = int(run.config["k"])
    ids = np.full((rows.size, k), -1, np.int64)
    dists = np.full((rows.size, k), np.inf, np.float32)
    returned = np.zeros(rows.size, bool)
    at = 0
    for c in run.calls:
        for j, r in enumerate(c.results):
            if r is not None:
                dists[at + j], ids[at + j] = r[0], r[1]
                returned[at + j] = True
        at += c.n
    st = system.stream
    return check.Served(
        queries=st.queries[torch.as_tensor(rows, device=st.queries.device)],
        targets=st.targets[rows], returned=returned, ids=ids, dists=dists)


def ndis_by_target(run: Run, targets: np.ndarray) -> Dict[float, Any]:
    """Per declared target of the window's queries (``targets``, row by
    row as ``served`` lists them): how many were harvested, their mean
    distance count, and the share that searched the whole collection."""
    if any(c.ndis is None for c in run.calls):
        return {}
    nd = np.concatenate([c.ndis for c in run.calls])
    out: Dict[float, Any] = {}
    for t in np.unique(targets):
        got = nd[(targets == t) & (nd >= 0)]
        if got.size:
            out[float(t)] = {
                "harvested": int(got.size),
                "ndis_mean": float(got.mean()),
                "full_share": float((got >= run.collection_rows).mean())}
    return out


def least_times(run: Run, rec: Optional[profiling.Recorder]) -> None:
    """The summed least time of the calls the traced stretch recorded."""
    if rec is None or run.peaks is None:
        return
    if rec.probe:
        vecs, store_ids, k = rec.probe_store
        live = (store_ids >= 0).sum(1)
        slot = torch.stack([s for s, _ in rec.probe])
        active = torch.stack([a for _, a in rec.probe])
        counts = roofline.probe_counts(
            slot, active, live, cap=vecs.shape[1], dim=vecs.shape[2],
            code_bytes=vecs.element_size(), k=k)
        run.least_s["bucket_probe"] = roofline.probe_least_s(counts,
                                                             run.peaks)
    if rec.gbdt:
        run.least_s["gbdt_predict"] = sum(
            roofline.gbdt_least_s(roofline.gbdt_counts(*shape), run.peaks)
            for shape in rec.gbdt)


def execute(root: pathlib.Path, cell_name: str, seed: int, seconds: float,
            traced: bool, device, t0: float) -> Dict[str, Any]:
    """Run one cell and return its result (the last line's object, with
    ``checks`` last) and what the earlier lines report."""
    man = manifest.load(root)
    cell = manifest.cell(man, cell_name)
    cfg = manifest.config(man, cell, root)
    mix = manifest.traffic(cell, root)
    run = Run(cell=cell, config=cfg, traffic=mix, seed=int(seed),
              seconds=float(seconds), traced=bool(traced),
              num_slots=int(cfg["server"]["num_slots"]))
    dev = torch.device(device)
    kind_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu")
    run.peaks = roofline.peaks(kind_name)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    probe_before = host_probe()
    system = serving(run, prepare(run, dev), dev)
    run.setup_s = time.time() - t0
    log(f"set-up {run.setup_s:.3f} s")

    stretch = None
    if traced:
        profiling.prime(dev)
        stretch = profiling.Stretch(TRACE_START * run.seconds,
                                min(TRACE_SECONDS, run.seconds / 3.0), dev)
    run.tally, run.collection_rows = harvest.Tally(), int(cfg["data"]["n"])
    with harvest.tallied(run.tally):
        window(run, system, stretch)
    sync(dev)
    peak = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else 0)
    truncated = sum(c.stats.truncated for c in run.calls)
    srv = served(run, system)
    run.failed = int((~srv.returned).sum()) + int(truncated)
    if stretch is not None:
        run.summary = stretch.summary()
        least_times(run, stretch.recorder)
        stretch.recorder = None
    from repro_torch.kernels import cuda as cuda_kernels
    log(f"window {run.window_s:.3f} s, {len(run.calls)} serve calls, "
        f"{run.attempted} offered, {run.completed} completed, "
        f"{truncated} truncated; kernel launches {dict(cuda_kernels.LAUNCHES)}")
    log(f"host probe: {probe_before:.4f} s before set-up, "
        f"{host_probe():.4f} s after the window")
    durs = [c.end - c.start for c in run.calls]
    log(f"serve calls: {len(durs)}, seconds min {min(durs):.4f} median "
        f"{float(np.median(durs)):.4f} max {max(durs):.4f}")
    if run.lag_s:
        log(f"generator lag (wake-up past the due time): median "
            f"{np.median(run.lag_s) * 1e3:.4f} ms, max "
            f"{max(run.lag_s) * 1e3:.4f} ms over {len(run.lag_s)} waits")

    base = system.coll.base
    system.server = system.darth = system.built = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    outcome = check.compare(base, srv, cfg["correct"], run.seed)
    for t, r in sorted(outcome["recall_by_target"].items()):
        log(f"recall@{srv.ids.shape[1]} at target {t:.2f}: {r:.6f} "
            f"({outcome['recall_sample']} sampled rows)")
    for t, v in sorted(ndis_by_target(run, srv.targets).items()):
        log(f"target {t:.2f}: {v['harvested']} harvested, "
            f"{v['ndis_mean']:.1f} distances a query, "
            f"{100 * v['full_share']:.4f} % searched every row")

    metrics = {}
    for m in manifest.metrics_for(man, cell_name, traced):
        v = manifest.reader(m["name"], root)(run, m["name"])
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    devinfo: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": kind_name, "count": 1, "memory_peak_bytes": peak}
    result: Dict[str, Any] = {
        "correct": all(c["ok"] for c in outcome["checks"]),
        "attempted": run.attempted, "failed": run.failed,
        "metrics": metrics, "device": devinfo}
    if traced and run.summary is not None:
        devinfo["busy_s"] = run.summary.busy_s
        devinfo["window_s"] = run.summary.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.summary.device_ops],
            "idle_gaps": [[n, s] for n, s in run.summary.idle_gaps]}
        log(f"traced stretch: busy {run.summary.busy_s:.6f} s of "
            f"{run.summary.window_s:.6f} s; kernel device s "
            f"{run.summary.kernel_s}, launches "
            f"{run.summary.kernel_launches}; least s {run.least_s}")
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in outcome["checks"]}
    return result
