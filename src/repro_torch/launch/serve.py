"""Declarative-recall serving launcher: builds an index, fits DARTH once,
then serves a stream of queries with per-request recall targets through
the slot-pool server (the port of the reference's ``launch/serve.py``).

Usage (on the card; ``--device cpu`` runs the same on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --n 30000 \
      --queries 512 --targets 0.8,0.9,0.95

Multi-host slot pool (--hosts N splits the slot pool into N per-host
slices, each with its own admission/refill loop — simulated multi-host
on one process):
  PYTHONPATH=src python -m repro_torch.launch.serve --hosts 4

Difficulty-aware serving (--tiers classifies queries at admission from
the routing scan and gives the hard tier reserved slots, a boosted
effective target, hedged duplicates on idle capacity, and bounded
admission under overload; per-tier p50/p99 recall and latency are
reported):
  PYTHONPATH=src python -m repro_torch.launch.serve --tiers --boost 0.05 \
      --hedge --max-queue 64 --overload degrade

Observability (--trace DIR writes the per-query lifecycle spans to
DIR/trace.jsonl and prints one termination story; --metrics exports the
Prometheus page + event log):
  PYTHONPATH=src python -m repro_torch.launch.serve --trace /tmp/tr --metrics
  python -m repro_torch.obs.explain /tmp/tr/trace.jsonl --qid 7

Streaming mutations (--mutations INS,DEL applies an insert/delete burst
between serve phases through repro_torch.mutate: delta ring + tombstones,
drift monitor, predictor recalibration hot-swap, compaction;
--online-compact streams the events into a live serve phase instead,
one per chunk boundary, then compacts in the background and hot-swaps
the folded base at a drained boundary):
  PYTHONPATH=src python -m repro_torch.launch.serve --mutations 0.2,0.1 \
      --drift 0.3
  PYTHONPATH=src python -m repro_torch.launch.serve --mutations 0.2,0.1 \
      --drift 0.3 --online-compact

Sharded index (--shards N splits every bucket's cap, or the graph's
rows with --engine hnsw, over N shards on --device: one shard per card
with ``cuda``, all N on one device when it is named; the fit's and the
report's ground truth row-shard the database the same way). With
--hosts H > 1 and a device that holds H x N shards the mesh gains a
"hosts" axis and each host group steps its own slot slice against the
global index; with --mutations the mutable view is placed on the mesh
(the delta ring whole on the lead device) and re-placed by
dist.refresh_placed_view:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda:0 \
      --shards 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --shards 2 \
      --engine hnsw
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --shards 2 \
      --hosts 2
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --shards 2 \
      --mutations 0.2,0.1 --online-compact
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import dist, mutate
from repro_torch.core import api, engines, training
from repro_torch.data import vectors
from repro_torch.index import flat, hnsw, ivf
from repro_torch.launch import mesh as mesh_lib
from repro_torch.serve import DarthServer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=30_000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--learn", type=int, default=2000,
                    help="DARTH training-query pool size")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--engine", choices=("ivf", "hnsw"), default="ivf")
    ap.add_argument("--nlist", type=int, default=128)
    ap.add_argument("--m", type=int, default=16,
                    help="HNSW graph degree (--engine hnsw)")
    ap.add_argument("--ef", type=int, default=128,
                    help="HNSW frontier size (--engine hnsw)")
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--targets", type=str, default="0.8,0.9,0.95")
    ap.add_argument("--shards", type=int, default=None,
                    help="shard the index (IVF bucket store, HNSW graph "
                         "rows) over N shards on --device (0 = every "
                         "visible card with --device cuda); with --hosts "
                         "H > 1 and H x N shards' room the mesh gains a "
                         "'hosts' axis")
    ap.add_argument("--hosts", type=int, default=1,
                    help="split the slot pool into N per-host loops "
                         "(admission/refill run per host)")
    ap.add_argument("--mutations", type=str, default=None,
                    metavar="INS,DEL",
                    help="streaming-mutation workload: apply an "
                         "insert_pct,delete_pct burst (of --n) between "
                         "serve phases, with drift monitoring, "
                         "predictor recalibration and compaction")
    ap.add_argument("--drift", type=float, default=0.0,
                    help="fraction of burst inserts drawn OOD "
                         "(mutation_stream)")
    ap.add_argument("--mutation-steps", type=int, default=4)
    ap.add_argument("--online-compact", action="store_true",
                    help="with --mutations: stream the events INTO a "
                         "live serve phase (one per chunk boundary, "
                         "contents-only delta refreshes), then run "
                         "compaction as a background incremental "
                         "rebuild ticked at boundaries and hot-swap "
                         "the folded base atomically at a drained "
                         "boundary")
    ap.add_argument("--delta-cap", type=int, default=0,
                    help="delta ring capacity (0 = sized to the burst)")
    ap.add_argument("--recal-threshold", type=float, default=0.02,
                    help="recall drift that triggers a predictor refit")
    ap.add_argument("--tiers", action="store_true",
                    help="difficulty-aware admission: classify queries "
                         "at admission (serve.difficulty) and partition "
                         "slots between easy/hard tiers")
    ap.add_argument("--hard-quantile", type=float, default=0.75,
                    help="difficulty-score quantile above which a query "
                         "is hard (--tiers)")
    ap.add_argument("--hard-slots", type=float, default=0.25,
                    help="fraction of each host's slots reserved for "
                         "the hard tier (--tiers)")
    ap.add_argument("--boost", type=float, default=0.0,
                    help="extra recall target for hard queries, clipped "
                         "to 0.99 (--tiers)")
    ap.add_argument("--hedge", action="store_true",
                    help="launch hedged duplicates of in-flight hard "
                         "queries into idle hard slots (--tiers)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="per-host admission bound; overflow is shed or "
                         "degraded per --overload (--tiers)")
    ap.add_argument("--overload", choices=("degrade", "shed"),
                    default="degrade",
                    help="overload policy beyond --max-queue (--tiers)")
    ap.add_argument("--degrade-target", type=float, default=0.80,
                    help="lowered target for --overload degrade")
    ap.add_argument("--rebalance", action="store_true",
                    help="steal queued queries from backlogged hosts "
                         "into idle hosts at refill boundaries (--tiers)")
    ap.add_argument("--trace", type=str, default=None, metavar="DIR",
                    help="per-query tracing (repro_torch.obs): write the "
                         "serve phase's lifecycle spans to DIR/"
                         "trace.jsonl and print one explain() story; "
                         "replay any query later with python -m "
                         "repro_torch.obs.explain DIR/trace.jsonl --qid N")
    ap.add_argument("--metrics", action="store_true",
                    help="aggregate serving metrics (repro_torch.obs) and "
                         "write the Prometheus exposition page + JSONL "
                         "event log to --trace DIR (or results/)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="device the index, the fit and the server run "
                         "on (default: the card)")
    args = ap.parse_args()
    mesh = None
    if args.shards is not None:
        shards = (args.shards
                  or mesh_lib.make_search_mesh(0, args.device).sizes[0])
        if (args.hosts > 1 and mesh_lib.device_capacity(args.device)
                >= args.hosts * shards):
            mesh = mesh_lib.make_serve_mesh(args.hosts, shards, args.device)
        else:
            mesh = mesh_lib.make_search_mesh(args.shards, args.device)
        print(f"[serve] serving on {mesh_lib.describe(mesh)}")

    device = torch.device(args.device)
    targets = [float(t) for t in args.targets.split(",")]
    ds = vectors.make_dataset(n=args.n, d=args.dim, num_learn=args.learn,
                              num_queries=args.queries,
                              clusters=max(32, args.nlist), seed=0)
    t0 = time.time()
    if args.engine == "hnsw":
        index = hnsw.build(ds.base, m=args.m, seed=0, device=device)
    else:
        index = ivf.build(ds.base, nlist=args.nlist, seed=0, device=device)
    print(f"[serve] {args.engine} index built: {index.num_vectors} vecs "
          f"on {device} ({time.time()-t0:.1f}s)")
    if args.hosts > 1:
        print(f"[serve] multi-host slot pool: {args.hosts} host loops x "
              f"{args.slots // args.hosts} slots")

    engine_kw = (dict(k=args.k, ef=args.ef) if args.engine == "hnsw"
                 else dict(k=args.k, nprobe=args.nlist))

    mutable = None
    if args.mutations is not None:
        ins_pct, del_pct = (float(v) for v in args.mutations.split(","))
        cap = args.delta_cap or max(
            args.k, -(-int(round(ins_pct * args.n)) // 128) * 128)
        mutable = mutate.MutableIndex(index, capacity=cap)
        print(f"[serve] mutable index: delta capacity {cap}")

    # a frozen index is placed once; a mutable view at every rebuild
    placed = (dist.place_index(index, mesh)
              if mesh is not None and mutable is None else index)

    def family_engine(idx, **kw):
        """Engine over an (already placed, when sharded) index."""
        if mesh is not None:
            if args.engine == "hnsw":
                return engines.sharded_hnsw_engine(idx, mesh, **kw)
            return engines.sharded_ivf_engine(idx, mesh, **kw)
        if args.engine == "hnsw":
            return engines.hnsw_engine(idx, **kw)
        return engines.ivf_engine(idx, **kw)

    def build_engine(**kw):
        if mutable is None:
            return family_engine(placed, **kw)
        view = mutable.view()
        if mesh is not None:
            view = dist.place_index(view, mesh)
        return engines.mutable_engine(family_engine(view.base, **kw),
                                      view.delta)

    darth = api.Darth(make_engine=build_engine,
                      engine=build_engine(**engine_kw))
    t0 = time.time()
    darth.fit(ds.learn, ds.base, mesh=mesh)
    print(f"[serve] DARTH fit ({time.time()-t0:.1f}s) "
          f"mse={darth.trained.metrics['mse']:.5f}")

    rng = np.random.default_rng(0)
    r_targets = rng.choice(targets, size=args.queries).astype(np.float32)
    tiers = None
    if args.tiers:
        from repro_torch.serve import TierConfig
        tiers = TierConfig(hard_quantile=args.hard_quantile,
                           hard_slot_fraction=args.hard_slots,
                           boost=args.boost, hedge=args.hedge,
                           max_queue=args.max_queue,
                           overload=args.overload,
                           degrade_target=args.degrade_target,
                           rebalance=args.rebalance)
        print(f"[serve] difficulty tiers: hard q>{args.hard_quantile:.2f}, "
              f"{args.hard_slots:.0%} hard slots, boost {args.boost:+.2f}"
              + (", hedging" if args.hedge else "")
              + (f", max_queue {args.max_queue} ({args.overload})"
                 if args.max_queue is not None else "")
              + (", rebalance" if args.rebalance else ""))
    tracer = None
    if args.trace is not None:
        from repro_torch.obs import Tracer
        os.makedirs(args.trace, exist_ok=True)
        trace_path = os.path.join(args.trace, "trace.jsonl")
        open(trace_path, "w").close()     # fresh file per run
        tracer = Tracer(path=trace_path)
        print(f"[serve] tracing -> {trace_path}")
    registry = None
    if args.metrics:
        from repro_torch.obs import MetricsRegistry
        registry = MetricsRegistry()
    server = DarthServer(darth.engine, darth.trained.predictor,
                         darth.interval_for_target, num_slots=args.slots,
                         mesh=mesh, hosts=args.hosts, tiers=tiers,
                         tracer=tracer, metrics=registry)
    monitor = None
    if mutable is not None:
        monitor = mutate.RecalibrationMonitor(
            mutable, darth, targets=targets,
            threshold=args.recal_threshold, mesh=mesh, metrics=registry)
        if registry is not None:
            mutable.attach_metrics(registry)
    frozen_gt = {}

    def ground_truth() -> torch.Tensor:
        """Exact top-k of the test queries over the current live set, as
        GLOBAL ids; the mutable path memoizes it on the mutation epoch
        (MutableIndex.live_ground_truth)."""
        if mutable is not None:
            return torch.as_tensor(
                mutable.live_ground_truth(ds.queries, args.k, mesh=mesh),
                device=device)
        if "gt" not in frozen_gt:
            frozen_gt["gt"] = training.ground_truth(
                torch.as_tensor(ds.queries, device=device),
                torch.as_tensor(ds.base, device=device), args.k,
                mesh=mesh)[1]
        return frozen_gt["gt"]

    def serve_phase(label: str, on_boundary=None):
        t0 = time.time()
        if tracer is not None:
            tracer.label = label       # spans carry the phase name
        results, stats = server.serve(ds.queries, r_targets,
                                      on_boundary=on_boundary)
        dt = time.time() - t0
        print(f"[serve] {label}: {stats.completed} queries in {dt:.1f}s "
              f"({stats.completed/max(dt, 1e-9):.0f} qps host-side; "
              f"{stats.engine_steps} engine steps, {stats.refills} refills)")
        if server.hosts > 1:
            print(f"[serve] {label}: per-host completed "
                  + "/".join(str(h.completed) for h in stats.hosts))
        for tier, ts in stats.tiers.items():
            extra = ""
            if ts.shed or ts.degraded:
                extra += f", {ts.shed} shed / {ts.degraded} degraded"
            if ts.hedged:
                extra += (f", {ts.hedged} hedged "
                          f"({ts.hedge_upgrades} upgrades)")
            print(f"[serve] {label}: tier {tier}: {ts.count} queries, "
                  f"recall p50/p99 {ts.recall_p50:.3f}/{ts.recall_p99:.3f}"
                  f" (predicted), latency p50/p99 {ts.latency_p50:.0f}/"
                  f"{ts.latency_p99:.0f} steps{extra}")
        if stats.tiers:
            print(f"[serve] {label}: chunk wall p50/p99 "
                  f"{stats.chunk_ms_p50:.1f}/{stats.chunk_ms_p99:.1f} ms")
        done = np.array([i for i, r in enumerate(results) if r is not None])
        if stats.truncated or len(done) < len(results):
            print(f"[serve] {label}: step budget hit: {stats.truncated} "
                  f"truncated, {len(results) - len(done)} never admitted")
        if done.size == 0:
            print(f"[serve] {label}: no queries completed — skipping "
                  f"recall report")
            return stats
        ids = np.stack([results[i][1] for i in done])
        gt_i = ground_truth()[torch.as_tensor(done, device=device)]
        rec = flat.recall_at_k(torch.as_tensor(ids, device=device),
                               gt_i).cpu().numpy()
        if monitor is not None:
            monitor.observe(ds.queries[done], r_targets[done], ids)
        for t in targets:
            sel = r_targets[done] == np.float32(t)
            if sel.any():
                print(f"[serve] {label}: target {t:.2f}: mean recall "
                      f"{rec[sel].mean():.4f} over {int(sel.sum())} queries")
            else:
                print(f"[serve] {label}: target {t:.2f}: no completed "
                      f"queries")
        return stats

    serve_phase("pre-mutation" if mutable is not None else "steady-state")

    if mutable is not None and args.online_compact:
        events = list(vectors.mutation_stream(
            ds, ins_pct, del_pct, drift=args.drift,
            steps=args.mutation_steps, seed=1))
        print(f"[serve] online mutation stream: {len(events)} events, "
              f"applied one per chunk boundary")

        def push_contents(update_base: bool) -> None:
            """Contents-only view refresh into the live server: delta
            always, base only when tombstones changed; on a mesh the
            new components are placed first."""
            base = mutable.base if update_base else None
            if mesh is not None:
                eng = server.engine._replace(index=dist.refresh_placed_view(
                    server.engine.index, mesh, base=base,
                    delta=mutable.delta))
            else:
                eng = mutate.refresh_view(server.engine, base=base,
                                          delta=mutable.delta)
            darth.engine = eng
            server.set_engine(eng, contents_only=True)

        state = {"swapped": False, "ticks": 0}

        def trace_event(srv, kind: str, **attrs) -> None:
            """Server-level compaction span, stamped at the boundary."""
            if srv.tracer is not None:
                srv.tracer.event(kind, step=srv.boundary_step,
                                 epoch=srv.engine_epoch, **attrs)

        def on_boundary(srv) -> None:
            # one unit of mutation work per boundary; once a swap is
            # staged, do nothing until the pool drains and applies it
            if srv.swap_pending or state["swapped"]:
                return
            if events:
                ev = events.pop(0)
                mutable.apply([ev])
                push_contents(update_base=(ev.kind == "delete"))
            elif not mutable.compacting:
                mutable.begin_compaction()
                trace_event(srv, "compact_begin")
            elif mutable.compact_tick():
                state["ticks"] = mutable.compaction_ticks
                trace_event(srv, "compact_tick",
                            tick=mutable.compaction_ticks, done=True)
                mutable.swap_compaction()
                trace_event(srv, "compact_swap")
                eng = build_engine(**engine_kw)
                srv.request_swap(eng, contents_only=True)
                darth.engine = eng
                state["swapped"] = True
            else:
                trace_event(srv, "compact_tick",
                            tick=mutable.compaction_ticks, done=False)

        stats = serve_phase("online-mutation", on_boundary=on_boundary)
        if not state["swapped"]:
            # the serve phase finished before the stream / rebuild did:
            # drain the leftovers synchronously (the same generator, so
            # the same shadow)
            if events:
                mutable.apply(events)
                events.clear()
            if mutable.compacting:
                while not mutable.compact_tick():
                    pass
                mutable.swap_compaction()
            else:
                mutable.compact()
            darth.engine = build_engine(**engine_kw)
            server.set_engine(darth.engine, contents_only=True)
        print(f"[serve] online compaction: {stats.swaps} atomic "
              f"swap(s) mid-serve ({state['ticks']} background ticks), "
              f"{stats.hedge_epoch_dropped} hedges dropped across "
              f"epochs; {mutable.num_live} live vectors, delta empty")
        serve_phase("post-swap")

    elif mutable is not None:
        events = vectors.mutation_stream(
            ds, ins_pct, del_pct, drift=args.drift,
            steps=args.mutation_steps, seed=1)
        mutable.apply(events)
        print(f"[serve] mutation burst applied: {mutable.num_delta} delta "
              f"inserts live, {len(mutable.deleted_ids)} tombstones, "
              f"{mutable.num_live} live vectors")
        darth.engine = build_engine(**engine_kw)
        server.set_engine(darth.engine, contents_only=True)
        serve_phase("post-burst")

        rep = monitor.drift()
        print(f"[serve] drift check over {rep.num_queries} replayed "
              f"queries: worst gap {rep.worst_gap:.4f} "
              f"({'RECALIBRATING' if rep.drifted else 'within threshold'})")
        if rep.drifted:
            t0 = time.time()
            monitor.recalibrate(ds.learn, server=server)
            print(f"[serve] predictor refit + hot-swap "
                  f"({time.time()-t0:.1f}s) "
                  f"mse={darth.trained.metrics['mse']:.5f}")
            serve_phase("post-recalibration")

        t0 = time.time()
        mutable.compact()
        darth.engine = build_engine(**engine_kw)
        server.set_engine(darth.engine, contents_only=True)
        print(f"[serve] compaction folded delta into base "
              f"({time.time()-t0:.1f}s): {mutable.num_live} live vectors, "
              f"delta empty")
        serve_phase("post-compaction")

    if mesh is not None:
        shards = dist.sharding.shard_count(mesh)
        print(f"[serve] sharded ground truth: {shards} shards x "
              f"[{args.queries}, {args.k}] candidates "
              f"({args.queries * args.k * 8 * shards / 1e3:.1f} kB) merged "
              f"on {mesh.lead}")
    if tracer is not None:
        from repro_torch.obs import explain as explain_lib
        print(f"[serve] trace: {len(tracer.last_spans)} spans in the "
              f"last phase; story of its worst-served query:")
        for line in explain_lib.explain(tracer.last_spans).splitlines():
            print(f"[serve]   {line}")
    if registry is not None:
        out_dir = args.trace if args.trace is not None else "results"
        os.makedirs(out_dir, exist_ok=True)
        prom = os.path.join(out_dir, "metrics.prom")
        events_path = os.path.join(out_dir, "events.jsonl")
        registry.write_prometheus(prom)
        registry.write_events(events_path, append=False)
        served = registry.counter("darth_queries_total")
        print(f"[serve] metrics -> {prom} (+ {events_path}): "
              f"{int(sum(served.values.values()))} query outcomes, "
              f"{len(registry.events)} events")


if __name__ == "__main__":
    main()
