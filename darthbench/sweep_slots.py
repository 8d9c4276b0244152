"""Sweep the server's slot pool of a backlog cell on the card.

    python3 darthbench/sweep_slots.py --workload ivf1024-hard-backlog \
        --seed 1 --slots 256,1024,4096 --seconds 10 [--traced-seconds 6]

One process builds the cell's index and fits DARTH once, then for each
pool size makes a server, warms it up, runs an untraced backlog window
(q/s) and a short traced one (the device's busy share over the stretch),
and prints one JSON line per size, also written to
``results/darthbench/sweep_slots_<cell>.jsonl`` (or ``--out``): q/s,
chunk p50, slot fill, distances per query, the busy share, the peak
memory, and the recall per declared target of the untraced window
against the reference. A configuration takes the smallest pool at which
the card is busy for most of the window, or, where none is, the one past
which q/s and the busy share fall (PERF.md records each sweep).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from darthbench.run import environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--slots", default="256,1024,4096")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--traced-seconds", type=float, default=6.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None,
                    help="the JSON lines file (default under results/)")
    args = ap.parse_args(argv)
    environment()
    import torch
    from darthbench import bench, check, harvest, manifest, profiling

    man = manifest.load(ROOT)
    cell = manifest.cell(man, args.workload)
    cfg, mix = manifest.config(man, cell, ROOT), manifest.traffic(cell, ROOT)
    dev = torch.device(args.device)

    def new_run(slots, seconds, traced):
        return bench.Run(cell=cell, config=cfg, traffic=mix, seed=args.seed,
                         seconds=seconds, traced=traced, num_slots=slots)

    sizes = [int(s) for s in args.slots.split(",")]
    base = bench.prepare(new_run(sizes[0], args.seconds, False), dev)
    profiling.prime(dev)
    out = pathlib.Path(args.out or ROOT / "results" / "darthbench"
                       / f"sweep_slots_{args.workload}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    for slots in sizes:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        run = new_run(slots, args.seconds, False)
        system = bench.serving(run, base, dev)
        run.tally = harvest.Tally()
        run.collection_rows = int(cfg["data"]["n"])
        with harvest.tallied(run.tally):
            bench.window(run, system)
        served = bench.served(run, system)
        outcome = check.compare(system.coll.base, served, cfg["correct"],
                                args.seed)
        traced = new_run(slots, args.traced_seconds, True)
        stretch = profiling.Stretch(args.traced_seconds / 3,
                                    args.traced_seconds / 3, dev)
        bench.window(traced, system, stretch)
        summ = stretch.summary()
        steps = sum(c.stats.engine_steps for c in run.calls)
        row = {
            "workload": args.workload, "slots": slots,
            "qps": run.completed / run.window_s, "window_s": run.window_s,
            "calls": len(run.calls), "completed": run.completed,
            "truncated": sum(c.stats.truncated for c in run.calls),
            "chunk_ms_p50": [c.stats.chunk_ms_p50 for c in run.calls],
            "slot_fill": sum(c.stats.slot_steps for c in run.calls)
            / max(1, steps * slots),
            "ndis_per_query": sum(c.stats.ndis_harvested for c in run.calls)
            / max(1, run.completed),
            "busy_share": None if summ is None
            else summ.busy_s / summ.window_s,
            "traced_window_s": None if summ is None else summ.window_s,
            "device_ops": None if summ is None else summ.device_ops,
            "idle_gaps": None if summ is None else summ.idle_gaps,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else 0,
            "recall_by_target": outcome["recall_by_target"],
            "ndis_by_target": bench.ndis_by_target(run, served.targets),
            "call_seconds": [c.end - c.start for c in run.calls],
            "checks": outcome["checks"]}
        print(json.dumps(row), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
        system = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
