"""Find the knee of an open-loop cell on the card: the highest arrival rate
the server sustains with no growing backlog.

    python3 darthbench/sweep_knee.py --workload ivf1024-mixed-open \
        --seed 1 --rates 2000,4000,8000,16000 --seconds 10

One process builds the index and fits DARTH once, makes the cell's server,
then for each rate runs the cell's drain loop on arrivals at that rate
(the mix's file with ``rate_qps`` replaced) and prints one JSON line per
rate, also written to ``results/darthbench/sweep_knee_<cell>.jsonl`` (or
``--out``): requests, p50 / p95 latency, the batch each serve call took,
and the drain after the arrivals stopped. A rate sustains when the
batches of the window's last third are no larger than 1.5 x those of its
middle third and the drain takes no longer than three median calls. The
last line names the knee; the mix's file then holds 0.8 x the knee as
its ``rate_qps``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from darthbench.run import environment  # noqa: E402


def sustained(calls, seconds: float) -> dict:
    """Whether the backlog grew over a window of drain-loop calls."""
    import numpy as np

    starts = np.array([c.start for c in calls])
    sizes = np.array([c.n for c in calls], float)
    durs = np.array([c.end - c.start for c in calls])
    mid = sizes[(starts >= seconds / 3) & (starts < 2 * seconds / 3)]
    last = sizes[starts >= 2 * seconds / 3]
    drain = calls[-1].end - seconds
    grow = (float(last.mean()) / max(1.0, float(mid.mean()))
            if mid.size and last.size else float("inf"))
    return {"batch_mid": float(mid.mean()) if mid.size else None,
            "batch_last": float(last.mean()) if last.size else None,
            "growth": grow, "drain_s": drain,
            "call_s_p50": float(np.median(durs)),
            "ok": bool(grow <= 1.5 and drain <= 3 * np.median(durs))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", default="2000,4000,8000,16000")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None,
                    help="the JSON lines file (default under results/)")
    args = ap.parse_args(argv)
    environment()
    import numpy as np
    import torch
    from darthbench import bench, manifest, stats

    man = manifest.load(ROOT)
    cell = manifest.cell(man, args.workload)
    cfg, mix = manifest.config(man, cell, ROOT), manifest.traffic(cell, ROOT)
    dev = torch.device(args.device)
    slots = int(cfg["server"]["num_slots"])

    def new_run(rate):
        return bench.Run(cell=cell, config=cfg, traffic=dict(mix,
                         rate_qps=rate), seed=args.seed,
                         seconds=args.seconds, traced=False, num_slots=slots)

    rates = [float(r) for r in args.rates.split(",")]
    base = bench.prepare(new_run(rates[0]), dev)
    out = pathlib.Path(args.out or ROOT / "results" / "darthbench"
                       / f"sweep_knee_{args.workload}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    knee = None
    for rate in rates:
        run = new_run(rate)
        system = bench.serving(run, base, dev)
        bench.window(run, system)
        lat = run.latencies_ms
        row = {"workload": args.workload, "rate_qps": rate,
               "requests": int(lat.size), "completed": run.completed,
               "latency_p50_ms": stats.p50(lat),
               "latency_p95_ms": stats.percentile(lat, 95),
               "latency_max_ms": float(np.nanmax(lat)),
               "calls": len(run.calls),
               "generator_lag_ms_max": 1e3 * max(run.lag_s, default=0.0)}
        row.update(sustained(run.calls, args.seconds))
        if row["ok"]:
            knee = rate
        print(json.dumps(row), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
    print(json.dumps({"workload": args.workload, "knee_qps": knee,
                      "rate_qps_at_0.8": None if knee is None
                      else 0.8 * knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
