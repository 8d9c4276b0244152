"""The readings that set the check's limits: the program's sound runs, the
lower-precision control and a planted predictor, on the card at the
cell's own size.

    python3 darthbench/control.py --workload ivf1024-hard-backlog \
        --seeds 11,12,13 --seconds 10 [--sample 16384] \
        [--plant-seeds 11,12] [--plain 2048]

One process builds the cell's deployment once (the collection, the index
and the fit: a configuration's own, the same for every run seed). For
each seed it makes the server and the seed's queries as a run does, runs
a window of ``--seconds`` at the cell's own load, and reads the check's
numbers of what the program served: the sound readings. Then the
control: the plain reference, put in the program's place and computed in
TF32 (the nearest precision below the float32 the configurations state),
answers a seeded sample of the same served queries, and the same
comparison reads its numbers. A sample and not every served query, so
that the control stays short: its largest gap over fewer rows can only
read lower than over all of them, which keeps the limit set below it
conservative. On the ``--plant-seeds``, a second window serves the same
queries with a predictor that says every target is met at its first
check, and the check reads that too. ``--plain`` rows of each seed's
served queries are also searched to the engine's end, without early
termination: the recall the index attains (a configuration's
``attainable_recall``). One JSON line a seed to standard output and to
``results/darthbench/control_<cell>.jsonl`` (or ``--out``); the last
line gives, per number, the largest sound reading and the smallest
control reading.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from darthbench import check, data  # noqa: E402


def control_readings(base, served: check.Served, limits: dict, seed: int,
                     sample: int, matmul: str) -> dict:
    """The check's numbers when the reference, computed with ``matmul``,
    answers ``sample`` of the served queries in the program's place."""
    import torch
    from darthbench import reference

    k = served.ids.shape[1]
    rng = np.random.default_rng(data.derive(seed, 11))
    rows = np.sort(rng.choice(served.ids.shape[0],
                              size=min(sample, served.ids.shape[0]),
                              replace=False))
    q = served.queries[torch.as_tensor(rows, device=served.queries.device)]
    d, i = reference.exact_knn(base, q, k, matmul=matmul)
    ctrl = check.Served(queries=q, targets=served.targets[rows],
                        returned=np.ones(rows.size, bool),
                        ids=i.cpu().numpy(), dists=d.cpu().numpy())
    return check.compare(base, ctrl, limits, seed)


class StopAtFirstCheck:
    """A planted predictor: every query's recall reads 1 at its first
    check, so DARTH stops each query there."""

    def __call__(self, feats):
        import torch
        return torch.ones(feats.shape[0], dtype=torch.float32,
                          device=feats.device)


def plain_recall(darth, base, queries, k: int, block: int = 2048) -> float:
    """Mean recall@k of the engine run to its natural end (no early
    termination) against the reference's exact neighbours."""
    import torch
    from darthbench import reference

    hits = []
    for lo in range(0, queries.shape[0], block):
        q = queries[lo:lo + block]
        _, got, _ = darth.search_plain(q)
        _, exact = reference.exact_knn(base, q, k)
        got, exact = got.long().cpu(), exact.long().cpu()
        hits.append((got[:, :, None] == exact[:, None, :]).any(2)
                    .float().mean(1))
    return float(torch.cat(hits).mean())


def numbers(outcome: dict) -> dict:
    return {c["name"]: c["value"] for c in outcome["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--sample", type=int, default=16384)
    ap.add_argument("--matmul", default="tf32")
    ap.add_argument("--plant-seeds", default="",
                    help="seeds also served with the planted predictor")
    ap.add_argument("--plain", type=int, default=0,
                    help="served queries a seed searched without DARTH")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None,
                    help="the JSON lines file (default under results/)")
    args = ap.parse_args(argv)
    from darthbench.run import environment
    environment()
    import torch
    from darthbench import bench, manifest

    man = manifest.load(ROOT)
    cell = manifest.cell(man, args.workload)
    cfg, mix = manifest.config(man, cell, ROOT), manifest.traffic(cell, ROOT)
    dev = torch.device(args.device)
    out = pathlib.Path(args.out or ROOT / "results" / "darthbench"
                       / f"control_{args.workload}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    sound, ctrl = {}, {}
    plant = {int(x) for x in args.plant_seeds.split(",") if x}
    seeds = [int(x) for x in args.seeds.split(",")]

    def new_run(seed):
        return bench.Run(cell=cell, config=cfg, traffic=mix, seed=seed,
                         seconds=args.seconds, traced=False,
                         num_slots=int(cfg["server"]["num_slots"]))

    deployment = bench.prepare(new_run(seeds[0]), dev)
    base, k = deployment.coll.base, int(cfg["k"])
    for seed in seeds:
        run = new_run(seed)
        system = bench.serving(run, deployment, dev)
        bench.window(run, system)
        served = bench.served(run, system)
        program = check.compare(base, served, cfg["correct"], seed)
        row = {"workload": args.workload, "seed": seed,
               "served": int(served.returned.sum()),
               "qps": run.completed / run.window_s,
               "sound": numbers(program),
               "sound_correct": all(c["ok"] for c in program["checks"]),
               "sound_recall": program["recall_by_target"]}
        if seed in plant:
            system.server.set_predictor(StopAtFirstCheck())
            planted = new_run(seed)
            bench.window(planted, system)
            outcome = check.compare(base, bench.served(planted, system),
                                    cfg["correct"], seed)
            row["planted"] = numbers(outcome)
            row["planted_correct"] = all(c["ok"] for c in outcome["checks"])
            row["planted_recall"] = outcome["recall_by_target"]
        system = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if args.plain:
            row["plain_recall"] = plain_recall(
                deployment.darth, base, served.queries[:args.plain], k)
        control = control_readings(base, served, cfg["correct"], seed,
                                   args.sample, args.matmul)
        row.update({"control": numbers(control),
                    "control_correct": all(c["ok"]
                                           for c in control["checks"]),
                    "control_matmul": args.matmul,
                    "control_rows": int(min(args.sample,
                                            served.ids.shape[0]))})
        for name, v in row["sound"].items():
            sound[name] = max(sound.get(name, -np.inf), v)
        for name, v in row["control"].items():
            ctrl[name] = min(ctrl.get(name, np.inf), v)
        print(json.dumps(row), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
        served = None
        gc.collect()
    print(json.dumps({"workload": args.workload, "lower": sound,
                      "control_least": ctrl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
