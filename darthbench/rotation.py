"""Run one cell with its collection turned by a seeded rotation.

    python3 darthbench/rotation.py --workload ivf1024-hard-backlog \
        --seed 11 --rotation 1 --seconds 51

A rotation keeps every distance between the collection's rows, its learn
queries and the queries drawn around its modes, and changes only how
their coordinates round: the index, the fit and the served answers follow
the same geometry. A metric that moves far more under a rotation than
between two runs of one seed measures rounding, not the program. The run
is ``run.py``'s, with ``data.make_collection`` wrapped; its result line is
printed the same way.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

T0 = time.time()
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from darthbench.run import environment, report  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rotation", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    environment()
    import dataclasses

    import torch

    from darthbench import bench, data

    make = data.make_collection

    def turned(cfg, device):
        coll = make(cfg, device)
        g = data.generator(device, args.rotation, 13)
        d = coll.base.shape[1]
        rot, _ = torch.linalg.qr(torch.randn((d, d), generator=g,
                                             device=device,
                                             dtype=torch.float64))
        rot = rot.float()
        return dataclasses.replace(coll, base=coll.base @ rot,
                                   learn=coll.learn @ rot,
                                   centers=coll.centers @ rot)

    data.make_collection = turned
    result = bench.execute(ROOT, args.workload, args.seed, args.seconds,
                           False, "cuda:0", T0)
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
