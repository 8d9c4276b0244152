#!/usr/bin/env python3
"""Device time of the port's l2_topk kernel at its call sites' shapes, on
one NVIDIA card, for the tree this script sits in.

    python3 tools/l2_topk_timing.py [--reps 5]

Shapes (``chip_smoke.py`` phase 3's and phase 7's): the fit's ground
truth (1024 queries x 1M rows of width 128, f32, k = 10), k-means
assignment (65536 rows x 1024 centroids, k = 1), int8 codes (k = 10) and
the wide ground truth of the evaluation (1000 queries x 1M rows, k = 100),
where the tree's kernel takes that k. The data are normal draws from a
fixed seed. Each line is one JSON object with the case, the mean ms per
call by CUDA events over ``--reps`` calls after one warm-up, and the card's
name and power limit. To compare two trees, copy this script into both and
run them in turns in one call. It imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("l2_topk_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    from repro_torch.kernels import cuda
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1_000_000, 128), generator=gen, device=dev) * 20
    q = torch.randn((1024, 128), generator=gen, device=dev) * 20
    cents = x[::977][:1024].contiguous()
    x8 = torch.randint(-127, 128, tuple(x.shape), generator=gen,
                       device=dev).to(torch.int8)
    cases = [("fit ground truth, f32, k=10", q, x, 10),
             ("k-means assignment, f32, k=1", x[:65536], cents, 1),
             ("int8 codes, k=10", q * 0.05, x8, 10),
             ("wide ground truth, f32, k=100", q[:1000].contiguous(), x,
              100)]
    for case, qq, xx, k in cases:
        if k > getattr(cuda, "L2_MAX_K", cuda.MAX_K):
            print(json.dumps({"case": case, "ms": None,
                              "note": "k above this tree's ceiling"}))
            continue
        sq = (xx.float() ** 2).sum(1)
        cuda.l2_topk(qq, xx, sq, k)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            cuda.l2_topk(qq, xx, sq, k)
        end.record()
        torch.cuda.synchronize()
        print(json.dumps({"case": case, "ms": start.elapsed_time(end)
                          / args.reps, "reps": args.reps, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
