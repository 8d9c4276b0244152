#!/usr/bin/env python3
"""Plain HNSW recall@10 of the port on one NVIDIA card, against the number
of rows indexed and the beam width.

    python3 tools/hnsw_recall_sweep.py

The collection is ``chip_smoke.py``'s (a SIFT1M-shaped synthetic mixture,
1024 clusters, seed 0); each N indexes its first N rows with the build
``chip_smoke.py`` runs (m 16, ef_construction 64, two passes, alpha 1.2).
Each line is one JSON object: N, ef, max_steps, build seconds, mean
recall@10 of the 1000 queries against exact ground truth, mean ndis, the
routing sample's R and the steps taken. It imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SWEEP = ((1_000_000, (384, 512, 768, 1024)), (750_000, (384,)),
         (500_000, (384,)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hnsw_recall_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    from repro_torch.data import vectors
    from repro_torch.index import flat, hnsw
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    ds = vectors.make_dataset(n=1_000_000, d=128, num_learn=10_000,
                              num_queries=1_000, clusters=1024, seed=0)
    q = torch.as_tensor(ds.queries, device="cuda")
    for n, efs in SWEEP:
        t0 = time.time()
        index = hnsw.build(ds.base[:n], m=16, ef_construction=64, passes=2,
                           alpha=1.2, seed=0, chunk=8192)
        torch.cuda.synchronize()
        build_s = time.time() - t0
        _, gt = flat.search(q, index.vectors, 10)
        for ef in efs:
            _, ids, st = hnsw.search(index, q, k=10, ef=ef, max_steps=1200)
            print(json.dumps({
                "n": n, "ef": ef, "max_steps": 1200, "build_s": build_s,
                "recall": float(flat.recall_at_k(ids, gt).mean()),
                "ndis": float(st.ndis.float().mean()),
                "route_ndis": index.route_ids.shape[0],
                "steps": int(st.nstep.max()),
                "still_active": int(st.active.sum())}), flush=True)
        del index
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
