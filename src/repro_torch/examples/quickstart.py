"""Quickstart: declarative recall in a few lines (a port of the
reference's ``examples/quickstart.py``).

Builds an IVF index over a synthetic clustered collection, fits DARTH once
(training-data generation + GBDT recall predictor), then serves ANY recall
target per query with no further tuning — the paper's headline API:

    ANNS(q, G, k, R_t)

Run on the card, or on the CPU with ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Sequence

import torch

from repro_torch.core import api, engines
from repro_torch.data import vectors
from repro_torch.index import flat, ivf

TARGETS = (0.80, 0.85, 0.90, 0.95, 0.99)


def main(*, n: int = 30_000, dim: int = 32, learn: int = 2_000,
         queries: int = 256, clusters: int = 128, nlist: int = 128,
         k: int = 10, targets: Sequence[float] = TARGETS,
         device="cuda") -> Dict[str, dict]:
    """Build, fit once, search at every target; print the table and
    return {"plain": {...}, "targets": {target: {recall, ndis, speedup,
    npred}}}."""
    print("== DARTH quickstart ==")
    ds = vectors.make_dataset(n=n, d=dim, num_learn=learn,
                              num_queries=queries, clusters=clusters, seed=0)
    t0 = time.time()
    index = ivf.build(ds.base, nlist=nlist, seed=0, device=device)
    print(f"IVF index: {index.num_vectors} vectors, nlist={index.nlist} "
          f"on {index.device} ({time.time()-t0:.1f}s)")

    darth = api.Darth(
        make_engine=lambda **kw: engines.ivf_engine(index, **kw),
        engine=engines.ivf_engine(index, k=k, nprobe=nlist))
    t0 = time.time()
    trained = darth.fit(ds.learn, ds.base)
    print(f"DARTH fit: predictor mse={trained.metrics['mse']:.5f} "
          f"r2={trained.metrics['r2']:.3f} ({time.time()-t0:.1f}s)")

    q = torch.as_tensor(ds.queries, device=index.device)
    _, gt_i = flat.search(q, torch.as_tensor(ds.base, device=index.device), k)
    _, plain_i, plain = darth.search_plain(q)
    plain_nd = float(plain.ndis.float().mean())
    out = {"plain": {"recall": float(flat.recall_at_k(plain_i, gt_i).mean()),
                     "ndis": plain_nd}, "targets": {}}
    print(f"\nplain search: recall={out['plain']['recall']:.3f} "
          f"mean-dists={plain_nd:.0f}")
    print(f"{'target':>7} {'recall':>7} {'dists':>7} {'speedup':>8} "
          f"{'pred-calls':>10}")
    for rt in targets:
        _, ii, st = darth.search(q, rt)
        row = {"recall": float(flat.recall_at_k(ii, gt_i).mean()),
               "ndis": float(st.inner.ndis.float().mean()),
               "npred": float(st.npred.float().mean())}
        row["speedup"] = plain_nd / row["ndis"]
        out["targets"][rt] = row
        print(f"{rt:7.2f} {row['recall']:7.3f} {row['ndis']:7.0f} "
              f"{row['speedup']:7.1f}x {row['npred']:10.1f}")
    print("\nEvery target met from ONE fit — no per-target tuning.")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the index, the fit and the search run "
                         "(default: the card)")
    main(device=ap.parse_args().device)
