#!/usr/bin/env python3
"""Does the card's IVF build and GBDT fit repeat, and what does it cost?
Times ``chip_smoke.py`` phase 2's ``ivf.build`` and its GBDT fit
(``training.fit_predictor`` on phase 2's own step log) for two trees of
the port in one process, on one NVIDIA card:

    python3 tools/repeat_timing.py --parent DIR

DIR is an unpacked older tree of the repository (``git archive``); its
``src/repro_torch/index/kmeans.py`` and ``src/repro_torch/gbdt/train.py``
are loaded beside this tree's, and everything else (the kernels, the
step log) is this tree's. The step log comes from one ``Darth.fit`` at
phase 2's size (1M x 128, nlist 1024, 10,000 learn queries, k 10, nprobe
1024). Then, in turns parent, change, change, parent, each tree builds
the index and fits the predictor; each line is one JSON object with the
seconds and whether the tree's two builds (centroids) and two fits
(feat, thresh, leaf of every tree) were bit-equal. The card's name and
power limit come first. It imports nothing of JAX.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--learn", type=int, default=10_000)
    ap.add_argument("--nlist", type=int, default=1024)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("repeat_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    from repro_torch.core import api, engines, training
    from repro_torch.data import vectors
    from repro_torch.gbdt import train as gbdt_change
    from repro_torch.index import ivf
    from repro_torch.index import kmeans as kmeans_change
    src = os.path.join(args.parent, "src", "repro_torch")
    trees = {
        "parent": (_load(os.path.join(src, "index", "kmeans.py"),
                         "parent_kmeans"),
                   _load(os.path.join(src, "gbdt", "train.py"),
                         "parent_gbdt_train")),
        "change": (kmeans_change, gbdt_change)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    ds = vectors.make_dataset(n=args.n, d=128, num_learn=args.learn,
                              num_queries=1, clusters=args.nlist, seed=0)
    index = ivf.build(ds.base, nlist=args.nlist, seed=0)
    darth = api.Darth(
        make_engine=None,
        engine=engines.ivf_engine(index, k=10, nprobe=args.nlist))
    darth.fit(ds.learn, ds.base)
    log = darth._last_log
    del darth, index
    print(json.dumps({"step_log_rows": int(log.valid.sum())}), flush=True)
    last = {}
    for name in ("parent", "change", "change", "parent"):
        kmeans_mod, gbdt_mod = trees[name]
        ivf.kmeans_lib, training.gbdt_train = kmeans_mod, gbdt_mod
        torch.cuda.synchronize()
        t0 = time.time()
        index = ivf.build(ds.base, nlist=args.nlist, seed=0)
        torch.cuda.synchronize()
        build_s = time.time() - t0
        t0 = time.time()
        params = training.fit_predictor(log).predictor.params
        torch.cuda.synchronize()
        gbdt_s = time.time() - t0
        got = (index.centroids, params.feat, params.thresh, params.leaf)
        row = {"tree": name, "build_s": build_s, "gbdt_s": gbdt_s}
        if name in last:
            was = last[name]
            row["centroids_equal"] = torch.equal(got[0], was[0])
            row["trees_equal"] = all(torch.equal(a, b)
                                     for a, b in zip(got[1:], was[1:]))
        last[name] = got
        del index
        print(json.dumps(row), flush=True)
    ivf.kmeans_lib, training.gbdt_train = kmeans_change, gbdt_change
    return 0


if __name__ == "__main__":
    sys.exit(main())
