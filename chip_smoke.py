#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # full size: N=1M, D=128, nlist=1024

Phases, each fatal on failure:

1. device:    the card's name and power limit; f32 matmuls in full f32;
              every kernel built from ``src/repro_torch/kernels/csrc`` (one
              nvcc per source, all at once).
2. main path: DARTH-on-IVF as a user runs it, on a SIFT1M-shaped synthetic
              collection: ``ivf.build`` -> ``Darth.fit`` -> ``search_plain``
              -> ``Darth.search`` at 0.80 / 0.90 / 0.95. The kernels' launch
              counts are zeroed just before and read just after; each kernel
              must have run. Each mean recall@10 (against exact ground truth)
              must reach its target - 0.03.
3. kernels:   each kernel against its plain PyTorch version on the main
              path's own tensors and shapes (f32, and int8 codes for both
              distance kernels), with times of the kernel, the plain version
              and, for l2_topk, one PyTorch call computing the same function.

It imports nothing of JAX or of the ``repro`` package. Output: a JSON line
of per-kernel results, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Full results also go to
``results/chip_smoke.json``. Without a CUDA card, or without the
repository around it, it exits non-zero and prints no result.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
TARGETS = (0.80, 0.90, 0.95)
TOL = 0.03


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, by CUDA events, after
    one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def topk_agreement(d_k, i_k, d_r, i_r, tol):
    """(max |d_k - d_r|, share of equal ids, ok). Ids may differ only
    where the distances at that rank lie within tol."""
    import torch
    err = (d_k - d_r).abs()
    finite = torch.isfinite(d_r)
    same_inf = ~finite & torch.isinf(d_k)
    max_err = float(err[finite].max()) if finite.any() else 0.0
    dist_ok = bool(((err <= tol) & finite | same_inf).all())
    diff = i_k != i_r
    ids_ok = bool((err[diff] <= tol).all()) if diff.any() else True
    return max_err, float((~diff).float().mean()), dist_ok and ids_ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--learn", type=int, default=10_000)
    ap.add_argument("--queries", type=int, default=1_000)
    ap.add_argument("--nlist", type=int, default=1024)
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.core import api, engines
        from repro_torch.data import vectors
        from repro_torch.index import flat, ivf
        from repro_torch.kernels import _build, cuda, ref
    except ImportError as e:
        return fail(f"the repro_torch package is not beside this script: {e}")
    if "jax" in sys.modules or "repro" in sys.modules:
        return fail("the port pulled in jax or the reference package")

    # -- 1. device ------------------------------------------------------------
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    if torch.get_float32_matmul_precision() != "highest":
        return fail("float32 matmul precision is not 'highest'")
    if torch.backends.cuda.matmul.allow_tf32:
        return fail("TF32 matmuls are enabled")
    t0 = time.time()
    _build.build()
    print(f"[device] kernels built in {time.time() - t0:.1f}s", flush=True)
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")

    # -- 2. main path ---------------------------------------------------------
    t0 = time.time()
    ds = vectors.make_dataset(n=args.n, d=args.dim, num_learn=args.learn,
                              num_queries=args.queries, clusters=args.nlist,
                              seed=0)
    print(f"[main] dataset n={args.n} d={args.dim} learn={args.learn} "
          f"queries={args.queries} ({time.time() - t0:.1f}s)", flush=True)
    main = {}
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.time()
    index = ivf.build(ds.base, nlist=args.nlist, seed=0)
    torch.cuda.synchronize()
    main["build_s"] = time.time() - t0
    print(f"[main] ivf.build nlist={index.nlist} cap={index.cap} "
          f"({main['build_s']:.1f}s)", flush=True)
    darth = api.Darth(
        make_engine=lambda **kw: engines.ivf_engine(index, **kw),
        engine=engines.ivf_engine(index, k=10, nprobe=args.nlist))
    t0 = time.time()
    trained = darth.fit(ds.learn, ds.base)
    main["fit_s"] = time.time() - t0
    main["fit_split_s"] = dict(darth.fit_seconds)
    main["predictor"] = dict(trained.metrics, samples=trained.num_samples)
    print(f"[main] Darth.fit {main['fit_s']:.1f}s split "
          + " ".join(f"{k}={v:.1f}s" for k, v in darth.fit_seconds.items())
          + f" mse={trained.metrics['mse']:.5f}", flush=True)
    q = torch.as_tensor(ds.queries, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    _, plain_i, plain = darth.search_plain(q)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    results = {}
    for rt in TARGETS:
        t0 = time.time()
        _, ids, st = darth.search(q, rt)
        torch.cuda.synchronize()
        results[rt] = (ids, st, time.time() - t0)
    launches = dict(cuda.LAUNCHES)
    print(f"[main] launches {launches}", flush=True)

    _, gt = flat.search(q, torch.as_tensor(ds.base, device=dev), 10)
    plain_ndis = float(plain.ndis.float().mean())
    main["plain"] = {
        "recall": float(flat.recall_at_k(plain_i, gt).mean()),
        "ndis": plain_ndis, "qps": args.queries / plain_s}
    print(f"[main] plain  recall={main['plain']['recall']:.4f} "
          f"ndis={plain_ndis:.0f} qps={main['plain']['qps']:.0f}")
    failures = []
    main["targets"] = {}
    for rt, (ids, st, secs) in results.items():
        rec = float(flat.recall_at_k(ids, gt).mean())
        nd = float(st.inner.ndis.float().mean())
        row = {"recall": rec, "ndis": nd, "speedup_ndis": plain_ndis / nd,
               "qps": args.queries / secs,
               "npred": float(st.npred.float().mean()), "steps": st.steps}
        main["targets"][str(rt)] = row
        print(f"[main] target {rt:.2f} recall={rec:.4f} ndis={nd:.0f} "
              f"speedup={row['speedup_ndis']:.2f}x qps={row['qps']:.0f} "
              f"npred={row['npred']:.2f} steps={st.steps}", flush=True)
        if rec < rt - TOL:
            failures.append(f"recall {rec:.4f} below target {rt} - {TOL}")
    for name in _build.KERNELS:
        if launches[name] < 1:
            failures.append(f"kernel {name} was not launched on the main path")
    if failures:
        return fail("; ".join(failures))

    # -- 3. kernels against their plain versions --------------------------------
    kernels = []
    gen = torch.Generator(device="cpu").manual_seed(0)

    # l2_topk at the fit's ground-truth shape: one query chunk x the database.
    qg = torch.as_tensor(ds.learn[:1024], device=dev)
    x = torch.as_tensor(ds.base, device=dev)
    xsq = (x ** 2).sum(1)
    k = 10
    d_k, i_k = cuda.l2_topk(qg, x, xsq, k)
    torch.cuda.synchronize()
    d_r, i_r = ref.l2_topk_ref(qg, x, xsq, k)
    tol = 1e-3 + 1e-5 * float(xsq.max())
    err, agree, ok = topk_agreement(d_k, i_k, d_r, i_r, tol)
    checks = [{"case": "f32 1024x1M k=10", "max_abs_err": err,
               "id_agreement": agree, "tol": tol}]
    if not ok:
        return fail(f"l2_topk f32 disagrees with plain (err {err}, tol {tol})")
    # k-means assignment shape (k=1), and int8 SQ8 codes.
    xa = x[:65536]
    cents = index.centroids
    d1, i1 = cuda.l2_topk(xa, cents, (cents ** 2).sum(1), 1)
    d1r, i1r = ref.l2_topk_ref(xa, cents, (cents ** 2).sum(1), 1)
    err1, agree1, ok1 = topk_agreement(d1, i1, d1r, i1r, tol)
    checks.append({"case": "f32 65536x1024 k=1", "max_abs_err": err1,
                   "id_agreement": agree1, "tol": tol})
    lo, hi = x.min(0).values, x.max(0).values
    scale = torch.clamp_min((hi - lo) / 254.0, 1e-12)
    offset = (hi + lo) / 2.0
    x8 = torch.clamp(torch.round((x - offset) / scale), -127, 127).to(
        torch.int8)
    xsq8 = ((x8.float() * scale + offset) ** 2).sum(1)
    qa = (qg * scale).contiguous()
    d8, i8 = cuda.l2_topk(qa, x8, xsq8, k)
    d8r, i8r = ref.l2_topk_ref(qa, x8, xsq8, k)
    err8, agree8, ok8 = topk_agreement(d8, i8, d8r, i8r, tol)
    checks.append({"case": "int8 1024x1M k=10", "max_abs_err": err8,
                   "id_agreement": agree8, "tol": tol})
    if not (ok1 and ok8):
        return fail(f"l2_topk disagrees with plain: {checks}")
    b, n, dd = qg.shape[0], x.shape[0], x.shape[1]
    flop = 2.0 * b * n * dd
    byts = 4.0 * (b * dd + n * dd + n) + 8.0 * b * k
    ms = cuda_ms(lambda: cuda.l2_topk(qg, x, xsq, k), 2)
    plain_ms = cuda_ms(lambda: ref.l2_topk_ref(qg, x, xsq, k), 1)
    lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(qg, x) ** 2, k,
                                        largest=False), 1)
    kernels.append({
        "name": "l2_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/l2_topk.cu",
        "replaces": "src/repro/kernels/l2_topk.py:35",
        "launches": launches["l2_topk"], "max_abs_err": max(err, err1, err8),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(flop / F32_FLOP_PER_S, byts / HBM_BYTES_PER_S),
        "bound_by": "operations" if flop / F32_FLOP_PER_S
        > byts / HBM_BYTES_PER_S else "bytes",
        "library_ms": lib_ms, "shape": f"q[{b},{dd}] x[{n},{dd}] k={k}",
        "checks": checks})
    del x8, d_r, i_r

    # bucket_probe: the first probe of a 256-query fit batch, read from the
    # whole bucket store (f32 and SQ8 int8), plus the pre-gathered entry.
    ql = torch.as_tensor(ds.learn[:256], device=dev)
    s0 = ivf.init_state(index, ql, k=10, nprobe=args.nlist)
    s1 = ivf.probe_step(index, s0)   # a filled running top-k
    slot = s1.probe_order[:, 1].contiguous()
    act = torch.ones_like(s1.active)
    kth = s1.topk_d[:, -1:].contiguous()
    store = (index.bucket_vecs, index.bucket_sqnorm, index.bucket_ids)
    pargs = (s1.q, *store, slot, act, s1.qsq, kth, s1.topk_d, s1.topk_i)
    got = cuda.bucket_probe_slots(*pargs)
    torch.cuda.synchronize()
    want = ref.bucket_probe_slots_ref(*pargs)
    btol = 1e-3 + 1e-5 * float(torch.nan_to_num(index.bucket_sqnorm,
                                                 posinf=0).max())
    errb, agreeb, okb = topk_agreement(got[0], got[1], want[0], want[1], btol)
    cnt_diff = int((got[2] - want[2]).abs().max())
    bchecks = [{"case": "f32 store B=256", "max_abs_err": errb,
                "id_agreement": agreeb, "count_max_diff": cnt_diff,
                "tol": btol}]
    sl = slot.long()
    pre = (s1.q, index.bucket_vecs[sl].contiguous(),
           index.bucket_sqnorm[sl].contiguous(),
           index.bucket_ids[sl].contiguous(), s1.qsq, kth, s1.topk_d,
           s1.topk_i)
    gp = cuda.bucket_probe(*pre)
    wp = ref.bucket_probe_ref(*pre)
    errp, agreep, okp = topk_agreement(gp[0], gp[1], wp[0], wp[1], btol)
    bchecks.append({"case": "f32 pre-gathered B=256", "max_abs_err": errp,
                    "id_agreement": agreep, "tol": btol})
    v8 = torch.clamp(torch.round((index.bucket_vecs - offset) / scale),
                     -127, 127).to(torch.int8)
    bias8 = s1.qsq - 2.0 * (s1.q @ offset)[:, None]
    qe = (s1.q * scale).contiguous()
    sq8 = torch.where(index.bucket_ids >= 0,
                      ((v8.float() * scale + offset) ** 2).sum(2),
                      float("inf"))
    a8 = (qe, v8, sq8, index.bucket_ids, slot, act, bias8, kth, s1.topk_d,
          s1.topk_i)
    g8, w8 = cuda.bucket_probe_slots(*a8), ref.bucket_probe_slots_ref(*a8)
    err8b, agree8b, ok8b = topk_agreement(g8[0], g8[1], w8[0], w8[1], btol)
    bchecks.append({"case": "int8 store B=256", "max_abs_err": err8b,
                    "id_agreement": agree8b, "tol": btol})
    if not (okb and okp and ok8b) or cnt_diff > 2:
        return fail(f"bucket_probe disagrees with plain: {bchecks}")
    # Bytes this probe must move: every id of each active query's bucket,
    # the codes and sqnorm of its live rows (pads carry id -1 and distance
    # +inf whatever their codes), the query, and the running top-k in/out.
    rows = int(act.sum())
    cap, code_bytes = index.cap, index.bucket_vecs.element_size()
    live = int((index.bucket_ids[sl[act]] >= 0).sum())
    byts = 4.0 * rows * cap + live * (dd * code_bytes + 4.0) \
        + 4.0 * rows * (dd + 3) + 16.0 * rows * 10
    flop = 2.0 * live * dd
    ms = cuda_ms(lambda: cuda.bucket_probe_slots(*pargs), 50)
    plain_ms = cuda_ms(lambda: ref.bucket_probe_slots_ref(*pargs), 5)
    kernels.append({
        "name": "bucket_probe", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bucket_probe.cu",
        "replaces": "src/repro/kernels/bucket_topk.py:36",
        "launches": launches["bucket_probe"],
        "max_abs_err": max(errb, errp, err8b), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(byts / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S),
        "bound_by": "bytes" if byts / HBM_BYTES_PER_S
        >= flop / F32_FLOP_PER_S else "operations",
        "library_ms": None,
        "shape": f"B={rows} store[{index.nlist},{cap},{dd}] f32 k=10 "
                 f"live_rows={live}",
        "checks": bchecks})
    del v8, sq8

    # gbdt_predict: the fitted predictor on one fit batch of logged features.
    p = trained.predictor.params
    log = darth._last_log
    pick = torch.randint(0, log.features.shape[0], (256,), generator=gen)
    feats = torch.as_tensor(
        log.features[pick.numpy(), torch.arange(256).numpy()], device=dev)
    got = cuda.gbdt_predict(feats, p.feat, p.thresh, p.leaf)
    torch.cuda.synchronize()
    want = ref.gbdt_predict_ref(feats, p.feat, p.thresh, p.leaf)
    errg = float((got - want).abs().max())
    if errg > 1e-5:
        return fail(f"gbdt_predict disagrees with plain: {errg}")
    nt, nint = p.feat.shape
    byts = 4.0 * (2 * nt * nint + nt * (nint + 1)) + 4.0 * 256 * 12
    flop = 256.0 * nt * (p.depth + 1)
    ms = cuda_ms(lambda: cuda.gbdt_predict(feats, p.feat, p.thresh, p.leaf),
                 200)
    plain_ms = cuda_ms(lambda: ref.gbdt_predict_ref(feats, p.feat, p.thresh,
                                                    p.leaf), 50)
    kernels.append({
        "name": "gbdt_predict", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gbdt_predict.cu",
        "replaces": "src/repro/kernels/gbdt_predict.py:24",
        "launches": launches["gbdt_predict"], "max_abs_err": errg,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(byts / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S),
        "bound_by": "bytes" if byts / HBM_BYTES_PER_S
        >= flop / F32_FLOP_PER_S else "operations",
        "library_ms": None,
        "shape": f"x[256,11] trees={nt} depth={p.depth}"})

    kname = torch.cuda.get_device_name(0)
    out = {"card": card, "kind": kname, "torch": torch.__version__,
           "args": vars(args), "main_path": main, "kernels": kernels,
           "launches": launches}
    os.makedirs(os.path.join(HERE, "results"), exist_ok=True)
    with open(os.path.join(HERE, "results", "chip_smoke.json"), "w") as f:
        json.dump(out, f, indent=1, default=float)
    print(json.dumps({"main_path": main}, default=float))
    print(json.dumps({"kernels": kernels}, default=float))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kname,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
