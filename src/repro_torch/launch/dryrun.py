"""Multi-pod dry run (a port of the reference's ``repro/launch/dryrun.py``):
trace every (architecture x input shape x mesh) cell on the production
mesh of 256 or 512 fake ranks and record per-device memory, flops, bytes
and collective traffic.

The reference lowers and compiles each cell with 512 placeholder host
devices. Here the process opens a world of fake ranks first
(``torch.distributed``'s "fake" backend: every collective is a no-op),
builds the production ``DeviceMesh`` on it, and, under
``FakeTensorMode`` (shapes and dtypes only, nothing allocated), places
``model_zoo.abstract_params`` / ``input_specs`` by the sharding rules
and runs the whole step on rank 0 inside ``use_mesh(mesh, sp=...)``: the
train step (loss, backward, clip, optimizer), the prefill step or the
one-token serve step. What rank 0 runs is what one device of the mesh
runs:

- ``memory``: ``argument_bytes`` and ``output_bytes`` are the local
  shards' bytes of the placed inputs and of the step's outputs;
  ``peak_bytes`` is ``MemTracker``'s peak over the step (the arguments
  included) and ``temp_bytes`` the peak less the arguments;
- ``hlo_flops``, ``hlo_bytes`` and ``collectives`` come from
  ``utils.opcount`` (counted op by op as the step runs; no HLO exists);
- ``trace_seconds`` is the wall of that run (the reference's lower and
  compile seconds). XLA's own ``cost_analysis`` numbers (the
  reference's ``flops`` and ``bytes_accessed``) have no counterpart.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k [--multi-pod]           # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --out results/dryrun_torch.json          # full sweep, both meshes
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell, runnable
from repro_torch.dist import sharding as sh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model_zoo
from repro_torch.optim.tree import tree_map
from repro_torch.train import step as step_lib
from repro_torch.utils import meshctx, opcount


def open_fake_world(size: int) -> None:
    """Make the default process group a world of ``size`` fake ranks,
    this process rank 0 (a standing group of another size is closed
    first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _leaves(tree):
    """Every tensor of a nested dict / tuple / list."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree's tensors (a DTensor's shard)."""
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in _leaves(tree))


def _placed(meta_tree, shardings):
    """Fake tensors of ``meta_tree``'s shapes and dtypes, placed."""
    return sh.distribute(tree_map(lambda m: torch.empty(
        m.shape, dtype=m.dtype), meta_tree), shardings)


def _memory_tracker():
    """A ``MemTracker`` that leaves out DTensor's sharding propagation (its
    global-shape runs are not the program's; ``opcount.in_propagation``)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if opcount.in_propagation():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)
    return Tracker()


def sequence_parallel(cfg: ArchConfig, cell: ShapeCell) -> bool:
    """The reference's rule: sequence parallelism for the attention
    families' train and prefill; not for ssm / hybrid, whose causal conv
    and chunked scans need the whole sequence on a device."""
    return (cell.kind in ("train", "prefill")
            and cfg.family in ("dense", "moe", "vlm", "audio"))


def trace(cfg: ArchConfig, cell: ShapeCell, mesh,
          overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Trace one cell of ``cfg`` on ``mesh`` (a ``DeviceMesh`` over the
    standing process group, this process its rank 0) under
    ``FakeTensorMode``; returns the record's measured part (module
    docstring)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    overrides = overrides or {}
    with FakeTensorMode(), opcount.cached_planning():
        params_abs = model_zoo.abstract_params(cfg)
        p_shard = sh.param_shardings(params_abs, mesh)
        params = _placed(params_abs, p_shard)
        specs = model_zoo.input_specs(cfg, cell.seq_len, cell.global_batch,
                                      cell.kind)
        if cell.kind == "train":
            init_opt, step = step_lib.make_train_step(cfg, **overrides)
            opt_abs = init_opt(params_abs)
            opt = _placed(opt_abs, sh.opt_shardings(opt_abs, params_abs,
                                                    mesh))
            batch = _placed(specs["batch"], sh.batch_shardings(
                specs["batch"], mesh, "train"))
            args = (params, opt, batch)
        elif cell.kind == "prefill":
            step = step_lib.make_prefill_step(cfg)
            batch = _placed(specs["batch"], sh.batch_shardings(
                specs["batch"], mesh, "prefill"))
            args = (params, batch)
        else:
            step = step_lib.make_serve_step(cfg)
            cache = _placed(specs["cache"], sh.cache_shardings(
                specs["cache"], mesh))
            tokens = _placed({"t": specs["tokens"]}, sh.batch_shardings(
                {"t": specs["tokens"]}, mesh, "decode"))["t"]
            args = (params, cache, tokens, cell.seq_len - 1)
        arg_bytes = local_bytes(args[:3])
        tracker = _memory_tracker()
        tracker.track_external(*_leaves(args))
        counter = opcount.OpCount()
        t0 = time.time()
        with meshctx.use_mesh(mesh, sp=sequence_parallel(cfg, cell)):
            with tracker, counter:
                out = step(*args)
        seconds = time.time() - t0
        peak = max((snap.get("Total", 0) for snap in
                    tracker.get_tracker_snapshot("peak").values()),
                   default=0)
    analysis = counter.result()
    return {
        "trace_seconds": round(seconds, 1),
        # per device, counted op by op (utils.opcount)
        "hlo_flops": analysis["flops"],
        "hlo_bytes": analysis["hbm_bytes"],
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": local_bytes(out),
                   "temp_bytes": max(peak - arg_bytes, 0),
                   "peak_bytes": peak},
        "collectives": {k: analysis[k] for k in
                        list(opcount.COLLECTIVES) + ["num_ops", "total"]},
        "num_devices": int(mesh.size()),
    }


def trace_cell(arch: str, shape: str, *, multi_pod: bool,
               overrides: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """One cell on the production mesh (the world is opened at its
    size); the record, "skipped" where ``runnable`` says so."""
    cfg = configs.get_config(arch)
    cell = SHAPES[shape]
    ok, reason = runnable(cfg, cell)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16", "kind": cell.kind}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    size = 512 if multi_pod else 256
    open_fake_world(size)
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                         device_type="cpu")
    rec.update(status="ok", **trace(cfg, cell, mesh, overrides))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep all arch x shape x {single,multi}-pod")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--out", type=str, default="results/dryrun_torch.json")
    args = ap.parse_args()
    # The fake world opens before anything else touches torch.distributed.
    open_fake_world(512 if args.multi_pod and not args.all else 256)

    cells = []
    if args.all:
        for arch in configs.ALL_ARCHS:
            for shape in SHAPES:
                cells.append((arch, shape, False))
                if not args.single_pod_only:
                    cells.append((arch, shape, True))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells.append((args.arch, args.shape, args.multi_pod))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    for arch, shape, mp in cells:
        key = (arch, shape, "2x16x16" if mp else "16x16")
        if key in done:
            print(f"[skip-done] {key}")
            continue
        print(f"[dryrun] {key} ...", flush=True)
        try:
            rec = trace_cell(arch, shape, multi_pod=mp)
        except Exception as e:  # record failures, keep sweeping
            rec = {"arch": arch, "shape": shape,
                   "mesh": key[2], "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        status = rec["status"]
        if status == "ok":
            extra = (f" flops={rec['hlo_flops']:.3g}"
                     f" coll={rec['collectives']['total']:.3g}B"
                     f" trace={rec['trace_seconds']}s")
        elif status == "skipped":
            extra = f" ({rec['reason'][:60]})"
        else:
            extra = f" ({rec['error'][:120]})"
        print(f"[dryrun] {key} -> {status}{extra}", flush=True)
        print(json.dumps(rec), flush=True)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\nDONE: {n_ok} ok, {n_skip} skipped (documented), {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
