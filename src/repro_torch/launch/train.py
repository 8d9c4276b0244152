"""The mesh-aware LM training launcher (a port of the reference's
``repro/launch/train.py``): the same flags and print lines over the loop
of ``repro_torch.train.loop`` (resume from the newest checkpoint, a
checkpoint every ``--ckpt-every`` steps and one at the end).

As the reference does, it runs under a mesh: the host mesh (1, 1) in a
world of one rank, the production mesh (16 x 16) in a world of 256 or
(2 x 16 x 16) 512; any other world raises. Parameters and optimizer
state are placed by ``dist.sharding``'s rules, each step runs under
``use_mesh(mesh, sp=True)`` and a resume restores to the same
placements. Without a standing process group it opens a world of one
rank on ``--device`` (NCCL on the card, gloo on the CPU) and closes it
at the end. On the host mesh every placement replicates, so a run
equals the loop without a mesh bit for bit.

Usage (on the card; ``--device cpu`` runs the same on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --steps 100 --global-batch 8 --seq-len 128 --scale 0.1
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch import ckpt, configs
from repro_torch.dist import sharding as sh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.train import loop


def reduced(cfg, scale: float):
    """Width/depth-scaled variant for CPU-sized runs (scale=1 -> full)."""
    if scale >= 1.0:
        return cfg

    def r(v, m=1):
        return max(m, int(v * scale))
    return cfg.scaled(
        num_layers=r(cfg.num_layers, 2),
        d_model=r(cfg.d_model // 64, 1) * 64,
        num_heads=r(cfg.num_heads, 2),
        num_kv_heads=max(1, min(r(cfg.num_kv_heads, 1), r(cfg.num_heads, 2))),
        d_ff=r(cfg.d_ff // 64, 2) * 64,
        vocab_size=min(cfg.vocab_size, 8192),
        num_experts=r(cfg.num_experts, 4) if cfg.num_experts else 0,
        moe_d_ff=r(cfg.moe_d_ff // 32, 2) * 32 if cfg.moe_d_ff else 0,
        ssm_state=min(cfg.ssm_state, 32) if cfg.ssm_state else 0,
        encoder_layers=r(cfg.encoder_layers, 1) if cfg.encoder_layers else 0,
        frontend_len=min(cfg.frontend_len, 16) if cfg.frontend_len else 0,
        frontend_dim=min(cfg.frontend_dim, 64) if cfg.frontend_dim else 0,
    )


def _describe(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


@contextlib.contextmanager
def world_of_one(device):
    """A process group of one rank on ``device``'s backend (NCCL on the
    card, gloo on the CPU; an in-process store: no address, no port) for
    the block, unless one stands already; closed after the block if it
    was opened here."""
    device = torch.device(device)
    if dist.is_initialized():
        yield
        return
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def launch_mesh(device: torch.device):
    """The reference's choice: the host mesh in a world of 1, the
    production mesh in a world of 256 (512: two pods); any other world
    raises."""
    world = dist.get_world_size()
    if world == 1:
        return mesh_lib.make_host_mesh(device.type)
    if world in (256, 512):
        return mesh_lib.make_production_mesh(multi_pod=world == 512,
                                             device_type=device.type)
    raise ValueError(f"a world of {world} ranks: the launcher runs on the "
                     f"host mesh (1 rank) or the production mesh (256 or "
                     f"512)")


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Parse ``argv`` (the command line when None), train, print the
    reference's lines and return {"config", "mesh", "start_step", "steps":
    per step {step, loss, grad_norm, lr, ..., wall_s}, "checkpoints": per
    save {step, seconds, bytes, path}, "peak_bytes" (None off the card),
    "params", "opt_state"}. Each step's metrics are read when it ends, so
    its wall is the step's own. The trees come back whole (plain
    tensors), gathered before the world closes."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=configs.ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--scale", type=float, default=0.1,
                    help="model width/depth scale (1.0 = full config)")
    ap.add_argument("--ckpt-dir", type=str, default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--peak-lr", type=float, default=1e-3)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    torch.empty(0, device=device)            # an unusable device raises here
    cfg = reduced(configs.get_config(args.arch), args.scale)
    with world_of_one(device):
        return _run(args, cfg, device)


def _run(args, cfg, device: torch.device) -> Dict[str, Any]:
    mesh = launch_mesh(device)
    print(f"[train] {cfg.name} scale={args.scale} on {_describe(device)}, "
          f"{mesh_lib.describe(mesh)}", flush=True)
    resumed = ckpt.latest_step(args.ckpt_dir)   # step N resumes at N
    if resumed is not None:
        print(f"[train] resumed from step {resumed}", flush=True)
    walls: List[float] = []

    def log(m: Dict[str, float], wall: float) -> None:
        walls.append(wall)
        s = m["step"]
        if s % 10 == 0 or s == args.steps - 1:
            print(f"step {s:5d} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.2f} "
                  f"({sum(walls) / len(walls):.2f}s/step)", flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = loop.train(cfg, steps=args.steps, global_batch=args.global_batch,
                     seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, peak_lr=args.peak_lr,
                     log_every=1, on_log=log, device=device, mesh=mesh)
    print("[train] done", flush=True)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    return {"config": cfg, "mesh": mesh_lib.describe(mesh),
            "start_step": out["start_step"],
            "steps": [dict(m, wall_s=w)
                      for m, w in zip(out["history"], out["walls"])],
            "checkpoints": out["checkpoints"], "peak_bytes": peak,
            "params": sh.gather(out["params"]),
            "opt_state": sh.gather(out["opt_state"])}


if __name__ == "__main__":
    main()
