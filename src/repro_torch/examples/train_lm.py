"""End-to-end LM training with fault tolerance (a port of the reference's
``examples/train_lm.py``).

Trains a reduced-width smollm-family model on the deterministic synthetic
token stream, checkpointing every --ckpt-every steps. Kill it at any
point and run it again: it resumes from the last committed checkpoint and
reproduces the exact loss trajectory (the stream's batch is a function
of the step).

The default is laptop-sized; --full trains a ~110M-parameter model.

Run (on the card; --device cpu runs the same on the CPU):
  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--full]
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Any, Dict, List, Optional

from repro_torch import configs
from repro_torch.train import train


def example_config(full: bool = False):
    """(config, global batch, sequence length) of the example."""
    base = configs.get_config("smollm-360m")
    if full:
        return base.scaled(num_layers=12, d_model=768, num_heads=12,
                           num_kv_heads=4, d_ff=2048, vocab_size=32000,
                           head_dim=64), 8, 256
    return base.scaled(num_layers=4, d_model=256, num_heads=4,
                       num_kv_heads=2, d_ff=688, vocab_size=4096,
                       head_dim=64), 8, 128


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--ckpt-dir", type=str, default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=40)
    ap.add_argument("--full", action="store_true",
                    help="~110M params (slow on CPU)")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (then re-run)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    cfg, batch, seq = example_config(args.full)
    out = train(cfg, steps=args.steps, global_batch=batch, seq_len=seq,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                peak_lr=1e-3, fail_at=args.fail_at, log_every=10,
                device=args.device)
    hist = out["history"]
    print(f"\nstep {hist[0]['step']}: loss={hist[0]['loss']:.3f}  ->  "
          f"step {hist[-1]['step']}: loss={hist[-1]['loss']:.3f} "
          f"({out['seconds']:.0f}s)")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError("loss should fall")
    print("checkpoints in", args.ckpt_dir,
          "- kill and re-run to see restart-exact resume")
    return out


if __name__ == "__main__":
    main()
