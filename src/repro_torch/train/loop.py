"""The training loop with fault tolerance (a port of the reference's
``repro/train/loop.py``): checkpoint and restart, failure injection, and
a restart-exact data order (the stream's batch is a function of the
step). The launcher (``repro_torch.launch.train``) runs this loop.

Contract (tests/test_torch_train.py): kill the loop at step K
(``fail_at`` or the ``REPRO_FAIL_AT_STEP`` environment variable),
restart, and the loss trajectory and the final parameters equal an
uninterrupted run's bit for bit; checkpoints are atomic.

With a ``mesh`` (a ``DeviceMesh``) the loop runs as the reference's
launcher does under its mesh: parameters and optimizer state placed by
``dist.sharding``'s rules, each step under ``use_mesh(mesh, sp=True)``,
checkpoints de-sharded and restored to the same placements. On the
(1, 1) host mesh every placement replicates and the run equals the
loop without a mesh bit for bit.
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch import ckpt
from repro_torch.configs.base import ArchConfig
from repro_torch.data.synthetic import PipelineConfig, TokenPipeline
from repro_torch.models import model_zoo
from repro_torch.dist import sharding as sh
from repro_torch.train import step as step_lib
from repro_torch.utils import meshctx


LogFn = Callable[[Dict[str, float], float], None]   # (row, wall seconds)


class SimulatedFailure(RuntimeError):
    pass


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, names in os.walk(path) for name in names)


def train(cfg: ArchConfig, *, steps: int, global_batch: int, seq_len: int,
          ckpt_dir: str, ckpt_every: int = 50, keep: int = 3,
          peak_lr: float = 3e-4, seed: int = 0,
          fail_at: Optional[int] = None, log_every: int = 10,
          compress_grads: bool = False,
          on_log: Optional[LogFn] = None,
          device="cuda", mesh=None) -> Dict[str, Any]:
    """Train ``cfg`` from ``init_params(cfg, seed)`` on ``device`` for
    ``steps`` steps (resuming from the newest committed checkpoint in
    ``ckpt_dir``, at its ``extra["next_step"]``), checkpointing every
    ``ckpt_every`` steps and at the end. Every ``log_every``-th step and
    the last read the device's metrics into a row of floats with "step",
    handed to ``on_log`` with the row's wall (the seconds since the
    previous row, checkpoint saves left out: with ``log_every=1`` each
    step's own wall). Returns {"history": the rows, "walls": their walls,
    "start_step", "checkpoints": per save {step, seconds, bytes, path},
    "params", "opt_state", "seconds"}. With ``mesh`` (module docstring)
    the trees returned are DTensors and each row's metrics are read
    whole."""
    pipe = TokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed), device=device)
    init_opt, train_step_fn = step_lib.make_train_step(
        cfg, peak_lr=peak_lr, compress_grads=compress_grads)

    params = model_zoo.init_params(cfg, seed, device=device)
    opt_state = init_opt(params)
    placed = None
    if mesh is not None:
        placed = (sh.param_shardings(params, mesh),
                  sh.opt_shardings(opt_state, params, mesh))
        params = sh.distribute(params, placed[0])
        opt_state = sh.distribute(opt_state, placed[1])
    start_step = 0
    if ckpt.latest_step(ckpt_dir) is not None:
        (params, opt_state), meta = ckpt.restore(
            ckpt_dir, (params, opt_state), shardings=placed)
        start_step = int(meta["extra"]["next_step"])

    env_fail = os.environ.get("REPRO_FAIL_AT_STEP")
    if fail_at is None and env_fail:
        fail_at = int(env_fail)

    history: List[Dict[str, float]] = []
    walls: List[float] = []
    saves: List[Dict[str, Any]] = []

    def save(at: int) -> None:
        t = time.time()
        path = ckpt.save(ckpt_dir, at, (params, opt_state),
                         extra={"next_step": at,
                                "pipeline": pipe.state_dict(at)}, keep=keep)
        saves.append({"step": at, "seconds": time.time() - t,
                      "bytes": _dir_bytes(path), "path": path})

    def batch_at(s: int):
        batch = pipe.get_batch(s)
        if mesh is None:
            return batch
        return sh.distribute(batch, sh.batch_shardings(batch, mesh))

    t0 = t_mark = time.time()
    for s in range(start_step, steps):
        if fail_at is not None and s == fail_at:
            raise SimulatedFailure(f"injected failure at step {s}")
        with meshctx.use_mesh(mesh, sp=True):
            params, opt_state, metrics = train_step_fn(params, opt_state,
                                                       batch_at(s))
        if s % log_every == 0 or s == steps - 1:
            m = {k: float(v) for k, v in sh.gather(metrics).items()}
            m["step"] = s
            history.append(m)
            walls.append(time.time() - t_mark)
            if on_log is not None:
                on_log(m, walls[-1])
            t_mark = time.time()
        if ckpt_every and (s + 1) % ckpt_every == 0:
            save(s + 1)
            t_mark = time.time()
    # the final save, unless the last step's save just wrote these trees
    if ckpt_every and not (saves and saves[-1]["step"] == steps):
        save(steps)
    return {"history": history, "walls": walls, "start_step": start_step,
            "checkpoints": saves, "params": params, "opt_state": opt_state,
            "seconds": time.time() - t0}
