#!/usr/bin/env python3
"""What does the LM cost on the host, before and after a change, and what
does the host mesh add to a training step? On one NVIDIA card:

    python3 tools/lm_host_timing.py --parent DIR

DIR is an unpacked older tree of the repository (``git archive``). In
turns (``--turns``, by default parent, change, change, parent, parent,
change), a fresh process on each tree's ``src`` serves ``chip_smoke.py``'s
phase 12 / 13 shapes without a mesh (smollm-360m and zamba2-1.2b at their
registered widths and depths from ``init_params(seed=0)``: prefill of
8 x 2048 seeded tokens, three times, tokens/s; a 64-token prompt
through ``decode_step`` then 64 greedy tokens at B 8, S_max 128, each
token timed to the card's end, the median and mean ms a token) and
trains the example's config (4 layers, d_model 256, B 8 x S 128) for 16
steps through ``train.loop.train`` without a mesh (each step's wall).

Then, on this tree alone, the same 8 steps in a world of one NCCL rank,
plain and on the (1, 1) host mesh (``launch.train.launch_mesh``), in
turns plain, mesh, mesh, plain, nothing else running. Steps 4 and 5 of
each run are profiled (``torch.profiler`` with Python stacks, the host
and the card): the device's kernel time, and the host's self time by
where it ran (DTensor's Python under ``torch/distributed/tensor``, the
port's Python, other Python, aten ops, the rest), each a step, and the
number of threads on which DTensor's Python ran (the backward runs on
the autograd engine's). The Python tracer slows the profiled steps:
read their shares, and the unprofiled steps' walls.

One JSON line per run, the card's name and power limit first. It
imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SERVE = r'''
import json, statistics, tempfile, time, torch
from repro_torch import configs
from repro_torch.examples import train_lm
from repro_torch.models import model_zoo
from repro_torch.train import loop

def sync():
    torch.cuda.synchronize()

out = {}
for arch in ("smollm-360m", "zamba2-1.2b"):
    cfg = configs.get_config(arch)
    params = model_zoo.init_params(cfg, seed=0, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (8, 2048),
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32).cuda()
    model_zoo.prefill(cfg, params, {"tokens": toks[:1, :64]})
    pre = []
    for _ in range(3):
        sync(); t0 = time.time()
        model_zoo.prefill(cfg, params, {"tokens": toks})
        sync(); pre.append(toks.numel() / (time.time() - t0))
    cache = model_zoo.make_cache(cfg, 8, 128, device="cuda")
    prompt, greedy = [], []
    sync()
    for t in range(64):
        t0 = time.time()
        logits, cache = model_zoo.decode_step(cfg, params, cache,
                                              toks[:, t:t + 1], t)
        sync(); prompt.append(1e3 * (time.time() - t0))
    tok = logits.argmax(-1)[:, None]
    for t in range(64):
        t0 = time.time()
        logits, cache = model_zoo.decode_step(cfg, params, cache, tok, 64 + t)
        tok = logits.argmax(-1)[:, None]
        sync(); greedy.append(1e3 * (time.time() - t0))
    out[arch] = {"prefill_tokens_per_s": pre,
                 "prompt_ms_per_token": [statistics.median(prompt),
                                         statistics.mean(prompt)],
                 "greedy_ms_per_token": [statistics.median(greedy),
                                         statistics.mean(greedy)]}
    del params, cache
    torch.cuda.empty_cache()
cfg, b, s = train_lm.example_config()
res = loop.train(cfg, steps=16, global_batch=b, seq_len=s,
                 ckpt_dir=tempfile.mkdtemp(), ckpt_every=0, peak_lr=1e-3,
                 log_every=1, device="cuda")
out["train_step_walls_s"] = res["walls"]
print(json.dumps(out))
'''

_MESH = r'''
import json, tempfile, time, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.examples import train_lm
from repro_torch.launch import train as launch
from repro_torch.train import loop

cfg, b, s = train_lm.example_config()

def run(mesh):
    walls, marks = [], {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   with_stack=True)

    def log(m, wall):
        walls.append(wall)
        if m["step"] == 3:
            torch.cuda.synchronize()
            prof.start()
            for _ in range(512):       # the profiler's first records drop
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            marks["t0"] = time.time()
        elif m["step"] == 5:
            torch.cuda.synchronize()
            marks["t1"] = time.time()
            prof.stop()
    loop.train(cfg, steps=8, global_batch=b, seq_len=s,
               ckpt_dir=tempfile.mkdtemp(), ckpt_every=0, peak_lr=1e-3,
               log_every=1, on_log=log, device="cuda", mesh=mesh)
    self_us, other, threads, kernel_us = {}, {}, set(), 0.0
    for e in prof.events():
        if "CUDA" in str(e.device_type):
            if "spin" not in e.name and "sleep" not in e.name:
                kernel_us += e.time_range.elapsed_us()
            continue
        kind = ("dtensor_py" if "torch/distributed/tensor" in e.name
                else "repro_torch_py" if "repro_torch/" in e.name
                else "other_py" if ".py(" in e.name
                or e.name.startswith("<built-in") else "aten"
                if e.name.startswith("aten::") else "other")
        self_us[kind] = self_us.get(kind, 0.0) + e.self_cpu_time_total
        if kind == "other":
            other[e.name] = other.get(e.name, 0.0) + e.self_cpu_time_total
        if kind == "dtensor_py":
            threads.add(e.thread)
    steps = 2
    return {"mesh": None if mesh is None else str(tuple(mesh.shape)),
            "step_walls_s": walls,
            "profiled_wall_s_a_step": (marks["t1"] - marks["t0"]) / steps,
            "kernel_ms_a_step": kernel_us / 1e3 / steps,
            "host_self_ms_a_step": {k: v / 1e3 / steps
                                    for k, v in sorted(self_us.items())},
            "dtensor_threads": len(threads),
            "top_other_ms_a_step": {
                k: v / 1e3 / steps for k, v in sorted(
                    other.items(), key=lambda kv: -kv[1])[:8]}}

rows = []
with launch.world_of_one("cuda"):
    mesh = launch.launch_mesh(torch.device("cuda"))
    for m in (None, mesh, mesh, None):
        rows.append(run(m))
print(json.dumps(rows))
'''


def child(code, tree):
    env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tree,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--turns", default="parent,change,change,parent,parent,"
                                       "change")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lm_host_timing: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    for turn in args.turns.split(","):
        print(json.dumps({"tree": turn, "serve": child(_SERVE, trees[turn])}),
              flush=True)
    for row in child(_MESH, ROOT):
        print(json.dumps({"tree": "change", "host_mesh": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
