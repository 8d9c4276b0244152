#!/usr/bin/env python3
"""Where do phase 13's card-vs-CPU gates lie across weight draws? For
rwkv6-3b at 2 layers and zamba2-1.2b at 7 (``chip_smoke.py``'s
FAM_GATE_LAYERS, full width), each seed's ``init_params`` and seeded
tokens (B 1 x S 64, FAM_VS_CPU) go through ``prefill`` on the card and on
the CPU: as shipped (bf16) and with the model computing in f32, each
beside its TF32 control (the card with TF32 matmuls allowed). One JSON
line per (arch, seed), the card's name and power limit first:

    python3 tools/lm_gate_seeds.py [--seeds 8]

A gate separates on a draw when its sound reading lies within the bound
and its control outside it. It needs one NVIDIA card and imports nothing
of JAX.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lm_gate_seeds: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.models import model_zoo
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__,
                      "bf16_bound": cs.FAM_VS_CPU_BOUND,
                      "f32_bound": cs.FAM_F32_BOUND}), flush=True)
    vb, vs = cs.FAM_VS_CPU
    for arch in (cs.SSM_ARCH, cs.HYBRID_ARCH):
        cfg = configs.get_config(arch).scaled(
            num_layers=cs.FAM_GATE_LAYERS[arch])
        for seed in range(args.seeds):
            t0 = time.time()
            params = model_zoo.init_params(cfg, seed=seed, device="cuda")
            toks = cs._seeded_tokens(cfg, (vb, vs),
                                     torch.Generator().manual_seed(seed))
            batch = {"tokens": toks}
            bf16 = cs._vs_cpu(cfg, params, batch, cs.FAM_VS_CPU_BOUND,
                              tf32_control=True)
            f32 = cs._vs_cpu_f32(cfg, params, batch, cs.FAM_F32_BOUND)
            print(json.dumps({
                "arch": arch, "layers": cfg.num_layers, "seed": seed,
                "bf16": bf16["max_abs_err"],
                "bf16_tf32_control": bf16["tf32_control"]["max_abs_err"],
                "f32": f32["max_abs_err"],
                "f32_tf32_control": f32["tf32_control"]["max_abs_err"],
                "f32_logits_max_abs": f32["logits_max_abs"],
                "seconds": time.time() - t0}), flush=True)
            del params
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
