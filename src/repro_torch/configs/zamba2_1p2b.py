"""zamba2-1.2b — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf]. Hybrid: sub-quadratic (runs long_500k)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,          # Mamba2 blocks
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,              # shared-attn block MLP width
    vocab_size=32000,
    ssm_state=64,
    attn_every=6,           # one shared attention application per 6 blocks
    sub_quadratic=True,
    source="arXiv:2411.15242; hf",
))
