"""rwkv6-3b — Finch: attention-free, data-dependent decay
[arXiv:2404.05892; hf]. Sub-quadratic (runs long_500k)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,           # head_dim 64 (rwkv6 standard)
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    head_dim=64,
    ssm_state=64,
    sub_quadratic=True,
    source="arXiv:2404.05892; hf",
))
