"""starcoder2-3b — GQA, RoPE [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    mlp="gelu",
    source="arXiv:2402.19173; hf",
))
