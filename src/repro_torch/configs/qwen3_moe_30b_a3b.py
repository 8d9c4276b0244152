"""qwen3-moe-30b-a3b — 128 experts, top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,               # per-expert FFN width (assignment table)
    vocab_size=151936,
    head_dim=128,           # Qwen3 uses head_dim 128 (> d_model/heads)
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
