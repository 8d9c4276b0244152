"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8
[arXiv:2501.kimi2; unverified (paper-table)]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,              # per-expert FFN width (assignment table)
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    source="arXiv:2501.kimi2; unverified",
))
