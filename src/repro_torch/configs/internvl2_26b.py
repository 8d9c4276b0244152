"""internvl2-26b — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

The assignment specifies the transformer BACKBONE only; the InternViT
frontend is a stub (`input_specs()` provides precomputed patch embeddings
that a linear connector projects into the LM sequence).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    frontend="vision_stub",
    frontend_dim=3200,      # InternViT-6B embedding width
    frontend_len=256,       # patch tokens per image after pixel-shuffle
    sub_quadratic=False,
    source="arXiv:2404.16821; hf",
))
