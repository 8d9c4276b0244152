"""whisper-base — enc-dec, conv frontend (stub) [arXiv:2212.04356;
unverified]. input_specs() provides precomputed frame embeddings."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,            # decoder layers
    encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    mlp="gelu",
    frontend="audio_stub",
    frontend_dim=512,        # post-conv frame embedding width
    frontend_len=1500,       # 30 s of audio at 50 Hz
    rope_theta=0.0,          # whisper uses learned/sinusoidal abs positions
    source="arXiv:2212.04356; unverified",
))
