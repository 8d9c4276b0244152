"""The LM architectures (``get_config("<id>")``) and shape cells: a copy
of the reference's ``repro.configs``, field for field, so that the port
needs nothing of the JAX package.

Importing this package populates the registry with all 10 architectures.
"""
from repro_torch.configs.base import (ArchConfig, SHAPES, ShapeCell,
                                      get_config, list_configs, register,
                                      runnable)

# populate registry
from repro_torch.configs import (glm4_9b, internvl2_26b, kimi_k2_1t_a32b,
                                 olmo_1b, qwen3_moe_30b_a3b, rwkv6_3b,
                                 smollm_360m, starcoder2_3b, whisper_base,
                                 zamba2_1p2b)

ALL_ARCHS = tuple(sorted([
    internvl2_26b.CONFIG.name, zamba2_1p2b.CONFIG.name,
    qwen3_moe_30b_a3b.CONFIG.name, kimi_k2_1t_a32b.CONFIG.name,
    glm4_9b.CONFIG.name, smollm_360m.CONFIG.name, olmo_1b.CONFIG.name,
    starcoder2_3b.CONFIG.name, rwkv6_3b.CONFIG.name, whisper_base.CONFIG.name,
]))

__all__ = ["ArchConfig", "SHAPES", "ShapeCell", "get_config", "list_configs",
           "register", "runnable", "ALL_ARCHS"]
