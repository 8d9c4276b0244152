"""The LM serving path on PyTorch (a port of the reference's
``repro.models`` for all six families: dense, VLM, MoE, RWKV-6 ``ssm``,
zamba2 ``hybrid`` and whisper ``audio``), and its loss and gradients:
``layers``, ``linear_attn``, ``transformer``, ``moe`` and
``model_zoo``."""
