"""The LM serving path on PyTorch (a port of the reference's
``repro.models`` for the dense, VLM and MoE families): ``layers``,
``transformer``, ``moe`` and ``model_zoo``."""
