"""DARTH core: declarative recall through early termination, with the
paper's competitors (``baselines``) and quality metrics (``metrics``)."""
from repro_torch.core import baselines, metrics

__all__ = ["baselines", "metrics"]
