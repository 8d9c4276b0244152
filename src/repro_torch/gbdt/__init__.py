"""Histogram GBDT: the recall predictor's model, inference and trainer,
and the paper's §4.1.5 comparison models."""
from repro_torch.gbdt.model import GBDTParams, from_state_dict, to_state_dict
from repro_torch.gbdt.train import (GBDTConfig, LinearModel, fit,
                                    fit_decision_tree, fit_linear,
                                    fit_random_forest)
from repro_torch.gbdt.infer import predict, predict_efficient

__all__ = [
    "GBDTParams", "GBDTConfig", "LinearModel", "fit",
    "fit_decision_tree", "fit_linear", "fit_random_forest", "predict",
    "predict_efficient", "to_state_dict", "from_state_dict",
]
