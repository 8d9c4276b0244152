"""LM training on one device (a port of the reference's ``repro.train``):
the train step (``step``) and the fault-tolerant loop (``loop``)."""
from repro_torch.train import loop, step
from repro_torch.train.loop import SimulatedFailure, train
from repro_torch.train.step import make_train_step, optimizer_for

__all__ = ["loop", "step", "train", "SimulatedFailure", "make_train_step",
           "optimizer_for"]
