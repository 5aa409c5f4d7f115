"""Solvers: ASGD and ASAGA (async and sync), the synchronous MiniBatchSGD
baseline, and the shared configuration types."""

from asyncframework_tpu_torch.solvers.asaga import ASAGA
from asyncframework_tpu_torch.solvers.asgd import ASGD
from asyncframework_tpu_torch.solvers.base import SolverConfig, TrainResult
from asyncframework_tpu_torch.solvers.minibatch_sgd import MiniBatchSGD

__all__ = ["ASAGA", "ASGD", "MiniBatchSGD", "SolverConfig", "TrainResult"]
