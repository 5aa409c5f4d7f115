"""Solvers: ASGD and ASAGA (async and sync) and the shared configuration
types."""

from asyncframework_tpu_torch.solvers.asaga import ASAGA
from asyncframework_tpu_torch.solvers.asgd import ASGD
from asyncframework_tpu_torch.solvers.base import SolverConfig, TrainResult

__all__ = ["ASAGA", "ASGD", "SolverConfig", "TrainResult"]
