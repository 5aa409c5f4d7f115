"""Deterministic straggler / delay injection.

Parity: the ASYNC drivers' simulation of slow workers
(``SparkASGDThread.scala:121-138`` for cohort construction,
``:284-309`` for the injected sleeps):

- ``coeff > 0``: worker 0 sleeps ``coeff * avg_delay`` each round (a single
  deterministic straggler whose slowness scales with measured average task
  latency);
- ``coeff == -1`` ("cloud mode", long-tail): 25% of workers are stragglers --
  of those, 80% sleep ``U(1.5, 2.5) * avg_delay`` and the rest sleep
  ``U(2.5, 10) * avg_delay``; straggler worker ids follow the reference's
  ``c * 4`` spacing pattern;
- delays activate only after the calibration phase (first ``100 * num_workers``
  accepted updates measure ``avg_delay``).

Delta from the reference: the per-round multipliers draw from a seeded
``numpy`` Generator instead of an unseeded ``java.util.Random``, so runs are
reproducible; staleness on real hardware also arises naturally from compute-time
variance -- this module only *adds* controlled skew.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


def build_cloud_stragglers(num_workers: int) -> Tuple[List[int], List[int]]:
    """Reference cohort construction (``SparkASGDThread.scala:126-138``):
    ``length = round(0.25 * n)`` stragglers; first ``length - round(0.8*length)``
    of the ``c*4`` id sequence are long-tail, the rest normal."""
    length = int(round(0.25 * num_workers))
    length_normal = int(round(0.8 * length))
    length_long_tail = length - length_normal
    long_tail = [c * 4 for c in range(0, length_long_tail)]
    normal = [c * 4 for c in range(length_long_tail, length)]
    return normal, long_tail


@dataclass
class DelayModel:
    """Computes the injected delay (ms) for a worker in one round."""

    coeff: float
    num_workers: int
    seed: int = 42
    avg_delay_ms: float = 0.0
    calibrated: bool = False
    _rng: np.random.Generator = field(default=None, repr=False)  # type: ignore
    _normal: List[int] = field(default_factory=list)
    _long_tail: List[int] = field(default_factory=list)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        if self.cloud_mode:
            self._normal, self._long_tail = build_cloud_stragglers(self.num_workers)

    @property
    def cloud_mode(self) -> bool:
        return self.coeff == -1

    @property
    def enabled(self) -> bool:
        return self.coeff != 0

    def calibrate(self, avg_delay_ms: float) -> None:
        """Fix the average-delay scale after the measurement phase."""
        self.avg_delay_ms = avg_delay_ms
        self.calibrated = True

    def delay_ms(self, worker_id: int) -> float:
        """Delay to inject for this worker this round (0 before calibration)."""
        if not self.enabled or not self.calibrated:
            return 0.0
        if not self.cloud_mode:
            if worker_id == 0 and self.coeff > 0:
                return float(round(self.coeff * self.avg_delay_ms))
            return 0.0
        if worker_id in self._long_tail:
            c = self._rng.random() * 7.5 + 2.5
            return float(round(c * self.avg_delay_ms))
        if worker_id in self._normal:
            c = self._rng.random() + 1.5
            return float(round(c * self.avg_delay_ms))
        return 0.0
