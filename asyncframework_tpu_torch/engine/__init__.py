"""The in-process engine: jobs, executors, scheduling, liveness, recovery,
speculation, dynamic allocation and accumulators."""

from asyncframework_tpu_torch.engine.job import Job, JobWaiter, TaskSpec
from asyncframework_tpu_torch.engine.executor import (
    DeviceExecutor,
    ExecutorPool,
    TaskMetrics,
)
from asyncframework_tpu_torch.engine.scheduler import JobScheduler
from asyncframework_tpu_torch.engine.barrier import partial_barrier
from asyncframework_tpu_torch.engine.straggler import (
    DelayModel,
    build_cloud_stragglers,
)
from asyncframework_tpu_torch.engine.blacklist import BlacklistTracker
from asyncframework_tpu_torch.engine.allocation import ExecutorAllocationManager
from asyncframework_tpu_torch.engine.speculation import (
    SpeculationMonitor,
    find_speculatable,
)
from asyncframework_tpu_torch.engine.recovery import (
    ReassignmentPlan,
    ShardRecovery,
    plan_reassignment,
)
from asyncframework_tpu_torch.engine.heartbeat import HeartbeatMonitor
from asyncframework_tpu_torch.engine.accumulator import (
    Accumulator,
    CollectionAccumulator,
    DoubleAccumulator,
    LongAccumulator,
    MaxAccumulator,
)

__all__ = [
    "Accumulator",
    "LongAccumulator",
    "DoubleAccumulator",
    "CollectionAccumulator",
    "MaxAccumulator",
    "Job",
    "JobWaiter",
    "TaskSpec",
    "DeviceExecutor",
    "ExecutorPool",
    "TaskMetrics",
    "JobScheduler",
    "partial_barrier",
    "DelayModel",
    "build_cloud_stragglers",
    "BlacklistTracker",
    "SpeculationMonitor",
    "ExecutorAllocationManager",
    "find_speculatable",
    "ReassignmentPlan",
    "ShardRecovery",
    "plan_reassignment",
    "HeartbeatMonitor",
]
