"""The in-process engine: jobs, executors, scheduling, liveness, recovery."""

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
from asyncframework_tpu_torch.engine.recovery import (
    ReassignmentPlan,
    ShardRecovery,
    plan_reassignment,
)
from asyncframework_tpu_torch.engine.heartbeat import HeartbeatMonitor

__all__ = [
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
    "ReassignmentPlan",
    "ShardRecovery",
    "plan_reassignment",
    "HeartbeatMonitor",
]
