"""Standalone cluster deploy: Master/Worker daemons + submission client.

Parity: ``deploy/master/Master.scala:41`` / ``deploy/worker/Worker.scala:43``
/ ``deploy/client/StandaloneAppClient.scala:44`` -- the reference's
standalone resource manager.  See ``deploy/master.py`` for the design notes.

Counterpart of ``asyncframework_tpu/deploy/``: copies of its JAX-free
modules with the imports renamed, so the frames and ``master-state.json``
are byte-identical and either package's daemons and clients talk to the
other's.  The worker daemon launches ``python -m
asyncframework_tpu_torch.cli``.
"""

from asyncframework_tpu_torch.deploy.client import (
    MasterClient,
    submit_app,
    wait_app,
)
from asyncframework_tpu_torch.deploy.leader import FileLeaderElection
from asyncframework_tpu_torch.deploy.master import Master
from asyncframework_tpu_torch.deploy.worker import Worker

__all__ = ["Master", "Worker", "MasterClient", "submit_app", "wait_app",
           "FileLeaderElection"]
