"""The port's standalone deploy layer (``asyncframework_tpu_torch/deploy/``)
against the JAX package's, on the CPU.

- ``tests/test_deploy.py`` runs here a second time on the port's
  ``Master``, ``Worker``, ``MasterClient`` and ``wait_app`` (its module
  globals by monkeypatch; its lazy ``asyncframework_tpu.deploy*`` and
  ``asyncframework_tpu.cli`` imports aliased to the port's modules), the
  worker daemons' executors running the port's CLI on the CPU
  (``ASYNCTPU_FORCE_CPU=1`` in their launch environment).  The JAX package
  gates its SPMD apps on its CPU backend's multi-process support; the
  port's SPMD runs on gloo, so they run ungated.  The standby-failover
  case starts its active master as a process of the port's module.
- Mixed deployments: a JAX package master with a port worker daemon runs
  a port app to ``FINISHED``; the port's master recovers a JAX master's
  ``master-state.json`` (and writes the same bytes back); a JAX package
  client submits to the port's master and waits it out.
"""

import json
import signal
import subprocess
import sys
import time

import pytest

import test_deploy as ref_dep
from torch_procs import readline_within
from asyncframework_tpu import deploy as j_deploy
from asyncframework_tpu.deploy import client as j_client
from asyncframework_tpu_torch import cli as t_cli
from asyncframework_tpu_torch import deploy as t_deploy
from asyncframework_tpu_torch.deploy import client as t_client

CPU_ENV = {"ASYNCTPU_FORCE_CPU": "1"}
#: a small 3-process DCN asgd app (PS + 2 workers)
ASGD_APP = ["--quiet", "asgd", "synthetic", "synthetic", "16", "2048", "8",
            "200", "1.0", "2147483647", "0.3", "0.5", "50", "0", "42"]


@pytest.fixture(autouse=True)
def _port_deploy(monkeypatch):
    for name, value in (("Master", t_deploy.Master),
                        ("MasterClient", t_deploy.MasterClient),
                        ("Worker", t_deploy.Worker),
                        ("wait_app", t_deploy.wait_app),
                        ("cpu_spmd_capability", lambda: "")):
        monkeypatch.setattr(ref_dep, name, value)
    for name, mod in (("asyncframework_tpu.deploy", t_deploy),
                      ("asyncframework_tpu.deploy.client", t_client),
                      ("asyncframework_tpu.cli", t_cli)):
        monkeypatch.setitem(sys.modules, name, mod)
    yield


@pytest.fixture()
def rig(tmp_path):
    m = t_deploy.Master(persistence_dir=str(tmp_path),
                        worker_timeout_s=2.0).start()
    workers = [
        t_deploy.Worker("127.0.0.1", m.port, worker_id=f"w{i}",
                        heartbeat_s=0.3, launch_env_extra=CPU_ENV).start()
        for i in range(2)
    ]
    yield m, workers
    for w in workers:
        w.stop()
    m.stop()


# ------------------------------------------ tests/test_deploy.py, port
class TestRegistryAndLivenessOnThePort(ref_dep.TestRegistryAndLiveness):
    pass


class TestAppLifecycleOnThePort(ref_dep.TestAppLifecycle):
    pass


class TestSubmitCLIMasterModeOnThePort(ref_dep.TestSubmitCLIMasterMode):
    def test_cli_master_submit_waits_to_finished(self, rig, capsys):
        """The JAX package's case on the port, with the daemons' output in
        every assertion's message (ROADMAP C14: one failure, output not
        kept): the CLI's and the worker daemons' stdout and stderr (the
        executors' exits and error tails) and the master's app records."""
        reason = ref_dep.cpu_spmd_capability()
        if reason:
            pytest.skip(reason)
        m, _ = rig
        rc = t_cli.main([
            "--master", f"127.0.0.1:{m.port}", "--processes", "2",
            "--supervise", "--quiet",
            "sgd-mllib", "synthetic", "synthetic",
            "16", "512", "4", "20", "1.0", "0", "0.5", "0.5",
            "10", "0", "42",
        ])
        cap = capsys.readouterr()
        context = (f"rc={rc}\n--- stdout\n{cap.out}\n--- stderr\n{cap.err}"
                   f"\n--- master apps\n"
                   f"{json.dumps(m.apps, default=str, indent=1)}")
        assert rc == 0, context
        lines = [ln for ln in cap.out.splitlines() if ln.startswith("{")]
        assert lines, context
        sub, fin = json.loads(lines[0]), json.loads(lines[-1])
        assert sub["supervise"] is True and sub["num_processes"] == 2, context
        assert fin["state"] == "FINISHED", context
        assert all(code == 0 for code in fin["exits"].values()), context
        # the master recorded the supervise flag on the app
        assert m.apps[sub["app_id"]]["supervise"] is True, context


class TestMasterUIOnThePort(ref_dep.TestMasterUI):
    pass


class TestMasterRecoveryOnThePort(ref_dep.TestMasterRecovery):
    pass


class TestExitPersistenceOnThePort(ref_dep.TestExitPersistence):
    pass


class TestSingleProcessAppOnThePort(ref_dep.TestSingleProcessApp):
    pass


@pytest.mark.slow
class TestStandbyFailoverOnThePort:
    def test_kill_active_master_standby_takes_over_app_finishes(
        self, tmp_path
    ):
        """The JAX package's case with the port's master as the active
        process: SIGKILL it mid-app; the standby wins the flock lease,
        recovers RUNNING as RUNNING, the workers rotate to it, and the app
        runs to FINISHED."""
        active = subprocess.Popen(
            [sys.executable, "-m", "asyncframework_tpu_torch.deploy.master",
             "--port", "0", "--persistence-dir", str(tmp_path), "--ha"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        standby = None
        workers = []
        try:
            line = readline_within(active)
            active_addr = line.split()[-2 if "(ha)" in line else -1]
            a_host, a_port = active_addr.rsplit(":", 1)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                try:
                    t_deploy.MasterClient(a_host, int(a_port)).workers()
                    break
                except (ConnectionError, OSError):
                    time.sleep(0.1)
            standby = t_deploy.Master(persistence_dir=str(tmp_path),
                                      worker_timeout_s=2.0, ha=True).start()
            with pytest.raises(ConnectionError):
                t_deploy.MasterClient("127.0.0.1", standby.port).workers()
            workers = [
                t_deploy.Worker(a_host, int(a_port), worker_id=f"w{i}",
                                heartbeat_s=0.3,
                                standby_masters=[
                                    f"127.0.0.1:{standby.port}"],
                                launch_env_extra=CPU_ENV).start()
                for i in range(2)
            ]
            ha_addr = f"{active_addr},127.0.0.1:{standby.port}"
            cl = t_client._client(ha_addr)
            app_id = cl.submit(
                ["--quiet", "asgd", "synthetic", "synthetic",
                 "16", "2048", "8", "20000", "0.05", "2147483647", "0.3",
                 "0.5", "1000", "0", "42"],
                num_processes=2,
            )
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                if cl.status(app_id)["state"] == "RUNNING":
                    break
                time.sleep(0.2)
            assert cl.status(app_id)["state"] == "RUNNING"
            time.sleep(1.0)  # executors underway
            active.send_signal(signal.SIGKILL)
            active.wait(timeout=10)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and not standby.active:
                time.sleep(0.1)
            assert standby.active, "standby never won the lease"
            assert cl.status(app_id)["state"] == "RUNNING"
            st = t_deploy.wait_app(ha_addr, app_id, timeout_s=240.0)
            assert st["state"] == "FINISHED", st
            assert len(st["exits"]) == 2
            assert all(rc == 0 for rc in st["exits"].values())
            assert set(cl.workers()) == {"w0", "w1"}
        finally:
            for w in workers:
                w.stop()
            if standby is not None:
                standby.stop()
            if active.poll() is None:
                active.kill()


# ---------------------------------------------------------- mixed deploys
def test_jax_master_with_a_port_worker_daemon_runs_a_port_app(tmp_path):
    m = j_deploy.Master(persistence_dir=str(tmp_path),
                        worker_timeout_s=2.0).start()
    w = t_deploy.Worker("127.0.0.1", m.port, worker_id="tw0",
                        heartbeat_s=0.3, launch_env_extra=CPU_ENV).start()
    try:
        cl = j_client.MasterClient("127.0.0.1", m.port)
        assert set(cl.workers()) == {"tw0"}
        app_id = cl.submit(ASGD_APP, num_processes=3)
        st = j_client.wait_app(f"127.0.0.1:{m.port}", app_id,
                               timeout_s=240.0)
        assert st["state"] == "FINISHED", st
        assert st["exits"] == {"0": 0, "1": 0, "2": 0}
    finally:
        w.stop()
        m.stop()


def test_port_master_recovers_a_jax_masters_state(tmp_path):
    """A JAX master's registry and apps (a failed one, a finished one, a
    running one) recovered by the port's master: the worker known but not
    alive until it heartbeats, the terminal apps as they were, the running
    one LOST (a cold restart); with only terminal apps, the port writes
    the file back byte for byte."""
    state_path = tmp_path / "master-state.json"
    m = j_deploy.Master(persistence_dir=str(tmp_path)).start()
    jw = j_deploy.Worker("127.0.0.1", m.port, worker_id="jw0",
                         heartbeat_s=0.3,
                         launch_env_extra={"ASYNCTPU_FORCE_CPU": "1",
                                           "JAX_PLATFORMS": "cpu"}).start()
    try:
        cl = j_client.MasterClient("127.0.0.1", m.port)
        bad = cl.submit(["definitely-not-a-driver"], num_processes=1)
        assert j_client.wait_app(f"127.0.0.1:{m.port}", bad,
                                 timeout_s=120.0)["state"] == "FAILED"
        with m._lock:
            m.apps["app-0100"] = {
                "argv": ["asgd"], "env": {"K": "v"}, "num_processes": 2,
                "state": "FINISHED", "assignments": [],
                "exits": {"0": 0, "1": 0}}
            m._persist()
    finally:
        jw.stop()
        m.stop()
    jax_bytes = state_path.read_bytes()
    m2 = t_deploy.Master(persistence_dir=str(tmp_path)).start()
    try:
        assert set(m2.workers) == {"jw0"}
        assert m2.workers["jw0"]["alive"] is False
        assert m2.apps[bad]["state"] == "FAILED"
        exits = m2.apps[bad]["exits"]
        assert set(exits) == {"0"} and exits["0"] != 0
        assert m2.apps["app-0100"]["state"] == "FINISHED"
        with m2._lock:
            m2._persist()
        assert state_path.read_bytes() == jax_bytes
        state = json.loads(jax_bytes)
        state["apps"]["app-0101"] = {"argv": ["x"], "env": {},
                                     "num_processes": 2,
                                     "state": "RUNNING", "exits": {"0": 0}}
        state["app_seq"] = 101
        state_path.write_text(json.dumps(state))
    finally:
        m2.stop()
    m3 = t_deploy.Master(persistence_dir=str(tmp_path)).start()
    try:
        assert m3.apps["app-0101"]["state"] == "LOST"
        assert m3.apps["app-0101"]["exits"] == {"0": 0}
        assert m3._app_seq == 101
    finally:
        m3.stop()


def test_jax_client_submits_to_the_port_master(tmp_path):
    m = t_deploy.Master(persistence_dir=str(tmp_path),
                        worker_timeout_s=2.0).start()
    w = t_deploy.Worker("127.0.0.1", m.port, worker_id="tw0",
                        heartbeat_s=0.3, launch_env_extra=CPU_ENV).start()
    try:
        cl = j_client.MasterClient("127.0.0.1", m.port)
        app_id = cl.submit(ASGD_APP, num_processes=3)
        # the retried SUBMIT of a lost reply is answered from the port
        # master's dedup window: still one app
        assert set(m.apps) == {app_id}
        st = j_client.wait_app(f"127.0.0.1:{m.port}", app_id,
                               timeout_s=240.0)
        assert st["state"] == "FINISHED", st
        assert st["exits"] == {"0": 0, "1": 0, "2": 0}
        assert m.apps[app_id]["argv"] == ASGD_APP
    finally:
        w.stop()
        m.stop()
