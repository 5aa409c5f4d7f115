"""The port's relaycast plane against the JAX package's own relaycast suite
and across the packages.

- The JAX package's cases (``tests/test_relaycast.py``: the tree plan,
  the relay node's store, reply shapes, fencing and learned children, the
  source's parent chain, re-homing on a dead, empty, corrupt or stale-epoch
  parent, the PS egress with the tree against direct SUBSCRIBE, the root
  offer path, the SIGKILL of an interior node of three real replica
  processes, and a replica's relay surface) run here a second time with
  the modules they test swapped for the port's copies on the CPU (the
  reference module's globals by monkeypatch; its replica processes are the
  port's ``serving.cli`` under ``ASYNCTPU_FORCE_CPU=1``).
- Across the packages: a port node and a JAX-package node holding the same
  versions answer every ``have=`` with the same bytes, raw and compressed;
  a tree whose nodes alternate between the packages, under either
  package's PS, delivers every version to every node bit-equal to the PS's
  snapshot and CRC-validated; either package's PS registers the other's
  relay child from its SUBSCRIBE and offers it each new version.

Waits are on conditions with deadlines, never fixed sleeps.
"""

import sys
import time

import numpy as np
import pytest

import asyncframework_tpu.serving  # noqa: F401  (before any alias below)
import test_relaycast as ref_relay
from asyncframework_tpu import relaycast as j_relay
from asyncframework_tpu.parallel import ps_dcn as j_ps
from asyncframework_tpu.solvers import SolverConfig as JConfig
from asyncframework_tpu_torch import conf as t_conf
from asyncframework_tpu_torch import relaycast as t_relay
from asyncframework_tpu_torch.metrics import reset_totals as t_reset_totals
from asyncframework_tpu_torch.metrics import timeseries as t_ts
from asyncframework_tpu_torch.net import faults as t_faults
from asyncframework_tpu_torch.net import frame as t_frame
from asyncframework_tpu_torch.net import wiredelta as t_wiredelta
from asyncframework_tpu_torch.net.retry import reset_breakers as t_breakers
from asyncframework_tpu_torch.parallel import ps_dcn as t_ps
from asyncframework_tpu_torch.relaycast import metrics as t_rmetrics
from asyncframework_tpu_torch.solvers import SolverConfig
from torch_serving_support import (
    CPU,
    CPUModelReplica,
    port_ps,
    port_replica,
    clean_jax_package,
    port_subprocess,
)

pytestmark = pytest.mark.relay


@pytest.fixture()
def devices8():
    """The reference cases' JAX device list, as the port's CPU devices."""
    return [CPU] * 8


def _clean():
    t_ts.stop_sampler()
    t_reset_totals()
    t_breakers()
    t_faults.clear()


@pytest.fixture(autouse=True)
def _port_modules(monkeypatch):
    """Point the reference module's globals at the port's copies and leave
    the port's process-global relay state clean."""
    monkeypatch.setitem(sys.modules, "asyncframework_tpu.serving.replica",
                        port_replica)
    for name, value in dict(
            set_global_conf=t_conf.set_global_conf,
            reset_totals=t_reset_totals, _frame=t_frame, faults=t_faults,
            wiredelta=t_wiredelta, reset_breakers=t_breakers,
            ps_dcn=port_ps, ROOT=t_relay.ROOT, RelayNode=t_relay.RelayNode,
            RelaySource=t_relay.RelaySource,
            children_of=t_relay.children_of, depth_of=t_relay.depth_of,
            parent_index=t_relay.parent_index, rmetrics=t_rmetrics,
            ModelReplica=CPUModelReplica, SolverConfig=SolverConfig,
            subprocess=port_subprocess).items():
        monkeypatch.setattr(ref_relay, name, value)
    _clean()
    yield
    _clean()
    clean_jax_package()
    t_conf.set_global_conf(None)


# ------------------------------------- tests/test_relaycast.py on the port
class TestTreePlanOnThePort(ref_relay.TestTreePlan):
    pass


class TestRelayNodeOnThePort(ref_relay.TestRelayNode):
    def test_children_learned_from_fetch_and_offered(self, rng):
        """The reference case, waiting for the child's offer callback: a
        node ACKs an offer before it runs ``on_offer`` (the parent's offer
        round must not wait on the child's refresh), so the callback can
        land after ``offer_children`` returns.  The reference case reads
        it at once, and fails when the child's thread is slow."""
        parent = t_relay.RelayNode(rid=0, port=0, compress=False,
                                   fanout=2).start()
        offers = []
        child = t_relay.RelayNode(rid=1, port=0, compress=False,
                                  on_offer=lambda: offers.append(1)).start()
        try:
            ref_relay._publish(parent, rng.normal(size=8).astype(np.float32),
                               ts=1)
            ref_relay.fetch_raw(parent.port, rport=child.port)
            assert ("127.0.0.1", child.port) in parent.children()
            ref_relay.fetch_raw(parent.port, rport=65000)
            ref_relay.fetch_raw(parent.port, rport=65001)
            assert len(parent.children()) == 2
            assert ("127.0.0.1", child.port) not in parent.children()
            ref_relay.fetch_raw(parent.port, rport=child.port)
            assert ("127.0.0.1", child.port) in parent.children()
            ref_relay._publish(parent, rng.normal(size=8).astype(np.float32),
                               ts=2)
            delivered = parent.offer_children()
            assert delivered == 1  # the real child; the fake one strikes
            assert child.offered_ts == 2
            deadline = time.monotonic() + 10.0
            while not offers:
                assert time.monotonic() < deadline, "on_offer never ran"
                time.sleep(0.01)
            assert offers == [1]
        finally:
            parent.stop()
            child.stop()


class TestRelaySourceOnThePort(ref_relay.TestRelaySource):
    pass


class TestEgressScalingOnThePort(ref_relay.TestEgressScaling):
    pass


class TestRootOfferPathOnThePort(ref_relay.TestRootOfferPath):
    pass


class TestInteriorKillAcceptanceOnThePort(
        ref_relay.TestInteriorKillAcceptance):
    pass


class TestReplicaIntegrationOnThePort(ref_relay.TestReplicaIntegration):
    pass


# ------------------------------------------------------ across the packages
PKGS = {"jax": (j_relay, j_ps, JConfig), "port": (t_relay, t_ps,
                                                  SolverConfig)}


def _start_ps(pkg, d):
    _relay, ps_mod, cfg_cls = PKGS[pkg]
    cfg = cfg_cls(num_workers=2, num_iterations=10_000, gamma=0.5,
                  taw=2**31 - 1, batch_rate=0.3, bucket_ratio=0.0,
                  printer_freq=100, seed=42, calibration_iters=4,
                  run_timeout_s=60.0)
    kw = {} if pkg == "jax" else {"device": CPU}
    return ps_mod.ParameterServer(cfg, d, 256, port=0, **kw).start()


def _push(cl, d, rng, v):
    ts, _w, _avg, _cal = cl.pull(0)
    scale = 0.5 * (0.45 ** v) + 1e-5  # decaying, as the JAX bench's arm
    cl.push(0, ts, (scale * rng.normal(size=d)).astype(np.float32))


def _fetch(port, have=None):
    hdr = {"op": "RELAY_FETCH", "rid": 99}
    if have is not None:
        hdr["have"] = have
    sock = t_frame.connect(("127.0.0.1", port))
    try:
        t_frame.send_msg(sock, hdr)
        return t_frame.recv_msg(sock)
    finally:
        sock.close()


@pytest.mark.parametrize("compress", [False, True])
def test_port_and_jax_nodes_send_the_same_bytes(compress):
    """The same stored versions in a node of each package: every ``have=``
    (none, an old version, the current one, one evicted) gets the same
    reply header, less the reply-time age, and the same payload bytes."""
    rs = np.random.default_rng(11)
    d = 4_096
    w = rs.normal(size=d).astype(np.float32)
    versions = [w]
    for v in range(1, 6):
        nxt = versions[-1].copy()
        if v % 2:  # sparse change: xdelta
            idx = rs.choice(d, size=40, replace=False)
            nxt[idx] += rs.normal(size=40).astype(np.float32)
        else:  # dense small change: full, or xfull when compressing
            nxt = (nxt * (1 + 1e-4 * rs.normal(size=d))).astype(np.float32)
        versions.append(nxt)
    nodes = [mod.RelayNode(rid=0, port=0, compress=compress,
                           versions=4).start() for mod in (t_relay, j_relay)]
    try:
        for node in nodes:
            for ts, arr in enumerate(versions, start=1):
                wire = arr.tobytes()
                node.publish(ts, wire, t_wiredelta.crc(wire), ts + 1, ts,
                             0.0, False, epoch=0)
        shapes = set()
        for have in (None, 1, 3, 5, 6):
            (h_t, p_t), (h_j, p_j) = (_fetch(n.port, have) for n in nodes)
            h_t.pop("age_ms")
            h_j.pop("age_ms")
            assert h_t == h_j, have
            assert p_t == p_j, have
            shapes.add(h_t["wenc"])
        assert {"full", "nm", "xdelta"} <= shapes
        if compress:
            assert "xfull" in shapes
    finally:
        for node in nodes:
            node.stop()


@pytest.mark.parametrize("ps_pkg", ["port", "jax"])
def test_mixed_tree_delivers_every_version_bit_equal(ps_pkg):
    """Eight nodes in the k = 2 plan, alternating between the packages
    (a port node's parent is a JAX-package node and the reverse where the
    plan allows), driven version by version in topological order: every
    node holds the PS's snapshot bytes with its CRC, most nodes fetch from
    their parent, and the PS's SUBSCRIBE egress is the root children's."""
    rs = np.random.default_rng(12)
    d = 1_024
    ps = _start_ps(ps_pkg, d)
    cl = PKGS[ps_pkg][1].PSClient("127.0.0.1", ps.port, pull_mode="full")
    nodes, sources = [], []
    try:
        for rid in range(8):
            mod = (t_relay, j_relay)[rid % 2]
            node = mod.RelayNode(rid=rid, port=0, compress=True,
                                 fanout=2).start()
            p = mod.parent_index(rid, 2)
            parent = None if p == mod.ROOT else ("127.0.0.1", nodes[p].port)
            nodes.append(node)
            sources.append(mod.RelaySource("127.0.0.1", ps.port, node,
                                           parent=parent, rid=rid))
        for v in range(8):
            _push(cl, d, rs, v)
            snap = ps._model_snap()
            for rid, src in enumerate(sources):
                got = src.subscribe(rid)
                assert got[0] == snap.ts
                assert got[1].tobytes() == np.asarray(
                    snap.w_host, np.float32).tobytes()
                cur = nodes[rid].current()
                assert cur.ts == snap.ts and cur.crc == snap.crc
                assert t_wiredelta.crc(np.frombuffer(cur.wire, np.float32)) \
                    == snap.crc
        via_parent = sum(s.via_parent for s in sources[2:])
        assert via_parent >= 6 * 7  # the boot round may fall to the root
        assert sum(s.via_parent for s in sources[:2]) == 0
        # only the two root children subscribe each version
        assert sum(ps.subscribe_replies.values()) <= 2 * 8 + 6
    finally:
        for node in nodes:
            node.stop()
        cl.bye()
        ps.stop()


@pytest.mark.parametrize("ps_pkg,node_pkg", [("port", "jax"),
                                             ("jax", "port"),
                                             ("port", "port")])
def test_ps_registers_the_other_packages_relay_child_and_offers(ps_pkg,
                                                                 node_pkg):
    """A SUBSCRIBE carrying ``rport`` from either package's relay source
    registers the node as the PS's child; each new version is then offered
    to it (``relay_offers`` counted on the PS, the node's ``offered_ts``
    advanced) without the node polling."""
    rs = np.random.default_rng(13)
    d = 64
    ps = _start_ps(ps_pkg, d)
    relay_mod = PKGS[node_pkg][0]
    node = relay_mod.RelayNode(rid=0, port=0, compress=False).start()
    cl = PKGS[ps_pkg][1].PSClient("127.0.0.1", ps.port, pull_mode="full")
    try:
        src = relay_mod.RelaySource("127.0.0.1", ps.port, node, rid=0)
        assert src.subscribe(0)[0] == 0
        assert ps._relay_registry is not None
        assert ("127.0.0.1", node.port) in ps._relay_registry.children()
        for v in range(1, 4):
            _push(cl, d, rs, v)
            # one offer round a clock change; it offers the snapshot the
            # loop read, the version before when the drain had ticked the
            # clock but not yet published the model
            deadline = time.monotonic() + 10.0
            while node.offers_in < v:
                assert time.monotonic() < deadline, \
                    f"version {v} was never offered"
                time.sleep(0.01)
            assert v - 1 <= node.offered_ts <= v
        # the PS counts an offer once the child has ACKed it
        deadline = time.monotonic() + 10.0
        while ps.relay_offers < 3:
            assert time.monotonic() < deadline, ps.relay_offers
            time.sleep(0.01)
        assert node.offers_in >= 3
        src.bye()
    finally:
        node.stop()
        cl.bye()
        ps.stop()


def test_relay_offer_loop_keeps_up_with_many_versions():
    """The root offer loop under a stream of versions: the PS offers its
    two children published versions as they come, each child's offered
    version a version the PS published.  Offers are advisory (a child's
    poll fetches whatever an offer missed): the loop marks a clock offered
    once it has offered the snapshot it read for it, which can be the
    version before when the drain has ticked the clock but not yet
    published the model."""
    rs = np.random.default_rng(14)
    d = 256
    ps = _start_ps("port", d)
    nodes = [t_relay.RelayNode(rid=r, port=0, compress=False).start()
             for r in range(2)]
    cl = t_ps.PSClient("127.0.0.1", ps.port, pull_mode="full")
    try:
        srcs = [t_relay.RelaySource("127.0.0.1", ps.port, n, rid=r)
                for r, n in enumerate(nodes)]
        for r, s in enumerate(srcs):
            s.subscribe(r)
        for v in range(20):
            _push(cl, d, rs, v)
        deadline = time.monotonic() + 10.0
        while (min(n.offered_ts for n in nodes) < 1
               or ps.relay_offers < 2):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert all(1 <= n.offered_ts <= ps._clock for n in nodes)
        assert t_rmetrics.relay_totals().get("offers_sent", 0) >= 2
    finally:
        for n in nodes:
            n.stop()
        cl.bye()
        ps.stop()


def test_relay_arm_on_the_cpu():
    """``tools/serve.py``'s relay arm (``chip_smoke.py`` phase 16 (c)) at
    a narrow width on the CPU: every node bit-equal at every version in
    the direct, raw-tree and compressed-tree arms, the PS's egress a
    version cut to its root children's (a quarter of direct at 8 nodes,
    fanout 2), the stopped interior node's children re-homed to the root,
    offers delivered in every arm."""
    from asyncframework_tpu_torch.tools import serve

    rec = serve.relay_arm(device="cpu", d=4_096)
    assert rec["ok"], rec["gates"]
    assert rec["egress_ratio_direct_to_tree_raw"] == pytest.approx(4.0)
    assert rec["tree_compressed"]["interior_stop"]["children"] == [4, 5]
