"""The port's copies of the wire (``asyncframework_tpu_torch/net``) against
the JAX package's own tests and against the JAX package's modules.

- The JAX package's ``tests/test_wirecodec.py`` (gradient quantization,
  snapshot compression) and ``tests/test_wire_native.py`` (each native
  entry point bit-equal to its pure-Python oracle, the shm ring across
  backends) run here a second time, with the modules they test swapped
  for the port's copies, whose natives the port's gateway
  (``native_build.py``) builds with g++ into its own build directory.
- A frame the port sends parses in the JAX package and the other way
  round, byte for byte, and so does an encoded model reply (the delta
  pull's NOT_MODIFIED / XDELTA / FULL forms) and a quantized push.
"""

import os
import socket

import numpy as np
import pytest

import test_wire_native as ref_native
import test_wirecodec as ref_codec
from asyncframework_tpu import native_build as j_native_build
from asyncframework_tpu.net import frame as j_frame
from asyncframework_tpu.net import wirecodec as j_wirecodec
from asyncframework_tpu.net import wiredelta as j_wiredelta
from asyncframework_tpu_torch import conf as t_conf
from asyncframework_tpu_torch import native_build as t_native_build
from asyncframework_tpu_torch.net import frame as t_frame
from asyncframework_tpu_torch.net import shmring as t_shmring
from asyncframework_tpu_torch.net import wirecodec as t_wirecodec
from asyncframework_tpu_torch.net import wiredelta as t_wiredelta


def _reset_port_totals():
    from asyncframework_tpu_torch.net import reset_net_totals
    from asyncframework_tpu_torch.net.retry import reset_breakers

    reset_net_totals()
    reset_breakers()
    t_wirecodec.reset_codec_totals()
    t_native_build.reset_native_totals()


@pytest.fixture()
def cf():
    """The port's global conf with its store saved and restored (the
    reference cases flip the native and shm knobs)."""
    c = t_conf.global_conf()
    saved = dict(c._store)
    yield c
    c._store.clear()
    c._store.update(saved)


@pytest.fixture(autouse=True)
def _port_modules(monkeypatch):
    """Point the reference test modules' globals at the port's copies."""
    _reset_port_totals()
    for name, mod in (("wc", t_wirecodec), ("wiredelta", t_wiredelta),
                      ("_frame", t_frame)):
        monkeypatch.setattr(ref_codec, name, mod)
    monkeypatch.setattr(ref_codec, "set_global_conf", t_conf.set_global_conf)
    for name, mod in (("frame", t_frame), ("shmring", t_shmring),
                      ("wirecodec", t_wirecodec), ("wiredelta", t_wiredelta),
                      ("conf_mod", t_conf), ("native_build", t_native_build)):
        monkeypatch.setattr(ref_native, name, mod)
    monkeypatch.setattr(ref_native, "ShmRing", t_shmring.ShmRing)
    monkeypatch.setattr(ref_native, "ShmSocket", t_shmring.ShmSocket)
    monkeypatch.setattr(ref_native, "ensure_built", t_native_build.ensure_built)
    monkeypatch.setattr(ref_native, "native_totals",
                        t_native_build.native_totals)
    yield
    t_conf.set_global_conf(None)
    _reset_port_totals()


# the JAX package's cases, run on the port's modules
class TestGradCodecOnThePort(ref_codec.TestGradCodec):
    pass


class TestSnapshotCodecOnThePort(ref_codec.TestSnapshotCodec):
    pass


class TestWireDeltaIdentityOnThePort(ref_native.TestWireDeltaIdentity):
    pass


class TestWireCodecIdentityOnThePort(ref_native.TestWireCodecIdentity):
    pass


class TestFrameGatherOnThePort(ref_native.TestFrameGather):
    pass


class TestRingCrossBackendOnThePort(ref_native.TestRingCrossBackend):
    pass


class TestShmSocketIntegrationOnThePort(ref_native.TestShmSocketIntegration):
    pass


# ---------------------------------------------------------- the gateway
def test_gateway_builds_into_the_port_and_loads_the_port_libraries():
    """g++ builds each wire source into the port's build directory, the
    port's loaders take those libraries (never ``native/*.so``), and the
    build is reused, not repeated."""
    for name in t_native_build.SOURCES:
        path = t_native_build.ensure_built(name)
        assert path is not None, f"{name} did not build"
        assert path.startswith(t_native_build.BUILD_DIR)
        assert os.path.exists(path)
        assert t_native_build.ensure_built(name) == path
        assert t_native_build.check_status(name) == "built"
    for mod, name in ((t_wiredelta, "wiredelta"), (t_wirecodec, "wirecodec"),
                      (t_shmring, "shmring")):
        lib = mod._native_lib()
        assert lib is not None
        assert lib._name == t_native_build.ensure_built(name)


def test_gateway_refuses_a_source_it_does_not_build():
    # the port builds the wire codecs, the LibSVM parser and the key-value
    # store (into its own build directory), not the JAX package's codec
    # plane, which stays ROADMAP A10's
    assert {"libsvm_parser", "kvstore"} <= set(t_native_build.SOURCES)
    built = t_native_build.ensure_built("kvstore")
    assert built is not None
    assert built.startswith(t_native_build.BUILD_DIR)
    assert t_native_build.check_status("kvstore") == "built"
    with pytest.raises(ValueError):
        t_native_build.ensure_built("codec")


# --------------------------------------------------- across the packages
def _roundtrip(send_mod, recv_mod, header, payload):
    a, b = socket.socketpair()
    try:
        send_mod.send_msg(a, header, payload)
        return recv_mod.recv_msg(b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_frames_parse_in_the_other_package(direction):
    send, recv = ((t_frame, j_frame) if direction == "port_to_jax"
                  else (j_frame, t_frame))
    rs = np.random.default_rng(3)
    payload = rs.normal(size=1_000).astype(np.float32).tobytes()
    header = {"op": "PUSH", "wid": 3, "ts": 17, "sid": "abc", "seq": 5}
    got_h, got_p = _roundtrip(send, recv, header, payload)
    assert got_h == header and got_p == payload
    # the same frame is the same bytes from either package
    frames = []
    for mod in (t_frame, j_frame):
        a, b = socket.socketpair()
        try:
            mod.send_msg(a, header, payload)
            a.shutdown(socket.SHUT_WR)
            chunks = []
            while True:
                c = b.recv(1 << 16)
                if not c:
                    break
                chunks.append(c)
            frames.append(b"".join(chunks))
        finally:
            a.close()
            b.close()
    assert frames[0] == frames[1]


def _model_pairs():
    rs = np.random.default_rng(5)
    cur = rs.normal(size=2_000).astype(np.float32)
    near = cur.copy()
    near[rs.integers(0, 2_000, 40)] += 1.0
    return [("nm", cur, cur.copy()), ("xdelta", cur, near),
            ("full", cur, None), ("full_new", cur, rs.normal(
                size=2_000).astype(np.float32))]


@pytest.mark.parametrize("case", [c[0] for c in _model_pairs()])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_encoded_model_replies_decode_in_the_other_package(case, direction):
    _name, cur, basis = {c[0]: c for c in _model_pairs()}[case]
    enc, dec = ((t_wiredelta, j_wiredelta) if direction == "port_to_jax"
                else (j_wiredelta, t_wiredelta))
    wire = cur.tobytes()
    wenc, payload, nnz = enc.encode(cur, basis, cur_bytes=wire)
    other = dec.encode(cur, basis, cur_bytes=wire)
    assert (wenc, payload, nnz) == other  # byte-identical encodings
    assert enc.crc(wire) == dec.crc(wire)
    if wenc == dec.FULL:
        got = np.frombuffer(payload, np.float32)
    else:
        got = dec.decode(wenc, payload, nnz, basis, enc.crc(wire),
                         dec.crc(basis.tobytes()))
    assert got is not None and got.tobytes() == wire


@pytest.mark.parametrize("codec", ["fp16", "int8"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_quantized_pushes_decode_in_the_other_package(codec, direction):
    enc, dec = ((t_wirecodec, j_wirecodec) if direction == "port_to_jax"
                else (j_wirecodec, t_wirecodec))
    g = np.random.default_rng(9).normal(size=513).astype(np.float32)
    hdr, payload, err = enc.encode_grad(g, codec, None)
    hdr2, payload2, err2 = dec.encode_grad(g, codec, None)
    assert hdr == hdr2 and payload == payload2
    np.testing.assert_array_equal(err, err2)
    np.testing.assert_array_equal(dec.decode_grad(hdr, payload, 513),
                                  enc.decode_grad(hdr, payload, 513))


def test_native_totals_are_the_ports_own():
    """The port's gateway counts its own dispatches: a CRC through the
    port's wiredelta bumps the port's totals, never the JAX package's."""
    t_conf.global_conf().set("async.native.enabled", True)
    before = j_native_build.native_totals().get("native_calls.crc", 0)
    t_native_build.reset_native_totals()
    t_wiredelta.crc(b"\x00" * 64)
    assert t_native_build.native_totals().get("native_calls.crc") == 1
    assert j_native_build.native_totals().get("native_calls.crc", 0) == before
