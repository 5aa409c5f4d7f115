"""Byte-exact model-delta codec for version-gated PULL replies.

ASAP (arXiv:1612.08608) showed async data-parallel systems win by sending
deltas instead of full state; the asynchronous-SGD transfer-volume line of
work (arXiv:1505.04956) identifies parameter bytes as the dominant DCN cost
at scale.  The blocker for deltas in a *correctness-first* PS protocol is
float arithmetic: ``basis + (current - basis)`` is NOT bit-equal to
``current`` in IEEE-754, and a worker whose reconstructed model drifts by
even one ulp is silently training against a model the PS never held.

This codec sidesteps arithmetic entirely: the delta is the **XOR of the
raw float32 bit patterns** (viewed as ``uint32``).  XOR is exact, so
``basis_bits ^ delta_bits == current_bits`` byte-for-byte, and entries the
update never touched XOR to zero -- the delta of a model that changed in
few coordinates is naturally sparse.  Encoding picks the smallest wire
form:

- ``nm``     -- basis bytes == current bytes: header-only NOT_MODIFIED.
- ``xdelta`` -- ``(idx u32, xorword u32)`` pairs for the changed entries,
  chosen when ``nnz * 8 < d * 4``.
- ``full``   -- the raw float32 payload (the delta would not be smaller,
  or the server no longer caches the basis).

Every non-full reply carries the CRC32 of the *current* model bytes; the
decoder recomputes (or, for ``nm``, compares its cached basis CRC) and
signals mismatch so the client can fall back to a full pull -- a delta
path can degrade to the legacy wire, never to a wrong model.

Native fast path (``async.native.enabled``, native/wiredelta.cc): the
XOR/CRC passes dispatch to GIL-free C twins loaded via ctypes; the numpy
implementations below (``_py_*``) are the registered bit-identity
oracles (``NATIVE_ORACLES``, enforced by the ``native-oracle`` lint) and
the fallback whenever the knob is off or no toolchain is present.  The
bytes produced are identical either way -- property-tested in
tests/test_native.py -- so flipping the knob never changes the wire.
"""

from __future__ import annotations

import ctypes
import zlib
from typing import Optional, Tuple

import numpy as np

from asyncframework_tpu_torch.metrics import profiler as _prof
from asyncframework_tpu_torch.native_build import bump_native as _bump_native

#: wire-encoding tags carried in the MODEL header's ``wenc`` field
FULL = "full"
NOT_MODIFIED = "nm"
XDELTA = "xdelta"
#: dense XOR form (relaycast plane only -- the PS never emits it): the
#: raw ``cur_bits ^ basis_bits`` words with NO index list, same size as
#: FULL but structurally compressible (consecutive training versions
#: agree in sign/exponent/top-mantissa bits, so the xor's high byte
#: planes are near-zero -- see net/wirecodec.py's shuffle transform).
#: Still byte-exact and CRC-gated like every other form.
XFULL = "xfull"

# --------------------------------------------------------- native loading
#: native symbol -> the same-module pure-Python oracle it must bit-match
#: (the ``native-oracle`` lint's declaration table; tests/test_native.py
#: property-tests each pair)
NATIVE_ORACLES = {
    "wd_crc32": "_py_crc",
    "wd_encode": "_py_encode",
    "wd_xor_dense": "_py_encode_xfull",
    "wd_apply_xdelta": "_py_decode",
}

_NATIVE = None


def _native_lib():
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE or None
    lib = None
    try:
        from asyncframework_tpu_torch.native_build import ensure_built

        built = ensure_built("wiredelta")
        if built:
            lib = ctypes.CDLL(built)
            lib.wd_crc32.restype = ctypes.c_uint32
            lib.wd_crc32.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
            lib.wd_encode.restype = ctypes.c_longlong
            lib.wd_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ]
            lib.wd_xor_dense.restype = None
            lib.wd_xor_dense.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong,
            ]
            lib.wd_apply_xdelta.restype = ctypes.c_int
            lib.wd_apply_xdelta.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_longlong,
            ]
    except Exception:  # noqa: BLE001 - fall back to Python
        lib = None
    _NATIVE = lib or False
    return lib


def _use_native():
    """The per-call dispatch decision: the loaded library when
    ``async.native.enabled`` is on and the build exists, else None.
    A wanted-but-unavailable native path bumps ``python_fallbacks`` --
    the silent degrade the ``native`` metrics family exists to surface."""
    from asyncframework_tpu_torch.conf import NATIVE_ENABLED, global_conf

    if not global_conf().get(NATIVE_ENABLED):
        return None
    lib = _native_lib()
    if lib is None:
        _bump_native("python_fallbacks")
    return lib


def _u8(buf) -> np.ndarray:
    """A zero-copy uint8 view over any contiguous buffer (raises
    ValueError on non-contiguous input -- callers fall back to Python)."""
    return np.frombuffer(memoryview(buf).cast("B"), np.uint8)


# ----------------------------------------------------------------- oracles
def _py_crc(model_buf) -> int:
    return zlib.crc32(model_buf) & 0xFFFFFFFF


def _py_encode(cur: np.ndarray, basis: np.ndarray,
               full) -> Tuple[str, bytes, int]:
    cur_bits = cur.view(np.uint32)
    xor = cur_bits ^ basis.view(np.uint32)
    (nz,) = np.nonzero(xor)
    if nz.size == 0:
        return NOT_MODIFIED, b"", 0
    if nz.size * 8 < cur.nbytes:
        payload = (nz.astype(np.uint32).tobytes()
                   + np.ascontiguousarray(xor[nz]).tobytes())
        return XDELTA, payload, int(nz.size)
    return full()


def _py_encode_xfull(cur: np.ndarray, basis: np.ndarray) -> bytes:
    return (cur.view(np.uint32) ^ basis.view(np.uint32)).tobytes()


def _py_decode(basis: np.ndarray, idx: np.ndarray,
               xwords: np.ndarray) -> Optional[np.ndarray]:
    if idx.size and int(idx.max()) >= basis.size:
        return None
    bits = basis.view(np.uint32).copy()
    bits[idx] ^= xwords
    return bits.view(np.float32)


# --------------------------------------------------------------------- API
@_prof.zoned("wire.crc")
def crc(model_buf) -> int:
    """CRC32 of a model payload (the integrity check on every delta/NM
    reply).  Accepts any buffer-protocol object -- pass the contiguous
    float32 array itself, no ``tobytes`` copy needed.  ~GB/s on commodity
    hosts: microseconds at DCN model sizes."""
    lib = _use_native()
    if lib is not None:
        try:
            a = _u8(model_buf)
        except (ValueError, TypeError):
            a = None
        if a is not None:
            _bump_native("native_calls.crc")
            return int(lib.wd_crc32(
                ctypes.c_void_p(a.ctypes.data), a.size))
    _bump_native("python_calls.crc")
    return _py_crc(model_buf)


@_prof.zoned("wire.xor")
def encode(cur: np.ndarray, basis: Optional[np.ndarray],
           cur_bytes: Optional[bytes] = None) -> Tuple[str, bytes, int]:
    """Encode ``cur`` (float32) against ``basis`` (float32 or None).

    Returns ``(wenc, payload, nnz)``: the chosen wire form, its model-part
    payload bytes, and the changed-entry count (0 for ``nm``/``full``).
    ``cur_bytes`` lets a caller with an already-serialized current model
    (the PS's per-version encoded cache) avoid a redundant ``tobytes``.
    """
    def full() -> Tuple[str, bytes, int]:
        return FULL, (cur_bytes if cur_bytes is not None
                      else cur.tobytes()), 0

    if basis is None or basis.shape != cur.shape:
        return full()
    lib = _use_native()
    if (lib is not None and cur.flags.c_contiguous
            and basis.flags.c_contiguous):
        n = int(cur.size)
        # the XDELTA cutoff shared with the oracle: acceptable while
        # nnz * 8 < nbytes, i.e. nnz < n / 2, so the largest acceptable
        # count (wd_encode treats max_nnz as inclusive) is (n - 1) // 2
        max_nnz = max(0, (n - 1) // 2)
        idx = np.empty(max_nnz, np.uint32)
        xw = np.empty(max_nnz, np.uint32)
        nnz = lib.wd_encode(
            ctypes.c_void_p(cur.ctypes.data),
            ctypes.c_void_p(basis.ctypes.data), n,
            ctypes.c_void_p(idx.ctypes.data),
            ctypes.c_void_p(xw.ctypes.data), max_nnz,
        )
        _bump_native("native_calls.xor")
        if nnz < 0:
            return full()
        if nnz == 0:
            return NOT_MODIFIED, b"", 0
        return XDELTA, idx[:nnz].tobytes() + xw[:nnz].tobytes(), int(nnz)
    _bump_native("python_calls.xor")
    return _py_encode(cur, basis, full)


@_prof.zoned("wire.xor")
def encode_xfull(cur: np.ndarray, basis: np.ndarray) -> bytes:
    """The dense XOR payload (``XFULL``): exact by construction, FULL-
    sized on the wire but built for the wirecodec shuffle+deflate
    transform.  Caller guarantees matching shapes."""
    lib = _use_native()
    if (lib is not None and cur.flags.c_contiguous
            and basis.flags.c_contiguous):
        out = np.empty(cur.size, np.uint32)
        lib.wd_xor_dense(ctypes.c_void_p(cur.ctypes.data),
                         ctypes.c_void_p(basis.ctypes.data),
                         ctypes.c_void_p(out.ctypes.data), int(cur.size))
        _bump_native("native_calls.xor")
        return out.tobytes()
    _bump_native("python_calls.xor")
    return _py_encode_xfull(cur, basis)


@_prof.zoned("wire.xor")
def decode(wenc: str, payload, nnz: int, basis: Optional[np.ndarray],
           want_crc: Optional[int], basis_crc: Optional[int] = None
           ) -> Optional[np.ndarray]:
    """Reconstruct the current model (float32) from a delta-form reply.

    ``basis`` is the client's cached basis array; ``want_crc`` the CRC the
    server stamped for the current version; ``basis_crc`` the client's
    cached CRC of its basis bytes (lets ``nm`` validate in O(1)).

    Returns the reconstructed array, or **None** on any mismatch -- cache
    miss, shape drift, CRC disagreement -- in which case the caller MUST
    fall back to a full pull.  Never returns a model that failed its CRC.
    """
    if wenc == FULL:
        return np.frombuffer(payload, np.float32)
    if basis is None:
        return None
    if wenc == NOT_MODIFIED:
        if want_crc is None:
            return None
        have = basis_crc if basis_crc is not None else crc(basis)
        return basis if have == want_crc else None
    if wenc == XFULL:
        if len(payload) != basis.nbytes:
            return None
        lib = _use_native()
        if lib is not None and basis.flags.c_contiguous:
            xw = np.frombuffer(payload, np.uint32)
            out = np.empty(basis.size, np.uint32)
            lib.wd_xor_dense(ctypes.c_void_p(basis.ctypes.data),
                             ctypes.c_void_p(xw.ctypes.data),
                             ctypes.c_void_p(out.ctypes.data),
                             int(basis.size))
            _bump_native("native_calls.xor")
            out = out.view(np.float32)
        else:
            _bump_native("python_calls.xor")
            bits = (basis.view(np.uint32)
                    ^ np.frombuffer(payload, np.uint32))
            out = bits.view(np.float32)
        if want_crc is None or crc(out) != want_crc:
            return None
        return out
    if wenc != XDELTA:
        return None
    if len(payload) != 8 * nnz or nnz <= 0:
        return None
    idx = np.frombuffer(payload[: 4 * nnz], np.uint32)
    xwords = np.frombuffer(payload[4 * nnz:], np.uint32)
    lib = _use_native()
    if lib is not None and basis.flags.c_contiguous:
        bits = basis.view(np.uint32).copy()
        rc = lib.wd_apply_xdelta(
            ctypes.c_void_p(bits.ctypes.data), int(basis.size),
            ctypes.c_void_p(idx.ctypes.data),
            ctypes.c_void_p(xwords.ctypes.data), int(nnz))
        _bump_native("native_calls.xor")
        out = None if rc != 0 else bits.view(np.float32)
    else:
        _bump_native("python_calls.xor")
        out = _py_decode(basis, idx, xwords)
    if out is None:
        return None
    if want_crc is None or crc(out) != want_crc:
        return None
    return out
