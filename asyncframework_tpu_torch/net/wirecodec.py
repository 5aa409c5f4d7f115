"""Wire-compression codec layer: quantized gradients + compressed deltas.

ASAP (arXiv:1612.08608) argues the right trade for asynchronous data-
parallel systems is *approximate with bounded error* on the wire; the
gradient-compression line of work (1-bit SGD, QSGD, error-feedback SGD)
makes that concrete for the PUSH path: quantize each gradient, keep the
quantization residual in a per-worker **error-feedback accumulator**, and
fold it into the next gradient before quantizing again.  The model then
never drifts unboundedly: after T pushes the applied sum equals the true
gradient sum minus only the CURRENT residual, and the residual is bounded
by one step's quantization error (see :func:`grad_error_bound`).

Two independent codecs live here, both conf-gated and both **off by
default = byte-identical wire** (the repo-wide discipline: every plane's
legacy wire is asserted byte-identical via per-op frame totals when its
knob is absent):

- **gradient quantization** (``async.codec.push`` = ``fp16`` | ``int8``):
  lossy-but-error-fed encode of dense ASGD PUSH payloads.  fp16 halves
  the gradient bytes; int8 (per-push max-abs scale) quarters them.
  Non-finite gradients (NaN/inf), fp16-overflowing magnitudes, sparse-
  encoded pushes, and ASAGA pushes (whose history scalars must be exact)
  all fall back to the raw f32 wire -- the codec degrades to exact,
  never to poisoned.

- **snapshot-delta compression** (the relaycast plane's
  ``async.relay.compress``): **lossless** zlib over the XOR-delta /
  full model payloads of ``net/wiredelta.py``.  XOR deltas of a
  training step are structurally compressible (sign/exponent bits of
  consecutive versions agree, so xor words lead with zero bytes, and
  the index half is ascending u32), and losslessness means the
  CRC-gating contract is untouched: decompress, then the stock decode
  verifies the version CRC exactly as before.

Native fast path (``async.native.enabled``, native/wirecodec.cc): the
quantize/dequantize passes (error-feedback fold included) and the
byte-shuffle / delta-index transforms dispatch to GIL-free C twins; the
numpy implementations (``_py_*``) stay the registered bit-identity
oracles (``NATIVE_ORACLES``, ``native-oracle`` lint) and the fallback
without a toolchain.  zlib itself already runs in C with the GIL
released, so deflate stays on the stdlib.  Bit-identical either way --
property-tested in tests/test_native.py incl. NaN/inf/-0.
"""

from __future__ import annotations

import ctypes
import threading
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from asyncframework_tpu_torch.metrics import profiler as _prof
from asyncframework_tpu_torch.native_build import bump_native as _bump_native

#: gradient-codec names (``async.codec.push`` values)
OFF = "off"
FP16 = "fp16"
INT8 = "int8"
GRAD_CODECS = (OFF, FP16, INT8)

#: fp16 magnitudes past this overflow to inf; ship such pushes raw
_FP16_SAFE_MAX = 6.0e4
#: fp16 relative quantization error (one ulp at 11 significand bits)
_FP16_REL = 2.0 ** -11
#: fp16 subnormal floor (absolute error near zero)
_FP16_ABS = 6.0e-8

_lock = threading.Lock()
_totals: Dict[str, int] = {}


def _bump(key: str, n: int = 1) -> None:
    with _lock:
        _totals[key] = _totals.get(key, 0) + n


def codec_totals() -> Dict[str, int]:
    """Flat monotone counters (metrics/registry.py ``codec`` family):
    grad_enc_fp16/int8, grad_enc_raw_fallback, grad_dec, grad_bytes_raw/
    grad_bytes_wire, snap_compressed, snap_incompressible,
    snap_bytes_raw/snap_bytes_wire, snap_decompressed."""
    with _lock:
        return dict(_totals)


def reset_codec_totals() -> None:
    with _lock:
        _totals.clear()


# --------------------------------------------------------- native loading
#: native symbol -> same-module pure-Python oracle (``native-oracle``
#: lint table; every pair is property-tested for bit identity)
NATIVE_ORACLES = {
    "wc_enc_fp16": "_py_enc_fp16",
    "wc_enc_int8": "_py_enc_int8",
    "wc_dec_fp16": "_py_dec_fp16",
    "wc_dec_int8": "_py_dec_int8",
    "wc_shuffle4": "_py_shuffle4",
    "wc_unshuffle4": "_py_unshuffle4",
    "wc_delta_idx": "_py_delta_idx",
    "wc_cumsum_idx": "_py_cumsum_idx",
}

_NATIVE = None


def _native_lib():
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE or None
    lib = None
    try:
        from asyncframework_tpu_torch.native_build import ensure_built

        built = ensure_built("wirecodec")
        if built:
            lib = ctypes.CDLL(built)
            P, LL = ctypes.c_void_p, ctypes.c_longlong
            lib.wc_enc_fp16.restype = ctypes.c_int
            lib.wc_enc_fp16.argtypes = [P, P, LL, P, P, ctypes.c_double]
            lib.wc_enc_int8.restype = ctypes.c_int
            lib.wc_enc_int8.argtypes = [P, P, LL, P, P, P]
            lib.wc_dec_fp16.restype = None
            lib.wc_dec_fp16.argtypes = [P, LL, P]
            lib.wc_dec_int8.restype = None
            lib.wc_dec_int8.argtypes = [P, LL, ctypes.c_float, P]
            lib.wc_shuffle4.restype = None
            lib.wc_shuffle4.argtypes = [P, LL, P]
            lib.wc_unshuffle4.restype = None
            lib.wc_unshuffle4.argtypes = [P, LL, P]
            lib.wc_delta_idx.restype = None
            lib.wc_delta_idx.argtypes = [P, LL, P]
            lib.wc_cumsum_idx.restype = None
            lib.wc_cumsum_idx.argtypes = [P, LL, P]
    except Exception:  # noqa: BLE001 - fall back to Python
        lib = None
    _NATIVE = lib or False
    return lib


def _use_native():
    from asyncframework_tpu_torch.conf import NATIVE_ENABLED, global_conf

    if not global_conf().get(NATIVE_ENABLED):
        return None
    lib = _native_lib()
    if lib is None:
        _bump_native("python_fallbacks")
    return lib


def _addr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


# ------------------------------------------------------------ gradient path
def grad_error_bound(codec: str, absmax: float) -> float:
    """Per-coordinate quantization error bound of ONE encode whose input
    (gradient + carried residual) has max-abs ``absmax``.  This is also
    the bound on the error-feedback residual itself, and therefore on
    the model's deviation from the uncompressed trajectory at any time
    (times the step size): the residual never compounds, because every
    encode folds the previous residual back in before quantizing."""
    if codec == INT8:
        # scale = absmax/127, rint rounds to the nearest level: s/2
        return absmax / 254.0
    if codec == FP16:
        return absmax * _FP16_REL + _FP16_ABS
    return 0.0


def _py_enc_fp16(x: np.ndarray, absmax: float):
    """fp16 oracle: returns (hdr, payload, new_err) or None (overflow).
    ``x`` is the residual-folded f32 input, known finite."""
    if absmax > _FP16_SAFE_MAX:
        return None
    q = x.astype(np.float16)
    applied = q.astype(np.float32)
    return {"gq": FP16}, q.tobytes(), x - applied


def _py_enc_int8(x: np.ndarray, absmax: float):
    """int8 oracle: returns (hdr, payload, new_err); never refuses."""
    scale = absmax / 127.0
    if scale > 0.0:
        q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
        applied = q.astype(np.float32) * np.float32(scale)
    else:
        q = np.zeros(x.shape, np.int8)
        applied = np.zeros(x.shape, np.float32)
    return {"gq": INT8, "gs": float(scale)}, q.tobytes(), x - applied


@_prof.zoned("wire.quantize")
def encode_grad(g: np.ndarray, codec: str, err: Optional[np.ndarray]
                ) -> Optional[Tuple[dict, bytes, np.ndarray]]:
    """Quantize ``g`` (float32) with error feedback.

    ``err`` is this worker's carried residual (None on the first push).
    Returns ``(header_fields, payload, new_err)``, or **None** when the
    push must ship raw f32: codec off, non-finite input (a NaN/inf
    gradient quantizes to garbage -- exactness is the only safe
    encoding), or an fp16-overflowing magnitude.  On the None path the
    residual is NOT consumed -- it simply rides to the next quantized
    push (the raw push is exact, so skipping the fold loses nothing).
    """
    if codec == OFF:
        return None
    if codec not in GRAD_CODECS:
        raise ValueError(f"unknown gradient codec {codec!r}")
    lib = _use_native()
    if (lib is not None and g.flags.c_contiguous
            and (err is None
                 or (err.flags.c_contiguous and err.size == g.size))):
        # the C twin folds the residual, scans finiteness, and
        # quantizes in ONE GIL-free pass; refusal statuses mirror the
        # oracle's None paths exactly
        n = int(g.size)
        new_err = np.empty(n, np.float32).reshape(g.shape)
        earg = _addr(err) if err is not None else None
        _bump_native("native_calls.quantize")
        if codec == FP16:
            q16 = np.empty(n, np.uint16)
            st = lib.wc_enc_fp16(_addr(g), earg, n, _addr(q16),
                                 _addr(new_err), _FP16_SAFE_MAX)
            if st != 0:  # 1 = non-finite, 2 = overflow
                _bump("grad_enc_raw_fallback")
                return None
            hdr, payload = {"gq": FP16}, q16.tobytes()
            _bump("grad_enc_fp16")
        else:  # INT8
            q8 = np.empty(n, np.int8)
            sc = ctypes.c_double()
            st = lib.wc_enc_int8(_addr(g), earg, n, _addr(q8),
                                 _addr(new_err), ctypes.byref(sc))
            if st != 0:
                _bump("grad_enc_raw_fallback")
                return None
            hdr, payload = {"gq": INT8, "gs": float(sc.value)}, q8.tobytes()
            _bump("grad_enc_int8")
        _bump("grad_bytes_raw", int(g.nbytes))
        _bump("grad_bytes_wire", len(payload))
        return hdr, payload, new_err
    _bump_native("python_calls.quantize")
    x = g + err if err is not None else np.array(g, np.float32)
    if not np.isfinite(x).all():
        _bump("grad_enc_raw_fallback")
        return None
    absmax = float(np.max(np.abs(x))) if x.size else 0.0
    if codec == FP16:
        enc = _py_enc_fp16(x, absmax)
        if enc is None:
            _bump("grad_enc_raw_fallback")
            return None
        _bump("grad_enc_fp16")
    else:  # INT8
        enc = _py_enc_int8(x, absmax)
        _bump("grad_enc_int8")
    hdr, payload, new_err = enc
    _bump("grad_bytes_raw", int(g.nbytes))
    _bump("grad_bytes_wire", len(payload))
    return hdr, payload, new_err


def _py_dec_fp16(payload) -> np.ndarray:
    return np.frombuffer(payload, np.float16).astype(np.float32)


def _py_dec_int8(payload, gs: float) -> np.ndarray:
    return (np.frombuffer(payload, np.int8).astype(np.float32)
            * np.float32(gs))


@_prof.zoned("wire.quantize")
def decode_grad(header: dict, payload, d: int) -> np.ndarray:
    """Server-side decode of a quantized PUSH payload back to float32.
    Raises ``ValueError`` on a malformed frame (wrong codec tag or
    payload length) -- the server answers ERR instead of applying."""
    gq = header.get("gq")
    lib = _use_native()
    if gq == FP16:
        if len(payload) != 2 * d:
            raise ValueError(f"fp16 push wants {2 * d} bytes, "
                             f"got {len(payload)}")
        if lib is not None:
            q = np.frombuffer(payload, np.uint16)
            g = np.empty(d, np.float32)
            lib.wc_dec_fp16(_addr(q), d, _addr(g))
            _bump_native("native_calls.quantize")
        else:
            _bump_native("python_calls.quantize")
            g = _py_dec_fp16(payload)
    elif gq == INT8:
        if len(payload) != d:
            raise ValueError(f"int8 push wants {d} bytes, "
                             f"got {len(payload)}")
        gs = header.get("gs")
        if gs is None or not np.isfinite(float(gs)) or float(gs) < 0.0:
            # a missing/garbage scale must answer ERR, not silently
            # apply an all-zero (or poisoned) gradient
            raise ValueError(f"int8 push with bad scale {gs!r}")
        if lib is not None:
            q = np.frombuffer(payload, np.int8)
            g = np.empty(d, np.float32)
            lib.wc_dec_int8(_addr(q), d,
                            ctypes.c_float(np.float32(gs)), _addr(g))
            _bump_native("native_calls.quantize")
        else:
            _bump_native("python_calls.quantize")
            g = _py_dec_int8(payload, gs)
    else:
        raise ValueError(f"unknown gradient codec tag {gq!r}")
    _bump("grad_dec")
    return g


# ------------------------------------------------------------ snapshot path
#: do not bother compressing payloads under this (zlib header overhead)
_SNAP_MIN_BYTES = 64
#: deflate level for snapshot deltas: the relay plane trades a little
#: encode CPU for wire bytes by design (one encode serves a subtree)
_SNAP_LEVEL = 6


def _py_shuffle4(payload: bytes) -> bytes:
    return np.frombuffer(payload, np.uint8).reshape(-1, 4).T.tobytes()


def _py_unshuffle4(payload: bytes) -> bytes:
    a = np.frombuffer(payload, np.uint8).reshape(4, -1).T
    return np.ascontiguousarray(a).tobytes()


def _py_delta_idx(idx: np.ndarray) -> np.ndarray:
    return np.diff(idx, prepend=np.uint32(0)).astype(np.uint32)


def _py_cumsum_idx(idxd: np.ndarray) -> np.ndarray:
    return np.cumsum(idxd.astype(np.uint64)).astype(np.uint32)


def _shuffle4(payload: bytes) -> bytes:
    """Byte-plane transposition over 4-byte words (the Blosc/HDF5
    shuffle filter): all byte-0s, then all byte-1s, ...  XOR words of
    consecutive training versions agree in their high bytes, so the
    transposed planes are runs deflate actually crunches.  Exact
    inverse in :func:`_unshuffle4`; requires word alignment."""
    lib = _use_native()
    if lib is not None:
        src = np.frombuffer(payload, np.uint8)
        dst = np.empty(src.size, np.uint8)
        lib.wc_shuffle4(_addr(src), src.size, _addr(dst))
        _bump_native("native_calls.shuffle")
        return dst.tobytes()
    _bump_native("python_calls.shuffle")
    return _py_shuffle4(payload)


def _unshuffle4(payload: bytes) -> bytes:
    lib = _use_native()
    if lib is not None:
        src = np.frombuffer(payload, np.uint8)
        dst = np.empty(src.size, np.uint8)
        lib.wc_unshuffle4(_addr(src), src.size, _addr(dst))
        _bump_native("native_calls.shuffle")
        return dst.tobytes()
    _bump_native("python_calls.shuffle")
    return _py_unshuffle4(payload)


def _delta_idx(idx: np.ndarray) -> np.ndarray:
    lib = _use_native()
    if lib is not None:
        out = np.empty(idx.size, np.uint32)
        lib.wc_delta_idx(_addr(idx), int(idx.size), _addr(out))
        _bump_native("native_calls.shuffle")
        return out
    _bump_native("python_calls.shuffle")
    return _py_delta_idx(idx)


def _cumsum_idx(idxd: np.ndarray) -> np.ndarray:
    lib = _use_native()
    if lib is not None:
        out = np.empty(idxd.size, np.uint32)
        lib.wc_cumsum_idx(_addr(idxd), int(idxd.size), _addr(out))
        _bump_native("native_calls.shuffle")
        return out
    _bump_native("python_calls.shuffle")
    return _py_cumsum_idx(idxd)


@_prof.zoned("wire.compress")
def compress_model_part(wenc: str, payload: bytes, nnz: int = 0
                        ) -> Tuple[dict, bytes]:
    """LOSSLESS compression of a model-part payload for the relay wire.

    Structure-aware, tag carried as the ``cz`` header field:

    - ``zd`` (sparse XOR delta with known ``nnz``): the ascending index
      half is delta-encoded (consecutive differences -- small ints with
      three near-zero byte planes) and both halves byte-shuffled before
      deflate;
    - ``zs`` (any word-aligned payload -- XFULL dense xor, FULL f32):
      byte-shuffle + deflate;
    - ``z``: plain deflate (unaligned fallback).

    Whichever candidate is smallest ships; if none beats raw, the
    payload ships unchanged (fields empty).  The consumer inverts the
    transform BEFORE ``wiredelta.decode``, so CRC gating sees exactly
    the original bytes -- compression can fail to help, never corrupt.
    """
    n = len(payload)
    if n < _SNAP_MIN_BYTES:
        return {}, payload
    best = ({}, payload)
    if wenc == "xdelta" and nnz > 0 and n == 8 * nnz:
        idx = np.frombuffer(payload[: 4 * nnz], np.uint32)
        idxd = _delta_idx(idx)
        z = zlib.compress(_shuffle4(idxd.tobytes())
                          + _shuffle4(payload[4 * nnz:]), _SNAP_LEVEL)
        if len(z) < len(best[1]):
            best = ({"cz": "zd", "ulen": n}, z)
    if n % 4 == 0:
        z = zlib.compress(_shuffle4(payload), _SNAP_LEVEL)
        if len(z) < len(best[1]):
            best = ({"cz": "zs", "ulen": n}, z)
    else:
        z = zlib.compress(payload, 1)
        if len(z) < len(best[1]):
            best = ({"cz": "z", "ulen": n}, z)
    if not best[0]:
        _bump("snap_incompressible")
        return best
    _bump("snap_compressed")
    _bump("snap_bytes_raw", n)
    _bump("snap_bytes_wire", len(best[1]))
    return best


@_prof.zoned("wire.compress")
def decompress_model_part(header: dict, payload) -> bytes:
    """Undo :func:`compress_model_part` (no-op for an uncompressed
    reply).  Raises ``ValueError`` on corrupt/length-mismatched data --
    callers treat it like a CRC mismatch (full-refetch fallback)."""
    cz = header.get("cz")
    if cz is None:
        return bytes(payload)
    if cz not in ("z", "zs", "zd"):
        raise ValueError(f"unknown compression tag {cz!r}")
    try:
        out = zlib.decompress(bytes(payload))
    except zlib.error as e:
        raise ValueError(f"corrupt compressed payload: {e}") from e
    ulen = int(header.get("ulen", -1))
    if len(out) != ulen:
        raise ValueError(f"decompressed to {len(out)} bytes, "
                         f"header says {ulen}")
    if cz == "zd":
        nnz = int(header.get("nnz", 0))
        if ulen != 8 * nnz or nnz <= 0:
            raise ValueError(f"zd payload: ulen={ulen} vs nnz={nnz}")
        idxd = np.frombuffer(_unshuffle4(out[: 4 * nnz]), np.uint32)
        xorw = _unshuffle4(out[4 * nnz:])
        idx = _cumsum_idx(idxd)
        out = idx.tobytes() + xorw
    elif cz == "zs":
        if ulen % 4 != 0:
            raise ValueError(f"zs payload: unaligned ulen={ulen}")
        out = _unshuffle4(out)
    _bump("snap_decompressed")
    return out
