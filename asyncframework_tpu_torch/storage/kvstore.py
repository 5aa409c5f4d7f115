"""Embedded persistent key/value store (history / app-status state).

Parity: the reference's ``common/kvstore`` -- a LevelDB-backed (leveldbjni,
``pom.xml:468``) embedded KV used by the UI/status store and history server,
NOT by the data path.  Here the same capability is an append-only record log
with an in-memory index and compaction:

- native backend: ``native/kvstore.cc`` via ctypes (built on demand);
- pure-Python fallback speaking the **identical file format** (magic
  ``AKV1``; ``[u32 klen][u32 vlen][key][val]`` records, ``vlen=0xFFFFFFFF``
  tombstones), so a store written by either implementation opens in both.

The Python-facing API is dict-like over ``bytes``/``str`` keys and values,
plus a JSON object layer (:meth:`put_obj`/:meth:`get_obj`) matching how the
reference stores typed records via its ``KVStoreSerializer``.

A copy of the JAX package's ``storage/kvstore.py``.  The native backend is
built through this package's own gateway (``native_build.py``, into
``asyncframework_tpu_torch/_build/native/``), never loaded from the JAX
package's ``native/*.so``.  ``backend="auto"`` takes the Python backend
only where the JAX package does -- the library cannot be built or loaded
-- and counts each such open in ``python_fallbacks`` of
``native_build.native_totals()``; ``backend="native"`` raises instead.
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
import threading
from typing import Dict, Iterator, Optional, Union

from asyncframework_tpu_torch.native_build import bump_native

_MAGIC = b"AKV1"
_TOMBSTONE = 0xFFFFFFFF

Bytes = Union[bytes, str]


def _to_bytes(x: Bytes) -> bytes:
    return x.encode() if isinstance(x, str) else x


def string_hash_code(s: Bytes) -> int:
    """Java ``String.hashCode`` semantics (parity with the reference's only
    in-tree C file, ``R/pkg/src-native/string_hash_code.c``): int32 rolling
    ``h = 31*h + byte`` with wraparound."""
    h = 0
    for b in _to_bytes(s):
        h = (h * 31 + b) & 0xFFFFFFFF
    return h - 0x100000000 if h >= 0x80000000 else h


_LIB = None

#: native symbol -> pure-Python twin (native-oracle lint contract).
#: The twin here is class-shaped: ``_PyBackend`` speaks the identical
#: AKV1 file format and backend selection happens once, in
#: ``KVStore.__init__``.
NATIVE_ORACLES = {
    "kv_open": "_PyBackend.__init__",
    "kv_put": "_PyBackend.put",
    "kv_get": "_PyBackend.get",
    "kv_get_len": "_PyBackend.get",
    "kv_delete": "_PyBackend.delete",
    "kv_count": "_PyBackend.count",
    "kv_compact": "_PyBackend.compact",
    "kv_keys_size": "_PyBackend.keys",
    "kv_keys_fill": "_PyBackend.keys",
    "kv_close": "_PyBackend.close",
    "string_hash_code": "string_hash_code",
}


def _native_lib():
    global _LIB
    if _LIB is not None:
        return _LIB or None
    from asyncframework_tpu_torch.native_build import ensure_built

    path = ensure_built("kvstore")
    if path is None:
        _LIB = False
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        _LIB = False
        return None
    lib.kv_open.restype = ctypes.c_void_p
    lib.kv_open.argtypes = [ctypes.c_char_p]
    lib.kv_put.restype = ctypes.c_int
    lib.kv_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                           ctypes.c_char_p, ctypes.c_uint32]
    lib.kv_get.restype = ctypes.c_longlong
    lib.kv_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                           ctypes.c_char_p, ctypes.c_longlong]
    lib.kv_get_len.restype = ctypes.c_longlong
    lib.kv_get_len.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.kv_delete.restype = ctypes.c_int
    lib.kv_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.kv_count.restype = ctypes.c_longlong
    lib.kv_count.argtypes = [ctypes.c_void_p]
    lib.kv_compact.restype = ctypes.c_int
    lib.kv_compact.argtypes = [ctypes.c_void_p]
    lib.kv_keys_size.restype = ctypes.c_longlong
    lib.kv_keys_size.argtypes = [ctypes.c_void_p]
    lib.kv_keys_fill.restype = ctypes.c_longlong
    lib.kv_keys_fill.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_longlong]
    lib.kv_close.restype = None
    lib.kv_close.argtypes = [ctypes.c_void_p]
    lib.string_hash_code.restype = ctypes.c_int
    lib.string_hash_code.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    _LIB = lib
    return lib


class _PyBackend:
    """Pure-Python reader/writer of the shared AKV1 log format."""

    def __init__(self, path: str):
        self.path = path
        self.live: Dict[bytes, bytes] = {}
        fresh = not os.path.exists(path)
        if not fresh and os.path.getsize(path) < len(_MAGIC):
            # crash between file creation and the magic write: treat as fresh
            # (consistent with the torn-tail truncation policy) instead of
            # failing every subsequent open as "not an AKV1 kvstore"
            os.remove(path)
            fresh = True
        if not fresh:
            valid_end = self._load()
            if valid_end is not None:
                # torn tail from a crashed writer: truncate before appending,
                # otherwise new records land after garbage and the *next*
                # reopen misparses everything from the torn point on
                with open(path, "r+b") as f:
                    f.truncate(valid_end)
        self._f = open(path, "ab")
        if fresh:
            self._f.write(_MAGIC)
            self._f.flush()

    def _load(self) -> Optional[int]:
        """Replay the log; returns the offset of a torn tail (to truncate)
        or None when the file ends on a record boundary."""
        with open(self.path, "rb") as f:
            if f.read(4) != _MAGIC:
                raise ValueError(f"{self.path}: not an AKV1 kvstore")
            while True:
                rec_start = f.tell()
                hdr = f.read(8)
                if not hdr:
                    return None  # clean end
                if len(hdr) < 8:
                    return rec_start
                kl, vl = struct.unpack("<II", hdr)
                key = f.read(kl)
                if len(key) < kl:
                    return rec_start  # torn record
                if vl == _TOMBSTONE:
                    self.live.pop(key, None)
                    continue
                val = f.read(vl)
                if len(val) < vl:
                    return rec_start  # torn record
                self.live[key] = val

    def put(self, key: bytes, val: bytes) -> None:
        self._f.write(struct.pack("<II", len(key), len(val)))
        self._f.write(key)
        self._f.write(val)
        self._f.flush()
        self.live[key] = val

    def get(self, key: bytes) -> Optional[bytes]:
        return self.live.get(key)

    def delete(self, key: bytes) -> None:
        self._f.write(struct.pack("<II", len(key), _TOMBSTONE))
        self._f.write(key)
        self._f.flush()
        self.live.pop(key, None)

    def count(self) -> int:
        return len(self.live)

    def keys(self):
        return list(self.live.keys())

    def compact(self) -> None:
        tmp = self.path + ".compact"
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            for k, v in self.live.items():
                f.write(struct.pack("<II", len(k), len(v)))
                f.write(k)
                f.write(v)
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")

    def close(self) -> None:
        self._f.close()


class _NativeBackend:
    def __init__(self, lib, path: str):
        self._lib = lib
        self._h = lib.kv_open(path.encode())
        if not self._h:
            raise ValueError(f"{path}: native kv_open failed (bad magic?)")

    def put(self, key: bytes, val: bytes) -> None:
        if self._lib.kv_put(self._h, key, len(key), val, len(val)) != 0:
            raise IOError("kv_put failed")

    def get(self, key: bytes) -> Optional[bytes]:
        n = self._lib.kv_get_len(self._h, key, len(key))
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(int(n))
        got = self._lib.kv_get(self._h, key, len(key), buf, n)
        if got < 0:
            return None
        return buf.raw[:got]

    def delete(self, key: bytes) -> None:
        self._lib.kv_delete(self._h, key, len(key))

    def count(self) -> int:
        return int(self._lib.kv_count(self._h))

    def keys(self):
        size = self._lib.kv_keys_size(self._h)
        buf = ctypes.create_string_buffer(int(size) or 1)
        n = self._lib.kv_keys_fill(self._h, buf, size)
        out, off = [], 0
        raw = buf.raw[: max(n, 0)]
        while off < len(raw):
            (kl,) = struct.unpack_from("<I", raw, off)
            off += 4
            out.append(raw[off:off + kl])
            off += kl
        return out

    def compact(self) -> None:
        if self._lib.kv_compact(self._h) != 0:
            raise IOError("kv_compact failed")

    def close(self) -> None:
        if self._h:
            self._lib.kv_close(self._h)
            self._h = None


class KVStore:
    """Dict-like persistent store; ``backend`` is 'auto' | 'native' | 'python'."""

    def __init__(self, path, backend: str = "auto"):
        path = str(path)
        self._lock = threading.Lock()
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown backend {backend!r}")
        lib = _native_lib() if backend in ("auto", "native") else None
        if backend == "native" and lib is None:
            raise RuntimeError("native kvstore backend unavailable (no g++?)")
        if backend == "auto" and lib is None:
            bump_native("python_fallbacks")
        self._b = _NativeBackend(lib, path) if lib is not None else _PyBackend(path)
        self.backend = "native" if lib is not None else "python"

    # ------------------------------------------------------------- raw bytes
    def put(self, key: Bytes, val: Bytes) -> None:
        with self._lock:
            self._b.put(_to_bytes(key), _to_bytes(val))

    def get(self, key: Bytes, default: Optional[bytes] = None) -> Optional[bytes]:
        with self._lock:
            v = self._b.get(_to_bytes(key))
        return default if v is None else v

    def delete(self, key: Bytes) -> None:
        with self._lock:
            self._b.delete(_to_bytes(key))

    def __contains__(self, key: Bytes) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        with self._lock:
            return self._b.count()

    def keys(self) -> Iterator[bytes]:
        with self._lock:
            return iter(sorted(self._b.keys()))

    def compact(self) -> None:
        with self._lock:
            self._b.compact()

    def close(self) -> None:
        with self._lock:
            self._b.close()

    # ----------------------------------------------------------- JSON object
    def put_obj(self, key: Bytes, obj) -> None:
        self.put(key, json.dumps(obj).encode())

    def get_obj(self, key: Bytes, default=None):
        v = self.get(key)
        return default if v is None else json.loads(v.decode())

    def __enter__(self) -> "KVStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
