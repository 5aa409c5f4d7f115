"""The profiling hooks of the DCN plane's choke points.

The JAX package's ``metrics/profiler.py`` is a sampling and exact-zone
profiler that its deploy daemons and live UI install.  This package
installs none yet (ROADMAP A5b), so it keeps only the hooks that the
copied ``net/*`` modules and the PS's merge drain call, in their
uninstalled form: :func:`zone` returns one shared no-op context manager
and :func:`zoned` returns the function unchanged.  A zone name must be one
of the JAX package's declared zones, as there.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

#: the JAX package's declared zone table
ZONES: Tuple[str, ...] = (
    "wire.encode",      # frame pump, send side: header stamp + sendall
    "wire.decode",      # frame pump, recv side: recv_exact + header parse
    "wire.xor",         # XOR bit-pattern delta encode/decode (wiredelta)
    "wire.crc",         # basis CRC gating (wiredelta.crc)
    "wire.quantize",    # gradient quantize/dequantize (wirecodec fp16/int8)
    "wire.compress",    # model-part compress/decompress (wirecodec)
    "merge.drain",      # PS merge-queue drain + fused apply dispatch
    "kernel.dispatch",  # step dispatch
    "serde",            # JSON header encode/decode and friends
    "gil.other",        # sampled Python time not claimed by any rule
)


class _NoopZone:
    """The uninstalled timing scope: one shared instance, no state."""

    __slots__ = ()

    def __enter__(self) -> "_NoopZone":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None


_NOOP_ZONE = _NoopZone()


def zone(name: str) -> Any:
    """Timing scope for one zone: ``with zone("wire.encode"): ...``."""
    return _NOOP_ZONE


def zoned(name: str) -> Callable[[Callable], Callable]:
    """Decorator form of :func:`zone` for whole-function choke points."""
    if name not in ZONES:
        raise ValueError(f"undeclared profile zone {name!r}")
    return lambda fn: fn
