"""Probabilistic sketches: Count-Min and Bloom filter.

Parity: ``common/sketch`` (Java ``CountMinSketch`` / ``BloomFilter``, used by
SQL stat functions and join planning).  Both are mergeable -- the distributed
usage pattern is per-partition sketches combined on the driver, which is how
``DistributedDataset.aggregate`` consumes them here.

Vectorized NumPy throughout: updates take whole arrays (one hash broadcast
per row batch), not per-item loops.  Hashing is double hashing over two
xxhash-style integer mixes, ``h_i(x) = h1(x) + i * h2(x)`` -- the standard
Kirsch-Mitzenmacher construction the reference's Bloom filter also uses.

A copy of the JAX package's ``utils/sketch.py`` (numpy only): the same
items land in the same counters, bits and registers in both packages, so
a sketch built by either merges with the other's.
"""

from __future__ import annotations

from typing import Iterable, Union

import numpy as np

_M1 = np.uint64(0xFF51AFD7ED558CCD)
_M2 = np.uint64(0xC4CEB9FE1A85EC53)


def _mix64(x: np.ndarray, seed: int) -> np.ndarray:
    """splitmix64-style avalanche over uint64 arrays."""
    with np.errstate(over="ignore"):
        h = x.astype(np.uint64) + np.uint64(seed) * np.uint64(
            0x9E3779B97F4A7C15
        )
        h ^= h >> np.uint64(33)
        h *= _M1
        h ^= h >> np.uint64(33)
        h *= _M2
        h ^= h >> np.uint64(33)
    return h


def _to_u64(items) -> np.ndarray:
    """Hash item arrays (or scalars) to 1-d uint64: ints pass through,
    floats via bit pattern, strings/bytes via an FNV-1a polynomial hash;
    object arrays dispatch per element by type."""
    a = np.atleast_1d(np.asarray(items))
    if a.dtype.kind in "iu":
        return a.astype(np.uint64)
    if a.dtype.kind == "f":
        return a.astype(np.float64).view(np.uint64)
    if a.dtype.kind in ("U", "S", "O"):
        out = np.empty(a.shape[0], np.uint64)
        with np.errstate(over="ignore"):
            for i, s in enumerate(a):
                if isinstance(s, (int, np.integer)):
                    out[i] = np.uint64(int(s) & 0xFFFFFFFFFFFFFFFF)
                    continue
                if isinstance(s, (float, np.floating)):
                    out[i] = np.asarray(float(s)).view(np.uint64)
                    continue
                if isinstance(s, str):
                    b = s.encode()
                elif isinstance(s, (bytes, np.bytes_)):
                    b = bytes(s)
                else:
                    raise TypeError(f"unhashable item type {type(s)}")
                h = np.uint64(1469598103934665603)
                for byte in b:
                    h = (h ^ np.uint64(byte)) * np.uint64(1099511628211)
                out[i] = h
        return out
    raise TypeError(f"unhashable dtype {a.dtype}")


class CountMinSketch:
    """Approximate frequency counting: overestimates, never underestimates.

    ``depth`` rows of ``width`` counters; estimate = min over rows.
    """

    def __init__(self, depth: int = 5, width: int = 1 << 12, seed: int = 42):
        if depth < 1 or width < 1:
            raise ValueError("depth and width must be >= 1")
        self.depth = depth
        self.width = width
        self.seed = seed
        self.table = np.zeros((depth, width), np.int64)
        self.total = 0

    def _slots(self, items) -> np.ndarray:
        keys = _to_u64(items)
        h1 = _mix64(keys, self.seed)
        h2 = _mix64(keys, self.seed + 1) | np.uint64(1)
        rows = np.arange(self.depth, dtype=np.uint64)[:, None]
        with np.errstate(over="ignore"):
            return ((h1[None, :] + rows * h2[None, :])
                    % np.uint64(self.width)).astype(np.intp)

    def add(self, items, counts: Union[int, np.ndarray] = 1) -> None:
        slots = self._slots(items)  # (depth, n)
        counts = np.broadcast_to(np.asarray(counts, np.int64), slots.shape[1:])
        for r in range(self.depth):
            np.add.at(self.table[r], slots[r], counts)
        self.total += int(counts.sum())

    def estimate(self, items) -> np.ndarray:
        slots = self._slots(items)
        ests = np.stack([self.table[r][slots[r]] for r in range(self.depth)])
        return ests.min(axis=0)

    def merge(self, other: "CountMinSketch") -> "CountMinSketch":
        if (self.depth, self.width, self.seed) != (
            other.depth, other.width, other.seed
        ):
            raise ValueError("can only merge identically-configured sketches")
        self.table += other.table
        self.total += other.total
        return self


class BloomFilter:
    """Approximate membership: no false negatives, tunable false positives."""

    def __init__(self, capacity: int = 10_000, fpp: float = 0.03,
                 seed: int = 42):
        if not 0 < fpp < 1:
            raise ValueError("fpp must be in (0, 1)")
        # standard sizing: m = -n ln p / ln2^2, k = m/n ln2
        m = int(np.ceil(-capacity * np.log(fpp) / (np.log(2) ** 2)))
        self.num_bits = max(64, m)
        self.num_hashes = max(1, int(round(m / capacity * np.log(2))))
        self.seed = seed
        self.bits = np.zeros((self.num_bits + 63) // 64, np.uint64)

    def _positions(self, items) -> np.ndarray:
        keys = _to_u64(items)
        h1 = _mix64(keys, self.seed)
        h2 = _mix64(keys, self.seed + 1) | np.uint64(1)
        ks = np.arange(self.num_hashes, dtype=np.uint64)[:, None]
        with np.errstate(over="ignore"):
            return ((h1[None, :] + ks * h2[None, :])
                    % np.uint64(self.num_bits)).astype(np.intp)

    def add(self, items) -> None:
        pos = self._positions(items).ravel()
        np.bitwise_or.at(
            self.bits, pos >> 6, np.uint64(1) << (pos & 63).astype(np.uint64)
        )

    def might_contain(self, items) -> np.ndarray:
        pos = self._positions(items)  # (k, n)
        word = self.bits[pos >> 6]
        bit = (word >> (pos & 63).astype(np.uint64)) & np.uint64(1)
        return bit.all(axis=0)

    def merge(self, other: "BloomFilter") -> "BloomFilter":
        if (self.num_bits, self.num_hashes, self.seed) != (
            other.num_bits, other.num_hashes, other.seed
        ):
            raise ValueError("can only merge identically-configured filters")
        self.bits |= other.bits
        return self


class HyperLogLog:
    """Cardinality sketch (``countApproxDistinct``'s engine).

    Parity: the reference uses stream-lib's HyperLogLogPlus
    (``rdd/RDD.scala`` countApproxDistinct); this is a clean classic HLL:
    2^p registers keeping the max leading-zero rank per bucket, harmonic
    mean estimate with small-range linear counting, mergeable by register
    max.  Standard error ~= 1.04 / sqrt(2^p).
    """

    def __init__(self, p: int = 14, seed: int = 42):
        if not 4 <= p <= 18:
            raise ValueError("p must be in [4, 18]")
        self.p = p
        self.m = 1 << p
        self.seed = seed
        self.registers = np.zeros(self.m, np.uint8)
        if self.m >= 128:
            self._alpha = 0.7213 / (1.0 + 1.079 / self.m)
        elif self.m == 64:
            self._alpha = 0.709
        elif self.m == 32:
            self._alpha = 0.697
        else:
            self._alpha = 0.673

    def add(self, items) -> None:
        h = _mix64(_to_u64(items), self.seed)
        bucket = (h >> np.uint64(64 - self.p)).astype(np.int64)
        rest = (h << np.uint64(self.p)) | np.uint64((1 << self.p) - 1)
        # rank = leading zeros of the remaining bits + 1
        lz = np.zeros(len(rest), np.uint8)
        probe = np.uint64(1) << np.uint64(63)
        cur = rest.copy()
        for _ in range(64 - self.p + 1):
            mask = (cur & probe) == 0
            lz[mask] += 1
            cur[mask] = cur[mask] << np.uint64(1)
            if not mask.any():
                break
        rank = lz + 1
        np.maximum.at(self.registers, bucket, rank)

    def estimate(self) -> float:
        regs = self.registers.astype(np.float64)
        raw = self._alpha * self.m * self.m / np.sum(2.0 ** (-regs))
        zeros = int(np.count_nonzero(self.registers == 0))
        if raw <= 2.5 * self.m and zeros:
            return float(self.m * np.log(self.m / zeros))  # linear counting
        return float(raw)

    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        if other.p != self.p or other.seed != self.seed:
            raise ValueError("can only merge HLLs with identical (p, seed)")
        self.registers = np.maximum(self.registers, other.registers)
        return self

    @property
    def relative_error(self) -> float:
        return 1.04 / np.sqrt(self.m)
