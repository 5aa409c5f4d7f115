"""Device-side shuffle for array-typed pair data.

Parity role: ``shuffle/sort/SortShuffleManager.scala:69`` -- the engine
component that moves (key, value) records to their key's partition and
reduces them there.  The reference sorts spill files and fetches blocks over
TCP because its partitions live in different JVMs; the pair ops normally
route through the driver (data/pairs.py -- fine at control-plane sizes).
THIS module is the data-plane path for numeric-array payloads.

Counterpart of ``asyncframework_tpu/ops/shuffle.py``, with the same output
contract: ``{pid: (keys, values)}`` in, ``{pid: (unique_keys,
reduced_values)}`` out as HOST numpy arrays, each partition's keys sorted
ascending, key ``k`` in partition ``k mod P``.

- :func:`device_reduce_by_key` runs on the partitions' device in torch.
  When every partition shares one device (one card, or the CPU) it is the
  JAX package's shared-device path (``ops/shuffle.py:303-319``): one sort
  of the concatenated keys and one segment reduce (``index_add_`` for
  ``sum``, ``scatter_reduce_`` for ``max``/``min``), then the distinct set
  split by ``key mod P`` on the device and copied to the host once.
  Partitions on several devices need the JAX package's ``all_to_all``
  exchange (``:239-296``), which is ROADMAP A6b.6 here: it raises.
- :func:`host_reduce_by_key` is the vectorized host twin (numpy
  ``bincount`` / sort + ``reduceat``), copied from the JAX package; a
  card tensor handed to it is copied to the host first.

Keys must be non-negative integers (word ids, user ids -- the shapes the
data plane exists for); ``SENTINEL`` (-1) marks an invalid slot and is
dropped.  Arbitrary Python keys stay on the driver-routed path.
:data:`calls` counts each plane's calls.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.utils.devices import entry_devices

SENTINEL = -1  # invalid-slot key; real keys must be >= 0

_OPS = ("sum", "max", "min")

#: calls of each plane (``device_reduce_by_key`` / ``host_reduce_by_key``)
calls = {"device": 0, "host": 0}


def _check_op(op: str) -> None:
    if op not in _OPS:
        raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")


def _identity(op: str, dtype: torch.dtype):
    """Reduction identity valid for the VALUE dtype: integers use their
    extremes, floats +/-inf."""
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("-inf") if op == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def _segment_reduce(keys: torch.Tensor, vals: torch.Tensor, op: str,
                    out_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted segment reduction: the distinct keys of ``keys`` ascending
    and each one's reduced value, on the keys' device.

    ``SENTINEL`` keys are dropped.  Only the ``out_cap`` smallest distinct
    keys are kept: the rest are DROPPED, as the JAX package's out-of-range
    scatter drops them (``mode="drop"``).
    """
    sk, order = torch.sort(keys, stable=True)
    sv = vals[order]
    valid = sk != SENTINEL
    first = valid.clone()
    first[1:] &= sk[1:] != sk[:-1]
    seg = torch.cumsum(first, 0) - 1
    n_out = min(int(first.sum()), out_cap)
    keep = valid & (seg < n_out)
    # every dropped entry lands in the extra slot ``n_out``, cut off below
    seg = torch.where(keep, seg, n_out)
    dev = keys.device
    out_keys = torch.full((n_out + 1,), SENTINEL, dtype=keys.dtype,
                          device=dev)
    out_keys.scatter_(0, seg, sk)
    out_vals = torch.full((n_out + 1,), _identity(op, vals.dtype),
                          dtype=vals.dtype, device=dev)
    if op == "sum":
        out_vals.index_add_(0, seg, sv)
    else:
        out_vals.scatter_reduce_(0, seg, sv,
                                 reduce="amax" if op == "max" else "amin")
    return out_keys[:n_out], out_vals[:n_out]


def _host(x) -> np.ndarray:
    """A block as a host array (a tensor is copied off its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def host_reduce_by_key(
    parts: Dict[int, Tuple[np.ndarray, np.ndarray]],
    op: str = "sum",
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Vectorized host shuffle-reduce: the same contract as
    :func:`device_reduce_by_key` (key-mod-P output partitioning) computed
    with numpy -- ``bincount`` when the key range is dense enough, else one
    stable sort + ``reduceat``."""
    _check_op(op)
    calls["host"] += 1
    pids = sorted(parts)
    p = len(pids)
    if p == 0:
        return {}
    ks = np.concatenate([_host(parts[pid][0]) for pid in pids])
    vs = np.concatenate([_host(parts[pid][1]) for pid in pids])
    if ks.size == 0:
        return {pid: (ks[:0], vs[:0]) for pid in pids}
    uk = uv = None
    if op == "sum" and ks.dtype.kind in "iu":
        kmax = int(ks.max())
        # dense-enough key space: one bincount beats the sort.  Bound the
        # count/sum temporaries by the INPUT size (not a multiple of it):
        # a sparse 40M-key space over 10M pairs would otherwise allocate
        # ~640 MB of scratch where the sort path needs none
        if kmax + 1 <= max(ks.size, 1 << 20):
            present = np.bincount(ks, minlength=kmax + 1) > 0
            inexact = False
            if vs.dtype.kind in "iu":
                # bincount's float64 weight sums silently round integer
                # totals past 2^53.  |any key's sum| <= max|v| * n, so only
                # cross to exact accumulation when that bound can round --
                # wordcount-shaped inputs (small values, many pairs) keep
                # the fast bincount path
                bound = max(abs(int(vs.min())), abs(int(vs.max()))) * ks.size
                inexact = bound >= (1 << 53)
            if inexact:
                # exact int64 accumulation (np.add.at is slower than
                # bincount, but correctness beats speed past the boundary)
                sums = np.zeros(kmax + 1, np.int64)
                np.add.at(sums, ks, vs.astype(np.int64, copy=False))
            else:
                sums = np.bincount(ks, weights=vs, minlength=kmax + 1)
            uk = np.nonzero(present)[0].astype(ks.dtype)
            uv = sums[uk].astype(vs.dtype, copy=False)
    if uk is None:
        order = np.argsort(ks, kind="stable")
        sk, sv = ks[order], vs[order]
        first = np.ones(sk.size, bool)
        first[1:] = sk[1:] != sk[:-1]
        idx = np.nonzero(first)[0]
        uk = sk[idx]
        red = {"sum": np.add, "max": np.maximum, "min": np.minimum}[op]
        uv = red.reduceat(sv, idx).astype(vs.dtype, copy=False)
    t = uk % p
    order2 = np.argsort(t, kind="stable")
    st, suk, suv = t[order2], uk[order2], uv[order2]
    bounds = np.searchsorted(st, np.arange(p + 1))
    return {
        pid: (suk[bounds[i]:bounds[i + 1]], suv[bounds[i]:bounds[i + 1]])
        for i, pid in enumerate(pids)
    }


def device_reduce_by_key(
    parts: Dict[int, Tuple[torch.Tensor, torch.Tensor]],
    op: str = "sum",
    devices: Optional[Sequence] = None,
    distinct_hint: Optional[int] = None,
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Shuffle-reduce on the partitions' device: ``{pid: (keys, vals)}``
    -> ``{pid: (unique_keys, reduced_vals)}`` with key-mod-P partitioning,
    returned as HOST arrays (the payload boundary).

    Blocks that are not tensors go to ``devices[0]`` (the card when None;
    raises without one).  Every block must sit on one device: partitions
    on several devices raise ``NotImplementedError`` (the exchange between
    cards is ROADMAP A6b.6).

    ``distinct_hint``: an upper bound on distinct keys per partition block
    (e.g. the vocabulary size for a word count).  It caps the output at
    ``distinct_hint * P`` distinct keys, as the JAX package's
    shared-device path does (``ops/shuffle.py:311-312``).  Too small a
    hint DROPS the largest keys; it is a capacity promise, not a
    suggestion.
    """
    _check_op(op)
    pids = sorted(parts)
    p = len(pids)
    if p == 0:
        return {}
    calls["device"] += 1
    ks, vs = [], []
    for pid in pids:
        k, v = parts[pid]
        if not isinstance(k, torch.Tensor):
            dev = entry_devices(devices)[0]
            k = torch.as_tensor(np.asarray(k), device=dev)
            v = torch.as_tensor(np.asarray(v), device=dev)
        ks.append(k)
        vs.append(v.to(k.device))
    devs = sorted({str(k.device) for k in ks})
    if len(devs) > 1:
        raise NotImplementedError(
            f"device_reduce_by_key: the partitions sit on {len(devs)} "
            f"devices ({', '.join(devs)}); the exchange between devices "
            "(the JAX package's all_to_all) is ROADMAP A6b.6 -- place every "
            "partition on one device, or take the host plane")
    n_total = sum(int(k.shape[0]) for k in ks)
    if n_total == 0:
        return {pid: (ks[0][:0].cpu().numpy(), vs[0][:0].cpu().numpy())
                for pid in pids}
    cap = (n_total if distinct_hint is None
           else min(n_total, int(distinct_hint) * p))
    uk, uv = _segment_reduce(torch.cat(ks), torch.cat(vs), op, cap)
    # key mod P on the device; a stable sort keeps each partition's keys
    # ascending, and one copy brings the split set to the host
    t = uk % p
    t_sorted, order = torch.sort(t, stable=True)
    counts = torch.bincount(t_sorted, minlength=p)
    uk_h = uk[order].cpu().numpy()
    uv_h = uv[order].cpu().numpy()
    bounds = np.concatenate([[0], np.cumsum(counts.cpu().numpy())])
    return {pid: (uk_h[bounds[i]:bounds[i + 1]], uv_h[bounds[i]:bounds[i + 1]])
            for i, pid in enumerate(pids)}
