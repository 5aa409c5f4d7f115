"""Checkpoint / resume of training state: a first-class feature here.

The reference has **no** checkpoint/resume for its training loop -- model
snapshots go to an in-memory list only (``SparkASGDThread.scala:192-195``);
its engine-level checkpointing (``rdd/RDD.scala:1773`` ``ReliableCheckpointRDD``)
persists *datasets*, not solver state.  SURVEY.md section 5 calls out real
model checkpointing as a capability the rebuild must add; this is the
port's copy of ``asyncframework_tpu/checkpoint.py``, with the same file
layout, so a checkpoint's model state reads in either package.

What a solver checkpoint holds (everything needed for bit-faithful resume):
``w`` (the model), the accepted-update counter ``k``, the logical clock, every
worker's generator state (``worker_gens`` in the port, ``worker_keys`` in
the JAX package), and -- for ASAGA -- the per-worker gradient-history
slices plus ``alpha_bar``.

Design:
- State is a nested dict whose leaves are arrays (numpy or ``torch.Tensor``;
  tensors are fetched to host on save) or plain scalars/strings.  Nesting is flattened to
  ``a/b/c`` path keys; everything -- flattened arrays plus a JSON manifest
  recording tree structure and leaf kinds -- goes into ONE ``.npz`` file, so
  restore rebuilds the exact structure.
- A checkpoint being a single file makes every write atomic, including
  same-step overwrite: serialize to ``.tmp-<step>-<pid>.npz`` then
  ``os.replace`` onto ``ckpt-<step>.npz`` (rename is atomic even over an
  existing file) -- a reader or a crash never observes a partial or missing
  checkpoint at any point.
- ``max_to_keep`` garbage-collects old steps after a successful save.

Integer dict keys (worker ids) survive a round trip: they are stored as
strings in the path encoding and re-created as ``int`` on restore when the
manifest marks the mapping as int-keyed.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

_CKPT_RE = re.compile(r"^ckpt-(\d+)\.npz$")
_TMP_RE = re.compile(r"^\.tmp-\d+-(\d+)\.npz$")
_SEP = "/"
_MANIFEST_KEY = "__manifest__"
_ARR_PREFIX = "arr:"  # namespaces array keys away from the manifest entry


def durable_replace(tmp_path, final_path) -> None:
    """Crash- AND power-loss-durable atomic rename: fsync the data file,
    ``os.replace`` it onto the final name, then fsync the parent directory
    so the rename itself is on disk.  Without the directory fsync a host
    power loss after a "completed" save can roll the directory entry back
    to the old (or no) file even though the data blocks were flushed --
    the classic rename-durability hole.  One definition so the PS
    checkpoint, the step-numbered manager, and the master's persistence
    engine cannot drift on the discipline."""
    fd = os.open(tmp_path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp_path, final_path)
    dfd = os.open(os.path.dirname(os.path.abspath(final_path)), os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _flatten(prefix: str, node: Any, arrays: Dict[str, np.ndarray]) -> Any:
    """Flatten ``node`` into ``arrays``; return the manifest subtree."""
    if isinstance(node, Mapping):
        keys = list(node.keys())
        int_keyed = all(isinstance(k, (int, np.integer)) for k in keys) and keys
        sub = {}
        for k in keys:
            ks = str(int(k)) if int_keyed else str(k)
            if _SEP in ks:
                raise ValueError(f"checkpoint keys may not contain '{_SEP}': {k!r}")
            path = f"{prefix}{_SEP}{ks}" if prefix else ks
            sub[ks] = _flatten(path, node[k], arrays)
        return {"kind": "dict", "int_keys": bool(int_keyed), "children": sub}
    if isinstance(node, (list, tuple)):
        sub = []
        for i, v in enumerate(node):
            path = f"{prefix}{_SEP}{i}" if prefix else str(i)
            sub.append(_flatten(path, v, arrays))
        return {"kind": "tuple" if isinstance(node, tuple) else "list",
                "children": sub}
    if node is None:
        return {"kind": "none"}
    if isinstance(node, bool):
        return {"kind": "bool", "value": bool(node)}
    if isinstance(node, (int, np.integer)):
        return {"kind": "int", "value": int(node)}
    if isinstance(node, (float, np.floating)):
        return {"kind": "float", "value": float(node)}
    if isinstance(node, str):
        return {"kind": "str", "value": node}
    # Array leaf: a tensor (on any device) or anything np.asarray takes.
    if isinstance(node, torch.Tensor):
        arrays[prefix] = node.detach().cpu().numpy()
    else:
        arrays[prefix] = np.asarray(node)
    return {"kind": "array", "path": prefix}


def _unflatten(entry: Dict[str, Any], arrays: Mapping[str, np.ndarray]) -> Any:
    kind = entry["kind"]
    if kind == "dict":
        out = {}
        for ks, sub in entry["children"].items():
            key = int(ks) if entry.get("int_keys") else ks
            out[key] = _unflatten(sub, arrays)
        return out
    if kind in ("list", "tuple"):
        vals = [_unflatten(sub, arrays) for sub in entry["children"]]
        return tuple(vals) if kind == "tuple" else vals
    if kind == "none":
        return None
    if kind in ("bool", "int", "float", "str"):
        return entry["value"]
    if kind == "array":
        return arrays[entry["path"]]
    raise ValueError(f"unknown manifest kind {kind!r}")


def save_checkpoint(path, state: Mapping[str, Any]) -> None:
    """Serialize ``state`` into the single file ``path`` (parent created).

    Not atomic on its own -- use :class:`CheckpointManager` for atomic
    step-numbered checkpoints."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    manifest = _flatten("", dict(state), arrays)
    payload = {_ARR_PREFIX + k: v for k, v in arrays.items()}
    payload[_MANIFEST_KEY] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8
    )
    # np.savez appends .npz when missing; write via an open handle to keep
    # the exact path
    with open(p, "wb") as f:
        np.savez(f, **payload)


def load_checkpoint(path) -> Dict[str, Any]:
    with np.load(Path(path)) as npz:
        manifest = json.loads(bytes(npz[_MANIFEST_KEY]).decode())
        arrays = {
            k[len(_ARR_PREFIX):]: npz[k]
            for k in npz.files
            if k.startswith(_ARR_PREFIX)
        }
    return _unflatten(manifest, arrays)


class CheckpointManager:
    """Step-numbered atomic checkpoints under one directory.

    ``save`` writes ``.tmp-<step>-<pid>.npz`` then atomically renames onto
    ``ckpt-<step>.npz`` (overwrite included -- there is a valid checkpoint at
    the step at every instant); ``restore`` loads a given (default: latest)
    step; old steps beyond ``max_to_keep`` are deleted after each save.
    """

    def __init__(self, directory, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError("max_to_keep must be >= 1")
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    # ------------------------------------------------------------------ query
    def all_steps(self) -> List[int]:
        steps = []
        for child in self.directory.iterdir():
            m = _CKPT_RE.match(child.name)
            if m and child.is_file():
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_path(self, step: int) -> Path:
        return self.directory / f"ckpt-{step}.npz"

    # ------------------------------------------------------------------- save
    def save(self, step: int, state: Mapping[str, Any]) -> Path:
        if step < 0:
            raise ValueError("step must be >= 0")
        final = self.step_path(step)
        tmp = self.directory / f".tmp-{step}-{os.getpid()}.npz"
        save_checkpoint(tmp, state)
        # fsync data before the rename and the directory after it, so a power
        # loss can never leave a truncated ckpt-<step>.npz behind the atomic
        # name swap (same discipline as native/kvstore.cc kv_compact)
        durable_replace(tmp, final)
        self._gc()
        return final

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}"
                )
        path = self.step_path(step)
        if not path.is_file():
            raise FileNotFoundError(f"no checkpoint at step {step}: {path}")
        return load_checkpoint(path)

    def restore_latest_or_none(self) -> Optional[Dict[str, Any]]:
        if self.latest_step() is None:
            return None
        return self.restore()

    # --------------------------------------------------------------------- gc
    def _gc(self) -> None:
        steps = self.all_steps()
        for step in steps[: max(0, len(steps) - self.max_to_keep)]:
            try:
                self.step_path(step).unlink()
            except FileNotFoundError:
                pass
        # sweep temp files from *crashed* writers only: a live pid may be a
        # concurrent writer mid-save whose file must not be yanked
        for child in self.directory.iterdir():
            m = _TMP_RE.match(child.name)
            if m is None:
                continue
            pid = int(m.group(1))
            if pid == os.getpid() or _pid_alive(pid):
                continue
            try:
                child.unlink()
            except FileNotFoundError:
                pass
