"""Long-context attention over a sequence-sharded mesh of GPUs.

    python -m asyncframework_tpu_torch.tools.ring_attention_demo

Ring attention: each rank holds T/P of the sequence; K/V blocks rotate
around the ranks while a flash-style online softmax accumulates -- exact
attention with O((T/P)^2) memory per block.  Runs over every visible CUDA
device through the hand-written block kernel, and prints the max |err|
against single-device full attention.
"""

from __future__ import annotations

import numpy as np
import torch

from asyncframework_tpu_torch.parallel import (
    make_mesh,
    reference_attention,
    ring_attention,
)
from asyncframework_tpu_torch.utils.devices import resolve_devices


def main(t=512, h=8, d=64, devices=None, block_kernel="cuda"):
    devs = resolve_devices(devices)
    p = len(devs)
    t = t - (t % p)
    mesh = make_mesh(p, axis_names=("sp",), devices=devs)
    rs = np.random.default_rng(0)
    q, k, v = (
        torch.tensor(rs.normal(size=(1, t, h, d)).astype(np.float32),
                     device=devs[0])
        for _ in range(3)
    )
    out = ring_attention(q, k, v, mesh, causal=True, block_kernel=block_kernel)
    want = reference_attention(q, k, v, causal=True)
    err = float((out - want).abs().max())
    print(f"ring attention over {p} device(s), seq {t}: "
          f"max |err| vs full attention = {err:.2e}")
    return out


if __name__ == "__main__":
    main()
