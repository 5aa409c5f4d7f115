"""Kernel B2's error at the unmasked ring block over many draws, on one GPU.

    python3 -m asyncframework_tpu_torch.tools.probe_chunk_attention \
        [--seeds 16] [--f64-heads 2] [--out FILE]

``chip_smoke.py`` phase 2 holds ``f_ring_block_nomask`` (1 x 8,192 x 8,192
x 32 x 128 bf16, no mask, the tensor-core route) to its plain version with
``o`` within 1e-4 of ``|o_plain|`` clamped at 1, on one draw.  This probe
draws q, k and v the same way (``randn`` then bf16, q, k, v in order) from
seeds 0, 1, ..., and for each draw prints one JSON line:

* the kernel against its plain version (``chunk_attention_reference``), in
  ``chip_smoke.py``'s metric, for o, m and l;
* the tensor-core route's arithmetic in plain PyTorch
  (``chunk_attention_tc_emulation``: the same tiles, the same three-term p,
  f32 sums) against the plain version, in the same metric;
* on the first ``--f64-heads`` heads, each of the three against the
  function computed in float64 from the same bf16 inputs, in the same
  metric, and its largest error over ``sum_k p_k |v_k|`` (the sum's own
  scale), with the row and column where the kernel's error peaks.

A last line sums the draws up (largest, median, how many exceed 1e-4).
Every line carries the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from asyncframework_tpu_torch.ops import chunk_attention as ca

B, T, H, D = 1, 8_192, 32, 128
O_TOL = 1e-4  # chip_smoke.py's ATT_TOL["o"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def rel(a: torch.Tensor, r: torch.Tensor) -> float:
    """``chip_smoke.py``'s metric: max |a - r| / max(|r|, 1)."""
    return float(((a.double() - r.double()).abs()
                  / r.double().abs().clamp(min=1.0)).max())


def f64_heads(q, k, v, heads: int):
    """(o, m, l, sum_k p_k |v_k|) of the first ``heads`` heads in float64,
    unmasked, in the kernel's (B, T, H, ...) layout."""
    scale = ca._scale(q.shape[-1]).double()
    outs = []
    for h in range(heads):
        qh, kh, vh = (x[0, :, h].double() for x in (q, k, v))
        s = (qh @ kh.T) * scale
        m = s.amax(-1)
        p = torch.exp(s - m[:, None])
        outs.append((p @ vh, m, p.sum(-1), p @ vh.abs()))
        del s, p
    o, m, l, cond = (torch.stack([x[i] for x in outs], dim=1)
                     for i in range(4))
    return (o[None], m[None].transpose(1, 2), l[None].transpose(1, 2),
            cond[None])


def one_draw(seed: int, heads: int, card: str) -> dict:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = (torch.randn(B, T, H, D, device=dev, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    assert ca.tensor_core_route(q, k, v)
    got = ca.chunk_attention(q, k, v, None)
    ref = ca.chunk_attention_reference(q, k, v, None)
    emu = ca.chunk_attention_tc_emulation(q, k, v, None)
    rec = {"seed": seed, "card": card, "shape": [B, T, T, H, D]}
    for key, a, e, r in zip("oml", got, emu, ref):
        rec[f"kernel_{key}_rel"] = rel(a, r)
        rec[f"emulation_{key}_rel"] = rel(e, r)
    rec["within_tol"] = rec["kernel_o_rel"] <= O_TOL
    if heads:
        o64, m64, l64, cond = f64_heads(q, k, v, heads)
        for name, (o, m, l) in (("kernel", got), ("plain", ref),
                                ("emulation", emu)):
            o_h = o[:, :, :heads]
            rec[f"{name}_vs_f64_o_rel"] = rel(o_h, o64)
            rec[f"{name}_vs_f64_m_rel"] = rel(m[:, :heads], m64)
            rec[f"{name}_vs_f64_l_rel"] = rel(l[:, :heads], l64)
            rec[f"{name}_vs_f64_o_over_cond"] = float(
                ((o_h.double() - o64).abs() / cond).max())
        err = (got[0][:, :, :heads].double() - o64).abs() \
            / o64.abs().clamp(min=1.0)
        at = divmod(int(err.argmax()), heads * D)
        row, (head, col) = at[0], divmod(at[1], D)
        rec["kernel_f64_peak"] = {
            "row": row, "head": head, "col": col,
            "o_f64": float(o64[0, row, head, col]),
            "sum_p_abs_v": float(cond[0, row, head, col]),
            "l_f64": float(l64[0, head, row])}
    del q, k, v, got, ref, emu
    torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--f64-heads", type=int, default=2)
    ap.add_argument("--out", default=None,
                    help="also append the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_chunk_attention: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    lines = []

    def emit(rec):
        line = json.dumps(rec)
        lines.append(line)
        print(line, flush=True)

    recs = [one_draw(s, args.f64_heads, card) for s in range(args.seeds)]
    for rec in recs:
        emit(rec)
    errs = [r["kernel_o_rel"] for r in recs]
    summary = {"summary": "f_ring_block_nomask o", "card": card,
               "draws": len(errs), "tol": O_TOL, "max": max(errs),
               "median": statistics.median(errs), "min": min(errs),
               "over_tol": sum(e > O_TOL for e in errs),
               "emulation_max": max(r["emulation_o_rel"] for r in recs)}
    if args.f64_heads:
        for name in ("kernel", "plain", "emulation"):
            summary[f"{name}_vs_f64_o_max"] = max(
                r[f"{name}_vs_f64_o_rel"] for r in recs)
            summary[f"{name}_vs_f64_o_over_cond_max"] = max(
                r[f"{name}_vs_f64_o_over_cond"] for r in recs)
    emit(summary)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
