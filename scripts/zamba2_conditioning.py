#!/usr/bin/env python3
"""How sensitive zamba2-2.7b is at random init, beside the families it is
compared with: the statistics that explain why its serving tokens part
from O5's under reduction-order noise (ROADMAP C8).

    PYTHONPATH=src python3 scripts/zamba2_conditioning.py

1. The scaled attention scores (q k^T times the kernels' scale) of one
   attention layer at published width, drawn by the port's initialiser
   (the reference's fan-in rule) from seed 0 on unit-RMS inputs of 200
   positions: zamba2-2.7b's shared attention (H=KV=32, head_dim 80, no
   qk-norm) beside qwen3-8b's (qk-norm).  Prints the scores' standard
   deviation and, for the last query, the median top softmax probability
   and top-1 minus top-2 score gap over the heads.
2. At smoke width, f32 compute, weights from seed 0: how far the final
   hidden state of ``forward`` (2 x 32 tokens) moves, relative to its
   largest magnitude, when every weight is scaled by ``1 + 1.2e-7 z``
   (about one f32 ulp), for zamba2-2.7b and for mamba2-2.7b.

These are properties of the initialiser and the architecture, computed
on the CPU; no device time is measured.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels.paged_attention.ref import kernel_scale
from repro_torch.models import attention as attn
from repro_torch.models import get_model, hybrid, mamba2
from repro_torch.models.layers import init_params, rms_norm

NUDGE = 1.2e-7


def score_stats(arch: str, S: int = 200) -> dict:
    cfg = get_config(arch)
    d, H, KV, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qk = cfg.qk_norm
    p = init_params(attn.attn_defs(d, H, KV, D, qk),
                    torch.Generator().manual_seed(0), torch.device("cpu"),
                    torch.float32)
    x = rms_norm(torch.randn(1, S, d, generator=torch.Generator()
                             .manual_seed(1)), torch.ones(d))
    q, k, _ = attn._project_qkv(p, x, torch.arange(S)[None], qk_norm=qk,
                                rope_theta=cfg.rope_theta)
    k = k.repeat_interleave(H // KV, dim=2)
    s = (torch.einsum("bqhd,bkhd->bhqk", q, k)
         * float(kernel_scale(D, torch.float32)))
    last = s[0, :, -1]
    top2 = last.topk(2, dim=-1).values
    return {"score_std": float(s.std()),
            "median_top_prob": float(torch.softmax(last, -1).max(-1)
                                     .values.median()),
            "median_top_gap": float((top2[:, 0] - top2[:, 1]).median())}


def _nudge(tree, gen):
    if isinstance(tree, dict):
        return {k: _nudge(v, gen) for k, v in tree.items()}
    return (tree.float() * (1 + NUDGE * torch.randn(tree.shape,
                                                     generator=gen))
            ).to(tree.dtype)


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def smoke_sensitivity(arch: str) -> float:
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    model = get_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    mod = {"hybrid": hybrid, "mamba": mamba2}[cfg.family]
    tok = torch.randint(0, cfg.vocab, (2, 32),
                        generator=torch.Generator().manual_seed(2))
    cast = mamba2.cast_params(cfg, params)
    h = mod.forward(cfg, cast, tok)
    h2 = mod.forward(cfg, _nudge(cast, torch.Generator().manual_seed(3)),
                     tok)
    return _rel(h2, h)


def main() -> None:
    for arch in ("zamba2-2.7b", "qwen3-8b"):
        st = score_stats(arch)
        print(f"{arch} attention at init: scaled score std "
              f"{st['score_std']:.2f}, median top softmax probability "
              f"{st['median_top_prob']:.3f}, median top-1 - top-2 gap "
              f"{st['median_top_gap']:.3f}")
    for arch in ("zamba2-2.7b", "mamba2-2.7b"):
        print(f"{arch} smoke, f32: a one-ulp nudge of the weights moves "
              f"the forward's hidden state by "
              f"{smoke_sensitivity(arch):.3e} of its scale")


if __name__ == "__main__":
    main()
