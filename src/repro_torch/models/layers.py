"""Model-building primitives: declarative param defs, norms, MLP, rope,
chunked cross-entropy.

Port of ``repro/models/layers.py``.  Parameters are declared as nested
dicts of ``PDef`` records and drawn by one generic ``init_params``; the
shapes and initializer rules are the reference's, so a JAX param tree
carries across leaf for leaf (``models/bridge.py``).

Numerics mirror the reference's rounding order: each primitive does its
math in float32 and rounds ONCE to the compute dtype where the JAX code
does, so the port holds the reference tightly in float32 compute.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.tree import from_leaves, leaves


@dataclasses.dataclass(frozen=True)
class PDef:
    shape: tuple
    init: str = "normal"         # normal | zeros | ones | small
    scale: Optional[float] = None


def _fan_in(shape: tuple) -> int:
    return shape[-2] if len(shape) >= 2 else max(1, shape[-1])


def init_params(defs, generator: torch.Generator, device: torch.device,
                dtype: torch.dtype) -> dict:
    """Draw a nested dict of PDefs on ``device`` and store each leaf once
    in ``dtype``.  Normal leaves draw float32 with std ``1/sqrt(fan_in)``
    (``scale`` overrides; ``small`` means 0.02) and round once — the bits
    the reference's per-use ``.astype(dt)`` of its float32 params gives.
    ``generator`` must live on ``device``; its stream is not JAX's, so
    cross-framework tests carry weights over with ``bridge``."""
    out = []
    for path, d in leaves(defs):
        if d.init == "zeros":
            a = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            a = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            std = d.scale if d.scale is not None else 1.0 / math.sqrt(
                _fan_in(d.shape))
            if d.init == "small":
                std = d.scale if d.scale is not None else 0.02
            a = torch.empty(d.shape, dtype=dtype, device=device)
            # Draw per leading index so a stacked (L, ...) leaf never
            # needs an L-times float32 staging buffer.
            for i in range(d.shape[0] if len(d.shape) > 2 else 1):
                dst = a[i] if len(d.shape) > 2 else a
                w = torch.randn(dst.shape, generator=generator,
                                device=device, dtype=torch.float32)
                dst.copy_(w.mul_(std))
        out.append((path, a))
    return from_leaves(out)


def stack_defs(defs, n: int):
    """Prepend a stacked ``layers`` dimension to every PDef."""
    if isinstance(defs, PDef):
        return PDef((n,) + defs.shape, defs.init, defs.scale)
    return {k: stack_defs(v, n) for k, v in defs.items()}


def param_shapes(defs) -> dict:
    """Same-structure tree of shapes."""
    if isinstance(defs, PDef):
        return tuple(defs.shape)
    return {k: param_shapes(v) for k, v in defs.items()}


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * weight.to(dt)


def rms_norm_defs(d: int) -> PDef:
    return PDef((d,), "ones")


def rope(x, positions, theta: float = 10_000.0):
    """Rotary embedding. x: (..., seq, heads, head_dim); positions:
    (..., seq).  Float32 math (the bf16 input promotes against the f32
    tables, as in the reference), one cast back to ``x.dtype``."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq          # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu_defs(d: int, d_ff: int) -> dict:
    return {
        "wi": PDef((d, d_ff)),
        "wg": PDef((d, d_ff)),
        "wo": PDef((d_ff, d)),
    }


def mlp_apply(params: dict, x, kind: str = "swiglu"):
    """SwiGLU in the compute dtype.  ``F.silu`` in bf16 is torch's; the
    reference's XLA-CPU bf16 sigmoid rounds differently on ~40% of
    elements, so bf16 parity with JAX is held to a tolerance (float32
    compute is tight)."""
    if kind != "swiglu":
        raise NotImplementedError(
            f"mlp_kind {kind!r} is not ported yet (ROADMAP A2)")
    h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    return h @ params["wo"]


def chunked_cross_entropy(h, params, labels, *, chunk: int = 2048,
                          compute_dtype=torch.bfloat16):
    """Mean token cross-entropy with the vocab projection applied one
    sequence chunk at a time, f32 logits per chunk (bounds the logits
    held at once).  h: (B, S, d); labels: (B, S) int."""
    B, S = labels.shape
    lm_head = params["lm_head"].to(compute_dtype)
    n_chunks = max(1, S // chunk)
    while S % n_chunks:          # S need not be chunk-aligned: the
        n_chunks -= 1            # largest divisor, as the reference
    s = S // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        logits = (h[:, c * s:(c + 1) * s] @ lm_head).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(
            -1, labels[:, c * s:(c + 1) * s, None].long()).squeeze(-1)
        total = total + (logz - gold).sum()
    return total / (B * S)
