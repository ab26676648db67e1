"""Public wrapper: blocked softmax attention (kernel B3), differentiable.

``flash_attention`` checks what the kernel takes and raises on anything
else, then launches the CUDA kernel for CUDA tensors — no fallback — or
runs the plain version (``ref``) for CPU tensors.  Each kernel launch
adds one to ``flash_attention.launches``.

The kernel has two bodies, and ``body`` picks one by dtype alone: bf16
runs the tensor-core body (``csrc/flash_attention_mma.cu``: mma.sync,
cp.async double buffering), f32 the CUDA-core body
(``csrc/flash_attention.cu``), whose f32 FMAs keep f32's accuracy.
Each body counts its launches in ``flash_attention.body_launches``; a
body that fails to build or launch raises.

Gradients: the reference has no backward kernel for B3 (no
``custom_vjp``), and a B3 backward kernel is a later PR's work.
``FlashAttention``'s forward is the kernel; its backward recomputes the
attention one chunk of ``q_chunk`` query rows at a time through the
plain version under autograd — the reference's per-chunk
``jax.checkpoint`` of its chunked attention — and accumulates dK and dV
across chunks in f32.  Under a causal mask a chunk reads only the K/V
positions its last row attends.  So the backward holds one chunk's
(B, H, q_chunk, S_kv) f32 scores at a time, not the whole (S, S_kv).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_DTYPES = (torch.bfloat16, torch.float32)
BODIES = ("cuda_core", "mma")
# The widest head the kernel is compiled for (it pads any narrower one
# to its next instance), and CUDA's grid-y limit (one row of blocks per
# batch x query head).
_MAX_HEAD_DIM = 256
_MAX_GRID_Y = 65_535


def _check(q, k, v, causal: bool) -> None:
    """Raise unless these operands are B3's: q (B, S, H, D), k and v
    (B, S_kv, Hkv, D), H % Hkv == 0, S_kv >= S under a causal mask (a
    non-causal row attends all S_kv keys, so any S_kv >= 1 will do), one
    float dtype, one device."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, S, H, D) and k, v (B, S_kv, Hkv, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    Bk, S_kv, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or H % Hkv != 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} (want equal B and D, H % Hkv "
                         f"== 0)")
    if S_kv < (S if causal else 1):
        want = "a causal call wants S_kv >= S" if causal else \
            "a non-causal call wants S_kv >= 1"
        raise ValueError(f"q {tuple(q.shape)} against k {tuple(k.shape)}: "
                         f"{want}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype} "
                        f"(bf16 or f32, all alike)")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"operands on different devices: {q.device}, "
                         f"{k.device}, {v.device}")


def body(dtype) -> str:
    """Which B3 body runs operands of ``dtype``: ``"mma"`` (tensor
    cores) for bf16, ``"cuda_core"`` for f32."""
    return "mma" if dtype == torch.bfloat16 else "cuda_core"


def _forward(q, k, v, causal: bool):
    """B3 itself: the kernel on a CUDA tensor, the plain version on a CPU
    one; anything else raises."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    B, S, H, D = q.shape
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"the flash-attention kernel takes head_dim up to "
                         f"{_MAX_HEAD_DIM}, got q {tuple(q.shape)}")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"B * H = {B * H} exceeds the kernel grid's "
                         f"{_MAX_GRID_Y} (q {tuple(q.shape)})")
    which = body(q.dtype)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    kernel.launch(q, k, v, out, causal=causal, scale=1.0 / D ** 0.5,
                  body=which)
    flash_attention.launches += 1
    flash_attention.body_launches[which] += 1
    return out


def _backward(q, k, v, grad, *, causal: bool, q_chunk: int):
    """(dq, dk, dv) of the attention by chunked recompute through the
    plain version, in f32, cast to the inputs' dtypes."""
    S, S_kv = q.shape[1], k.shape[1]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for c0 in range(0, S, q_chunk):
        c1 = min(S, c0 + q_chunk)
        # The chunk's last row attends kv positions < c1 + S_kv - S; with
        # K/V cut there, the plain version's own offset (n_kv - rows) is
        # the chunk's c0 + S_kv - S.
        n_kv = c1 + S_kv - S if causal else S_kv
        with torch.enable_grad():
            qs = q[:, c0:c1].detach().float().requires_grad_()
            ks = k[:, :n_kv].detach().float().requires_grad_()
            vs = v[:, :n_kv].detach().float().requires_grad_()
            out = flash_attention_ref(qs, ks, vs, causal=causal)
            gq, gk, gv = torch.autograd.grad(
                out, (qs, ks, vs), grad[:, c0:c1].float())
        dq[:, c0:c1] = gq
        dk[:, :n_kv] += gk
        dv[:, :n_kv] += gv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """B3 forward; chunked-recompute backward through the plain version
    (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_chunk: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        ctx.q_chunk = q_chunk
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, grad, causal=ctx.causal,
                               q_chunk=ctx.q_chunk)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128, q_chunk: int = 1024):
    """q: (B, S, H, D); k, v: (B, S_kv, Hkv, D) with H % Hkv == 0 and,
    with ``causal``, S_kv >= S (without, any S_kv: the encoder's and a
    cross-attention's rows attend every key), bf16 or f32 alike.

    Returns (B, S, H, D) in q's dtype: softmax attention in f32 with an
    f32 scale ``1 / sqrt(D)``, query head h reading kv head
    ``h // (H // Hkv)`` (K/V never repeated), and with ``causal`` query
    row r attending kv positions ``<= r + S_kv - S``.  ``block_q`` and
    ``block_k`` are the reference's tiling knobs: they do not change the
    result, and the kernel picks its own tiles.  ``q_chunk`` is the
    number of query rows the backward recomputes at a time (a memory
    cap; it does not change the result beyond summation order).

    On CUDA tensors the kernel takes any head_dim up to 256 and raises
    above; on CPU tensors the plain version runs.  Differentiable in q,
    k and v.
    """
    _check(q, k, v, causal)
    if min(block_q, block_k, q_chunk) < 1:
        raise ValueError(f"block_q {block_q}, block_k {block_k} and "
                         f"q_chunk {q_chunk} must be positive")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, q_chunk)
    return _forward(q, k, v, causal)


flash_attention.launches = 0
flash_attention.body_launches = dict.fromkeys(BODIES, 0)
