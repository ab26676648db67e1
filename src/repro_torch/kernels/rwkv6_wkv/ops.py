"""Public wrapper: the chunked RWKV-6 WKV recurrence (kernel B4),
differentiable.

``wkv`` is the drop-in for ``models.rwkv6.wkv_chunked``.  It checks what
the kernel takes and raises on anything else, then launches the CUDA
kernel for CUDA tensors — no fallback — or runs the plain version
(``ref.wkv_chunked_ref``) for CPU tensors.  Each call that launches the
kernel adds one to ``wkv.launches``.

The kernel has two bodies, and ``body`` picks one from the widths alone,
in bf16 and f32 alike: N a multiple of 16 up to 64 and a chunk a
multiple of 32 up to 128 (rwkv6-3b's training shape and its smoke width)
run the chunk-parallel tensor-core body (``csrc/rwkv6_wkv_chunk.cu``:
chunk states, a scan over them, then the outputs, on 3xTF32 mma.sync);
anything else runs the CUDA-core body (``csrc/rwkv6_wkv.cu``).  Each
body counts its calls in ``wkv.body_launches``; a body that fails to
build or launch raises.

Gradients: the reference has no backward kernel for B4 (no
``custom_vjp``; its model differentiates the jnp twin), and a B4
backward kernel is a later PR's work.  ``WKV``'s forward is the kernel;
its backward recomputes the recurrence through the plain version under
autograd in f32 and returns dr, dk, dv, dlw, du (summed over the batch,
as u is shared) and, when a state was given, ds0.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6_wkv import kernel
from repro_torch.kernels.rwkv6_wkv.ref import wkv_chunked_ref

_DTYPES = (torch.bfloat16, torch.float32)
BODIES = ("cuda_core", "chunk_tf32x3")
# The widest key/value head and the longest chunk the kernel takes (its
# shared-memory tiles are sized for them).
_MAX_N = 128
_MAX_CHUNK = 128


def _check(r, k, v, lw, u, init_state, chunk: int) -> int:
    """Raise unless these operands are B4's; returns the chunk length
    ``min(chunk, S)``, which must divide S."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, lw)):
        raise ValueError(f"want r, k, v, lw (B, S, H, N) alike; got "
                         f"{[tuple(t.shape) for t in (r, k, v, lw)]}")
    B, S, H, N = r.shape
    if tuple(u.shape) != (H, N):
        raise ValueError(f"want u (H, N) = {(H, N)}, got {tuple(u.shape)}")
    if init_state is not None and tuple(init_state.shape) != (B, H, N, N):
        raise ValueError(f"want init_state (B, H, N, N) = {(B, H, N, N)}, "
                         f"got {tuple(init_state.shape)}")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype
                                     for t in (k, v, lw, u)):
        raise TypeError(f"dtypes {[t.dtype for t in (r, k, v, lw, u)]} "
                        f"(bf16 or f32, all alike)")
    if init_state is not None and init_state.dtype != torch.float32:
        raise TypeError(f"init_state must be float32, got "
                        f"{init_state.dtype}")
    devices = {t.device for t in (r, k, v, lw, u)}
    if init_state is not None:
        devices.add(init_state.device)
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    if S < 1 or not 1 <= N <= _MAX_N:
        raise ValueError(f"want S >= 1 and 1 <= N <= {_MAX_N}, got "
                         f"{tuple(r.shape)}")
    Q = min(chunk, S)
    if not 1 <= Q <= _MAX_CHUNK or S % Q:
        raise ValueError(f"chunk {chunk}: want min(chunk, S) in 1.."
                         f"{_MAX_CHUNK} dividing S = {S}")
    return Q


def body(N: int, Q: int) -> str:
    """Which B4 body runs operands (bf16 or f32 alike: bf16 v is exact in
    TF32, the rest is split) with head width N and chunk length Q:
    ``"chunk_tf32x3"`` (tensor cores) for N a multiple of 16 up to 64
    (the MMA's depth and the tiles' widths; the chunk's r, k, v, A and
    state within a block's shared memory) and Q a multiple of 32 up to
    128 (whole 32-row warp tiles); ``"cuda_core"`` otherwise."""
    if N % 16 == 0 and 16 <= N <= 64 and Q % 32 == 0 and \
            32 <= Q <= _MAX_CHUNK:
        return "chunk_tf32x3"
    return "cuda_core"


def _forward(r, k, v, lw, u, init_state, Q: int):
    """B4 itself: the kernel on CUDA tensors, the plain version on CPU
    ones; anything else raises."""
    if r.device.type == "cpu":
        return wkv_chunked_ref(r, k, v, lw, u, init_state=init_state,
                               chunk=Q)
    if r.device.type != "cuda":
        raise ValueError(f"wkv runs on cuda or cpu, not {r.device}")
    B, S, H, N = r.shape
    r, k, v, lw = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (r, k, v, lw))
    u = u.contiguous()
    which = body(N, Q)
    s0 = None if init_state is None else init_state.contiguous()
    if s0 is not None and s0.data_ptr() % 16:
        s0 = s0.clone()     # the chunk body reads it as float4
    y = torch.empty((B, S, H, N), dtype=r.dtype, device=r.device)
    sf = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    kernel.launch(r, k, v, lw, u, s0, y, sf, chunk=Q, body=which)
    wkv.launches += 1
    wkv.body_launches[which] += 1
    return y, sf


def _backward(saved, gy, gsf, Q: int):
    """Gradients of (y, final state) by recompute through the plain
    version in f32, each cast to its input's dtype."""
    with torch.enable_grad():
        ins = [t.detach().float().requires_grad_() for t in saved]
        r, k, v, lw, u = ins[:5]
        y, sf = wkv_chunked_ref(r, k, v, lw, u,
                                init_state=ins[5] if len(ins) > 5 else None,
                                chunk=Q)
        grads = torch.autograd.grad((y, sf), ins, (gy.float(), gsf.float()))
    return [g.to(t.dtype) for g, t in zip(grads, saved)]


class WKV(torch.autograd.Function):
    """B4 forward; backward recomputed through the plain version (see
    the module docstring)."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, init_state, Q: int):
        saved = (r, k, v, lw, u) + (() if init_state is None
                                    else (init_state,))
        ctx.save_for_backward(*saved)
        ctx.Q = Q
        return _forward(r, k, v, lw, u, init_state, Q)

    @staticmethod
    def backward(ctx, gy, gsf):
        grads = _backward(ctx.saved_tensors, gy, gsf, ctx.Q)
        return (*grads[:5], grads[5] if len(grads) > 5 else None, None)


def wkv(r, k, v, lw, u, *, init_state=None, chunk: int = 128):
    """r, k, v, lw: (B, S, H, N), lw the log-decay in [-0.35, 0]; u: (H,
    N); all bf16 or all f32; init_state: (B, H, N, N) f32 or None
    (zeros).  The chunk length is ``min(chunk, S)``, at most 128 and a
    divisor of S; N is at most 128.

    Returns (y (B, S, H, N) in r's dtype, final state (B, H, N, N) f32):
    the chunked recurrence of ``wkv_pallas`` computed in f32.
    Differentiable in every input."""
    Q = _check(r, k, v, lw, u, init_state, chunk)
    ins = (r, k, v, lw, u) + (() if init_state is None else (init_state,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return WKV.apply(r, k, v, lw, u, init_state, Q)
    return _forward(r, k, v, lw, u, init_state, Q)


wkv.launches = 0
wkv.body_launches = {b: 0 for b in BODIES}
