"""Public wrapper: the chunked Mamba-2 SSD scan (kernel B5),
differentiable.

``ssd`` is the drop-in for ``models.mamba2.ssd_chunked``.  It checks what
the kernel takes and raises on anything else, then launches the CUDA
kernel for CUDA tensors — no fallback — or runs the plain version
(``ref.ssd_chunked_ref``) for CPU tensors.  Each call that launches the
kernel adds one to ``ssd.launches``.

The kernel has two bodies, and ``body`` picks one from the widths alone,
in bf16 and f32 alike: P 32 or 64, N a multiple of 16 up to 128 and a
chunk a multiple of 64 up to 256 (mamba2-2.7b's training shape and its
smoke width) run the chunk-parallel tensor-core body
(``csrc/mamba2_ssd_chunk.cu``: chunk states, a scan over them, then the
outputs, on 3xTF32 mma.sync); anything else runs the CUDA-core body
(``csrc/mamba2_ssd.cu``).  Each body counts its calls in
``ssd.body_launches``; a body that fails to build or launch raises.

Gradients: the reference has no backward kernel for B5 (no
``custom_vjp``; its model differentiates the jnp twin), and a B5
backward kernel is a later PR's work.  ``SSD``'s forward is the kernel;
its backward recomputes the scan through the plain version under
autograd in f32 and returns dx, ddt, dA (summed over the batch and the
sequence, as A is shared), dBs, dCs and, when a state was given, ds0.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.mamba2_ssd import kernel
from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked_ref

_DTYPES = (torch.bfloat16, torch.float32)
BODIES = ("cuda_core", "chunk_tf32x3")
# The widest head (P), the widest state (N) and the longest chunk the
# wrapper takes: the kernel's shared-memory tiles are sized for P and N.
_MAX_P = 64
_MAX_N = 128
_MAX_CHUNK = 256


def _check(x, dt, A, Bs, Cs, init_state, chunk: int) -> int:
    """Raise unless these operands are B5's; returns the chunk length
    ``min(chunk, S)``, which must divide S."""
    if x.dim() != 4:
        raise ValueError(f"want x (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,):
        raise ValueError(f"want dt (B, S, H) = {(B, S, H)} and A (H,); got "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}")
    if Bs.dim() != 3 or Bs.shape[:2] != (B, S) or Cs.shape != Bs.shape:
        raise ValueError(f"want Bs, Cs (B, S, N) alike with (B, S) = "
                         f"{(B, S)}; got {tuple(Bs.shape)}, "
                         f"{tuple(Cs.shape)}")
    N = Bs.shape[-1]
    if init_state is not None and tuple(init_state.shape) != (B, H, P, N):
        raise ValueError(f"want init_state (B, H, P, N) = {(B, H, P, N)}, "
                         f"got {tuple(init_state.shape)}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype
                                     for t in (dt, A, Bs, Cs)):
        raise TypeError(f"dtypes {[t.dtype for t in (x, dt, A, Bs, Cs)]} "
                        f"(bf16 or f32, all alike)")
    if init_state is not None and init_state.dtype != torch.float32:
        raise TypeError(f"init_state must be float32, got "
                        f"{init_state.dtype}")
    devices = {t.device for t in (x, dt, A, Bs, Cs)}
    if init_state is not None:
        devices.add(init_state.device)
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    if S < 1 or not 1 <= P <= _MAX_P or not 1 <= N <= _MAX_N:
        raise ValueError(f"want S >= 1, 1 <= P <= {_MAX_P} and 1 <= N <= "
                         f"{_MAX_N}, got x {tuple(x.shape)}, N = {N}")
    Q = min(chunk, S)
    if not 1 <= Q <= _MAX_CHUNK or S % Q:
        raise ValueError(f"chunk {chunk}: want min(chunk, S) in 1.."
                         f"{_MAX_CHUNK} dividing S = {S}")
    return Q


def body(P: int, N: int, Q: int) -> str:
    """Which B5 body runs operands (bf16 or f32 alike: a bf16 operand is
    exact in TF32, an f32 one is split) with head width P, state width N
    and chunk length Q: ``"chunk_tf32x3"`` (tensor cores) for P 32 or 64
    (warp tiles of 16 columns over a 64-row output tile), N a multiple of
    16 up to 128 (the MMA's depth and the tiles' widths) and Q a multiple
    of 64 up to 256 (whole 64-row tiles; the chunk's B rows within a
    block's shared memory); ``"cuda_core"`` otherwise."""
    if P in (32, 64) and N % 16 == 0 and 16 <= N <= _MAX_N and \
            Q % 64 == 0 and 64 <= Q <= _MAX_CHUNK:
        return "chunk_tf32x3"
    return "cuda_core"


def _forward(x, dt, A, Bs, Cs, init_state, Q: int):
    """B5 itself: the kernel on CUDA tensors, the plain version on CPU
    ones; anything else raises."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, Bs, Cs, init_state=init_state,
                               chunk=Q)
    if x.device.type != "cuda":
        raise ValueError(f"ssd runs on cuda or cpu, not {x.device}")
    B, S, H, P = x.shape
    x, dt, Bs, Cs = (t if t.stride(-1) == 1 else t.contiguous()
                     for t in (x, dt, Bs, Cs))
    A = A.contiguous()
    which = body(P, Bs.shape[-1], Q)
    s0 = None if init_state is None else init_state.contiguous()
    if s0 is not None and s0.data_ptr() % 16:
        s0 = s0.clone()     # the chunk body reads it as float4
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    sf = torch.empty((B, H, P, Bs.shape[-1]), dtype=torch.float32,
                     device=x.device)
    kernel.launch(x, dt, A, Bs, Cs, s0, y, sf, chunk=Q, body=which)
    ssd.launches += 1
    ssd.body_launches[which] += 1
    return y, sf


def _backward(saved, gy, gsf, Q: int):
    """Gradients of (y, final state) by recompute through the plain
    version in f32, each cast to its input's dtype."""
    with torch.enable_grad():
        ins = [t.detach().float().requires_grad_() for t in saved]
        x, dt, A, Bs, Cs = ins[:5]
        y, sf = ssd_chunked_ref(x, dt, A, Bs, Cs,
                                init_state=ins[5] if len(ins) > 5 else None,
                                chunk=Q)
        grads = torch.autograd.grad((y, sf), ins, (gy.float(), gsf.float()))
    return [g.to(t.dtype) for g, t in zip(grads, saved)]


class SSD(torch.autograd.Function):
    """B5 forward; backward recomputed through the plain version (see
    the module docstring)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bs, Cs, init_state, Q: int):
        saved = (x, dt, A, Bs, Cs) + (() if init_state is None
                                      else (init_state,))
        ctx.save_for_backward(*saved)
        ctx.Q = Q
        return _forward(x, dt, A, Bs, Cs, init_state, Q)

    @staticmethod
    def backward(ctx, gy, gsf):
        grads = _backward(ctx.saved_tensors, gy, gsf, ctx.Q)
        return (*grads[:5], grads[5] if len(grads) > 5 else None, None)


def ssd(x, dt, A, Bs, Cs, *, init_state=None, chunk: int = 256):
    """x: (B, S, H, P); dt: (B, S, H) after softplus; A: (H,) negative;
    Bs, Cs: (B, S, N); all bf16 or all f32; init_state: (B, H, P, N) f32
    or None (zeros).  The chunk length is ``min(chunk, S)``, at most 256
    and a divisor of S; P is at most 64 and N at most 128.

    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32):
    the chunked scan of ``ssd_pallas`` computed in f32.  Differentiable
    in every input."""
    Q = _check(x, dt, A, Bs, Cs, init_state, chunk)
    ins = (x, dt, A, Bs, Cs) + (() if init_state is None else (init_state,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return SSD.apply(x, dt, A, Bs, Cs, init_state, Q)
    return _forward(x, dt, A, Bs, Cs, init_state, Q)


ssd.launches = 0
ssd.body_launches = {b: 0 for b in BODIES}
