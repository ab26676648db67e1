"""Plain PyTorch versions of kernel B4, the chunked RWKV-6 WKV recurrence

    S_t = diag(w_t) S_{t-1} + k_t^T v_t,   y_t = r_t (S_{t-1} + u k_t^T v_t)

with ``lw = log w`` already clamped to [-0.35, 0] by the caller.

``wkv_ref`` is the sequential oracle of ``repro/kernels/rwkv6_wkv/
ref.py`` in its flat (B*H, S, N) layout.  ``wkv_chunked_ref`` is the
arithmetic of ``wkv_pallas`` (``_wkv_kernel``) in the model's (B, S, H, N)
layout: everything cast to f32, the chunked cumsum of lw, the strictly
causal (Q, Q) product of ``r exp(cum - lw)`` against ``k exp(-cum)``, the
``u`` diagonal, the read of the state entering the chunk and its update
to the chunk's end; y rounds once to r's dtype, the state stays f32.
The intra-chunk parts of every chunk are computed at once; only the
state is carried through a loop over chunks.  The CPU tests hold both
against the JAX kernel, ``chip_smoke.py`` holds the CUDA kernel against
``wkv_chunked_ref``, and ``ops.wkv`` recomputes through it for its
gradient.
"""

from __future__ import annotations

import torch


def wkv_ref(r, k, v, lw, u, s0):
    """r, k, v, lw: (BH, S, N); u: (BH, N); s0: (BH, N, N) f32.
    Returns (y (BH, S, N) in r's dtype, final state (BH, N, N) f32)."""
    uf = u.float()[..., None]
    state = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t].float()[:, :, None] * v[:, t].float()[:, None, :]
        ys.append(torch.einsum("bc,bcn->bn", r[:, t].float(),
                               state + uf * kv))
        state = state * torch.exp(lw[:, t].float())[..., None] + kv
    return torch.stack(ys, dim=1).to(r.dtype), state


def wkv_chunked_ref(r, k, v, lw, u, *, init_state=None, chunk: int = 128):
    """r, k, v, lw: (B, S, H, N); u: (H, N); init_state: (B, H, N, N) or
    None (zeros); S % chunk == 0.  Returns (y (B, S, H, N) in r's dtype,
    final state (B, H, N, N) f32)."""
    B, S, H, N = r.shape
    Q = chunk
    nc = S // Q
    f32 = lambda t: t.float().reshape(B, nc, Q, H, N)
    rc, kc, vc, lwc = f32(r), f32(k), f32(v), f32(lw)
    cum = torch.cumsum(lwc, dim=2)                       # (B, nc, Q, H, N)
    ri = rc * torch.exp(cum - lwc)                       # r_i exp(cum_{i-1})
    kj = kc * torch.exp(-cum)
    # A[i, j] = <ri_i, kj_j> for j < i, per chunk and head.
    A = torch.einsum("bcihn,bcjhn->bchij", ri, kj)
    strict = torch.ones(Q, Q, dtype=torch.bool, device=r.device).tril(-1)
    A = torch.where(strict, A, torch.zeros((), device=r.device))
    diag = torch.einsum("bcihn,hn,bcihn->bcih", rc, u.float(), kc)
    y = torch.einsum("bchij,bcjhn->bcihn", A, vc) + diag[..., None] * vc
    # Each chunk's own contribution to the state at its end, and its decay.
    decay_k = torch.exp(cum[:, :, -1:] - cum)
    st = torch.einsum("bcjhm,bcjhn->bchmn", kc * decay_k, vc)
    total = torch.exp(cum[:, :, -1])                     # (B, nc, H, N)
    state = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
             if init_state is None else init_state.float())
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * total[:, c, :, :, None] + st[:, c]
    y = y + torch.einsum("bcihm,bchmn->bcihn", ri, torch.stack(entering, 1))
    return y.reshape(B, S, H, N).to(r.dtype), state
