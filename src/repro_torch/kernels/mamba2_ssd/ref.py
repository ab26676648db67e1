"""Plain PyTorch versions of kernel B5, the Mamba-2 SSD scan

    S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t

per head, with x (B, S, H, P), dt (B, S, H) after softplus, A (H,)
negative, and B, C (B, S, N) shared by every head (one group); the
state S is (P, N) per head.

``ssd_ref`` is the sequential oracle of ``repro/kernels/mamba2_ssd/
ref.py``.  ``ssd_chunked_ref`` is the arithmetic of ``ssd_pallas``
(``_ssd_kernel``): everything cast to f32, per chunk of Q rows the
cumsum ``cum`` of dt A, the causal (Q, Q) block ``C B^T`` times
``L[i, j] = exp(cum_i - cum_j)``, applied to ``x dt``, the read of the
state entering the chunk scaled by ``exp(cum_i)``, and the state's
update to the chunk's end; y rounds once to x's dtype, the state stays
f32.  Every decay is the exponential of a difference of cums, never a
product ``exp(cum_i) exp(-cum_j)``: mamba2's decay is not clamped, and
``cum`` passes -88 (where ``exp(-cum)`` overflows f32) inside one chunk
at the reference's initialiser.  The intra-chunk parts of every chunk
are computed at once; only the state is carried through a loop over
chunks.  The CPU tests hold both against the JAX kernel and oracle,
``chip_smoke.py`` holds the CUDA kernel against ``ssd_chunked_ref``,
and ``ops.ssd`` recomputes through it for its gradient.
"""

from __future__ import annotations

import torch


def ssd_ref(x, dt, A, Bs, Cs, s0):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); Bs, Cs: (B, S, N); s0:
    (B, H, P, N) f32.  Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) f32)."""
    Af = A.float()
    state = s0.float()
    ys = []
    for t in range(x.shape[1]):
        dt_t = dt[:, t].float()                              # (B, H)
        upd = torch.einsum("bhp,bn,bh->bhpn", x[:, t].float(),
                           Bs[:, t].float(), dt_t)
        state = state * torch.exp(dt_t * Af)[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cs[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_chunked_ref(x, dt, A, Bs, Cs, *, init_state=None, chunk: int = 256):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); Bs, Cs: (B, S, N);
    init_state: (B, H, P, N) or None (zeros); S % chunk == 0.  Returns
    (y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32)."""
    B, S, H, P = x.shape
    N = Bs.shape[-1]
    Q = chunk
    nc = S // Q
    xc = x.float().reshape(B, nc, Q, H, P)
    dtc = dt.float().reshape(B, nc, Q, H)
    Bc = Bs.float().reshape(B, nc, Q, N)
    Cc = Cs.float().reshape(B, nc, Q, N)
    cum = torch.cumsum(dtc * A.float(), dim=2).transpose(2, 3)  # (B,nc,H,Q)
    # L[i, j] = exp(cum_i - cum_j) for j <= i: the masked differences are
    # set to -inf before the exponential (exp(+) may overflow, and a
    # where() after it would carry inf * 0 into the gradient).
    upper = torch.ones(Q, Q, dtype=torch.bool, device=x.device).triu(1)
    L = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(
        upper, float("-inf")))                               # (B,nc,H,Q,Q)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    xdt = (xc * dtc[..., None]).transpose(2, 3)              # (B,nc,H,Q,P)
    y = (CB[:, :, None] * L) @ xdt                           # (B,nc,H,Q,P)
    # Each chunk's own contribution to the state at its end, and its decay.
    decay = torch.exp(cum[..., -1:] - cum)                   # (B,nc,H,Q)
    st = torch.einsum("bchjp,bcjn->bchpn", xdt * decay[..., None], Bc)
    total = torch.exp(cum[..., -1])                          # (B,nc,H)
    state = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * total[:, c, :, None, None] + st[:, c]
    y_off = torch.einsum("bcin,bchpn->bchip", Cc, torch.stack(entering, 1))
    y = y + y_off * torch.exp(cum)[..., None]
    return y.transpose(2, 3).reshape(B, S, H, P).to(x.dtype), state
