"""RWKV-6 ("Finch"): data-dependent-decay linear attention, attention-free
(port of ``repro/models/rwkv6.py``).

Time-mix uses the RWKV-6 ddlerp (token shift mixed by a low-rank,
data-dependent amount) and a per-channel data-dependent decay
``w = exp(-exp(ww))``; the WKV recurrence

    y_t = r_t . (S_{t-1} + u (x) k_t v_t),   S_t = diag(w_t) S_{t-1} + k_t v_t

runs in chunked form for training through kernel B4
(``kernels/rwkv6_wkv``), where the reference runs its jnp twin
``wkv_chunked``.  The twin is kept here, in the compute dtype as the
reference has it, for the tests; B4 computes in f32 and rounds once, so
the two agree tightly in f32 compute and to a tolerance in bf16.  The
log-decay is clamped to [-LW_CLAMP, 0] so chunk-local exponents stay in
f32 range.  Decode (``decode=True``) runs the single-step update
``wkv_sequential`` in plain torch, as the reference does: serving
reaches no kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models.layers import PDef, rms_norm

LORA_MIX = 32       # ddlerp low-rank width
LORA_DECAY = 64     # decay low-rank width
LW_CLAMP = 0.35     # max |log w| per step (see module docstring)


def rwkv6_time_mix_defs(d: int, head_dim: int = 64) -> dict:
    H = d // head_dim
    return {
        "ln": PDef((d,), "ones"),
        "mu_base": PDef((d,), "small"),
        "mix_w1": PDef((d, 5 * LORA_MIX), "small"),
        "mix_w2": PDef((5, LORA_MIX, d), "small"),
        "mu5": PDef((5, d), "small"),
        "decay_w0": PDef((d,), "small"),
        "decay_w1": PDef((d, LORA_DECAY), "small"),
        "decay_w2": PDef((LORA_DECAY, d), "small"),
        "wr": PDef((d, d)),
        "wk": PDef((d, d)),
        "wv": PDef((d, d)),
        "wg": PDef((d, d)),
        "bonus_u": PDef((H, head_dim), "small"),
        "wo": PDef((d, d)),
        "out_gn": PDef((d,), "ones"),
    }


def rwkv6_channel_mix_defs(d: int, d_ff: int) -> dict:
    return {
        "ln": PDef((d,), "ones"),
        "mu_k": PDef((d,), "small"),
        "mu_r": PDef((d,), "small"),
        "wk": PDef((d, d_ff)),
        "wv": PDef((d_ff, d)),
        "wr": PDef((d, d)),
    }


def _token_shift(x, x_prev_token=None):
    """Shift right by one along seq; first slot filled by x_prev_token."""
    first = (torch.zeros_like(x[:, :1]) if x_prev_token is None
             else x_prev_token[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(params, x, xx):
    """RWKV6 data-dependent lerp -> the 5 mixed inputs (w, k, v, r, g)."""
    base = x + xx * params["mu_base"]
    lora = torch.tanh(base @ params["mix_w1"])
    B, S, _ = lora.shape
    lora = lora.reshape(B, S, 5, LORA_MIX)
    dyn = torch.einsum("bsfl,fld->bsfd", lora, params["mix_w2"])
    mixed = x[:, :, None] + xx[:, :, None] * (params["mu5"] + dyn)
    return [mixed[:, :, i] for i in range(5)]


def wkv_chunked(r, k, v, lw, u, *, chunk: int, init_state=None):
    """The reference's chunked WKV in the inputs' dtype (its einsums,
    cumsum and exps round there; the state is f32).  r, k, v: (B, S, H,
    N); lw: (B, S, H, N) log-decay in [-c, 0]; u: (H, N).  Returns
    (y (B, S, H, N), final_state (B, H, N, N)).  The model runs B4
    instead; this twin is the tests' bridge to the JAX model."""
    B, S, H, N = r.shape
    nc = S // chunk
    assert S % chunk == 0
    cm = lambda t: t.reshape(B, nc, chunk, H, N).movedim(1, 0)
    rc, kc, vc, lwc = cm(r), cm(k), cm(v), cm(lw)
    ii = torch.arange(chunk, device=r.device)
    strict = (ii[:, None] > ii[None, :])[None, None]     # (1,1,Q,Q): j < i
    state = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
             if init_state is None else init_state)
    ys = []
    for c in range(nc):
        r_c, k_c, v_c, lw_c = rc[c], kc[c], vc[c], lwc[c]   # (B,Q,H,N)
        cum = torch.cumsum(lw_c, dim=1)
        ri = r_c * torch.exp(cum - lw_c)
        kj = k_c * torch.exp(-cum)
        A = torch.einsum("bihc,bjhc->bhij", ri, kj)
        A = torch.where(strict, A, torch.zeros((), dtype=A.dtype,
                                               device=A.device))
        diag = torch.einsum("bihc,hc,bihc->bih", r_c, u, k_c)
        y = torch.einsum("bhij,bjhn->bihn", A, v_c) + diag[..., None] * v_c
        y = y + torch.einsum("bihc,bhcn->bihn", ri, state.to(ri.dtype))
        decay_k = torch.exp(cum[:, -1:] - cum)
        st_c = torch.einsum("bjhc,bjhn->bhcn", k_c * decay_k, v_c)
        total_decay = torch.exp(cum[:, -1])                  # (B,H,N)
        state = (state * total_decay[..., None].float()
                 + st_c.float())
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, H, N), state


def wkv_sequential(r, k, v, lw, u, *, init_state=None):
    """Step-by-step form: the decode step's update, and the reference's
    branch for sequences that the chunk does not divide.  Returns (y in
    r's dtype, f32 state)."""
    B, S, H, N = r.shape
    state = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
             if init_state is None else init_state)
    ys = []
    for t in range(S):
        # The reference's einsums "bhc,bhn->bhcn" (an outer product) and
        # "bhc,bhcn->bhn" (a batched product), without einsum's parsing.
        kv = (k[:, t, :, :, None] * v[:, t, :, None, :]).float()
        ys.append((r[:, t, :, None, :].float()
                   @ (state + u[..., None] * kv))[:, :, 0])
        state = state * torch.exp(lw[:, t].float())[..., None] + kv
    return torch.stack(ys, dim=1).to(r.dtype), state


def time_mix_apply(params, x, *, head_dim=64, chunk=128, state=None,
                   x_prev=None, decode=False):
    """x: (B, S, d).  Returns (out, (final_wkv_state, last_token)).
    ``params`` are in x's dtype (``rwkv_lm.lm_loss`` casts them once).
    ``decode`` runs the single-step update from ``state`` (f32) and
    ``x_prev`` (the cache's token shift), never B4."""
    B, S, d = x.shape
    H = d // head_dim

    h = rms_norm(x, params["ln"])
    xx = _token_shift(h, x_prev) - h
    xw, xk, xv, xr, xg = _ddlerp(params, h, xx)

    ww = params["decay_w0"] + torch.tanh(
        xw @ params["decay_w1"]) @ params["decay_w2"]
    lw = -torch.clamp(torch.exp(ww.float()), 0.0, LW_CLAMP)   # (B, S, d)

    r = (xr @ params["wr"]).reshape(B, S, H, head_dim)
    k = (xk @ params["wk"]).reshape(B, S, H, head_dim)
    v = (xv @ params["wv"]).reshape(B, S, H, head_dim)
    g = F.silu(xg @ params["wg"])
    lwh = lw.reshape(B, S, H, head_dim).to(x.dtype)
    u = params["bonus_u"]

    ck = min(chunk, S)
    if decode or S % ck != 0:
        y, new_state = wkv_sequential(r, k, v, lwh, u, init_state=state)
    else:
        y, new_state = wkv_ops.wkv(r, k, v, lwh, u, init_state=state,
                                   chunk=ck)

    y = y.reshape(B, S, d)
    y = rms_norm(y, params["out_gn"]) * g
    out = y @ params["wo"]
    return out, (new_state, h[:, -1])


def channel_mix_apply(params, x, *, x_prev=None):
    """x: (B, S, d) -> (out, last_token)."""
    h = rms_norm(x, params["ln"])
    xx = _token_shift(h, x_prev) - h
    xk = h + xx * params["mu_k"]
    xr = h + xx * params["mu_r"]
    k = torch.relu(xk @ params["wk"])
    kv = (k * k) @ params["wv"]
    rgate = torch.sigmoid(xr @ params["wr"])
    return rgate * kv, h[:, -1]
