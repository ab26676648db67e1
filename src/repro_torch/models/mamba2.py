"""Mamba-2 (SSD) block and the pure-SSD language model (port of
``repro/models/mamba2.py``): the training loss and the serving steps.

Shapes: x (B, S, d_model); inside, d_inner = expand * d_model splits into
H = d_inner / P heads of dim P; the state is N = ssm_state wide; one
group (B and C shared by every head).  The full-sequence block runs its
SSD scan through kernel B5 (``kernels/mamba2_ssd``), where the reference
runs its jnp twin ``ssd_chunked``.  The twin is kept here, in the
compute dtype as the reference has it, for the tests; B5 computes in f32
and rounds once, so the two agree tightly in f32 compute and to a
tolerance in bf16.

``softplus`` is ``F.softplus``, whose ``threshold=20`` returns x itself
above 20 where ``jax.nn.softplus`` adds ``log1p(exp(-x))`` < 2.1e-9: in
f32 that sum rounds back to x (its ulp at 20 is 1.9e-6), so the two agree.

Layer params are stacked on a leading L axis as in the reference; its
``scan`` over layers becomes a Python loop, each layer under the
config's remat policy (under "full" B5 launches twice a layer a step).
``lm_loss`` casts the float32 masters to the compute dtype once at its
entry, except ``A_log`` and ``dt_bias``, which the reference reads in
float32 (``init`` keeps those two in float32 whatever the dtype).

Serving carries, per layer, the causal conv's last K-1 inputs (``conv``)
and the SSM state (``ssm``, (H, P, N)), both in the cache dtype (bf16 by
default, as in the reference).  The decode step is the single-step
update in plain torch (no kernel, as in the reference) with the
reference's rounding sites: the state is read into f32, ``ssm * decay +
upd`` and the ``C`` contraction run there, and the new state is rounded
back to the cache dtype every step.  The paged step (``model_zoo``)
runs the decode body on the slots' state rows and the chunked prefill
over the chunk (both in ``models/scan_prefill``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.models.layers import (PDef, chunked_cross_entropy,
                                       init_params, rms_norm, rms_norm_defs,
                                       stack_defs)
from repro_torch.models.remat import resolve_policy, wrap_layer_body
from repro_torch.models.scan_prefill import batch_axes_of, scan_prefill
from repro_torch.models.transformer import (compute_dtype, layer_params,
                                            padded_vocab)

# Leaves the reference reads as float32 whatever the compute dtype.
_F32_LEAVES = ("A_log", "dt_bias")


def mamba2_defs(d: int, *, expand: int = 2, head_dim: int = 64,
                state: int = 64, conv_width: int = 4) -> dict:
    d_in = expand * d
    nheads = d_in // head_dim
    conv_ch = d_in + 2 * state
    return {
        "norm": PDef((d,), "ones"),
        # in_proj -> [z (d_in), x (d_in), B (N), C (N), dt (H)]
        "in_proj": PDef((d, 2 * d_in + 2 * state + nheads)),
        "conv_w": PDef((conv_width, conv_ch), "small"),
        "conv_b": PDef((conv_ch,), "zeros"),
        "A_log": PDef((nheads,), "zeros"),
        "D": PDef((nheads,), "ones"),
        "dt_bias": PDef((nheads,), "zeros"),
        "gate_norm": PDef((d_in,), "ones"),
        "out_proj": PDef((d_in, d)),
    }


def _split_proj(zxbcdt, d_in, state, nheads):
    z = zxbcdt[..., :d_in]
    xs = zxbcdt[..., d_in: 2 * d_in]
    Bs = zxbcdt[..., 2 * d_in: 2 * d_in + state]
    Cs = zxbcdt[..., 2 * d_in + state: 2 * d_in + 2 * state]
    dt = zxbcdt[..., 2 * d_in + 2 * state:]
    return z, xs, Bs, Cs, dt


def _causal_conv(x, w, b):
    """Depthwise causal conv, K terms summed in x's dtype as the
    reference does. x: (B, S, ch); w: (K, ch)."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + pad[:, i: i + x.shape[1]] * w[i]
    return out + b


def ssd_chunked(xh, dt, A, Bs, Cs, *, chunk: int, init_state=None):
    """The reference's chunked SSD scan in the inputs' dtype (its
    cumsum, exps and einsums round there; the state is carried in f32).
    xh: (B, S, H, P); dt: (B, S, H) after softplus; A: (H,) negative;
    Bs, Cs: (B, S, N).  Returns (y (B, S, H, P), final state (B, H, P, N)
    in xh's dtype).  The model runs B5 instead; this twin is the tests'
    bridge to the JAX model."""
    Bsz, S, H, P = xh.shape
    N = Bs.shape[-1]
    nc = S // chunk
    assert S % chunk == 0, (S, chunk)
    cm = lambda t: t.reshape(Bsz, nc, chunk, *t.shape[2:]).movedim(1, 0)
    xc, dtc, Bc, Cc = cm(xh), cm(dt), cm(Bs), cm(Cs)
    ii = torch.arange(chunk, device=xh.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]   # (1,Q,Q,1)
    state = (torch.zeros((Bsz, H, P, N), dtype=xh.dtype, device=xh.device)
             if init_state is None else init_state).float()
    zero = torch.zeros((), dtype=xh.dtype, device=xh.device)
    ys = []
    for c in range(nc):
        x_c, dt_c, B_c, C_c = xc[c], dtc[c], Bc[c], Cc[c]
        cum = torch.cumsum(dt_c * A, dim=1)                   # (B,Q,H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]         # (B,Q,Q,H)
        L = torch.where(causal, torch.exp(seg), zero).to(xh.dtype)
        CB = torch.einsum("bin,bjn->bij", C_c, B_c)
        xdt = x_c * dt_c[..., None]
        y_diag = torch.einsum("bij,bijh,bjhp->bihp", CB, L, xdt)
        out_decay = torch.exp(cum).to(xh.dtype)
        y_off = torch.einsum("bin,bhpn,bih->bihp", C_c,
                             state.to(xh.dtype), out_decay)
        decay_states = torch.exp(cum[:, -1:] - cum)
        st_c = torch.einsum("bjn,bjh,bjhp->bhpn", B_c, decay_states, xdt)
        chunk_decay = torch.exp(cum[:, -1]).float()
        state = state * chunk_decay[:, :, None, None] + st_c.float()
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    return y, state.to(xh.dtype)


def mamba2_apply(params, x, *, expand=2, head_dim=64, state=64,
                 conv_width=4, chunk=256):
    """Full-sequence block apply. x: (B, S, d) -> (B, S, d).  ``params``
    are in x's dtype (``lm_loss`` casts them once), ``A_log`` and
    ``dt_bias`` in any float dtype (read as float32)."""
    B, S, d = x.shape
    dt_ = x.dtype
    d_in = expand * d
    H = d_in // head_dim

    h = rms_norm(x, params["norm"])
    zxbcdt = h @ params["in_proj"]
    z, _, _, _, dtr = _split_proj(zxbcdt, d_in, state, H)

    # [x, B, C] are adjacent columns of the projection: one conv over them.
    xbc = F.silu(_causal_conv(zxbcdt[..., d_in: 2 * d_in + 2 * state],
                              params["conv_w"], params["conv_b"]))
    xs, Bs, Cs = (xbc[..., :d_in], xbc[..., d_in:d_in + state],
                  xbc[..., d_in + state:])

    dt = F.softplus(dtr.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = xs.reshape(B, S, H, head_dim)

    y, _ = ssd_ops.ssd(xh, dt.to(dt_), A.to(dt_), Bs, Cs,
                       chunk=min(chunk, S))
    y = y + xh * params["D"][None, None, :, None]
    y = y.reshape(B, S, d_in)
    y = rms_norm(y * F.silu(z), params["gate_norm"])
    return y @ params["out_proj"]


# ---------------------------------------------------------------------------
# Language model: embed -> L x residual mamba2 block -> norm -> head.
# ---------------------------------------------------------------------------

def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "mamba":
        raise ValueError(f"{cfg.name}: mamba2 runs the mamba family, not "
                         f"{cfg.family!r}")


def _block_kw(cfg: ArchConfig) -> dict:
    return dict(expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                state=cfg.ssm_state, conv_width=cfg.conv_width)


def model_defs(cfg: ArchConfig) -> dict:
    _check_family(cfg)
    d = cfg.d_model
    return {
        "embedding": PDef((padded_vocab(cfg.vocab), d), "small"),
        "lm_head": PDef((d, padded_vocab(cfg.vocab))),
        "final_norm": rms_norm_defs(d),
        "layers": stack_defs(mamba2_defs(d, **_block_kw(cfg)),
                             cfg.n_layers),
    }


def init(cfg: ArchConfig, generator: torch.Generator,
         device: torch.device, dtype=None) -> dict:
    """Random weights drawn on ``device`` from ``generator`` in ``dtype``
    (default the compute dtype; training passes float32 for its
    masters), but ``A_log`` and ``dt_bias`` in float32, as the reference
    reads them."""
    params = init_params(model_defs(cfg), generator, device,
                         dtype or compute_dtype(cfg))
    layers = params["layers"]
    for k in _F32_LEAVES:
        layers[k] = layers[k].float()
    return params


def cast_params(cfg: ArchConfig, params: dict) -> dict:
    """The param tree in the compute dtype (a differentiable cast), but
    ``A_log`` and ``dt_bias`` as they are."""
    dt = compute_dtype(cfg)
    return {k: (v if k in _F32_LEAVES else cast_params(cfg, v)
                if isinstance(v, dict) else v.to(dt))
            for k, v in params.items()}


def forward(cfg: ArchConfig, params, tokens):
    """tokens (B, S) -> final-normed hidden (B, S, d).  ``params`` as
    ``cast_params`` gives them."""
    _check_family(cfg)
    h = params["embedding"][tokens.long()]

    def body(h, lp):
        return h + mamba2_apply(lp, h, **_block_kw(cfg))

    body_fn = wrap_layer_body(body, resolve_policy(cfg))
    for l in range(cfg.n_layers):
        h = body_fn(h, layer_params(params, l))
    return rms_norm(h, params["final_norm"])


def lm_loss(cfg: ArchConfig, params, batch):
    """Mean next-token cross-entropy.  batch: {"tokens": (B, S),
    "labels": (B, S)}; ``params`` in any float dtype, cast once here."""
    params = cast_params(cfg, params)
    h = forward(cfg, params, batch["tokens"])
    labels = batch["labels"]
    return chunked_cross_entropy(
        h, params, labels, chunk=min(cfg.loss_chunk, labels.shape[1]),
        compute_dtype=compute_dtype(cfg))


# ---------------------------------------------------------------------------
# Serving: the single-token step and the carried state (conv + ssm)
# ---------------------------------------------------------------------------

def mamba2_state_spec(batch, d, *, expand=2, head_dim=64, state=64,
                      conv_width=4, dtype=torch.bfloat16) -> dict:
    """{name: (shape, dtype)} of one block's decode state."""
    d_in = expand * d
    return {"conv": ((batch, conv_width - 1, d_in + 2 * state), dtype),
            "ssm": ((batch, d_in // head_dim, head_dim, state), dtype)}


def mamba2_init_state(batch, d, *, device, expand=2, head_dim=64, state=64,
                      conv_width=4, dtype=torch.bfloat16) -> dict:
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in mamba2_state_spec(
                batch, d, expand=expand, head_dim=head_dim, state=state,
                conv_width=conv_width, dtype=dtype).items()}


def mamba2_decode(params, x, cache, *, expand=2, head_dim=64, state=64,
                  conv_width=4):
    """Single-token step.  x: (B, 1, d); cache {conv (B, K-1, ch), ssm
    (B, H, P, N)}.  Returns (out (B, 1, d), new state in the cache's
    dtypes); the inputs are not written."""
    B, _, d = x.shape
    dt_ = x.dtype
    d_in = expand * d
    H = d_in // head_dim

    h = rms_norm(x, params["norm"])
    zxbcdt = h @ params["in_proj"]
    z, _, _, _, dtr = _split_proj(zxbcdt, d_in, state, H)

    # [x, B, C] are adjacent columns of the projection.
    xbc_t = zxbcdt[:, 0, d_in: 2 * d_in + 2 * state]          # (B, ch)
    window = torch.cat([cache["conv"].to(dt_), xbc_t[:, None]], dim=1)
    conv_out = (torch.einsum("bkc,kc->bc", window, params["conv_w"])
                + params["conv_b"])
    xbc = F.silu(conv_out)
    xs_t = xbc[:, :d_in]
    B_t = xbc[:, d_in:d_in + state]
    C_t = xbc[:, d_in + state:]

    dt = F.softplus(dtr[:, 0].float() + params["dt_bias"].float())  # (B,H)
    A = -torch.exp(params["A_log"].float())
    decay = torch.exp(dt * A)

    xh = xs_t.reshape(B, H, head_dim)
    # The reference's einsums "bhp,bn,bh->bhpn" and "bhpn,bn->bhp", as
    # broadcasts and a batched product: (x dt) B in that order, as XLA
    # computes it, and no per-call contraction-path search on the host.
    upd = ((xh.float() * dt[:, :, None])[..., None]
           * B_t.float()[:, None, None, :])
    ssm = cache["ssm"].float() * decay[:, :, None, None] + upd
    y = (ssm @ C_t.float()[:, None, :, None])[..., 0]
    y = y.to(dt_) + xh * params["D"][None, :, None]
    y = rms_norm(y.reshape(B, 1, d_in) * F.silu(z), params["gate_norm"])
    out = y @ params["out_proj"]
    return out, {"conv": window[:, 1:].to(cache["conv"].dtype),
                 "ssm": ssm.to(cache["ssm"].dtype)}


def cache_spec(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16) -> dict:
    """{name: (shape, dtype)}: ``conv`` (L, B, K-1, ch) and ``ssm`` (L,
    B, H, P, N), both in the cache dtype.  ``max_seq`` is unused (the
    state does not grow) but kept for API parity."""
    per = mamba2_state_spec(batch, cfg.d_model, dtype=dtype,
                            **_block_kw(cfg))
    return {name: ((cfg.n_layers,) + shape, dt)
            for name, (shape, dt) in per.items()}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, device,
               dtype=torch.bfloat16) -> dict:
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in cache_spec(cfg, batch, max_seq,
                                                dtype).items()}


def cache_axes(cfg: ArchConfig) -> dict:
    return {"conv": ("layers", "batch", None, "mlp"),
            "ssm": ("layers", "batch", "heads", None, None)}


def _decode(cfg: ArchConfig, params, cache, tokens, out) -> torch.Tensor:
    """The single-token decode body: reads layer ``l`` of ``cache`` and
    writes its new state into layer ``l`` of ``out`` (``cache`` itself
    for an in-place step).  Returns the logits (B, vocab_padded) f32."""
    _check_family(cfg)
    h = params["embedding"][tokens.long()]                    # (B, 1, d)
    for l in range(cfg.n_layers):
        o, new = mamba2_decode(layer_params(params, l), h,
                               {name: leaf[l] for name, leaf in cache.items()},
                               **_block_kw(cfg))
        h = h + o
        for name, leaf in out.items():
            leaf[l].copy_(new[name])
    h = rms_norm(h, params["final_norm"])
    return (h[:, 0] @ params["lm_head"]).float()


def decode_step(cfg: ArchConfig, params, cache, tokens, positions):
    """One decode step.  tokens (B, 1); ``positions`` unused (the state
    carries the history) but kept for API parity.  The cache is written
    in place.  Returns (logits (B, vocab_padded) f32, cache)."""
    return _decode(cfg, params, cache, tokens, cache), cache



def prefill_step(cfg: ArchConfig, params, cache, tokens, start, last):
    """Chunked prefill by running the decode body over the chunk, each
    slot frozen past ``last`` (``models/scan_prefill``).  The cache is
    written in place.  Returns (logits (B, vocab_padded) at the ``last``
    rows, cache)."""
    def step(c, tok, pos):
        new = {name: torch.empty_like(leaf) for name, leaf in c.items()}
        return _decode(cfg, params, c, tok, new), new

    return scan_prefill(step, cache, tokens, start, last,
                        logits_width=padded_vocab(cfg.vocab),
                        batch_axes=batch_axes_of(cache_axes(cfg)))
