"""The port's whisper-base (family "audio": an encoder-decoder with
cross-attention, conv frontend stubbed) against the JAX package on its
smoke config (2 encoder and 2 decoder layers, d_model 64, 4 heads of
16), on the CPU.

Weights come from the reference's ``init(cfg, PRNGKey(0))`` through
``models/bridge.py``; frame embeddings (normal x 0.02, the reference's
synthetic scale), caches and tokens from seeded numpy generators.  The
serving caches use ``max_seq`` 22 with blocks of 4, so the paged views
are 24 positions wide: T does not divide ``max_seq``.

Tolerances.  In f32 compute ``encode``, ``decode_full`` (fed the same
encoder states), ``lm_loss`` and the serving steps are held within 1e-5
of each output's scale, and the gradients within 1e-4 of theirs or twice
their own one-ulp noise floor, whichever is larger.  The steps are held
over f32 caches (the cross K/V holding bf16 values): XLA and torch sum
in different orders, so an appended K element stored in bf16 can round
one ulp apart, which this model turns into up to 6e-5 of the logits
(ROADMAP C8); the int8 pool test stores int8 words, which round alike
here.  ``build_cross_cache`` in bf16 compute is bitwise but for rare
one-ulp ties.
bf16 compute: the loss within C5's 3e-2; elementwise, the smoke model
at random init is chaotic (ROADMAP C8: no qk-norm, and the reference's
fan-in rule), so the reference's own bf16 ``encode`` parts from its f32
``encode`` by a third of the output's scale, and the port's bf16
outputs are held to within twice that distance of the f32 reference
instead of to 3e-2 of the reference's bf16 outputs.

The engine's greedy tokens in f32 equal the JAX O5 contiguous engine's
(ROADMAP C1) at every rung, with the reference's zero cross K/V and with
an encoded one put in through ``PrefillResult.kv_state``.
"""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.core.optlevel import BestEffortConfig as JaxConfig
from repro.core.optlevel import OptLevel as JaxLevel
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as \
    jax_attention_ref
from repro.models import encdec as jax_encdec
from repro.models import get_model as jax_get_model
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.optlevel import BestEffortConfig, OptLevel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import steps
from repro_torch.launch.serve import serve_demo
from repro_torch.models import encdec, get_model, input_specs, make_batch
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.layers import param_shapes
from repro_torch.serving import DecodeEngine, Request, kvquant
from repro_torch.serving.paged import (NULL_BLOCK, NULL_ROW, BlockPagingPlan,
                                       StatePagingPlan, StatePool)
from repro_torch.tree import leaves

ARCH = "whisper-base"
TOL = 1e-5
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_MODELS = {}


def _models(dtype: str = "float32"):
    """(jax model, jax params, port model, port params in ``dtype``):
    identical weights, ``dtype`` compute."""
    if dtype not in _MODELS:
        jm = jax_get_model(dataclasses.replace(jax_smoke(ARCH),
                                               compute_dtype=dtype))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = get_model(dataclasses.replace(get_smoke(ARCH),
                                           compute_dtype=dtype),
                       device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu",
                             dtype=TDT[dtype])
        _MODELS[dtype] = (jm, jp, tm, tp)
    return _MODELS[dtype]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jx(t, dtype=None):
    """A JAX array holding a COPY of tensor ``t`` (``jnp.asarray`` of a
    numpy view may alias the tensor's memory, and JAX dispatches
    asynchronously, so a later in-place write by the port could reach
    it)."""
    a = np.array(t.numpy() if t.dtype != torch.bfloat16 else
                 t.float().numpy(), copy=True)
    return jnp.asarray(a, dtype) if dtype is not None else jnp.asarray(a)


def _rel(got, want) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _close(got, want, what, ulp=False):
    """|got - want| <= TOL * max|want| (+ one bf16 ulp of ``want``)."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    bound = TOL * np.abs(w).max() + (np.abs(w) * 2.0 ** -7 if ulp else 0)
    err = np.abs(g - w)
    assert (err <= bound).all(), (what, float(err.max()),
                                  float(np.abs(w).max()))


def _frames(B, S, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, S, 64)) * 0.02).astype(np.float32)


def _tokens(B, C, seed):
    return np.random.default_rng(seed).integers(1, 256, (B, C)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# Config, params and batches
# ---------------------------------------------------------------------------

def test_the_port_registers_whisper_with_the_reference_widths():
    for name in ("family", "n_layers", "n_enc_layers", "d_model", "n_heads",
                 "n_kv_heads", "head_dim", "d_ff", "vocab",
                 "loss_chunk", "q_chunk", "remat", "compute_dtype",
                 "param_dtype", "is_encdec"):
        assert getattr(get_config(ARCH), name) == getattr(
            jax_config(ARCH), name), name
        assert getattr(get_smoke(ARCH), name) == getattr(
            jax_smoke(ARCH), name), name
    full = get_config(ARCH)
    assert full.n_params() == jax_config(ARCH).n_params()
    assert get_config("qwen3-8b").n_params() == \
        jax_config("qwen3-8b").n_params()
    with pytest.raises(NotImplementedError, match="model_defs"):
        get_config("zamba2-2.7b").n_params()
    m = get_model(full, device="cpu")
    shapes = [s for _, s in leaves(param_shapes(m.defs()))]
    assert sum(math.prod(s) for s in shapes) == 109_854_720
    jdefs = jax_encdec.model_defs(jax_config(ARCH))
    assert {p: d.shape for p, d in leaves(jdefs)} == {
        p: s for p, s in leaves(param_shapes(m.defs()))}
    assert {k: s for k, (s, _) in m.cache_spec(8, 1500).items()} == {
        "k": (6, 8, 1500, 8, 64), "v": (6, 8, 1500, 8, 64),
        "cross_k": (6, 8, 1500, 8, 64), "cross_v": (6, 8, 1500, 8, 64)}


def test_get_model_builds_the_audio_family_without_carried_state():
    _, _, tm, _ = _models()
    assert not tm.carries_state
    assert tm.paged_decode_step is not None and tm.prefill_step is not None
    assert tm.verify_step is None and tm.paged_verify_step is None
    assert tm.paged_prefill_step is None


def test_input_specs_and_make_batch_give_frames():
    cfg = get_smoke(ARCH)
    shape = ShapeConfig("t", 16, 2, "train")
    spec = input_specs(cfg, shape)
    assert spec == {"frames": ((2, 16, 64), torch.bfloat16),
                    "tokens": ((2, 16), torch.int32),
                    "labels": ((2, 16), torch.int32)}
    b = make_batch(cfg, shape, torch.Generator().manual_seed(0),
                   device="cpu")
    assert b["frames"].dtype == torch.bfloat16
    assert 0.01 < float(b["frames"].float().std()) < 0.03
    assert int(b["tokens"].max()) < cfg.vocab
    loss = get_model(cfg, device="cpu").loss(
        get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0)),
        b)
    assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# Forward and gradients
# ---------------------------------------------------------------------------

def test_encode_decode_full_and_lm_loss_match_jax_f32():
    jm, jp, tm, tp = _models()
    fr, tok = _frames(2, 24, 0), _tokens(2, 12, 1)
    je = jax_encdec.encode(jm.cfg, jp, jnp.asarray(fr))
    te = encdec.encode(tm.cfg, tp, torch.tensor(fr))
    _close(te, je, "encode")
    # Fed the same encoder states (the smoke model amplifies a 1e-6
    # difference in them: C8).
    jh = jax_encdec.decode_full(jm.cfg, jp, jnp.asarray(tok), je)
    th = encdec.decode_full(tm.cfg, tp, torch.tensor(tok),
                            torch.tensor(np.asarray(je)))
    _close(th, jh, "decode_full")
    batch = {"frames": fr, "tokens": tok, "labels": _tokens(2, 12, 2)}
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = steps.value_and_grad(
        tm.loss, tp, {k: torch.tensor(v) for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
    jg = dict(leaves(jax.tree.map(np.asarray, jg)))
    tg = dict(leaves(tg))
    assert set(tg) == set(jg) and ("decoder", "cross", "wk") in tg
    # The gradients' noise floor: the port's own gradients after a
    # one-ulp nudge of one weight leaf.  This smoke model moves them by
    # ~2e-4 of their scale (C8), above the 1e-4 the dense family meets;
    # each leaf is held within 1e-4 or twice that floor.
    nudged = dict(tp, encoder=dict(tp["encoder"], attn=dict(
        tp["encoder"]["attn"],
        wq=tp["encoder"]["attn"]["wq"] * (1 + 2.0 ** -23))))
    _, tg2 = steps.value_and_grad(
        tm.loss, nudged, {k: torch.tensor(v) for k, v in batch.items()})
    tg2 = dict(leaves(tg2))
    floor = max(float((tg[p] - tg2[p]).abs().max()) / np.abs(jg[p]).max()
                for p in tg)
    assert 1e-5 < floor < 1e-3, floor
    for path, g in tg.items():
        assert g.dtype == torch.float32, path
        err = np.abs(g.numpy() - jg[path]).max() / np.abs(jg[path]).max()
        assert err <= max(1e-4, 2 * floor), (path, err, floor)


def test_bf16_forward_within_the_references_own_bf16_spread():
    """bf16 compute: the loss within C5's 3e-2 of the reference's;
    ``encode`` and ``decode_full`` within twice the distance that bf16
    rounding puts between the reference's own bf16 and f32 runs (C8)."""
    jm32, jp, _, _ = _models()
    jm, _, tm, tp = _models("bfloat16")
    fr, tok = _frames(2, 24, 0), _tokens(2, 12, 1)
    j32 = jax_encdec.encode(jm32.cfg, jp, jnp.asarray(fr))
    jb = jax_encdec.encode(jm.cfg, jp, jnp.asarray(fr))
    tb = encdec.encode(tm.cfg, tp, torch.tensor(fr))
    assert tb.dtype == torch.bfloat16
    assert _rel(tb, j32) <= 2 * _rel(jb, j32)
    h32 = jax_encdec.decode_full(jm32.cfg, jp, jnp.asarray(tok), j32)
    hb = jax_encdec.decode_full(jm.cfg, jp, jnp.asarray(tok),
                                j32.astype(jnp.bfloat16))
    th = encdec.decode_full(tm.cfg, tp, torch.tensor(tok),
                            torch.tensor(np.asarray(j32)).bfloat16())
    assert _rel(th, h32) <= 2 * _rel(hb, h32)
    batch = {"frames": fr, "tokens": tok, "labels": _tokens(2, 12, 2)}
    jl = float(jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    tl = float(tm.loss(tp, {k: torch.tensor(v) for k, v in batch.items()}))
    assert abs(tl - jl) <= 3e-2 * abs(jl), (tl, jl)


def test_cross_attention_runs_b3_without_a_mask():
    """``attention(kv_x=...)`` is B3 non-causal over the encoder's keys,
    with fewer decoder rows than encoder positions and more; a CPU call
    counts no launch."""
    from repro_torch.models import attention as attn

    _, _, tm, tp = _models()
    lp = {k: v[0] for k, v in tp["decoder"]["cross"].items()}
    r = np.random.default_rng(3)
    before = flash_ops.flash_attention.launches
    for S, Se in ((6, 24), (24, 6)):
        x = torch.tensor(r.standard_normal((2, S, 64)).astype(np.float32))
        enc = torch.tensor(r.standard_normal((2, Se, 64)).astype(np.float32))
        pos = torch.arange(S)[None].expand(2, S)
        out = attn.attention(lp, x, pos, n_heads=4, n_kv=4, head_dim=16,
                             causal=False, kv_x=enc,
                             kv_positions=torch.arange(Se)[None].expand(2,
                                                                        Se))
        # One query row's output depends on its own row only: the rows
        # are independent of how many there are.
        one = attn.attention(lp, x[:, :1], pos[:, :1], n_heads=4, n_kv=4,
                             head_dim=16, causal=False, kv_x=enc,
                             kv_positions=torch.arange(Se)[None].expand(
                                 2, Se))
        assert out.shape == x.shape
        _close(out[:, :1], one, "row 0 alone")
    assert flash_ops.flash_attention.launches == before


@pytest.mark.parametrize("cross,kv_pos,causal", [
    (False, False, True), (False, False, False), (True, True, False),
    (True, False, False)])
def test_attention_options_match_jax(cross, kv_pos, causal):
    """``attention`` against the reference's in f32: causal and
    non-causal (the encoder's) self-attention, and cross-attention
    (non-causal, 10 encoder positions for 6 rows) with k roped at
    ``kv_positions`` and with k not roped."""
    from repro.models import attention as jax_attn
    from repro_torch.models import attention as attn

    jm, jp, _, tp = _models()
    jlp = jax.tree.map(lambda a: a[0], jp["decoder"]["cross"])
    tlp = {k: v[0] for k, v in tp["decoder"]["cross"].items()}
    r = np.random.default_rng(21)
    x = r.standard_normal((2, 6, 64)).astype(np.float32)
    enc = r.standard_normal((2, 10, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6)[None], (2, 6))
    epos = np.broadcast_to(np.arange(3, 13)[None], (2, 10))
    kw = dict(n_heads=4, n_kv=4, head_dim=16, causal=causal)
    jkw, tkw = dict(kw), dict(kw)
    if cross:
        jkw.update(kv_x=jnp.asarray(enc))
        tkw.update(kv_x=torch.tensor(enc))
        if kv_pos:
            jkw.update(kv_positions=jnp.asarray(epos))
            tkw.update(kv_positions=torch.tensor(epos))
    want = jax_attn.attention(jlp, jnp.asarray(x), jnp.asarray(pos), **jkw)
    got = attn.attention(tlp, torch.tensor(x), torch.tensor(pos), **tkw)
    _close(got, want, f"attention cross={cross} kv_pos={kv_pos} "
                      f"causal={causal}")


@pytest.mark.parametrize("S,S_kv", [(64, 16), (48, 40), (32, 1)])
def test_b3_plain_non_causal_with_fewer_keys_than_queries_matches_jax(
        S, S_kv):
    """S_kv < S without a mask, which the reference's cross-attention
    takes: the JAX Pallas kernel asserts S_kv >= S whatever the mask, so
    the plain version is held to the JAX package's oracle
    (``attention_ref``, K/V repeated to the query heads), and at S_kv >=
    S to the JAX kernel in interpret mode; a causal call still wants
    S_kv >= S."""
    r = np.random.default_rng(S + S_kv)
    q, k, v = (r.normal(size=shape).astype(np.float32) for shape in (
        (2, S, 4, 16), (2, S_kv, 2, 16), (2, S_kv, 2, 16)))

    def flat(a):
        a = np.repeat(a, 4 // a.shape[2], axis=2)
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(-1, *a.shape[1:2],
                                                           16))

    want = np.asarray(jax_attention_ref(flat(q), flat(k), flat(v),
                                        causal=False))
    want = want.reshape(2, 4, S, 16).transpose(0, 2, 1, 3)
    got = flash_ops.flash_attention(torch.tensor(q), torch.tensor(k),
                                    torch.tensor(v), causal=False)
    _close(got, want, "B3 non-causal S_kv < S")
    # Both ways round at S_kv >= S: the oracle equals the JAX kernel.
    kk, vv = (np.concatenate([a] * (S // S_kv + 1), axis=1)[:, :S]
              for a in (k, v))
    kern = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(kk),
                                jnp.asarray(vv), causal=False, block_q=16,
                                block_k=16))
    _close(flash_ops.flash_attention(torch.tensor(q), torch.tensor(kk),
                                     torch.tensor(vv), causal=False),
           kern, "B3 non-causal S_kv >= S")
    with pytest.raises(ValueError, match="S_kv >= S"):
        flash_ops.flash_attention(torch.tensor(q), torch.tensor(k),
                                  torch.tensor(v), causal=True)


# ---------------------------------------------------------------------------
# The cross cache and the serving steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 4])
def test_build_cross_cache_is_bitwise_in_bf16_but_for_rare_ties(seed):
    """bf16 compute, the same encoder states on both sides: every element
    equal, but for a rare one that the two summation orders round to
    neighbouring bf16 values (seed 4: 1 of 6,144); f32 compute stores
    bf16 too (the reference's ``astype``)."""
    jm, jp, tm, tp = _models("bfloat16")
    enc = jax_encdec.encode(jm.cfg, jp, jnp.asarray(_frames(2, 24, seed)))
    want = jax_encdec.build_cross_cache(jm.cfg, jp, enc)
    got = encdec.build_cross_cache(tm.cfg, tp,
                                   torch.tensor(_np(enc)).bfloat16())
    for name, ref in (("cross_k", want["k"]), ("cross_v", want["v"])):
        assert got[name].dtype == torch.bfloat16
        assert got[name].shape == (2, 2, 24, 4, 16)
        g, w = _np(got[name]), _np(ref)
        assert (np.abs(g - w) <= np.abs(w) * 2.0 ** -7).all()
        assert (g != w).sum() <= 2, (name, int((g != w).sum()))
    # f32 compute still stores bf16 (the reference's astype).
    _, _, tm32, tp32 = _models()
    got32 = encdec.build_cross_cache(tm32.cfg, tp32,
                                     torch.tensor(_np(enc)))
    assert got32["cross_k"].dtype == torch.bfloat16


B, S, T = 3, 22, 4
NB = -(-S // T)
POS = np.array([3, 9, 17], np.int32)        # a block's end, middle, start


def _cross(B_, seed):
    """A non-zero cross K/V from the reference's encoder: bf16 (L, B,
    S, KV, dh) numpy, the same bits on both sides."""
    jm, jp, _, _ = _models()
    enc = jax_encdec.encode(jm.cfg, jp, jnp.asarray(_frames(B_, S, seed)))
    c = jax_encdec.build_cross_cache(jm.cfg, jp, enc)
    return {"cross_k": np.asarray(c["k"]), "cross_v": np.asarray(c["v"])}


def _dense_cache(seed):
    """An f32 dense cache: random bf16-valued self K/V up to each slot's
    ``POS`` (zero past it, which the reference's dense step never reads)
    and a cross K/V encoded from random frames (bf16 values)."""
    _, _, tm, _ = _models()
    rng = np.random.default_rng(seed)
    c = {}
    for name in encdec.SELF:
        shape, _ = tm.cache_spec(B, S)[name]
        c[name] = torch.tensor(rng.standard_normal(shape).astype(np.float32)
                               * 0.5).bfloat16().float()
        for b in range(B):
            c[name][:, b, POS[b]:] = 0
    for name, arr in _cross(B, seed + 100).items():
        c[name] = torch.tensor(arr.astype(np.float32))
    return c


def _to_jax(c):
    j = {n: _jx(v) for n, v in c.items()}
    return {"self_kv": {"k": j["k"], "v": j["v"]},
            "cross_kv": {"k": j["cross_k"], "v": j["cross_v"]}}


def _flat(jc):
    return {"k": jc["self_kv"]["k"], "v": jc["self_kv"]["v"],
            "cross_k": jc["cross_kv"]["k"], "cross_v": jc["cross_kv"]["v"]}


def test_decode_step_matches_jax_over_a_nonzero_cross_cache():
    """Three decode steps: logits and the self K/V after each; the cross
    leaves keep their bits."""
    jm, jp, tm, tp = _models()
    cache = _dense_cache(seed=1)
    cross0 = {n: cache[n].clone() for n in encdec.CROSS}
    jc = _to_jax(cache)
    pos = POS.copy()
    for t in range(3):
        tok = _tokens(B, 1, 10 + t)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, cache = tm.decode_step(tp, cache, torch.tensor(tok),
                                   torch.tensor(pos))
        _close(tl, jl, f"logits {t}")
        for name, want in _flat(jc).items():
            _close(cache[name], want, f"{name} {t}")
        pos = pos + 1
    for n in encdec.CROSS:
        assert torch.equal(cache[n], cross0[n])


def test_a_nonzero_cross_cache_changes_the_logits():
    """With K = V = 0 every cross softmax is uniform and its output 0, so
    the served tokens cannot see a wrong cross attention; an encoded
    cross K/V moves the logits."""
    _, _, tm, tp = _models()
    cache = _dense_cache(seed=2)
    zero = {n: (torch.zeros_like(v) if n in encdec.CROSS else v.clone())
            for n, v in cache.items()}
    tok, pos = torch.tensor(_tokens(B, 1, 3)), torch.tensor(POS)
    a, _ = tm.decode_step(tp, {k: v.clone() for k, v in cache.items()}, tok,
                          pos)
    b, _ = tm.decode_step(tp, zero, tok, pos)
    assert _rel(a, b) > 0.05


def test_prefill_step_matches_jax_and_equals_its_one_token_steps():
    """A ragged chunk (slots stop after rows 4, 1 and 2 of 5; slot 2's
    tail runs past ``max_seq`` and clips): the reference's prefill step
    within 1e-5; bit for bit the port's own one-token steps of the batch
    on each slot's live rows; frozen positions keep their bits; the
    cross leaves are the same tensors, untouched."""
    jm, jp, tm, tp = _models()
    c0 = _dense_cache(seed=5)
    start = torch.tensor([3, 9, 18])
    last = torch.tensor([4, 1, 2])
    tok = _tokens(B, 5, 6)
    cache = {k: v.clone() for k, v in c0.items()}
    ids = {n: cache[n].data_ptr() for n in cache}
    sel, out = tm.prefill_step(tp, cache, torch.tensor(tok), start, last)
    assert out is cache and {n: cache[n].data_ptr() for n in cache} == ids
    jsel, jcache = jm.prefill_step(jp, _to_jax(c0), jnp.asarray(tok),
                                   jnp.asarray(start.numpy()),
                                   jnp.asarray(last.numpy()))
    _close(sel, jsel, "prefill logits")
    for name, want in _flat(jcache).items():
        _close(cache[name], want, name)
    for n in encdec.CROSS:
        assert torch.equal(cache[n], c0[n])
    # One-token steps of the whole batch, as many as slot b has live
    # rows, clipped as the chunk clips.
    for b in range(B):
        steps_ = {k: v.clone() for k, v in c0.items()}
        for j in range(int(last[b]) + 1):
            lg, _ = tm.decode_step(tp, steps_, torch.tensor(tok[:, j:j + 1]),
                                   (start + j).clamp(max=S - 1))
        assert torch.equal(sel[b], lg[b]), b
        for name in c0:
            assert torch.equal(cache[name][:, b], steps_[name][:, b]), \
                (b, name)


def _layout(seed):
    """Shuffled tables over a pool of 1 + B*NB + 2 block rows (two
    spare), and cross rows [2, 4, 1] of 5 (row 3 spare, row 0 NULL)."""
    rng = np.random.default_rng(seed)
    R = 1 + B * NB + 2
    tables = rng.permutation(np.arange(1, R))[:B * NB].reshape(B, NB)
    return tables.astype(np.int32), np.array([2, 4, 1], np.int64), R, 5


def _mixed_pool(dense, tables, rows, R, n_rows, seed):
    """The dense cache in a mixed pool: self K/V blocks through
    ``tables`` (the view padded to NB*T), cross K/V through ``rows``;
    every other row and block (the NULL ones too) random garbage."""
    g = torch.Generator().manual_seed(seed)
    pool = {}
    for name, leaf in dense.items():
        if name in encdec.SELF:
            L, _, _, KV, D = leaf.shape
            p = torch.randn((L, R, T, KV, D), generator=g).to(leaf.dtype)
            wide = torch.zeros((L, B, NB * T, KV, D), dtype=leaf.dtype)
            wide[:, :, :S] = leaf
            idx = torch.from_numpy(tables.reshape(-1).astype(np.int64))
            p[:, idx] = wide.reshape(L, B * NB, T, KV, D)
        else:
            shape = list(leaf.shape)
            shape[1] = n_rows
            p = torch.randn(shape, generator=g).to(leaf.dtype)
            p[:, torch.from_numpy(rows)] = leaf
        pool[name] = p
    return pool


def _view(pool, tables, name):
    leaf = pool[name]
    idx = torch.from_numpy(tables.reshape(-1).astype(np.int64))
    g = leaf[:, idx]
    return g.reshape(leaf.shape[0], B, NB * T, *leaf.shape[3:])[:, :, :S]


def test_paged_decode_step_on_a_wide_pool_matches_jax_decode_step():
    """From a mixed pool (f32 words, as the dense cache) holding a dense
    cache, the paged step's logits and new self K/V equal the
    reference's dense ``decode_step``; the pool's cross leaves and every
    row and block no slot holds keep their bits."""
    jm, jp, tm, tp = _models()
    dense = _dense_cache(seed=7)
    tables, rows, R, n_rows = _layout(seed=8)
    pool = _mixed_pool(dense, tables, rows, R, n_rows, seed=9)
    before = {k: v.clone() for k, v in pool.items()}
    tok = _tokens(B, 1, 10)
    jl, jc = jm.decode_step(jp, _to_jax(dense), jnp.asarray(tok),
                            jnp.asarray(POS))
    tl, out = tm.paged_decode_step(tp, pool, torch.tensor(tables),
                                   torch.tensor(rows), torch.tensor(tok),
                                   torch.tensor(POS))
    assert out is pool
    _close(tl, jl, "logits")
    want = _flat(jc)
    for name in encdec.SELF:
        _close(_view(pool, tables, name), want[name], name)
    for name in encdec.CROSS:
        assert torch.equal(pool[name], before[name]), name
    held = set(tables.reshape(-1).tolist()) | {NULL_BLOCK}
    for name in encdec.SELF:
        for r in range(R):
            if r not in held:
                assert torch.equal(pool[name][:, r], before[name][:, r])


def test_paged_decode_step_on_an_int8_pool_matches_jax_paged_step():
    """An int8 pool of the same words and (row, kv head) scales on both
    sides: the reference's paged step (its Pallas kernel's quantized
    branch, interpret mode) against the port's (B1q's plain version):
    logits, scales and the re-quantized self K/V; the cross rows stay
    bf16 and are never quantized."""
    jm, jp, tm, tp = _models()
    dense = _dense_cache(seed=11)
    tables, rows, R, n_rows = _layout(seed=12)
    pool = _mixed_pool(dense, tables, rows, R, n_rows, seed=13)
    scales = {}
    for name in encdec.SELF:
        x = pool[name].float()
        s = kvquant.block_scale(x, (2, 4), "int8")
        pool[name] = kvquant.quantize(x, s, "int8")
        scales[name] = s[:, :, 0, :, 0].contiguous()
    for name in encdec.CROSS:                 # bf16 values, stored bf16
        pool[name] = pool[name].bfloat16()
    cross0 = {n: pool[n].clone() for n in encdec.CROSS}
    jpool = {"self_kv": {n: _jx(pool[n]) for n in encdec.SELF},
             "cross_kv": {n[6:]: _jx(pool[n], jnp.bfloat16)
                          for n in encdec.CROSS}}
    jscales = {"self_kv": {n: _jx(scales[n])[:, :, None, :, None]
                           for n in encdec.SELF},
               "cross_kv": {"k": jnp.zeros(()), "v": jnp.zeros(())}}
    tok = _tokens(B, 1, 14)
    jl, jpo, jsc = jm.paged_decode_step(
        jp, jpool, jnp.asarray(tables), jnp.asarray(rows.astype(np.int32)),
        jnp.asarray(tok), jnp.asarray(POS), scales=jscales, kv_dtype="int8")
    tl, out, tsc = tm.paged_decode_step(
        tp, pool, torch.tensor(tables), torch.tensor(rows),
        torch.tensor(tok), torch.tensor(POS), scales=scales,
        kv_dtype="int8")
    assert out is pool and tsc is scales and set(scales) == set(encdec.SELF)
    _close(tl, jl, "logits")
    held = torch.from_numpy(tables.reshape(-1).astype(np.int64))
    for name in encdec.SELF:
        assert pool[name].dtype == torch.int8
        js = np.asarray(jsc["self_kv"][name])[:, :, 0, :, 0]
        _close(scales[name][:, held], js[:, held.numpy()], f"{name} scale")
        deq = lambda w, s: w.float() * s[:, :, None, :, None]
        got = deq(pool[name][:, held], scales[name][:, held])
        want = deq(torch.tensor(np.asarray(jpo["self_kv"][name]))[:, held],
                   torch.tensor(js)[:, held])
        step = scales[name][:, held][:, :, None, :, None].expand_as(got)
        err = (got - want).abs()
        assert (err <= TOL * want.abs().max() + step * (1 + 1e-5)).all()
    for name in encdec.CROSS:
        assert pool[name].dtype == torch.bfloat16
        assert torch.equal(pool[name], cross0[name])


def test_c12_decode_full_and_the_decode_loop_part_on_the_cross_rope():
    """ROADMAP C12: the reference's teacher-forced ``decode_full`` ropes
    the cross keys at the encoder positions; its ``decode_step`` over
    ``build_cross_cache`` does not (and reads them in bf16).  The two
    part by a large share of the logits' scale, in the reference and in
    the port alike, and each port path holds its own reference path."""
    jm, jp, tm, tp = _models()
    fr, tok = _frames(2, S, 15), _tokens(2, 8, 16)
    enc = jax_encdec.encode(jm.cfg, jp, jnp.asarray(fr))
    jh = jax_encdec.decode_full(jm.cfg, jp, jnp.asarray(tok), enc)
    j_full = np.asarray(jh) @ np.asarray(jp["lm_head"])
    th = encdec.decode_full(tm.cfg, tp, torch.tensor(tok),
                            torch.tensor(np.asarray(enc)))
    t_full = th @ tp["lm_head"]
    _close(t_full, j_full, "decode_full logits")

    f64 = jax.tree.map(lambda t: t.double(), tp)
    # f32 caches holding the bf16 cross K/V (see the module docstring).
    jc = jax_encdec.init_cache(jm.cfg, 2, S, dtype=jnp.float32)
    cross = jax_encdec.build_cross_cache(jm.cfg, jp, enc)
    jc["cross_kv"] = {n: cross[n].astype(jnp.float32) for n in "kv"}
    tc = encdec.init_cache(tm.cfg, 2, S, device="cpu", dtype=torch.float32)
    tc["cross_k"] = torch.tensor(_np(cross["k"]))
    tc["cross_v"] = torch.tensor(_np(cross["v"]))
    j_loop, t_loop = [], []
    for j in range(tok.shape[1]):
        pos = np.full((2,), j, np.int32)
        # Each port step from the reference's cache of the step before
        # (free-running steps compound summation-order noise, C8), held
        # within 1e-5 of the reference's step or, on a step this model
        # conditions badly (step 4 here: a one-ulp weight nudge moves
        # its logits 6e-6), at least as close as the reference's to the
        # same step evaluated in f64.
        synced = {n: torch.tensor(_np(v)) for n, v in _flat(jc).items()}
        wide = {n: v.double() for n, v in synced.items()}
        ts, _ = tm.decode_step(tp, synced, torch.tensor(tok[:, j:j + 1]),
                               torch.tensor(pos))
        t64, _ = tm.decode_step(f64, wide, torch.tensor(tok[:, j:j + 1]),
                                torch.tensor(pos))
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok[:, j:j + 1]),
                                jnp.asarray(pos))
        if _rel(ts, jl) > TOL:
            assert _rel(ts, t64) <= max(TOL, _rel(jl, t64)), j
        tl, tc = tm.decode_step(tp, tc, torch.tensor(tok[:, j:j + 1]),
                                torch.tensor(pos))
        j_loop.append(np.asarray(jl))
        t_loop.append(tl)
    vp = j_full.shape[-1]
    j_loop = np.stack(j_loop, 1)[..., :vp]
    t_loop = torch.stack(t_loop, 1)[..., :vp]
    assert _rel(j_loop, j_full) > 0.1
    assert _rel(t_loop, t_full) > 0.1
    assert _rel(t_loop, j_loop) < 0.01


# ---------------------------------------------------------------------------
# Pools
# ---------------------------------------------------------------------------

def test_cross_leaves_live_in_state_rows_never_in_blocks():
    """At whisper-base's width and ``max_seq`` 1500: the self K/V in
    blocks (12,288 B a token; an int8 pool 6,144 B with its scales), the
    cross K/V in state rows (18,432,000 B a row), never block-paged or
    quantized; the model's axes alone say so (``enc_seq``, not
    ``kv_seq``, on the cross leaves)."""
    from repro_torch.serving.paged import is_read_only_leaf, is_state_leaf

    full = get_model(get_config(ARCH), device="cpu")
    axes = full.cache_axes()
    assert [n for n, ax in axes.items() if is_state_leaf(ax)] == [
        "cross_k", "cross_v"]
    assert [n for n, ax in axes.items() if is_read_only_leaf(ax)] == [
        "cross_k", "cross_v"]
    for kvd, tok_b in (("bf16", 12_288), ("int8", 6_144)):
        plan = BlockPagingPlan(full, 8, 1500, 16, 0, kv_dtype=kvd)
        assert set(plan.leaf_specs) == {"k", "v"}
        assert plan.token_bytes == tok_b and plan.nb == 94
        assert plan.scale_bytes_per_block == (0 if kvd == "bf16" else
                                              2 * 6 * 8 * 4)
    splan = StatePagingPlan(full, StatePool(8), 1500)
    assert set(splan.leaf_specs) == {"cross_k", "cross_v"}
    assert splan.state_row_bytes == 18_432_000
    assert splan.carried_axes == {}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_the_manager_pools_cross_rows_and_blocks(kv_dtype):
    _, _, tm, tp = _models()
    eng = DecodeEngine(tm, tp, batch_size=3, max_seq=S,
                       config=BestEffortConfig(level=OptLevel.O6,
                                               kv_block_size=T,
                                               kv_dtype=kv_dtype))
    mgr = eng.cache_mgr
    assert eng.layout.state_impl == "rows" and mgr.has_blocks
    pool = mgr.cache if kv_dtype == "bf16" else mgr.cache["pool"]
    assert pool["cross_k"].shape == (2, 4, S, 4, 16)
    assert pool["cross_k"].dtype == torch.bfloat16
    assert pool["k"].shape[2] == T
    if kv_dtype == "int8":
        assert set(mgr.cache["scale"]) == {"k", "v"}
    g = mgr.geometry
    assert g["state_row_bytes"] == 2 * 2 * S * 4 * 16 * 2
    assert g["pool_bytes"] == g["state_bytes"] + g["pool_rows"] * (
        T * g["token_bytes"] + g["scale_bytes_per_block"])


_MIX = [([5, 6, 7, 8, 9, 10, 11], 4), ([9, 3], 5),
        ([3, 1, 4, 1, 5, 9, 2, 6, 5], 3), ([2, 2, 2], 4)]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("attn", ["gather", "kernel"])
def test_a_parked_slot_keeps_its_cross_row_and_blocks(attn, kv_dtype):
    """O6 with ``prefill_chunk=3``: at every batched decode tick, each
    slot parked mid-prompt keeps every bit of its cross row and of its
    self K/V blocks (words and, on int8, scales), and no tick writes a
    held cross row at all; on the bf16 pool the tokens equal a run
    without chunking."""
    _, _, tm, tp = _models()

    def engine(chunk):
        return DecodeEngine(tm, tp, batch_size=3, max_seq=S,
                            config=BestEffortConfig(
                                level=OptLevel.O6, kv_block_size=T,
                                paged_attn=attn, kv_dtype=kv_dtype,
                                prefill_chunk=chunk))

    eng = engine(3)
    mgr = eng.cache_mgr
    step_fn, extras_fn = eng._step_fn, mgr.step_extras
    seen = {"parked": None, "ticks": 0}

    def extras(parked=None):
        seen["parked"] = list(parked or [])
        return extras_fn(parked=parked)

    def pool():
        return mgr.cache if kv_dtype == "bf16" else mgr.cache["pool"]

    def snapshot(i):
        out = {n: pool()[n][:, int(mgr.state.rows[i])].clone()
               for n in encdec.CROSS}
        blocks = torch.from_numpy(mgr.tables[i].astype(np.int64))
        blocks = blocks[blocks != NULL_BLOCK]
        out.update({n: pool()[n][:, blocks].clone() for n in encdec.SELF})
        if kv_dtype != "bf16":
            out.update({f"{n} scale": mgr.cache["scale"][n][:, blocks]
                        .clone() for n in encdec.SELF})
        return out

    def step(params, cache, *rest):
        parked = seen["parked"]
        snaps = {i: snapshot(i) for i in parked}
        held = [int(r) for r in mgr.state.rows if r != NULL_ROW]
        cross = {n: pool()[n][:, held].clone() for n in encdec.CROSS}
        out = step_fn(params, cache, *rest)
        for i in parked:
            after = snapshot(i)
            for n, v in snaps[i].items():
                assert torch.equal(after[n], v), (i, n)
        for n in encdec.CROSS:
            assert torch.equal(pool()[n][:, held], cross[n]), n
        seen["ticks"] += bool(parked)
        return out

    mgr.step_extras, eng._step_fn = extras, step
    rids = [eng.submit(Request(prompt=list(p), max_new_tokens=n))
            for p, n in _MIX]
    eng.generate()
    assert eng.prefill_mode == "chunked" and seen["ticks"] >= 3
    if kv_dtype != "bf16":
        return
    got = {r.rid: r.generated for r in eng.finished}
    plain = engine(0)
    want_rids = [plain.submit(Request(prompt=list(p), max_new_tokens=n))
                 for p, n in _MIX]
    want = {r.rid: r.generated for r in plain.generate()}
    assert [got[r] for r in rids] == [want[r] for r in want_rids]


@pytest.mark.parametrize("level", ["O5", "O6"])
def test_a_reused_slot_starts_from_a_zero_cross_cache(level):
    """A request inserted with an encoded cross K/V retires; the next
    tenant of its slot (state row on the paged layout) is submitted and
    starts from zero, as the reference serves a submitted request: its
    tokens equal a fresh engine's, and the row reads zero after the
    admission reset."""
    _, _, tm, tp = _models()
    kw = dict(level=OptLevel.O6, kv_block_size=T) if level == "O6" else \
        dict(level=OptLevel.O5)
    eng = DecodeEngine(tm, tp, batch_size=1, max_seq=S,
                       config=BestEffortConfig(**kw))
    res = eng.prefill([4, 5, 6], max_new_tokens=3)
    for name, arr in _cross(1, 17).items():
        res.kv_state[name] = torch.tensor(arr.astype(np.float32)).bfloat16()
    eng.insert(res)
    eng.generate()
    second = Request(prompt=[7, 8], max_new_tokens=4)
    eng.submit(second)
    eng.step()
    if level == "O6":
        pool = eng.cache_mgr.cache
        row = int(eng.cache_mgr.state.rows[0])
        for n in encdec.CROSS:
            assert not pool[n][:, row].any()
    else:
        for n in encdec.CROSS:
            assert not eng.cache_mgr.cache[n].any()
    eng.generate()
    fresh = DecodeEngine(tm, tp, batch_size=1, max_seq=S,
                         config=BestEffortConfig(**kw))
    ref = Request(prompt=[7, 8], max_new_tokens=4)
    fresh.submit(ref)
    fresh.generate()
    assert second.generated == ref.generated


# ---------------------------------------------------------------------------
# The engine against the JAX O5 engine
# ---------------------------------------------------------------------------

RUNGS = {
    "O0": dict(level=OptLevel.O0),
    "O1": dict(level=OptLevel.O1),
    "O2": dict(level=OptLevel.O2),
    "O3": dict(level=OptLevel.O3),
    "O4": dict(level=OptLevel.O4),
    "O5": dict(level=OptLevel.O5),
    "O5-chunk": dict(level=OptLevel.O5, prefill_chunk=3),
    "O6-gather": dict(level=OptLevel.O6, kv_block_size=T,
                      kv_pool_blocks=10),
    "O6-kernel": dict(level=OptLevel.O6, kv_block_size=T,
                      kv_pool_blocks=10, paged_attn="kernel"),
    "O6-gather-chunk": dict(level=OptLevel.O6, kv_block_size=T,
                            kv_pool_blocks=10, prefill_chunk=3),
    "O6-kernel-chunk": dict(level=OptLevel.O6, kv_block_size=T,
                            kv_pool_blocks=10, paged_attn="kernel",
                            prefill_chunk=3),
    "O7": dict(level=OptLevel.O7, kv_block_size=T, paged_attn="kernel",
               draft_model="smollm-360m"),
}
_REF = {}


def _random_mix(seed, *, n=8, prompt_hi=8, new_hi=5):
    """``tests/test_serving.py``'s ``_random_mix`` at the reference fuzz's
    whisper settings (seed 74)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(1, prompt_hi))
        new = int(rng.integers(1, new_hi))
        out.append((rng.integers(1, 256, plen).tolist(), new))
    return out


def _drive(eng, request_cls, mix, *, eos=None, late_from=None):
    eos = eos or {}
    head = mix if late_from is None else mix[:late_from]
    rids = [eng.submit(request_cls(prompt=list(p), max_new_tokens=n,
                                   eos_id=eos.get(k)))
            for k, (p, n) in enumerate(head)]
    if late_from is not None:
        for _ in range(2):
            eng.step()
        rids += [eng.submit(request_cls(prompt=list(p), max_new_tokens=n,
                                        eos_id=eos.get(late_from + k)))
                 for k, (p, n) in enumerate(mix[late_from:])]
    for _ in range(1000):
        stepped = eng.step()
        if eng.__class__ is DecodeEngine and eng.layout.name == "paged":
            eng.cache_mgr.check_conservation()
        if not stepped and not eng.queue:
            break
    fin = {r.rid: r.generated for r in eng.finished}
    return [fin[rid] for rid in rids]


def _jax_engine():
    jm, jp, _, _ = _models()
    return JaxEngine(jm, jp, batch_size=2, max_seq=S,
                     config=JaxConfig(level=JaxLevel.O5))


def _fuzz():
    """The reference fuzz's whisper mix (seed 74) with eos planted from a
    first JAX O5 run and its tail arriving mid-flight, and the JAX O5
    float32 tokens."""
    if "fuzz" not in _REF:
        mix = _random_mix(74)
        first = _drive(_jax_engine(), JaxRequest, mix)
        eos = {k: g[len(g) // 2] for k, g in enumerate(first)
               if k % 2 == 0 and len(g) > 1}
        assert eos, "no eos planted"
        _REF["fuzz"] = (mix, eos, _drive(_jax_engine(), JaxRequest, mix,
                                          eos=eos, late_from=5))
    return _REF["fuzz"]


@pytest.mark.parametrize("rung", list(RUNGS))
def test_f32_greedy_tokens_identical_to_jax_o5(rung):
    mix, eos, want = _fuzz()
    _, _, tm, tp = _models()
    eng = DecodeEngine(tm, tp, batch_size=2, max_seq=S,
                       config=BestEffortConfig(**RUNGS[rung]))
    got = _drive(eng, Request, mix, eos=eos, late_from=5)
    assert got == want, f"{rung}: {got} != {want}"
    assert eng.degrade_reason is None
    assert eng.prefill_mode == ("chunked" if "chunk" in rung else "token")
    if "chunk" in rung and eng.layout.name == "paged":
        assert eng.layout.prefill_impl == "gather"
    if eng.layout.name == "paged":
        assert eng.layout.state_impl == "rows"
        assert eng.cache_mgr.state.free_rows == 2
    if rung == "O7":
        assert eng.spec_mode == "off"
        assert "no verify step" in eng.spec_off_reason


def _insert_run(eng, request_cls, mix, cross, set_cross):
    """The first two requests of ``mix`` prefilled, given their encoded
    cross K/V (``set_cross(result, k)``) and inserted; the rest
    submitted; generated tokens in mix order."""
    rids = []
    for k, (p, n) in enumerate(mix[:2]):
        res = eng.prefill(p, max_new_tokens=n)
        set_cross(res, cross[k])
        eng.insert(res)
        rids.append(res.request.rid)
    rids += [eng.submit(request_cls(prompt=list(p), max_new_tokens=n))
             for p, n in mix[2:]]
    fin = {r.rid: r.generated for r in eng.generate()}
    return [fin[r] for r in rids]


def _cross_per_request():
    if "cross" not in _REF:
        _REF["cross"] = [_cross(1, 40 + k) for k in range(2)]
    return _REF["cross"]


def _jax_insert_tokens():
    if "insert" not in _REF:
        mix = _random_mix(74)[:5]

        def set_cross(res, c):
            res.kv_state["cross_kv"] = {
                "k": jnp.asarray(c["cross_k"]), "v": jnp.asarray(c["cross_v"])}

        _REF["insert"] = _insert_run(_jax_engine(), JaxRequest, mix,
                                     _cross_per_request(), set_cross)
        # The cross K/V reaches the tokens.
        plain = _insert_run(_jax_engine(), JaxRequest, mix,
                            [None, None], lambda res, c: None)
        assert plain[:2] != _REF["insert"][:2]
    return _REF["insert"]


@pytest.mark.parametrize("rung", list(RUNGS))
def test_inserted_cross_kv_gives_the_jax_o5_tokens(rung):
    """prefill -> the request's encoded cross K/V put into
    ``PrefillResult.kv_state`` -> insert -> generate, on the port at
    every rung and on the JAX O5 engine: the same tokens."""
    want = _jax_insert_tokens()
    _, _, tm, tp = _models()
    eng = DecodeEngine(tm, tp, batch_size=2, max_seq=S,
                       config=BestEffortConfig(**RUNGS[rung]))

    def set_cross(res, c):
        for name, arr in c.items():
            assert res.kv_state[name].shape == (2, 1, S, 4, 16)
            res.kv_state[name] = torch.tensor(
                arr.astype(np.float32)).bfloat16()

    got = _insert_run(eng, Request, _random_mix(74)[:5],
                      _cross_per_request(), set_cross)
    assert got == want, (rung, got, want)


def test_bf16_rungs_identical_to_port_o5():
    mix, eos, _ = _fuzz()
    _, _, tm, tp = _models("bfloat16")
    out = {}
    for rung in ("O5", "O2", "O6-gather", "O6-kernel-chunk"):
        eng = DecodeEngine(tm, tp, batch_size=2, max_seq=S,
                           config=BestEffortConfig(**RUNGS[rung]))
        out[rung] = _drive(eng, Request, mix, eos=eos, late_from=5)
    assert all(v == out["O5"] for v in out.values()), out


def test_serve_demo_and_cli_serve_whisper_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    out = serve_demo(get_smoke(ARCH), batch_size=3, max_seq=32,
                     n_requests=4, level=OptLevel.O6, paged_attn="kernel",
                     kv_block_size=4, prefill_chunk=4, device="cpu")
    assert len(out["finished"]) == 4 and out["ticks"] > 0
    assert out["prefill_mode"] == "chunked" and out["spec_mode"] == "off"
    g = out["pool"]
    assert g["state_rows"] == 4 and g["state_row_bytes"] == 2 * 2 * 32 * \
        4 * 16 * 2
    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--level", "5",
          "--prefill-chunk", "4", "--requests", "3"])
    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--level", "6",
          "--paged-attn", "kernel", "--kv-dtype", "int8", "--requests",
          "3"])
    printed = capsys.readouterr().out
    assert "[contiguous/prefill=chunked(4) on cpu]: 3 requests" in printed
    assert "[paged/kernel/kv=int8 on cpu]: 3 requests" in printed
