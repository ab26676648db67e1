"""The port's dense decode model against the JAX reference.

Weights come from the reference's ``init(cfg, PRNGKey(0))`` and cross the
framework boundary as numpy (``repro_torch.models.bridge``); token and
position streams are drawn from seeded numpy generators.  Per-step
logits of ``decode_step`` (dense cache) and ``paged_decode_step`` (the
paged kernel path; the JAX kernel runs in interpret mode) are held to
1e-5 of the logits' scale in float32 compute, and to 3e-2 in bf16, where
XLA's bf16 ``sigmoid`` and its excess precision round differently from
torch.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import get_model as jax_get_model
from repro.models import attention as jax_attn
from repro_torch.configs import get_smoke
from repro_torch.models import attention as port_attn
from repro_torch.models import get_model
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.layers import param_shapes

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# max |port - jax| over max |jax| per step
TOL = {"float32": 1e-5, "bfloat16": 3e-2}

_CACHE = {}


def _pair(dtype: str):
    """(jax model, jax params, port model, port params) on the qwen3-8b
    smoke config in ``dtype`` compute, with identical weights."""
    if dtype not in _CACHE:
        jcfg = dataclasses.replace(jax_smoke("qwen3-8b"),
                                   compute_dtype=dtype)
        jm = jax_get_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tcfg = dataclasses.replace(get_smoke("qwen3-8b"),
                                   compute_dtype=dtype)
        tm = get_model(tcfg, device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu",
                             dtype=DTYPES[dtype])
        _CACHE[dtype] = (jm, jp, tm, tp)
    return _CACHE[dtype]


def _rel(want, got) -> float:
    want, got = np.asarray(want), got.float().numpy()
    return float(np.abs(want - got).max() / np.abs(want).max())


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def test_params_from_jax_round_trip():
    """Key for key, shape for shape the port's own init; values exactly
    the JAX leaves (f32) or their bf16 rounding."""
    jm, jp, tm, tp = _pair("float32")
    want = _flat(param_shapes(tm.defs()))
    got = _flat(tp)
    assert set(got) == set(want)
    for k, t in got.items():
        assert tuple(t.shape) == want[k], k
    gen = torch.Generator().manual_seed(0)
    own = _flat(tm.init(gen))
    assert {k: tuple(v.shape) for k, v in own.items()} == want
    jflat = _flat(jax.tree.map(np.asarray, jp))
    for k, t in got.items():
        assert np.array_equal(t.numpy(), jflat[k]), k
    bf = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu",
                         dtype=torch.bfloat16)
    for k, t in _flat(bf).items():
        ref = np.asarray(jnp.asarray(jflat[k]).astype(jnp.bfloat16)
                         .astype(jnp.float32))
        assert np.array_equal(t.float().numpy(), ref), k


def test_port_init_follows_pdef_rules():
    _, _, tm, _ = _pair("bfloat16")
    p = tm.init(torch.Generator().manual_seed(1))
    assert p["embedding"].dtype == torch.bfloat16
    assert torch.all(p["final_norm"] == 1)
    assert abs(float(p["embedding"].float().std()) - 0.02) < 2e-3
    wi = p["layers"]["mlp"]["wi"].float()       # fan_in = d_model
    assert abs(float(wi.std()) * 64 ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_logits_match_jax(dtype):
    jm, jp, tm, tp = _pair(dtype)
    B, S = 3, 16
    jc, tc = jm.init_cache(B, S), tm.init_cache(B, S)
    step = jax.jit(jm.decode_step)
    rng = np.random.default_rng(0)
    for t in range(10):
        toks = rng.integers(1, 256, (B, 1)).astype(np.int32)
        pos = np.full((B,), t, np.int32)
        jl, jc = step(jp, jc, jnp.asarray(toks), jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, torch.tensor(toks),
                                torch.tensor(pos))
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        assert _rel(jl, tl) <= TOL[dtype], (t, _rel(jl, tl))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_step_logits_match_jax(dtype):
    """The paged kernel path off a shuffled block pool (T=4): logits per
    step against the JAX paged step (Pallas kernel, interpret mode), and
    the pools it wrote are the same bits in float32 compute."""
    jm, jp, tm, tp = _pair(dtype)
    cfg = tm.cfg
    B, S, T = 3, 16, 4
    nb = S // T
    R = 1 + B * nb
    rng = np.random.default_rng(0)
    tables = rng.permutation(np.arange(1, R)).astype(np.int32).reshape(B, nb)
    shape = (cfg.n_layers, R, T, cfg.n_kv_heads, cfg.head_dim)
    jpool = {k: jnp.zeros(shape, jnp.bfloat16) for k in "kv"}
    tpool = {k: torch.zeros(shape, dtype=torch.bfloat16) for k in "kv"}
    step = jax.jit(jm.paged_decode_step)
    for t in range(10):
        toks = rng.integers(1, 256, (B, 1)).astype(np.int32)
        pos = np.full((B,), t, np.int32)
        jl, jpool = step(jp, jpool, jnp.asarray(tables), jnp.asarray(toks),
                         jnp.asarray(pos))
        tl, tpool = tm.paged_decode_step(tp, tpool, torch.tensor(tables),
                                         torch.tensor(toks),
                                         torch.tensor(pos))
        assert _rel(jl, tl) <= TOL[dtype], (t, _rel(jl, tl))
    if dtype == "float32":
        for k in "kv":
            assert np.array_equal(np.asarray(jpool[k], np.float32),
                                  tpool[k].float().numpy())


def test_bf16_decode_attention_at_head_dim_128_is_bitwise():
    """One dense attention layer at qwen3-8b's head_dim in bf16 against
    the jitted JAX layer: the bf16-rounded scale and the float32 scaled
    scores reproduce every output bit (the smoke config's head_dim 16
    has an exact scale and cannot show this)."""
    r = np.random.default_rng(0)
    d, H, KV, D, B, S = 256, 4, 2, 128, 3, 32
    P = {"wq": r.normal(size=(d, H, D)) / 16,
         "wk": r.normal(size=(d, KV, D)) / 16,
         "wv": r.normal(size=(d, KV, D)) / 16,
         "wo": r.normal(size=(H, D, d)) / 22,
         "q_norm": np.ones(D), "k_norm": np.ones(D)}
    P = {k: v.astype(np.float32) for k, v in P.items()}
    ck = r.normal(size=(B, S, KV, D)).astype(np.float32)
    cv = r.normal(size=(B, S, KV, D)).astype(np.float32)
    x = r.normal(size=(B, 1, d)).astype(np.float32)
    pos = np.array([5, 17, 31], np.int32)
    kw = dict(n_heads=H, n_kv=KV, head_dim=D, qk_norm=True, rope_theta=1e4)
    bf = jnp.bfloat16
    fn = jax.jit(lambda p, x, c, pos: jax_attn.decode_attention(
        p, x, c, pos, **kw))
    jo, _ = fn({k: jnp.asarray(v) for k, v in P.items()},
               jnp.asarray(x, bf),
               {"k": jnp.asarray(ck, bf), "v": jnp.asarray(cv, bf)},
               jnp.asarray(pos))
    tb = torch.bfloat16
    to, _ = port_attn.decode_attention(
        {k: torch.tensor(v).to(tb) for k, v in P.items()},
        torch.tensor(x).to(tb),
        {"k": torch.tensor(ck).to(tb), "v": torch.tensor(cv).to(tb)},
        torch.tensor(pos), **kw)
    assert np.array_equal(np.asarray(jo.astype(jnp.float32)),
                          to.float().numpy())


def test_get_model_rejects_unported_families():
    cfg = dataclasses.replace(get_smoke("qwen3-8b"), family="moe",
                              n_experts=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(cfg, device="cpu")
    from repro_torch.configs import get_config
    with pytest.raises(KeyError, match="not ported"):
        get_config("internvl2-26b")


# ---------------------------------------------------------------------------
# Chunked prefill and speculative verify steps
# ---------------------------------------------------------------------------

# (start (B,), last (B,)) per call: a first chunk, a second, and a padded
# final chunk whose tail clips at position S-1 (its ``last`` rows stay
# below the clip, as the engine's do).
_PREFILL_CALLS = [([0, 0, 0], [3, 1, 2]), ([4, 4, 4], [3, 3, 0]),
                  ([13, 9, 12], [1, 3, 2])]
# start (B,) per verify window of 4 rows (slot 1 ends on position S-1).
_VERIFY_CALLS = [[0, 0, 0], [4, 2, 6], [11, 12, 10]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", ["prefill", "paged_prefill", "verify",
                                  "paged_verify"])
def test_window_steps_logits_match_jax(step, dtype):
    """``prefill_step`` / ``verify_step`` on a dense cache and their
    paged twins on a shuffled block pool (T=4, the JAX kernel in
    interpret mode; the pool in the compute dtype) against JAX, call by
    call over the same cache: the
    ``last`` rows' logits (prefill) or every row's (verify) within 1e-5
    of the logits' scale in float32, 3e-2 in bf16."""
    jm, jp, tm, tp = _pair(dtype)
    cfg = tm.cfg
    B, S, T, C = 3, 16, 4, 4
    paged = step.startswith("paged")
    rng = np.random.default_rng(1)
    if paged:
        nb = S // T
        R = 1 + B * nb
        tables = rng.permutation(np.arange(1, R)).astype(np.int32).reshape(
            B, nb)
        shape = (cfg.n_layers, R, T, cfg.n_kv_heads, cfg.head_dim)
        # The pool in the compute dtype: in float32 the point is the
        # algorithm, not the bf16 rounding of what is stored.
        jc = {k: jnp.zeros(shape, jnp.dtype(dtype)) for k in "kv"}
        tc = {k: torch.zeros(shape, dtype=DTYPES[dtype]) for k in "kv"}
        extra_j, extra_t = (jnp.asarray(tables),), (torch.tensor(tables),)
    else:
        jc, tc = jm.init_cache(B, S), tm.init_cache(B, S)
        extra_j = extra_t = ()
    jfn = jax.jit(getattr(jm, f"{step}_step"))
    tfn = getattr(tm, f"{step}_step")
    calls = (_PREFILL_CALLS if step.endswith("prefill")
             else [(s, None) for s in _VERIFY_CALLS])
    for start, last in calls:
        toks = rng.integers(1, 256, (B, C)).astype(np.int32)
        jargs = [jnp.asarray(toks), jnp.asarray(start, jnp.int32)]
        targs = [torch.tensor(toks), torch.tensor(start)]
        if last is not None:
            jargs.append(jnp.asarray(last, jnp.int32))
            targs.append(torch.tensor(last))
        jl, jc = jfn(jp, jc, *extra_j, *jargs)
        tl, tc = tfn(tp, tc, *extra_t, *targs)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        assert _rel(jl, tl) <= TOL[dtype], (start, _rel(jl, tl))


@pytest.mark.parametrize("paged", [False, True])
def test_padded_chunk_never_overwrites_a_real_row(paged):
    """A padded final chunk whose real last token sits at the clip
    position: every write there carries that real row's K/V (CUDA leaves
    undefined which of several writes to one index lands), so the cache
    and the row's logits are those of the same chunk without its pad."""
    _, _, tm, tp = _pair("float32")
    cfg = tm.cfg
    S, T = 16, 4
    toks = torch.tensor([[7, 9, 11, 0, 0]])
    if paged:
        tables = torch.arange(1, S // T + 1, dtype=torch.int32)[None]
        shape = (cfg.n_layers, S // T + 1, T, cfg.n_kv_heads, cfg.head_dim)

        def run(t):
            pool = {k: torch.zeros(shape, dtype=torch.bfloat16) for k in "kv"}
            lg, pool = tm.paged_prefill_step(tp, pool, tables, t,
                                             torch.tensor([13]),
                                             torch.tensor([2]))
            return lg, pool["k"][:, 4, 1:]               # positions 13..15
    else:
        def run(t):
            cache = tm.init_cache(1, S)
            lg, cache = tm.prefill_step(tp, cache, t, torch.tensor([13]),
                                        torch.tensor([2]))
            return lg, cache["k"][:, 0, 13:]
    lg_pad, k_pad = run(toks)
    lg_real, k_real = run(toks[:, :3])
    torch.testing.assert_close(k_pad, k_real, rtol=0, atol=1e-2)
    torch.testing.assert_close(lg_pad, lg_real, rtol=1e-5, atol=1e-5)
    lg_other, k_other = run(torch.tensor([[7, 9, 0, 0, 0]]))
    assert not torch.allclose(k_other[:, 2], k_real[:, 2], atol=1e-2), \
        "the pad token's K/V must differ for this test to mean anything"


def test_smollm_configs_match_the_reference():
    """The port's smollm-360m FULL and smoke configs carry the
    reference's widths (the smoke drafter: head_dim 20, no qk-norm)."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config

    fields = ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "head_dim", "qk_norm",
              "mlp_kind", "rope_theta")
    for port_cfg, ref_cfg in ((get_config("smollm-360m"),
                               jax_config("smollm-360m")),
                              (get_smoke("smollm-360m"),
                               jax_smoke("smollm-360m"))):
        assert ({f: getattr(port_cfg, f) for f in fields}
                == {f: getattr(ref_cfg, f) for f in fields})
    small = get_smoke("smollm-360m")
    assert (small.head_dim, small.qk_norm) == (20, False)


def test_compatible_drafter_resolves_at_the_target_scale():
    """A drafter named by string resolves at the target's scale: the
    smoke pair shares the 256-token vocab; at full scale qwen3-8b
    (151,936) and smollm-360m (49,152) do not, which raises naming both."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import (DRAFTER_PAIRS,
                                              compatible_drafter)

    assert DRAFTER_PAIRS["qwen3-8b"] == "smollm-360m"
    d = compatible_drafter(get_smoke("qwen3-8b"))
    assert d == get_smoke("smollm-360m")
    with pytest.raises(ValueError, match=r"vocab 49152\).*vocab 151936"):
        compatible_drafter("qwen3-8b", "smollm-360m")
    with pytest.raises(ValueError, match="not token-compatible"):
        compatible_drafter(get_config("qwen3-8b"))
    with pytest.raises(ValueError, match="no known drafter"):
        compatible_drafter(get_smoke("smollm-360m"))
    assert compatible_drafter(get_config("qwen3-8b"),
                              get_config("qwen3-8b")).vocab == 151_936


def test_smoke_drafter_runs_the_dense_path_like_jax():
    """The smollm smoke drafter (head_dim 20 — 40-byte bf16 rows the
    paged kernel refuses — and no qk-norm) decodes and prefills on the
    dense path within 1e-5 of JAX in float32."""
    jcfg = dataclasses.replace(jax_smoke("smollm-360m"),
                               compute_dtype="float32")
    jm = jax_get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = get_model(dataclasses.replace(get_smoke("smollm-360m"),
                                       compute_dtype="float32"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    B, S = 2, 16
    jc, tc = jm.init_cache(B, S), tm.init_cache(B, S)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, 256, (B, 6)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill_step)(jp, jc, jnp.asarray(toks),
                                      jnp.asarray([0, 0], jnp.int32),
                                      jnp.asarray([5, 3], jnp.int32))
    tl, tc = tm.prefill_step(tp, tc, torch.tensor(toks), torch.tensor([0, 0]),
                             torch.tensor([5, 3]))
    assert _rel(jl, tl) <= 1e-5
    nxt = rng.integers(1, 256, (B, 1)).astype(np.int32)
    jl, _ = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(nxt),
                                    jnp.asarray([6, 6], jnp.int32))
    tl, _ = tm.decode_step(tp, tc, torch.tensor(nxt), torch.tensor([6, 6]))
    assert _rel(jl, tl) <= 1e-5
