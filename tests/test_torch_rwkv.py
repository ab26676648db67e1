"""The port's rwkv6 model and its training path against the JAX
reference, on the rwkv6-3b smoke config (2 layers, d_model 64, head_dim
16, d_ff 128, vocab 256).

Weights come from the reference's ``init(cfg, PRNGKey(0))`` and cross
the framework boundary as numpy (``repro_torch.models.bridge``);
activations and batches are drawn from seeded numpy generators.

Tolerances.  In float32 compute: the blocks within 1e-5 of their
output's scale, the loss within 1e-5 of its value, each gradient within
1e-4 of its largest magnitude.  In bf16 the reference runs the chunked
WKV's cumsum, exps and einsums in bf16 (it even rounds the state it
reads), while kernel B4 and its plain version compute in f32 and round
once, and XLA-CPU's bf16 silu/sigmoid are its own (ROADMAP C2, C5).
Measured on this config, time-mix at S = 64: the reference's own bf16
output and state sit 2.8e-2 and 4.0e-2 of their scale from its f32
ones, the port's bf16 6.2e-3 and 5.1e-3 from the reference's f32.  So a
bf16 block is held to the reference's f32 result within 2e-2 of the
scale and to its bf16 result within 6e-2 (1.5 times the reference's own
bf16 error).  The loss: the reference's bf16 loss sits 6.7e-4 from its
f32 loss, its bf16 gradients at worst 0.159 of a leaf's scale from its
f32 ones (smallest cosine 0.994); the port's bf16 loss sits 7.6e-4 from
the reference's bf16 loss, its gradients at worst 0.149 of the scale
(smallest cosine 0.996).  So the bf16 loss is held within 2e-3
relative, every gradient at cosine >= 0.98 and within 0.3 of its scale.
At the reference's initialiser ``exp(ww)`` is near 1, above the clamp
0.35, so every log-decay is -0.35 and the decay LoRA's gradients are
exactly zero on both sides.
"""

import dataclasses
import io
from contextlib import redirect_stdout

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import ShapeConfig as JaxShape
from repro.launch import steps as jax_steps
from repro.launch.mesh import make_host_mesh
from repro.models import get_model as jax_get_model
from repro.models import rwkv6 as jax_rwkv6
from repro.optim import adamw as jax_adamw
from repro.parallel.sharding import use_sharder
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps
from repro_torch.launch.train import main as train_main, train
from repro_torch.models import get_model, rwkv6, rwkv_lm
from repro_torch.models.bridge import opt_state_from_jax, params_from_jax
from repro_torch.models.layers import param_shapes
from repro_torch.optim import adamw
from repro_torch.tree import leaves, map_tree

ARCH = "rwkv6-3b"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_CACHE = {}


def _setup(dtype: str):
    """(jax model, jax params, port model, port f32 params): identical
    weights, ``dtype`` compute."""
    if dtype not in _CACHE:
        jm = jax_get_model(dataclasses.replace(jax_smoke(ARCH),
                                               compute_dtype=dtype))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = get_model(dataclasses.replace(get_smoke(ARCH),
                                           compute_dtype=dtype),
                       device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _CACHE[dtype] = (jm, jp, tm, tp)
    return _CACHE[dtype]


def _batch(B=2, S=64, vocab=256, seed=0):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": r.integers(0, vocab, (B, S)).astype(np.int32)}


def _layer0(sub: str, dtype: str):
    """Layer 0's ``sub`` params ("tm" or "cm") as (jax, torch) trees in
    the compute dtype."""
    _, jp, _, tp = _setup(dtype)
    j = jax.tree.map(lambda a: a[0].astype(JDT[dtype]), jp["layers"][sub])
    t = {k: v[0].to(TDT[dtype]) for k, v in tp["layers"][sub].items()}
    return j, t


def _x(B, S, d, seed=1):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


def _held(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _jax_time_mix(dtype, x):
    jpar, _ = _layer0("tm", dtype)
    jo, (js, jh) = jax_rwkv6.time_mix_apply(
        jpar, jnp.asarray(x).astype(JDT[dtype]),
        head_dim=get_smoke(ARCH).rwkv_head_dim)
    return jo, js, jh


def test_the_port_registers_rwkv6_3b_with_the_reference_widths():
    assert ARCH in ARCH_NAMES
    full, smoke = get_config(ARCH), get_smoke(ARCH)
    for name in ("family", "n_layers", "d_model", "d_ff", "vocab",
                 "rwkv_head_dim", "param_dtype", "compute_dtype", "remat"):
        assert getattr(full, name) == getattr(jax_config(ARCH), name), name
        assert getattr(smoke, name) == getattr(jax_smoke(ARCH), name), name
    assert full.d_model // full.rwkv_head_dim == 40


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [64, 130])
def test_time_mix_matches_jax(dtype, S):
    """S = 64 runs the chunked branch (B4's plain version on the CPU);
    S = 130 is not a multiple of min(128, S), so both sides take the
    step-by-step branch."""
    _, tpar = _layer0("tm", dtype)
    cfg = get_smoke(ARCH)
    x = _x(2, S, cfg.d_model)
    to, (ts, th) = rwkv6.time_mix_apply(
        tpar, torch.tensor(x).to(TDT[dtype]), head_dim=cfg.rwkv_head_dim)
    assert to.dtype == TDT[dtype] and ts.dtype == torch.float32
    refs = [(_jax_time_mix("float32", x), 1e-5 if dtype == "float32"
             else 2e-2)]
    if dtype == "bfloat16":
        refs.append((_jax_time_mix(dtype, x), 6e-2))
    for want, tol in refs:
        for got, w in zip((to, ts, th), want):
            _held(got, w, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_jax(dtype):
    jpar, tpar = _layer0("cm", dtype)
    x = _x(2, 64, get_smoke(ARCH).d_model, seed=2)
    jo, jh = jax_rwkv6.channel_mix_apply(
        jpar, jnp.asarray(x).astype(JDT[dtype]))
    to, th = rwkv6.channel_mix_apply(tpar, torch.tensor(x).to(TDT[dtype]))
    tol = 1e-5 if dtype == "float32" else 3e-2
    _held(to, jo, tol)
    _held(th, jh, tol)


def _wkv_inputs(B=2, S=64, H=2, N=16, seed=5):
    r = np.random.default_rng(seed)
    mk = lambda *s, sc=0.5: (r.normal(size=s) * sc).astype(np.float32)
    lw = (-np.abs(r.normal(size=(B, S, H, N))) * 0.3).astype(np.float32)
    return (mk(B, S, H, N), mk(B, S, H, N), mk(B, S, H, N), lw,
            mk(H, N, sc=0.1), mk(B, H, N, N, sc=0.2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_twins_match_the_jax_model(dtype):
    """The port's ``wkv_chunked`` (compute-dtype twin) and
    ``wkv_sequential`` against the JAX model's: f32 within 1e-5 of
    scale, bf16 within 3e-2 (both round in bf16, accumulating their
    einsums in other orders)."""
    r, k, v, lw, u, s0 = _wkv_inputs()
    J = lambda a: jnp.asarray(a).astype(JDT[dtype])
    T = lambda a: torch.tensor(a).to(TDT[dtype])
    for jfn, tfn, kw in ((jax_rwkv6.wkv_chunked, rwkv6.wkv_chunked,
                          {"chunk": 16}),
                         (jax_rwkv6.wkv_sequential, rwkv6.wkv_sequential,
                          {})):
        jy, js = jfn(J(r), J(k), J(v), J(lw), J(u),
                     init_state=jnp.asarray(s0), **kw)
        ty, ts = tfn(T(r), T(k), T(v), T(lw), T(u),
                     init_state=torch.tensor(s0), **kw)
        tol = 1e-5 if dtype == "float32" else 3e-2
        _held(ty, jy, tol)
        _held(ts, js, tol)


def _loss_and_grads(dtype, b=None):
    jm, jp, tm, tp = _setup(dtype)
    b = b or _batch()
    jl, jg = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tg = steps.value_and_grad(
        tm.loss, tp, {k: torch.tensor(v) for k, v in b.items()})
    return (float(jl), dict(leaves(jax.tree.map(np.asarray, jg))),
            float(tl), dict(leaves(tg)))


def test_bridge_carries_the_reference_tree_leaf_for_leaf():
    _, jp, tm, tp = _setup("float32")
    want = dict(leaves(param_shapes(tm.defs())))
    got = {p: tuple(t.shape) for p, t in leaves(tp)}
    jshapes = {p: tuple(a.shape) for p, a in
               leaves(jax.tree.map(np.asarray, jp))}
    assert got == want == jshapes
    for p, a in leaves(jax.tree.map(np.asarray, jp)):
        assert np.array_equal(dict(leaves(tp))[p].numpy(), a), p


def test_lm_loss_and_grads_match_jax_f32():
    jl, jg, tl, tg = _loss_and_grads("float32")
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    assert set(tg) == set(jg)
    for path, g in tg.items():
        assert g.dtype == torch.float32, path      # f32 masters
        want = jg[path]
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (path, err)


def test_lm_loss_and_grads_match_jax_bf16():
    jl, jg, tl, tg = _loss_and_grads("bfloat16")
    assert abs(tl - jl) <= 2e-3 * abs(jl), (tl, jl)
    for path, g in tg.items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), path
        got, want = g.numpy().ravel(), jg[path].ravel()
        if not want.any():          # the saturated decay clamp
            assert not got.any(), path
            continue
        cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
        assert cos >= 0.98, (path, cos)
        assert np.abs(got - want).max() <= 0.3 * np.abs(want).max(), path


def test_remat_full_computes_the_same_gradients():
    _, _, tm, tp = _setup("float32")
    b = {k: torch.tensor(v) for k, v in _batch(S=32).items()}
    out = {}
    for pol in ("none", "full"):
        cfg = dataclasses.replace(tm.cfg, remat_policy=pol)
        out[pol] = steps.value_and_grad(
            get_model(cfg, device="cpu").loss, tp, b)
    assert torch.equal(out["none"][0], out["full"][0])
    for (_, a), (_, c) in zip(leaves(out["none"][1]),
                              leaves(out["full"][1])):
        assert torch.equal(a, c)


def test_serving_hooks_and_decode_raise_naming_the_roadmap_item():
    """The serving hooks serve now (ROADMAP A11a): a zeroed cache of the
    reference's leaves and dtypes, a decode step (``time_mix_apply(...,
    decode=True)`` underneath) and a chunked prefill step; no verify
    step, as in the reference.  The family check of ``model_defs``
    stands."""
    tm = get_model(get_smoke(ARCH), device="cpu")
    assert tm.carries_state
    spec = tm.cache_spec(2, 16)
    assert {k: v[1] for k, v in spec.items()} == {
        "wkv": torch.float32, "tm_prev": torch.bfloat16,
        "cm_prev": torch.bfloat16}
    assert spec["wkv"][0] == (2, 2, 4, 16, 16)
    cache = tm.init_cache(2, 16)
    assert all(not leaf.any() for leaf in cache.values())
    _, tpar = _layer0("tm", "float32")
    out, (state, last) = rwkv6.time_mix_apply(
        tpar, torch.ones(1, 1, 64), head_dim=16, decode=True)
    assert out.shape == (1, 1, 64) and state.shape == (1, 4, 16, 16)
    params = tm.init(torch.Generator().manual_seed(0))
    logits, cache = tm.decode_step(params, cache,
                                   torch.tensor([[3], [4]]),
                                   torch.tensor([0, 0]))
    assert logits.shape == (2, 256) and cache["wkv"].any()
    logits, _ = tm.prefill_step(params, cache, torch.tensor([[1, 2]] * 2),
                                torch.tensor([1, 1]), torch.tensor([1, 0]))
    assert torch.isfinite(logits).all()
    for hook in ("verify_step", "paged_verify_step", "paged_prefill_step"):
        assert getattr(tm, hook) is None
    with pytest.raises(ValueError, match="ssm"):
        rwkv_lm.model_defs(get_smoke("smollm-360m"))


def test_get_model_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(get_smoke(ARCH))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(get_smoke(ARCH), ShapeConfig("t", 16, 2, "train"), steps=1)


def test_build_train_microbatch_matches_jax_train_step():
    """One step of ``build_train`` with microbatch=2 against the
    reference's jitted ``train_step`` on a one-device mesh, from the same
    params, AdamW state and batch, in float32 compute (AdamW eps 1.0, as
    in ``tests/test_torch_train.py``)."""
    jm, jp, _, tp = _setup("float32")
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32",
                              microbatch=2)
    jcfg = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32",
                               microbatch=2)
    kw = dict(lr=1e-2, eps=1.0, warmup_steps=1)
    b = _batch(B=4, S=32, seed=11)
    jopt = jax_adamw.init_state(jax_adamw.AdamWConfig(**kw), jp)
    jopt["mu"] = jax.tree.map(lambda x: x + 1e-3, jopt["mu"])
    jopt["nu"] = jax.tree.map(lambda x: x + 1e-4, jopt["nu"])
    art = jax_steps.build_train(jcfg, JaxShape("t", 32, 4, "train"),
                                make_host_mesh(),
                                adamw_cfg=jax_adamw.AdamWConfig(**kw))
    with art.sharder.mesh, use_sharder(art.sharder):
        copy = lambda t: jax.tree.map(lambda x: x + 0, t)
        jp2, jo2, jmet = art.jit()(copy(jp), copy(jopt),
                                   {k: jnp.asarray(v) for k, v in b.items()})
    tart = steps.build_train(cfg, ShapeConfig("t", 32, 4, "train"),
                             adamw_cfg=adamw.AdamWConfig(**kw),
                             device="cpu")
    topt = opt_state_from_jax(jax.tree.map(np.asarray, jopt), device="cpu")
    # The step updates its params and state in place (the reference's
    # jit donates them): hand it a copy of the shared params.
    tp2, to2, tmet = tart.step_fn(map_tree(torch.clone, tp), topt,
                                  {k: torch.tensor(v) for k, v in b.items()})
    for name in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                   rtol=1e-5)
    jflat = {"params": dict(leaves(jax.tree.map(np.asarray, jp2))),
             "mu": dict(leaves(jax.tree.map(np.asarray, jo2["mu"]))),
             "nu": dict(leaves(jax.tree.map(np.asarray, jo2["nu"])))}
    p0 = dict(leaves(jax.tree.map(np.asarray, jp)))
    for name, tree in (("params", tp2), ("mu", to2["mu"]),
                       ("nu", to2["nu"])):
        for path, got in leaves(tree):
            want = jflat[name][path]
            base = p0[path] if name == "params" else 0.0
            err = np.abs(got.numpy() - want).max()
            scale = np.abs(want - base).max()    # the update, for params
            assert err <= 1e-4 * scale + 1e-7, (name, path, err, scale)


def test_train_cli_on_the_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        train_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "32"])
    out = buf.getvalue()
    assert "[train] 2 steps" in out
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.splitlines() if "] step " in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
