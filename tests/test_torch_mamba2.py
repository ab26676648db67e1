"""The port's mamba2 model and its training path against the JAX
reference, on the mamba2-2.7b smoke config (4 layers, d_model 64,
head_dim 32, state 16, vocab 256).

Weights come from the reference's ``init(cfg, PRNGKey(0))`` and cross
the framework boundary as numpy (``repro_torch.models.bridge``);
activations and batches are drawn from seeded numpy generators.

Tolerances.  In float32 compute: the blocks within 1e-5 of their
output's scale, the loss within 1e-5 of its value, each gradient within
1e-4 of its largest magnitude (measured: the loss equal, the gradients
at most 1.4e-5).  The reference runs under ``jax.jit``, as its training
step does.  In bf16 the reference runs the chunked SSD's cumsum,
exps and einsums in bf16 (it rounds L, C B^T and the state it reads),
while kernel B5 and its plain version compute in f32 and round once,
and XLA-CPU's bf16 silu is its own (ROADMAP C2, C5).  Measured on this
config at S = 64: the block's bf16 output sits 1.0e-2 of its scale from
the reference's f32 one in the reference and 8.5e-3 in the port, 6.6e-3
from the reference's bf16; so a bf16 block is held to both within 3e-2.
The loss: the reference's bf16 loss sits 1.0e-4 from its f32 loss, the
port's 1.5e-4 from the reference's bf16 loss; the reference's bf16
gradients at worst 0.30 of a leaf's scale from its f32 ones (smallest
cosine 0.988), the port's 0.23 from the reference's bf16 ones (smallest
cosine 0.989).  So the bf16 loss is held within 1e-3 relative, every
gradient at cosine >= 0.98 and within 0.35 of its scale.
"""

import dataclasses
import io
import math
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
from repro.models import mamba2 as jax_mamba2
from repro.models.layers import param_shapes as jax_param_shapes
from repro.optim import adamw as jax_adamw
from repro.parallel.sharding import use_sharder
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.launch import steps
from repro_torch.launch.train import main as train_main, train
from repro_torch.models import get_model, mamba2
from repro_torch.models.bridge import opt_state_from_jax, params_from_jax
from repro_torch.models.layers import param_shapes
from repro_torch.optim import adamw
from repro_torch.tree import leaves, map_tree

ARCH = "mamba2-2.7b"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_CACHE = {}
_APPLY = {}


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


def _layer0(dtype: str):
    """Layer 0's params as (jax, torch) trees in the compute dtype."""
    _, jp, _, tp = _setup(dtype)
    j = jax.tree.map(lambda a: a[0].astype(JDT[dtype]), jp["layers"])
    t = {k: v[0].to(TDT[dtype]) for k, v in tp["layers"].items()}
    return j, t


def _block_kw():
    cfg = get_smoke(ARCH)
    return dict(expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                state=cfg.ssm_state, conv_width=cfg.conv_width)


def _x(*shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(
        np.float32)


def _held(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_the_port_registers_mamba2_2p7b_with_the_reference_widths():
    assert ARCH in ARCH_NAMES
    full, smoke = get_config(ARCH), get_smoke(ARCH)
    for name in ("family", "n_layers", "d_model", "vocab", "ssm_state",
                 "ssm_head_dim", "ssm_expand", "conv_width", "loss_chunk",
                 "param_dtype", "compute_dtype", "remat"):
        assert getattr(full, name) == getattr(jax_config(ARCH), name), name
        assert getattr(smoke, name) == getattr(jax_smoke(ARCH), name), name
    assert (full.n_layers, full.d_model, full.ssm_state) == (64, 2560, 128)
    assert full.ssm_expand * full.d_model // full.ssm_head_dim == 80


def test_full_width_params_match_the_reference_leaf_for_leaf():
    """The port's param tree at full width has the reference's shapes;
    its count is ``ArchConfig.n_params()`` plus what that formula leaves
    out: per layer conv_b and the gate norm's d_in - d extra width, the
    final norm, and the vocab padding of the embedding and head."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    got = dict(leaves(param_shapes(mamba2.model_defs(cfg))))
    want = {p: tuple(s.shape) for p, s in
            leaves(jax_param_shapes(jax_mamba2.model_defs(jcfg)))}
    assert got == want
    n = sum(math.prod(s) for s in got.values())
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    d_in = cfg.ssm_expand * d
    vp = got[("embedding",)][0]
    assert vp == 50_432
    missing = L * (d_in + 2 * cfg.ssm_state + d_in - d) + d \
        + 2 * (vp - V) * d
    assert n == jcfg.n_params() + missing == 2_832_074_240


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    jpar, tpar = _layer0(dtype)
    x = _x(2, 64, tpar["conv_w"].shape[1], seed=2)
    jo = jax_mamba2._causal_conv(jnp.asarray(x).astype(JDT[dtype]),
                                 jpar["conv_w"], jpar["conv_b"])
    to = mamba2._causal_conv(torch.tensor(x).to(TDT[dtype]),
                             tpar["conv_w"], tpar["conv_b"])
    assert to.dtype == TDT[dtype]
    _held(to, jo, 1e-5 if dtype == "float32" else 3e-2)


def _jax_apply(dtype, x):
    if dtype not in _APPLY:
        jpar, _ = _layer0(dtype)
        _APPLY[dtype] = jax.jit(lambda v: jax_mamba2.mamba2_apply(
            jpar, v, **_block_kw()))(jnp.asarray(x).astype(JDT[dtype]))
    return _APPLY[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_apply_matches_jax(dtype):
    """The block, with B5's plain version at its core on the CPU, held to
    the reference's f32 block (and, in bf16, to its bf16 block)."""
    _, tpar = _layer0(dtype)
    x = _x(2, 64, get_smoke(ARCH).d_model)
    before = ssd_ops.ssd.launches
    to = mamba2.mamba2_apply(tpar, torch.tensor(x).to(TDT[dtype]),
                             **_block_kw())
    assert to.dtype == TDT[dtype] and ssd_ops.ssd.launches == before
    _held(to, _jax_apply("float32", x), 1e-5 if dtype == "float32"
          else 3e-2)
    if dtype == "bfloat16":
        _held(to, _jax_apply(dtype, x), 3e-2)


def test_the_twin_matches_the_jax_model():
    """The port's ``ssd_chunked`` (compute-dtype twin) against the JAX
    model's: f32 within 1e-5 of scale.  In bf16 both round their cumsum,
    exps and einsums, the port op by op and XLA after fusing some of
    them in f32 (C4): measured on these inputs, the reference's bf16 y
    and state sit 1.4e-2 and 1.8e-2 of their scale from its f32 ones, the
    port's 3.5e-2 and 1.8e-2, and 4.5e-2 and 9.3e-3 from the reference's
    bf16 ones.  So the bf16 twin is held to the reference's f32 result
    within 5e-2 and to its bf16 result within 6e-2."""
    r = np.random.default_rng(5)
    B, S, H, P, N = 2, 64, 2, 16, 8
    mk = lambda *s, sc=0.5: (r.normal(size=s) * sc).astype(np.float32)
    ins = [mk(B, S, H, P), np.log1p(np.exp(r.normal(size=(B, S, H)))),
           -np.exp(r.normal(size=H) * 0.3), mk(B, S, N), mk(B, S, N)]
    s0 = mk(B, H, P, N, sc=0.2)
    out = {}
    for dtype in ("float32", "bfloat16"):
        J = lambda a: jnp.asarray(a).astype(JDT[dtype])
        T = lambda a: torch.tensor(a).to(TDT[dtype])
        out[dtype] = (
            jax_mamba2.ssd_chunked(*map(J, ins), chunk=16,
                                   init_state=jnp.asarray(s0)),
            mamba2.ssd_chunked(*map(T, ins), chunk=16,
                               init_state=torch.tensor(s0)))
    (jy, js), (ty, ts) = out["float32"]
    (jby, jbs), (tby, tbs) = out["bfloat16"]
    for got, want_f32, want_bf16 in ((ty, jy, None), (ts, js, None),
                                     (tby, jy, jby), (tbs, js, jbs)):
        _held(got, want_f32, 1e-5 if want_bf16 is None else 5e-2)
        if want_bf16 is not None:
            _held(got, want_bf16, 6e-2)


def _loss_and_grads(dtype, b=None):
    jm, jp, tm, tp = _setup(dtype)
    b = b or _batch()
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
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
    assert abs(tl - jl) <= 1e-3 * abs(jl), (tl, jl)
    for path, g in tg.items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), path
        got, want = g.numpy().ravel(), jg[path].ravel()
        cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
        assert cos >= 0.98, (path, cos)
        assert np.abs(got - want).max() <= 0.35 * np.abs(want).max(), path


def test_gradients_stay_finite_where_the_reference_twin_overflows():
    """At S = 128 the reference's chunk (min(256, S) rows) is long enough
    for its cumsum of dt A to pass -88 at its initialiser: its twin takes
    ``exp`` of the positive differences above the diagonal, which
    overflow to inf before ``where`` masks them, so its loss is right but
    its gradients are NaN (inf * 0; ROADMAP C10).  The port masks before
    the exponential (B5's plain version) and its kernel never forms them:
    the same loss, finite gradients."""
    jl, jg, tl, tg = _loss_and_grads("float32", _batch(S=128, seed=3))
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    assert not all(np.isfinite(g).all() for g in jg.values())
    assert all(torch.isfinite(g).all() for g in tg.values())


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
    """The serving hooks serve now (ROADMAP A11a): ``cache_spec`` in the
    cache dtype (bf16, as the reference), ``mamba2_decode`` under a
    decode step, a paged step over state rows and a chunked prefill step;
    no verify step, as in the reference.  The family check of
    ``model_defs`` stands."""
    tm = get_model(get_smoke(ARCH), device="cpu")
    assert tm.carries_state
    spec = tm.cache_spec(2, 16)
    assert spec == {"conv": ((4, 2, 3, 160), torch.bfloat16),
                    "ssm": ((4, 2, 4, 32, 16), torch.bfloat16)}
    assert mamba2.cache_spec(tm.cfg, 2, 16) == spec
    params = tm.init(torch.Generator().manual_seed(0))
    assert params["layers"]["A_log"].dtype == torch.float32
    cache = tm.init_cache(2, 16)
    logits, cache = tm.decode_step(params, cache, torch.tensor([[3], [4]]),
                                   torch.tensor([0, 0]))
    assert logits.shape == (2, 256) and cache["ssm"].any()
    pool = {k: torch.cat([torch.zeros_like(v[:, :1]), v], dim=1)
            for k, v in cache.items()}
    paged, _ = tm.paged_decode_step(params, pool, torch.tensor([1, 2]),
                                    torch.tensor([[5], [6]]),
                                    torch.tensor([1, 1]))
    dense, _ = tm.decode_step(params, cache, torch.tensor([[5], [6]]),
                              torch.tensor([1, 1]))
    assert torch.equal(paged, dense)
    assert torch.equal(pool["ssm"][:, 1:], cache["ssm"])
    logits, _ = tm.prefill_step(params, cache, torch.tensor([[1, 2]] * 2),
                                torch.tensor([2, 2]), torch.tensor([1, 0]))
    assert torch.isfinite(logits).all()
    for hook in ("verify_step", "paged_verify_step", "paged_prefill_step"):
        assert getattr(tm, hook) is None
    with pytest.raises(ValueError, match="mamba"):
        mamba2.model_defs(get_smoke("rwkv6-3b"))


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
