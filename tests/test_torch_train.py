"""The port's training path against the JAX reference: the loss and its
gradients, AdamW, the synthetic data stream, the train step with
gradient accumulation, checkpointing, the resilient runner and the
driver's restart.

Weights come from the reference's ``init(cfg, PRNGKey(0))`` and cross the
framework boundary as numpy (``repro_torch.models.bridge``); batches and
gradients are drawn from seeded numpy generators.

Tolerances: in float32 compute the loss within 1e-5 of its value and
each gradient within 1e-4 of its largest magnitude (the smoke models'
gradients are large and ill-conditioned at random init: the reference's
own float32 gradients sit 4e-5 from a float64 evaluation).  In bf16 the
loss within 2e-3 of its value: B3 keeps scores and probabilities in f32
where the reference rounds them to bf16, and XLA's bf16 sigmoid is its
own (ROADMAP C5).  bf16 gradients are compared on the qwen3-8b smoke
config only, within 5e-2 of each gradient's scale: at the smollm-360m
smoke config (no qk-norm) the reference's own bf16 gradients have a
cosine of 0.53 with its float32 ones, so no port can be held to them.
"""

import dataclasses
import io
import json
import os
import time
from contextlib import redirect_stdout

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.configs.base import ShapeConfig as JaxShape
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.launch import steps as jax_steps
from repro.launch.mesh import make_host_mesh
from repro.models import get_model as jax_get_model
from repro.optim import adamw as jax_adamw
from repro.parallel.sharding import use_sharder
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.sharded import load_manifest
from repro_torch.configs import SHAPES, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.launch import steps
from repro_torch.launch.train import main as train_main, train
from repro_torch.models import get_model, input_specs, make_batch
from repro_torch.models.bridge import opt_state_from_jax, params_from_jax
from repro_torch.optim import adamw
from repro_torch.runtime import (FaultInjector, Heartbeat, ResilientRunner,
                                 StepFailure)
from repro_torch.tree import leaves, map_tree

_CACHE = {}


def _setup(arch: str, dtype: str):
    """(jax model, jax params, port model, port f32 params) with identical
    weights, ``dtype`` compute."""
    key = (arch, dtype)
    if key not in _CACHE:
        jm = jax_get_model(dataclasses.replace(jax_smoke(arch),
                                               compute_dtype=dtype))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = get_model(dataclasses.replace(get_smoke(arch),
                                           compute_dtype=dtype),
                       device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _CACHE[key] = (jm, jp, tm, tp)
    return _CACHE[key]


def _batch(B=2, S=64, vocab=256, seed=0):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": r.integers(0, vocab, (B, S)).astype(np.int32)}


def _loss_and_grads(arch, dtype):
    jm, jp, tm, tp = _setup(arch, dtype)
    b = _batch()
    jl, jg = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tg = steps.value_and_grad(
        tm.loss, tp, {k: torch.tensor(v) for k, v in b.items()})
    return (float(jl), dict(leaves(jax.tree.map(np.asarray, jg))),
            float(tl), dict(leaves(tg)))


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-8b"])
def test_lm_loss_and_grads_match_jax_f32(arch):
    jl, jg, tl, tg = _loss_and_grads(arch, "float32")
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    assert set(tg) == set(jg)
    for path, g in tg.items():
        assert g.dtype == torch.float32, path      # f32 masters
        want = jg[path]
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (path, err)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-8b"])
def test_lm_loss_matches_jax_bf16(arch):
    jl, jg, tl, tg = _loss_and_grads(arch, "bfloat16")
    assert abs(tl - jl) <= 2e-3 * abs(jl), (tl, jl)
    for path, g in tg.items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), path
    if arch == "qwen3-8b":
        for path, g in tg.items():
            want = jg[path]
            err = np.abs(g.numpy() - want).max()
            assert err <= 5e-2 * np.abs(want).max(), (path, err)


def test_remat_policies_compute_the_same_gradients():
    """remat "full" (per-layer checkpoint) recomputes the same bits as
    "none"; "dots" is not ported and says which ROADMAP item has it."""
    _, _, tm, tp = _setup("qwen3-8b", "float32")
    b = {k: torch.tensor(v) for k, v in _batch().items()}
    out = {}
    for pol in ("none", "full"):
        cfg = dataclasses.replace(tm.cfg, remat_policy=pol)
        out[pol] = steps.value_and_grad(
            get_model(cfg, device="cpu").loss, tp, b)
    assert torch.equal(out["none"][0], out["full"][0])
    for (_, a), (_, c) in zip(leaves(out["none"][1]),
                              leaves(out["full"][1])):
        assert torch.equal(a, c)
    dots = get_model(dataclasses.replace(tm.cfg, remat_policy="dots"),
                     device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        steps.value_and_grad(dots.loss, tp, b)


def test_unported_attention_options_raise():
    _, _, tm, tp = _setup("qwen3-8b", "float32")
    b = {k: torch.tensor(v) for k, v in _batch().items()}
    cfg = dataclasses.replace(tm.cfg, scores_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="A14"):
        get_model(cfg, device="cpu").loss(tp, b)


def _tree(seed, shapes):
    r = np.random.default_rng(seed)
    return {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def test_adamw_update_matches_jax_over_three_steps():
    """Three updates with the same gradients on both sides, through the
    warmup and past it, with clipping active: params, moments and the
    metrics within float32 rounding."""
    shapes = {"a": (4, 6), "b": (6,), "c": (3, 2, 5)}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=1.0)
    jp = {k: jnp.asarray(v) for k, v in _tree(0, shapes).items()}
    jst = jax_adamw.init_state(jax_adamw.AdamWConfig(**cfg), jp)
    tp = {k: torch.tensor(v) for k, v in _tree(0, shapes).items()}
    tst = adamw.init_state(adamw.AdamWConfig(**cfg), tp)
    for step in range(3):
        g = _tree(10 + step, shapes)
        jp, jst, jm = jax_adamw.update(
            jax_adamw.AdamWConfig(**cfg), {k: jnp.asarray(v)
                                           for k, v in g.items()}, jst, jp)
        tp, tst, tm = adamw.update(
            adamw.AdamWConfig(**cfg), {k: torch.tensor(v)
                                       for k, v in g.items()}, tst, tp)
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6)
        for a, b in ((tp, jp), (tst["mu"], jst["mu"]),
                     (tst["nu"], jst["nu"])):
            for k in shapes:
                np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                           rtol=1e-5, atol=1e-7)


def test_schedule_matches_jax():
    cfg = adamw.AdamWConfig()
    jcfg = jax_adamw.AdamWConfig()
    for s in (0, 1, 50, 100, 101, 5_000, 10_000, 20_000):
        got = float(adamw.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
        want = float(jax_adamw.schedule(jcfg, jnp.int32(s)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("vocab,seq,batch", [(256, 64, 4),
                                             (49_152, 512, 2)])
def test_synthetic_batches_equal_the_reference_bitwise(vocab, seq, batch):
    ours = SyntheticLM(vocab, seq, batch, seed=3)
    ref = JaxSyntheticLM(vocab, seq, batch, seed=3)
    for step in range(4):
        a, b = ours.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == torch.int32
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


def test_prefetch_order_and_seek():
    ds = SyntheticLM(vocab=100, seq_len=16, global_batch=2, seed=1)
    pf = Prefetcher(ds, start_step=10, depth=3, device="cpu")
    try:
        for s in (10, 11, 12, 13):
            np.testing.assert_array_equal(pf.get(s)["tokens"].numpy(),
                                          ds.batch_at(s)["tokens"].numpy())
        with pytest.raises(RuntimeError):
            pf.get(99)   # out-of-order detection
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetch_hands_a_failure_to_the_consumer():
    class Broken(SyntheticLM):
        def batch_at(self, step):
            raise OSError("disk gone")

    pf = Prefetcher(Broken(100, 16, 2), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="failed at step 0"):
            pf.get(0)
    finally:
        pf.close()


def test_input_specs_and_make_batch():
    cfg = get_smoke("smollm-360m")
    shape = ShapeConfig("t", 32, 3, "train")
    specs = input_specs(cfg, shape)
    assert specs == {"tokens": ((3, 32), torch.int32),
                     "labels": ((3, 32), torch.int32)}
    b = make_batch(cfg, shape, torch.Generator().manual_seed(0),
                   device="cpu")
    for name, (shp, dt) in specs.items():
        assert b[name].shape == shp and b[name].dtype == dt
        assert 0 <= int(b[name].min()) and int(b[name].max()) < cfg.vocab
    assert SHAPES["train_4k"].seq_len == 4096


def test_build_train_microbatch_matches_jax_train_step():
    """One step of ``build_train`` with microbatch=2 (f32 accumulator)
    against the reference's jitted ``train_step`` on a one-device mesh,
    from the same params, AdamW state and batch, in float32 compute.
    AdamW's eps is 1.0 so the update is a smooth function of the
    gradient (with eps 1e-8 a near-zero gradient entry moves its weight
    by +-lr on its sign alone)."""
    jm, jp, _, tp = _setup("qwen3-8b", "float32")
    cfg = dataclasses.replace(get_smoke("qwen3-8b"), compute_dtype="float32",
                              microbatch=2)
    jcfg = dataclasses.replace(jax_smoke("qwen3-8b"),
                               compute_dtype="float32", microbatch=2)
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
    assert int(to2["step"]) == int(jo2["step"]) == 1
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


SMOKE = ShapeConfig("smoke_train", 32, 4, "train")


def test_train_restart_is_bitwise_identical(tmp_path):
    """Stop at step 6, resume to 10 == one uninterrupted 10-step run, bit
    for bit (losses and final params) on the CPU."""
    cfg = get_smoke("smollm-360m")
    with redirect_stdout(io.StringIO()):
        full = train(cfg, SMOKE, steps=10, seed=0, device="cpu")
        part = train(cfg, SMOKE, steps=6, ckpt_dir=str(tmp_path / "ck"),
                     ckpt_every=3, seed=0, device="cpu")
        resumed = train(cfg, SMOKE, steps=4, ckpt_dir=str(tmp_path / "ck"),
                        ckpt_every=3, seed=0, device="cpu")
    assert part["steps"] == 6 and resumed["steps"] == 4
    assert dict(part["losses"]) == {s: l for s, l in full["losses"]
                                    if s < 6}
    assert [s for s, _ in resumed["losses"]] == [6, 7, 8, 9]
    assert dict(resumed["losses"]) == {s: l for s, l in full["losses"]
                                       if s >= 6}
    for (_, a), (_, b) in zip(leaves(full["params"]),
                              leaves(resumed["params"])):
        assert torch.equal(a, b)
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0
               for m in full["metrics"])


def test_train_cli_on_the_cpu(tmp_path):
    buf = io.StringIO()
    with redirect_stdout(buf):
        train_main(["--smoke", "--device", "cpu", "--steps", "2",
                    "--batch", "2", "--seq", "16", "--overlap-grad-sync",
                    "--ckpt", str(tmp_path / "ck"), "--ckpt-every", "1"])
    out = buf.getvalue()
    assert "overlap/compression knobs are no-ops" in out
    assert "[train] 2 steps" in out
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000001",
                                                   "step_00000002"]


# ---------------------------------------------------------------------------
# Checkpointing (the cases of tests/test_checkpoint.py that apply to one
# device)
# ---------------------------------------------------------------------------

@pytest.fixture
def tree():
    return {
        "layers": {"w": torch.arange(24.0).reshape(4, 6),
                   "b": torch.ones((6,), dtype=torch.bfloat16) / 3},
        "step_scale": torch.tensor(0.5),
        "step": torch.tensor(7, dtype=torch.int32),
    }


def test_checkpoint_roundtrip(tmp_path, tree):
    path = save_checkpoint(str(tmp_path / "ck"), tree, step=7,
                           extra={"note": "hi"})
    restored, step, extra = load_checkpoint(path, tree)
    assert step == 7 and extra == {"note": "hi"}
    for (pa, a), (pb, b) in zip(leaves(tree), leaves(restored)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_restores_into_a_shape_only_skeleton(tmp_path, tree):
    """A target of "meta" tensors (shapes only, as the driver keeps for
    restores) with an explicit device."""
    path = save_checkpoint(str(tmp_path / "ck"), tree, step=5)
    skeleton = {"layers": {k: torch.empty_like(v, device="meta")
                           for k, v in tree["layers"].items()},
                "step_scale": torch.empty((), device="meta"),
                "step": torch.empty((), device="meta")}
    restored, step, _ = load_checkpoint(path, skeleton, device="cpu")
    assert step == 5
    for (_, a), (_, b) in zip(leaves(tree), leaves(restored)):
        assert b.device.type == "cpu" and torch.equal(a, b)


def test_checkpoint_shape_mismatch_rejected(tmp_path, tree):
    path = save_checkpoint(str(tmp_path / "ck"), tree, step=0)
    with pytest.raises(ValueError):
        load_checkpoint(path, dict(tree, step_scale=torch.zeros(3)))


def test_checkpoint_missing_leaf_rejected(tmp_path, tree):
    path = save_checkpoint(str(tmp_path / "ck"), tree, step=0)
    with pytest.raises(KeyError):
        load_checkpoint(path, dict(tree, extra_leaf=torch.zeros(2)))


def test_checkpoint_atomic_no_tmp_left(tmp_path, tree):
    path = save_checkpoint(str(tmp_path / "ck"), tree, step=1)
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    save_checkpoint(path, tree, step=2)      # re-save over the same path
    assert load_checkpoint(path, tree)[1] == 2


def test_checkpoint_manifest_is_json_with_one_file_per_leaf(tmp_path, tree):
    path = save_checkpoint(str(tmp_path / "ck"), tree, step=3)
    man = load_manifest(path)
    assert man["step"] == 3
    assert man["leaves"]["layers.w"]["shape"] == [4, 6]
    assert man["leaves"]["layers.b"]["dtype"] == "bfloat16"
    for rec in man["leaves"].values():
        assert os.path.exists(os.path.join(path, rec["file"]))
    json.dumps(man)


def test_checkpoint_manager_rotation_and_latest(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path / "root"), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(tree, step=s)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert mgr.restore_latest(tree)[1] == 4
    mgr.close()


def test_checkpoint_manager_async_snapshot_isolation(tmp_path):
    """Overwriting the live tensors after save_async must not corrupt the
    checkpoint: the save took a host snapshot."""
    mgr = CheckpointManager(str(tmp_path / "root"), keep=2)
    arr = torch.arange(8.0)
    mgr.save_async({"a": arr}, step=1)
    arr.mul_(0).sub_(5.0)    # training overwrites its buffers in place
    mgr.wait()
    restored, _, _ = mgr.restore_latest({"a": arr})
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(8.0))
    mgr.close()


def test_checkpoint_restore_empty_returns_none(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.restore_latest(tree) is None
    mgr.close()


# ---------------------------------------------------------------------------
# The resilient runner (tests/test_runtime.py's cases)
# ---------------------------------------------------------------------------

def _mk_runner(inj, **kw):
    ckpt = {}

    def save(st, s):
        ckpt[s] = st

    def restore():
        if not ckpt:
            return None
        s = max(ckpt)
        return ckpt[s], s

    return ResilientRunner(lambda st, s: st + s, save_fn=save,
                           restore_fn=restore, every=2, injector=inj, **kw)


def test_runner_transient_retry():
    rr = _mk_runner(FaultInjector(fail_at={(3, 0)}), max_retries=2)
    state, _ = rr.run(0, n_steps=6)
    assert state == sum(range(6))
    assert [e[0] for e in rr.events].count("failure") == 1
    assert not any(e[0] == "restore" for e in rr.events)


def test_runner_restore_and_replay_exact():
    rr = _mk_runner(FaultInjector(fail_at={(5, 0), (5, 1), (5, 2)}),
                    max_retries=2)
    state, _ = rr.run(0, n_steps=10)
    assert state == sum(range(10))
    assert any(e[0] == "restore" for e in rr.events)


def test_runner_unrecoverable_raises():
    inj = FaultInjector(fail_at={(s, a) for s in range(3, 9)
                                 for a in range(4)})
    rr = _mk_runner(inj, max_retries=1, max_restores=2)
    with pytest.raises(StepFailure):
        rr.run(0, n_steps=10)


def test_heartbeat():
    hb = Heartbeat(timeout_s=0.05)
    hb.beat()
    assert not hb.expired
    time.sleep(0.08)
    assert hb.expired
    with pytest.raises(StepFailure):
        hb.check()
