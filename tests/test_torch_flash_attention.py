"""The port's blocked softmax attention (kernel B3's plain version and its
autograd Function) against the JAX reference kernel.

``repro_torch.kernels.flash_attention`` is held against the JAX
``flash_attention`` run as ``tests/test_kernels.py`` runs it (interpret
mode), on the same numpy inputs drawn from seeded generators; the
Function's chunked-recompute gradient is held against autograd through
the plain version and against ``jax.grad`` of the reference's
``attention_ref``.  The CUDA kernel is held against the plain version on
the card in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: float32 within 1e-5 of the output's largest magnitude
(reduction order only); bf16 within two bf16 ulps of each row's largest
output (both sides compute in f32 and round once, so only a near-tie
rounds differently — B2's rule).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def _case(B, S, S_kv, H, Hkv, D, *, seed=0):
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, S, H, D)).astype(np.float32)
    k = r.normal(size=(B, S_kv, Hkv, D)).astype(np.float32)
    v = r.normal(size=(B, S_kv, Hkv, D)).astype(np.float32)
    return q, k, v


def _jax(case, causal, dtype=jnp.float32, block=16):
    q, k, v = (jnp.asarray(a, dtype) for a in case)
    out = jax_flash(q, k, v, causal=causal, block_q=block, block_k=block)
    assert out.dtype == dtype
    return np.asarray(out.astype(jnp.float32))


def _port(case, causal, dtype=torch.float32, **kw):
    q, k, v = (torch.tensor(a).to(dtype) for a in case)
    out = ops.flash_attention(q, k, v, causal=causal, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


def _bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def _close_f32(got, want):
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", [
    (1, 64, 64, 2, 2, 16),       # MHA
    (2, 64, 64, 6, 2, 16),       # GQA 6/2
    (1, 64, 64, 15, 5, 64),      # smollm-360m's heads
    (1, 48, 48, 4, 2, 32),       # S not a multiple of the port's tiles
])
def test_plain_matches_jax_kernel_f32(dims, causal):
    case = _case(*dims)
    _close_f32(_port(case, causal), _jax(case, causal))


@pytest.mark.parametrize("S_kv,S", [(64, 16), (96, 32), (1024, 64)])
def test_rectangular_causal_offset_matches_jax(S_kv, S):
    """S_kv > S: query row r attends kv positions <= r + S_kv - S."""
    case = _case(2, S, S_kv, 4, 2, 16, seed=1)
    _close_f32(_port(case, True), _jax(case, True))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_kernel_bf16(causal):
    case = _case(2, 64, 64, 6, 2, 32, seed=2)
    got = _port(case, causal, torch.bfloat16)
    want = _jax(case, causal, jnp.bfloat16)
    row = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= 2 * _bf16_ulp(row)).all()


@pytest.mark.parametrize("blocks", [(16, 64), (64, 16), (128, 128)])
def test_block_sizes_do_not_change_the_result(blocks):
    """block_q / block_k are tiling knobs: the port's result is the same
    for every choice, and the JAX kernel's at that choice."""
    bq, bk = blocks
    case = _case(1, 128, 128, 2, 2, 16, seed=3)
    got = _port(case, True, block_q=bq, block_k=bk)
    np.testing.assert_array_equal(got, _port(case, True))
    q, k, v = (jnp.asarray(a) for a in case)
    want = np.asarray(jax_flash(q, k, v, causal=True, block_q=bq,
                                block_k=bk))
    _close_f32(got, want)


def test_gqa_by_index_equals_repeated_kv():
    """Query head h reads kv head h // G without K/V being repeated; the
    result is the repeated-K/V one."""
    q, k, v = _case(2, 64, 64, 6, 2, 16, seed=4)
    rep = lambda a: np.repeat(a, 3, axis=2)
    got = _port((q, k, v), True)
    _close_f32(got, _port((q, rep(k), rep(v)), True))


def _grads(fn, case, w, causal, **kw):
    q, k, v = (torch.tensor(a, requires_grad=True) for a in case)
    out = fn(q, k, v, causal=causal, **kw)
    (out * torch.tensor(w)).sum().backward()
    return [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims,q_chunk", [
    ((2, 64, 64, 6, 2, 16), 16),     # GQA, 4 chunks
    ((1, 48, 48, 15, 5, 16), 20),    # ragged last chunk
    ((2, 16, 64, 4, 2, 16), 8),      # rectangular offset
])
def test_function_gradient_matches_autograd_through_plain(dims, q_chunk,
                                                          causal):
    """The Function's chunked recompute (q_chunk rows at a time, K/V cut
    at each chunk's causal limit) gives autograd's gradient through the
    plain version in one piece, within 1e-5 of each gradient's scale."""
    case = _case(*dims, seed=5)
    w = np.random.default_rng(6).normal(size=case[0].shape).astype(
        np.float32)
    got = _grads(ops.flash_attention, case, w, causal, q_chunk=q_chunk)
    want = _grads(flash_attention_ref, case, w, causal)
    for g, ref in zip(got, want):
        assert np.abs(g - ref).max() <= 1e-5 * np.abs(ref).max()


def test_function_gradient_matches_jax_grad_of_attention_ref():
    """Against ``jax.grad`` of the reference's ``attention_ref`` (K/V
    repeated to H heads for it, so dK/dV sum over each group) in f32."""
    B, S, H, Hkv, D = 2, 64, 6, 2, 16
    case = _case(B, S, S, H, Hkv, D, seed=7)
    w = np.random.default_rng(8).normal(size=case[0].shape).astype(
        np.float32)

    def loss(q, k, v):
        G = H // Hkv
        flat = lambda t: t.transpose(0, 2, 1, 3).reshape(B * H, S, D)
        o = attention_ref(flat(q), flat(jnp.repeat(k, G, axis=2)),
                          flat(jnp.repeat(v, G, axis=2)), causal=True)
        return jnp.sum(o.reshape(B, H, S, D).transpose(0, 2, 1, 3) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in case))
    got = _grads(ops.flash_attention, case, w, True, q_chunk=16)
    for g, ref in zip(got, want):
        ref = np.asarray(ref)
        assert np.abs(g - ref).max() <= 1e-5 * np.abs(ref).max()


def test_bf16_gradients_keep_the_input_dtype():
    case = _case(1, 32, 32, 4, 2, 16, seed=9)
    q, k, v = (torch.tensor(a).to(torch.bfloat16).requires_grad_()
               for a in case)
    ops.flash_attention(q, k, v, q_chunk=8).float().sum().backward()
    for t in (q, k, v):
        assert t.grad.dtype == torch.bfloat16
        assert torch.isfinite(t.grad).all()


def test_cpu_never_counts_a_kernel_launch():
    before = ops.flash_attention.launches
    bodies = dict(ops.flash_attention.body_launches)
    _port(_case(1, 16, 16, 2, 1, 16), True)
    assert ops.flash_attention.launches == before
    assert ops.flash_attention.body_launches == bodies


def test_bodies_are_routed_by_dtype():
    """bf16 runs the tensor-core body, f32 the CUDA-core body (TF32
    tensor cores would not hold f32's 1e-5); nothing else is taken."""
    assert ops.body(torch.bfloat16) == "mma"
    assert ops.body(torch.float32) == "cuda_core"
    assert set(ops.flash_attention.body_launches) == {"mma", "cuda_core"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_counts_no_launch_of_either_body(dtype):
    before = (ops.flash_attention.launches,
              dict(ops.flash_attention.body_launches))
    _port(_case(1, 16, 16, 2, 1, 16, seed=11), True, dtype)
    assert (ops.flash_attention.launches,
            ops.flash_attention.body_launches) == before


@pytest.mark.parametrize("shapes,dtypes,err", [
    (((1, 8, 4, 16), (1, 8, 3, 16)), None, ValueError),    # H % Hkv
    (((1, 8, 2, 16), (1, 4, 2, 16)), None, ValueError),    # S_kv < S
    (((1, 8, 2, 16), (1, 8, 2, 32)), None, ValueError),    # D differs
    (((1, 8, 2, 16), (1, 8, 2, 16)), (torch.float32, torch.bfloat16),
     TypeError),
    (((1, 8, 2, 16), (1, 8, 2, 16)), (torch.float16, torch.float16),
     TypeError),
])
def test_rejects_what_the_kernel_does_not_take(shapes, dtypes, err):
    qd, kd = dtypes or (torch.float32, torch.float32)
    q = torch.zeros(shapes[0], dtype=qd)
    k = torch.zeros(shapes[1], dtype=kd)
    with pytest.raises(err):
        ops.flash_attention(q, k, k.clone())


def test_other_devices_raise_instead_of_falling_back():
    q = torch.zeros((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(q, q, q)
