"""The port's paged-decode attention against the JAX reference kernel.

The port's plain version (``repro_torch.kernels.paged_attention.ref``) is
held against the JAX Pallas kernel run as ``tests/test_kernels.py`` runs
it (interpret mode), on the same numpy inputs drawn from seeded
generators.  The CUDA kernel is held against the plain version on the
card in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.paged_attention.ops import paged_attention as jax_paged
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import ref as port_ref


def _case(B, H, KV, D, T, nb, *, extra_rows=2, seed=1, full_lengths=False):
    """Random pool/tables/lengths with real blocks covering each slot's
    valid prefix and NULL (row 0) entries past it; ``extra_rows`` pool
    rows stay unreferenced (as in ``tests/test_kernels.py``)."""
    r = np.random.default_rng(seed)
    lengths = (np.full(B, nb * T) if full_lengths
               else r.integers(1, nb * T + 1, B)).astype(np.int32)
    R = 1 + B * nb + extra_rows
    kp = r.normal(size=(R, T, KV, D)).astype(np.float32)
    vp = r.normal(size=(R, T, KV, D)).astype(np.float32)
    tables = np.zeros((B, nb), np.int32)
    free = list(range(1, R))
    r.shuffle(free)
    for b in range(B):
        for j in range(-(-int(lengths[b]) // T)):
            tables[b, j] = free.pop()
    q = r.normal(size=(B, H, D)).astype(np.float32)
    return q, kp, vp, tables, lengths


def _jax(case, dtype):
    q, kp, vp, tables, lengths = case
    out = jax_paged(jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
                    jnp.asarray(vp, dtype), jnp.asarray(tables),
                    jnp.asarray(lengths))
    return np.asarray(out.astype(jnp.float32))


def _port(case, dtype):
    q, kp, vp, tables, lengths = case
    out = ops.paged_attention(
        torch.tensor(q).to(dtype), torch.tensor(kp).to(dtype),
        torch.tensor(vp).to(dtype), torch.tensor(tables),
        torch.tensor(lengths))
    assert out.dtype == dtype
    return out.float().numpy()


def _bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("dims", [
    (3, 4, 2, 16, 4, 8),     # GQA, partial final blocks
    (2, 2, 2, 32, 8, 4),     # MHA
    (1, 3, 1, 16, 4, 3),     # single kv head, odd group
    (4, 8, 2, 16, 16, 2),    # wide groups, big blocks
])
def test_ref_matches_jax_kernel_f32(dims):
    """float32: the two-pass math agrees with the Pallas kernel to
    reduction-order noise (rtol 1e-5, atol 1e-6)."""
    case = _case(*dims)
    np.testing.assert_allclose(_port(case, torch.float32),
                               _jax(case, jnp.float32),
                               rtol=1e-5, atol=1e-6)


def test_ref_matches_jax_kernel_full_lengths():
    case = _case(2, 4, 2, 16, 4, 8, full_lengths=True)
    np.testing.assert_allclose(_port(case, torch.float32),
                               _jax(case, jnp.float32),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dims", [
    (3, 4, 2, 16, 4, 6),     # smoke head_dim: scale 0.25 is exact
    (2, 8, 2, 128, 16, 4),   # qwen3-8b head_dim: the scale rounds in bf16
])
def test_ref_matches_jax_kernel_bf16_within_one_ulp(dims):
    """bf16: every output element within ONE bf16 ulp of the JAX kernel's
    (the rounding sites match; only float32 reduction order differs)."""
    case = _case(*dims, seed=3)
    got, want = _port(case, torch.bfloat16), _jax(case, jnp.bfloat16)
    assert np.all(np.abs(got - want) <= _bf16_ulp(want)), \
        np.abs(got - want).max()


def _variant_ref(case, *, scale, round_product):
    """The plain version's math in bf16 with the scale multiply changed:
    ``scale`` as given, and the scaled score rounded to bf16 or not."""
    q, kp, vp, tables, lengths = (torch.tensor(a) for a in case)
    bf = torch.bfloat16
    B, H, D = q.shape
    _, T, KV, _ = kp.shape
    S = tables.shape[1] * T
    rows = tables.reshape(-1).long()
    k = kp.to(bf).index_select(0, rows).reshape(B, S, KV, D).float()
    v = vp.to(bf).index_select(0, rows).reshape(B, S, KV, D).float()
    valid = torch.arange(S)[None] < lengths[:, None]
    s = torch.einsum("bkgd,bskd->bkgs",
                     q.to(bf).reshape(B, KV, H // KV, D).float(), k)
    s = s.to(bf).float() * scale
    if round_product:
        s = s.to(bf).float()
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1).to(bf).float()
    v = torch.where(valid[:, :, None, None], v, 0.0)
    o = torch.einsum("bkgs,bskd->bkgd", p, v).reshape(B, H, D)
    return o.to(bf).float().numpy()


def test_scale_rounding_sites_that_match_jax_at_head_dim_128():
    """Which scale multiply the JAX kernel really computes (bf16, D=128,
    2,048 outputs): the source rounds the scaled score, but XLA keeps it
    in float32; and the scale itself is bf16.  Only the port's choice —
    bf16 scale, unrounded product — reproduces every bit (this case:
    rounding the product mismatches 825 outputs, an f32 scale 33)."""
    case = _case(2, 8, 2, 128, 16, 4, seed=3)
    want = _jax(case, jnp.bfloat16)
    bf16_scale = port_ref.kernel_scale(128, torch.bfloat16)
    f32_scale = float(np.float32(1.0 / np.sqrt(128.0)))
    mismatches = {
        (name, rounded): int((_variant_ref(case, scale=sc,
                                           round_product=rounded)
                              != want).sum())
        for name, sc in (("bf16", bf16_scale), ("f32", f32_scale))
        for rounded in (False, True)}
    assert mismatches[("bf16", False)] == 0
    assert np.array_equal(_port(case, torch.bfloat16), want)
    assert mismatches[("bf16", True)] > 100, mismatches
    assert mismatches[("f32", False)] > 0, mismatches


def test_kernel_scale_rounds_to_the_compute_dtype():
    """JAX multiplies a bf16 array by the Python-float scale as a weak
    type, i.e. by bf16(1/sqrt(D)); at D=128 that is not the f32 scale."""
    s = port_ref.kernel_scale(128, torch.bfloat16)
    assert s == float(torch.tensor(128 ** -0.5, dtype=torch.bfloat16))
    assert s != float(torch.tensor(128 ** -0.5, dtype=torch.float32))
    assert port_ref.kernel_scale(16, torch.bfloat16) == 0.25
    assert port_ref.kernel_scale(128, torch.float32) == float(
        np.float32(1.0 / np.sqrt(128.0)))


def test_null_block_and_stale_tails_never_leak():
    """NaN in the NULL block, in every unreferenced row and in each
    slot's tail past its length changes no output bit."""
    q, kp, vp, tables, lengths = _case(3, 4, 2, 16, 4, 6, seed=9)
    clean = _port((q, kp, vp, tables, lengths), torch.float32)
    kp2, vp2 = kp.copy(), vp.copy()
    referenced = {int(tables[b, j]) for b in range(3)
                  for j in range(-(-int(lengths[b]) // 4))}
    for row in range(kp.shape[0]):
        if row not in referenced:
            kp2[row] = np.nan
            vp2[row] = np.nan
    for b in range(3):
        L = int(lengths[b])
        if L % 4:
            kp2[tables[b, L // 4], L % 4:] = np.nan
            vp2[tables[b, L // 4], L % 4:] = np.nan
    dirty = _port((q, kp2, vp2, tables, lengths), torch.float32)
    assert np.isfinite(dirty).all()
    assert np.array_equal(clean, dirty)


def test_zero_length_slot_gives_zeros():
    q, kp, vp, tables, lengths = _case(2, 4, 2, 16, 4, 3)
    lengths[1] = 0
    tables[1] = 0
    out = _port((q, kp, vp, tables, lengths), torch.float32)
    assert np.array_equal(out[1], np.zeros_like(out[1]))
    np.testing.assert_allclose(out, _jax((q, kp, vp, tables, lengths),
                                         jnp.float32),
                               rtol=1e-5, atol=1e-6)


def test_rejects_bad_shapes_and_dtypes():
    q, kp, vp, tables, lengths = (torch.tensor(a) for a in
                                  _case(2, 4, 2, 16, 4, 4))
    with pytest.raises(ValueError, match="multiple"):
        ops.paged_attention(q[:, :3], kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="mismatch"):
        ops.paged_attention(q, kp, vp[..., :8], tables, lengths)
    with pytest.raises(ValueError, match="mismatch"):
        ops.paged_attention(q, kp, vp, tables[:1], lengths)
    with pytest.raises(TypeError):
        ops.paged_attention(q.half(), kp, vp, tables, lengths)
    with pytest.raises(TypeError):
        ops.paged_attention(q, kp, vp, tables.float(), lengths)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                            kp, vp, tables, lengths)
    # the kernel stages pool rows with 16-byte loads: 12-byte rows refused
    q6, kp6, vp6, t6, l6 = (torch.tensor(a) for a in
                            _case(2, 4, 2, 6, 4, 4))
    with pytest.raises(ValueError, match="16-byte"):
        ops.paged_attention(q6.bfloat16(), kp6.bfloat16(), vp6.bfloat16(),
                            t6, l6)


def test_cpu_tensors_take_the_plain_version():
    case = _case(2, 4, 2, 16, 4, 4)
    before = ops.paged_attention.launches
    _port(case, torch.float32)
    assert ops.paged_attention.launches == before


# The kernel's two bodies: ``ops.body`` routes by q and pool dtype and
# head_dim alone.
@pytest.mark.parametrize("pool", [torch.bfloat16, torch.int8,
                                  torch.float8_e4m3fn])
@pytest.mark.parametrize("D", [16, 128])
def test_bf16_queries_on_bf16_and_narrow_pools_run_the_split_body(pool, D):
    assert ops.body(torch.bfloat16, pool, D) == "split_mma"


@pytest.mark.parametrize("q_dtype,pool,D", [
    (torch.float32, torch.float32, 128),     # f32 q and pool
    (torch.float32, torch.bfloat16, 128),    # f32 q
    (torch.float32, torch.int8, 16),         # f32 q on a narrow pool
    (torch.bfloat16, torch.float32, 128),    # f32 pool
    (torch.bfloat16, torch.bfloat16, 20),    # head_dim not a multiple of 16
    (torch.bfloat16, torch.bfloat16, 8),
    (torch.bfloat16, torch.bfloat16, 272),   # over 256
])
def test_other_operands_run_the_cuda_core_body(q_dtype, pool, D):
    assert ops.body(q_dtype, pool, D) == "cuda_core"


@pytest.mark.parametrize("T", [1, 4, 8, 16, 20, 64, 128])
@pytest.mark.parametrize("D", [16, 128])
def test_split_partitions_are_fixed_by_block_and_head_width(T, D):
    """A row's partitions are [0, P), [P, 2P), ... up to its limit, with P
    a function of (T, D) alone — nothing of Q, the row tile or a slot's
    length enters it — made of whole 64-position chunks and whole pool
    blocks, at most 512 blocks a partition."""
    import inspect

    P = ops.partition_positions(T, D)
    assert list(inspect.signature(ops.partition_positions).parameters) == [
        "T", "D"]
    assert P % 64 == 0 and P % T == 0 and P // T <= 512
    if 64 % T == 0:
        assert P == 128
    assert [ops.row_tile(n) for n in (1, 4, 16, 17, 20, 32, 33, 256)] == [
        16, 16, 16, 32, 32, 32, 64, 64]


def test_cpu_call_counts_no_launch_of_either_body():
    case = _case(2, 4, 2, 16, 4, 3)
    before = dict(ops.paged_attention.body_launches)
    _port(case, torch.bfloat16)
    assert ops.paged_attention.body_launches == before
    assert set(before) == {"split_mma", "cuda_core"}
