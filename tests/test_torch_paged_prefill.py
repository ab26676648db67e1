"""The port's multi-query paged attention (kernel B2's plain version)
against the JAX reference kernel.

``repro_torch.kernels.paged_attention.ref.paged_prefill_attention_ref``
is held against the JAX ``paged_prefill_attention`` run as
``tests/test_kernels.py`` runs it (interpret mode), on the same numpy
inputs drawn from seeded generators, and against the port's own decode
plain version (B1's), which every one of its rows must equal bit for bit
at that row's limit.  The CUDA kernel is held against it on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.paged_attention.ops import (
    paged_prefill_attention as jax_prefill)
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import ref as port_ref


def _case(B, H, KV, D, T, nb, Q, *, extra_rows=2, seed=3):
    """Q queries per slot whose K/V are the last Q of ``start + Q``
    positions, random starts; real blocks cover each slot's prefix and
    NULL (row 0) entries lie past it (``tests/test_kernels.py``'s
    ``_paged_prefill_case``)."""
    r = np.random.default_rng(seed)
    lengths = (r.integers(0, nb * T - Q + 1, B) + Q).astype(np.int32)
    R = 1 + B * nb + extra_rows
    kp = r.normal(size=(R, T, KV, D)).astype(np.float32)
    vp = r.normal(size=(R, T, KV, D)).astype(np.float32)
    tables = np.zeros((B, nb), np.int32)
    free = list(range(1, R))
    r.shuffle(free)
    for b in range(B):
        for j in range(-(-int(lengths[b]) // T)):
            tables[b, j] = free.pop()
    q = r.normal(size=(B, Q, H, D)).astype(np.float32)
    return q, kp, vp, tables, lengths


def _jax(case, dtype):
    q, kp, vp, tables, lengths = case
    out = jax_prefill(jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
                      jnp.asarray(vp, dtype), jnp.asarray(tables),
                      jnp.asarray(lengths))
    return np.asarray(out.astype(jnp.float32))


def _torch(case, dtype):
    q, kp, vp, tables, lengths = case
    return (torch.tensor(q).to(dtype), torch.tensor(kp).to(dtype),
            torch.tensor(vp).to(dtype), torch.tensor(tables),
            torch.tensor(lengths))


def _port(case, dtype):
    out = ops.paged_prefill_attention(*_torch(case, dtype))
    assert out.dtype == dtype
    return out.float().numpy()


def _bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("dims", [
    (3, 4, 2, 16, 4, 8, 5),    # GQA, Q coprime with T: rows cross blocks
    (2, 2, 2, 32, 8, 4, 8),    # MHA, Q == T
    (1, 3, 1, 16, 4, 3, 2),    # single kv head, odd group
    (2, 8, 2, 16, 16, 2, 11),  # big blocks, Q > T/2, partial final block
])
def test_prefill_ref_matches_jax_kernel_f32(dims):
    """float32: reduction-order noise only (rtol 1e-5, atol 1e-6)."""
    case = _case(*dims)
    np.testing.assert_allclose(_port(case, torch.float32),
                               _jax(case, jnp.float32),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dims", [
    (3, 4, 2, 16, 4, 6, 5),     # smoke head_dim: scale 0.25 is exact
    (2, 8, 2, 128, 16, 4, 7),   # qwen3-8b head_dim: the scale rounds in bf16
])
def test_prefill_ref_matches_jax_kernel_bf16_within_one_ulp(dims):
    """bf16: every output within ONE bf16 ulp of the JAX kernel's (the
    rounding sites match; only float32 reduction order differs)."""
    case = _case(*dims, seed=4)
    got, want = _port(case, torch.bfloat16), _jax(case, jnp.bfloat16)
    assert np.all(np.abs(got - want) <= _bf16_ulp(want)), \
        np.abs(got - want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_rows_are_the_decode_version_at_their_limits(dtype):
    """Q=1 is the decode plain version, and every row of a window is the
    decode plain version called with ``lengths = that row's limit``, bit
    for bit — the property that makes chunked prefill and O7 verify give
    the tokens plain decoding gives."""
    q, kp, vp, tables, lengths = _torch(_case(3, 8, 2, 128, 16, 4, 5,
                                              seed=6), dtype)
    win = port_ref.paged_prefill_attention_ref(q, kp, vp, tables, lengths)
    for qi in range(5):
        one = port_ref.paged_attention_ref(q[:, qi], kp, vp, tables,
                                           lengths - (4 - qi))
        assert torch.equal(win[:, qi], one), qi
    q1 = port_ref.paged_prefill_attention_ref(q[:, :1], kp, vp, tables,
                                              lengths)
    assert torch.equal(q1[:, 0], port_ref.paged_attention_ref(
        q[:, 0], kp, vp, tables, lengths))


def test_prefill_null_and_future_garbage_never_leak():
    """NaN in the NULL block, in unreferenced rows and at every position
    past each slot's length — and NaN in the window's own later
    positions, past an earlier row's limit — changes no output bit of
    the rows that cannot see them."""
    q, kp, vp, tables, lengths = _case(3, 4, 2, 16, 4, 6, 5, seed=11)
    clean = _port((q, kp, vp, tables, lengths), torch.float32)
    kp2, vp2 = kp.copy(), vp.copy()
    T = kp.shape[1]
    referenced = {}
    for b in range(3):
        for j in range(-(-int(lengths[b]) // T)):
            row = int(tables[b, j])
            referenced[row] = min(int(lengths[b]) - j * T, T)
    for row in range(kp.shape[0]):
        kp2[row, referenced.get(row, 0):] = np.nan
        vp2[row, referenced.get(row, 0):] = np.nan
    dirty = _port((q, kp2, vp2, tables, lengths), torch.float32)
    assert np.isfinite(dirty).all()
    assert np.array_equal(clean, dirty)
    # The window's last position (row Q-1's own K/V) poisoned: rows
    # 0..Q-2 cannot see it.
    for b in range(3):
        p = int(lengths[b]) - 1
        kp2[tables[b, p // T], p % T] = np.nan
        vp2[tables[b, p // T], p % T] = np.nan
    late = _port((q, kp2, vp2, tables, lengths), torch.float32)
    assert np.array_equal(late[:, :-1], clean[:, :-1])
    assert np.isnan(late[:, -1]).all()


def test_prefill_row_without_positions_gives_zeros():
    """A row whose limit is below 1 (lengths < Q, which the engine never
    passes) attends nothing and gives zeros, as B1 does for length 0."""
    q, kp, vp, tables, lengths = _case(2, 4, 2, 16, 4, 3, 4, seed=2)
    lengths[0] = 2                       # rows 0 and 1 of slot 0: limit <= 0
    out = _port((q, kp, vp, tables, lengths), torch.float32)
    assert np.array_equal(out[0, :2], np.zeros_like(out[0, :2]))
    assert np.abs(out[0, 2:]).max() > 0


def test_prefill_rejects_bad_shapes_and_dtypes():
    q, kp, vp, tables, lengths = _torch(_case(2, 4, 2, 16, 4, 4, 3),
                                        torch.float32)
    with pytest.raises(ValueError, match="want q"):
        ops.paged_prefill_attention(q[:, 0], kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="multiple"):
        ops.paged_prefill_attention(q[:, :, :3], kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="mismatch"):
        ops.paged_prefill_attention(q, kp, vp[..., :8], tables, lengths)
    with pytest.raises(ValueError, match="mismatch"):
        ops.paged_prefill_attention(q, kp, vp, tables, lengths[:1])
    with pytest.raises(TypeError):
        ops.paged_prefill_attention(q.half(), kp, vp, tables, lengths)
    with pytest.raises(TypeError):
        ops.paged_prefill_attention(q, kp, vp, tables, lengths.float())
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_prefill_attention(q.transpose(1, 2).contiguous()
                                    .transpose(1, 2), kp, vp, tables,
                                    lengths)
    q6, kp6, vp6, t6, l6 = _torch(_case(2, 4, 2, 6, 4, 4, 3), torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        ops.paged_prefill_attention(q6, kp6, vp6, t6, l6)


def test_prefill_cpu_tensors_take_the_plain_version():
    case = _case(2, 4, 2, 16, 4, 4, 3)
    before = ops.paged_prefill_attention.launches
    want = port_ref.paged_prefill_attention_ref(*_torch(case, torch.float32))
    assert np.array_equal(_port(case, torch.float32), want.numpy())
    assert ops.paged_prefill_attention.launches == before


def test_kernel_entry_points_resolve_once(monkeypatch):
    """A launch must not rebuild or re-hash the kernel library: the C
    entry point is looked up once per process."""
    from repro_torch.kernels.paged_attention import kernel

    loads = []

    class Fn:
        argtypes = restype = None

    class FakeLib:
        paged_attention_decode = Fn()

    def load(name, sources):
        loads.append(name)
        return FakeLib

    monkeypatch.setattr(kernel._build, "load_library", load)
    kernel._entry.cache_clear()
    try:
        first = kernel._entry("paged_attention_decode", 6)
        assert kernel._entry("paged_attention_decode", 6) is first
        assert loads == ["paged_attention"]
        # 8 pointers (q, k/v pools, k/v scales, tables, lengths, out),
        # 6 dims, q_bf16, kv_kind, scale, stream
        assert len(first.argtypes) == 18
    finally:
        kernel._entry.cache_clear()


# The split body's arithmetic (``csrc/paged_attention_split.cu``) in
# plain torch: positions in partitions of P at fixed offsets, each
# partition's online (m, l) chunk by chunk, the row's statistics combined
# over its partitions in partition order, p rounded with them, each
# partition's p V in f32 and the partials summed in partition order.  It
# bounds the algorithm's error on the CPU; the card holds the kernel to
# the plain version and B2's rows to B1 bit for bit.
def _split_emulation(q, kp, vp, tables, lengths, P):
    B, Q, H, D = q.shape
    _, T, KV, _ = kp.shape
    G, S = H // KV, tables.shape[1] * T
    rows = tables.reshape(-1).long()
    k = kp.index_select(0, rows).reshape(B, S, KV, D).float()
    v = vp.index_select(0, rows).reshape(B, S, KV, D).float()
    pos = torch.arange(S)
    lim = (lengths.long()[:, None] - (Q - 1 - torch.arange(Q))).clamp(max=S)
    valid = (pos[None, None] < lim[:, :, None])[:, None, None]  # B,1,1,Q,S
    v = torch.where((pos[None] < lim.amax(1, keepdim=True))[..., None, None],
                    v, 0.0)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(B, Q, KV, G, D).float(),
                     k)
    s = s.to(q.dtype).float() * port_ref.kernel_scale(D, q.dtype)
    n_part = -(-S // P)
    nq = (lim.clamp(min=0) + P - 1) // P                        # (B, Q)
    ms, ls = [], []
    for part in range(n_part):
        m = torch.full(s.shape[:-1], -1e30)
        l = torch.zeros(s.shape[:-1])
        for c0 in range(part * P, min((part + 1) * P, S), 64):
            sc, cm = s[..., c0:c0 + 64], valid[..., c0:c0 + 64]
            has = cm.any(-1)
            m_new = torch.where(has, torch.maximum(
                m, torch.where(cm, sc, -1e30).amax(-1)), m)
            e = torch.where(cm, torch.exp(sc - m_new[..., None]), 0.0)
            l = torch.where(has, l * torch.exp(m - m_new) + e.sum(-1), l)
            m = m_new
        ms.append(m)
        ls.append(l)
    used = [(part < nq)[:, None, None] for part in range(n_part)]
    m = torch.full(s.shape[:-1], -1e30)
    for part in range(n_part):
        m = torch.where(used[part], torch.maximum(m, ms[part]), m)
    l = torch.zeros(s.shape[:-1])
    for part in range(n_part):
        l = torch.where(used[part],
                        l + ls[part] * torch.exp(ms[part] - m), l)
    p = torch.exp(s - m[..., None]) / l.clamp_min(1e-30)[..., None]
    p = torch.where(valid, p.to(q.dtype).float(), 0.0)
    out = torch.zeros(B, KV, G, Q, D)
    for part in range(n_part):
        sl = slice(part * P, (part + 1) * P)
        partial = torch.einsum("bkgqs,bskd->bkgqd", p[..., sl], v[:, sl])
        out = torch.where(used[part][..., None], out + partial, out)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Q, H, D).to(q.dtype)


@pytest.mark.parametrize("dims", [
    (3, 4, 2, 16, 4, 40, 5),    # smoke width, 160 positions
    (2, 8, 2, 128, 16, 24, 7),  # qwen3-8b head_dim, 384 positions
    (2, 8, 2, 128, 16, 24, 1),  # decode (B1 is Q = 1)
])
@pytest.mark.parametrize("P", [64, 128, None])
def test_split_arithmetic_matches_jax_kernel_bf16(dims, P):
    """The split arithmetic in bf16 against the JAX kernel, at P = 64
    and 128 (several partitions) and the routed P: within two bf16 ulps
    of the row's largest output plus 1e-3, the card's tolerance."""
    case = _case(*dims, seed=8)
    t = _torch(case, torch.bfloat16)
    P = P or ops.partition_positions(t[1].shape[1], t[0].shape[-1])
    got = _split_emulation(*t, P).float().numpy()
    want = _jax(case, jnp.bfloat16)
    row = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-3 + 1.6e-2 * row), \
        np.abs(got - want).max()


def test_split_arithmetic_skips_empty_partitions_and_garbage():
    """A zero-length slot gets zeros; a row's empty partitions are
    skipped, never combined as (-inf, 0); NaN past every length (the
    NULL block, unused rows, stale tails) changes no bit."""
    q, kp, vp, tables, lengths = _torch(_case(3, 4, 2, 16, 4, 40, 1,
                                              seed=9), torch.bfloat16)
    lengths = torch.tensor([0, 70, 160], dtype=torch.int32)
    clean = _split_emulation(q, kp, vp, tables, lengths, 64)
    assert (clean[0] == 0).all() and torch.isfinite(clean).all()
    kp2, vp2 = kp.clone(), vp.clone()
    used = {int(tables[b, j]) for b in range(3)
            for j in range(-(-int(lengths[b]) // 4))}
    for row in set(range(kp.shape[0])) - used:
        kp2[row] = float("nan")
        vp2[row] = float("nan")
    kp2[int(tables[1, 70 // 4]), 70 % 4:] = float("nan")
    vp2[int(tables[1, 70 // 4]), 70 % 4:] = float("nan")
    assert torch.equal(_split_emulation(q, kp2, vp2, tables, lengths, 64),
                       clean)
    want = port_ref.paged_prefill_attention_ref(q, kp, vp, tables, lengths)
    err = (clean.float() - want.float()).abs()
    assert (err <= 1e-3 + 1.6e-2 * want.float().abs().amax(-1,
                                                            keepdim=True)).all()
