"""Tests that need an NVIDIA GPU: the port's CUDA kernels (B1 decode, B2
multi-query, both on wide and narrow int8 / fp8 pools and in both bodies
— bf16 q on the split mma.sync body, f32 on the CUDA cores —, B3 flash
attention in both bodies — bf16 on mma.sync, f32 on the CUDA cores —,
B4 RWKV-6 WKV and B5 Mamba-2 SSD in both bodies — the chunk-parallel
3xTF32 mma.sync body for the shapes their routers send it, the CUDA-core
body otherwise —, B6/B7 tiled matmul, B6 in its three
bodies — bf16 tiles on wgmma fed by TMA, the f32 rungs with a block per
tile on 3xTF32 mma.sync, the rest on the CUDA cores) against
their plain PyTorch versions on the card; the MachSuite byte kernels
(aes, kmp, nw) at every level on the card against their oracles; and the
recurrent serving steps of rwkv6 and mamba2 (no kernel: the same torch
ops) on the card against the CPU; and whisper's shapes: B1 / B1q at
H = KV = 8, D = 64, B3 non-causal with fewer keys than queries, and the
enc-dec decode, paged and prefill steps on the card against the CPU.
They carry the ``cuda`` marker and
skip without a card; run them there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch and the port only (the card's machine has no
JAX).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import ops, ref


def _case(B, H, KV, D, T, nb, *, dtype, seed=5, device="cuda", Q=None,
          lengths=None, stale_tails=False):
    """A shuffled pool with NaN in the NULL block and unreferenced rows
    (and, with ``stale_tails``, in every slot's block past its length);
    ``Q`` gives q a query axis (B, Q, H, D); ``lengths`` (default random,
    >= Q, the first nb * T) sets every slot's length."""
    r = np.random.default_rng(seed)
    if lengths is None:
        lengths = r.integers(Q or 1, nb * T + 1, B).astype(np.int32)
        lengths[0] = nb * T
    lengths = np.asarray(lengths, np.int32)
    R = 1 + B * nb + 3
    kp = r.normal(size=(R, T, KV, D)).astype(np.float32)
    vp = r.normal(size=(R, T, KV, D)).astype(np.float32)
    tables = np.zeros((B, nb), np.int32)
    free = list(range(1, R))
    r.shuffle(free)
    used = set()
    for b in range(B):
        for j in range(-(-int(lengths[b]) // T)):
            tables[b, j] = free.pop()
            used.add(int(tables[b, j]))
    for row in set(range(R)) - used:
        kp[row] = np.nan
        vp[row] = np.nan
    for b, L in enumerate(lengths.tolist()):
        if stale_tails and L % T:
            kp[tables[b, L // T], L % T:] = np.nan
            vp[tables[b, L // T], L % T:] = np.nan
    q = r.normal(size=(B, H, D) if Q is None else (B, Q, H, D)).astype(
        np.float32)
    to = lambda a, dt=dtype: torch.tensor(a).to(device=device, dtype=dt)
    return (to(q), to(kp), to(vp), to(tables, torch.int32),
            to(lengths, torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,dtype", [
    ((8, 32, 8, 128, 16, 128), torch.bfloat16),   # qwen3-8b main path
    ((3, 4, 2, 16, 4, 6), torch.bfloat16),        # smoke width
    ((4, 8, 8, 64, 8, 5), torch.float32),         # G = 1, f32 pool
])
def test_paged_attention_kernel_matches_plain(dims, dtype):
    """bf16 within two bf16 ulps plus 1e-3; f32 within rtol 1e-4 /
    atol 1e-5 (reduction order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    case = _case(*dims, dtype=dtype)
    before = ops.paged_attention.launches
    got = ops.paged_attention(*case)
    torch.cuda.synchronize()
    assert ops.paged_attention.launches == before + 1
    want = ref.paged_attention_ref(*case)
    assert torch.isfinite(got).all()
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=1.6e-2, atol=1e-3)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,Q,dtype", [
    ((8, 32, 8, 128, 16, 128), 5, torch.bfloat16),   # qwen3-8b verify
    ((1, 32, 8, 128, 16, 64), 64, torch.bfloat16),   # qwen3-8b chunk
    ((3, 4, 2, 16, 4, 6), 3, torch.bfloat16),        # smoke width
    ((4, 8, 8, 64, 8, 5), 7, torch.float32),         # G = 1, f32 pool
])
def test_paged_prefill_kernel_matches_plain_and_b1(dims, Q, dtype):
    """B2 against its plain version (bf16: two bf16 ulps of the row's
    largest output plus 1e-3 — a short row's near-1 probabilities move
    its every output when one rounds the other way; f32: rtol 1e-4 /
    atol 1e-5), and every row bitwise equal to B1 at that row's limit
    (Q=1 included)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    case = _case(*dims, dtype=dtype, Q=Q)
    before = ops.paged_prefill_attention.launches
    got = ops.paged_prefill_attention(*case)
    torch.cuda.synchronize()
    assert ops.paged_prefill_attention.launches == before + 1
    want = ref.paged_prefill_attention_ref(*case)
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs()
    row = want.float().abs().amax(dim=-1, keepdim=True)
    if dtype == torch.bfloat16:
        assert (err <= 1e-3 + 1.6e-2 * row).all(), float(err.max())
    else:
        assert (err <= 1e-5 + 1e-4 * row).all(), float(err.max())
    q, kp, vp, tables, lengths = case
    for qi in range(Q):
        one = ops.paged_attention(q[:, qi].contiguous(), kp, vp, tables,
                                  lengths - (Q - 1 - qi))
        assert torch.equal(one, got[:, qi]), qi
    q1 = ops.paged_prefill_attention(q[:, :1].contiguous(), kp, vp, tables,
                                     lengths)
    assert torch.equal(q1[:, 0], ops.paged_attention(
        q[:, 0].contiguous(), kp, vp, tables, lengths))


def _quant_case(dims, kvd, *, Q=None, seed=6):
    """``_case`` in f32 quantized per (row, kv head) block to an int8 or
    fp8 pool with (R, KV) scales; the unreferenced rows (the NULL block
    among them) get NaN scales, and NaN bytes in an fp8 pool."""
    from repro_torch.serving import kvquant

    q, kp, vp, tables, lengths = _case(*dims, dtype=torch.float32,
                                       seed=seed, Q=Q)
    out = [q.bfloat16()]
    for pool in (kp, vp):
        unused = torch.isnan(pool).flatten(1).any(1)
        x = torch.nan_to_num(pool)
        s = kvquant.block_scale(x, (1, 3), kvd)
        w = kvquant.quantize(x, s, kvd)
        s = s[:, 0, :, 0].contiguous()
        s[unused] = float("nan")
        if kvd == "fp8":
            kvquant.as_bytes(w)[unused] = 0x7F
        out += [w, s]
    q, kw, ks, vw, vs = out
    return q, kw, vw, tables, lengths, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("kvd", ["int8", "fp8"])
@pytest.mark.parametrize("dims,Q", [
    ((8, 32, 8, 128, 16, 128), None),   # qwen3-8b decode
    ((8, 32, 8, 128, 16, 128), 5),      # qwen3-8b verify
    ((1, 32, 8, 128, 16, 64), 64),      # qwen3-8b chunk
    ((3, 4, 2, 16, 4, 6), 3),           # smoke width
    ((4, 8, 8, 64, 8, 5), None),        # G = 1
])
def test_quantized_kernel_matches_plain_and_dequantized_pool(kvd, dims, Q):
    """The quantized branch of B1/B2: within two bf16 ulps (of the row's
    largest output for B2) plus 1e-3 of its plain version, and equal bit
    for bit to the kernel on the same pool dequantized to bf16 with no
    scales."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.serving import kvquant

    q, kw, vw, tables, lengths, ks, vs = _quant_case(dims, kvd, Q=Q)
    fn, plain = ((ops.paged_attention, ref.paged_attention_ref) if Q is None
                 else (ops.paged_prefill_attention,
                       ref.paged_prefill_attention_ref))
    before = fn.launches
    got = fn(q, kw, vw, tables, lengths, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.isfinite(got).all()
    want = plain(q, kw, vw, tables, lengths, ks, vs).float()
    err = (got.float() - want).abs()
    row = want.abs().amax(dim=-1, keepdim=True)
    assert (err <= 1e-3 + 1.6e-2 * row).all(), float(err.max())
    wide = fn(q, kvquant.dequantize(kw, ks[:, None, :, None]),
              kvquant.dequantize(vw, vs[:, None, :, None]), tables, lengths)
    assert torch.equal(got, wide)


def _case_at(lengths, *, H=32, KV=8, D=128, T=16, Q=None, nb=None,
             dtype=torch.bfloat16, seed=7):
    """``_case`` at the given lengths (B = len(lengths)), stale tails
    NaN; ``nb`` widens the tables past the longest length."""
    return _case(len(lengths), H, KV, D, T,
                 nb or max(1, -(-max(lengths) // T)), dtype=dtype, seed=seed,
                 Q=Q, lengths=lengths, stale_tails=True)


def _held_split(case, *, narrow=None):
    """B1 (3-D q) or B2 on the split body against the plain version
    (two bf16 ulps plus 1e-3; of the row's largest output for B2), every
    B2 row bitwise equal to B1 at its limit, a narrow pool's output
    bitwise equal to the kernel on its dequantized pool; asserts each
    call ran the split body once."""
    from repro_torch.serving import kvquant

    q = case[0]
    prefill = q.dim() == 4
    fn, plain = ((ops.paged_prefill_attention,
                  ref.paged_prefill_attention_ref) if prefill else
                 (ops.paged_attention, ref.paged_attention_ref))
    kw = {} if narrow is None else dict(k_scale=narrow[0], v_scale=narrow[1])
    before = dict(fn.body_launches)
    got = fn(*case, **kw)
    torch.cuda.synchronize()
    assert fn.body_launches == {**before,
                                "split_mma": before["split_mma"] + 1}
    assert torch.isfinite(got).all()
    want = plain(*case, *(narrow or ())).float()
    err = (got.float() - want).abs()
    scale = want.abs().amax(dim=-1, keepdim=True) if prefill else want.abs()
    assert (err <= 1e-3 + 1.6e-2 * scale).all(), float(err.max())
    if prefill:
        q, kp, vp, tables, lengths = case
        Q = q.shape[1]
        for qi in range(Q):
            one = ops.paged_attention(q[:, qi].contiguous(), kp, vp, tables,
                                      lengths - (Q - 1 - qi), **kw)
            assert torch.equal(one, got[:, qi]), qi
    if narrow is not None:
        ks, vs = narrow
        wide = fn(case[0], kvquant.dequantize(case[1], ks[:, None, :, None]),
                  kvquant.dequantize(case[2], vs[:, None, :, None]),
                  *case[3:])
        assert torch.equal(got, wide)
    return got


# The split body's partitions: P positions at fixed offsets (256 at
# T = 16, D = 128; ops.partition_positions).
def _P(T=16, D=128):
    return ops.partition_positions(T, D)


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [
    [2048, 4096, 1, 300],                                  # many partitions
    [_P() - 1, _P(), _P() + 1, 2 * _P(), 2 * _P() + 1],    # at the edges
    [0, 40, 3],                                            # a zero length
    [17] * 4,
])
@pytest.mark.parametrize("G", [4, 1])
def test_split_body_decode_matches_plain(lengths, G):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    case = _case_at(lengths, H=8 * G, KV=8)
    out = _held_split(case)
    for b, L in enumerate(lengths):
        if L == 0:
            assert (out[b] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("lengths,Q", [
    ([960 + 64], 64),                       # the main path's chunk
    ([_P() + 30], 64),                      # a chunk across a partition
    ([2 * _P() + 2, _P() + 1, _P() + 4, 5, 3000], 5),  # verify across
    ([4096], 64),                           # a long prefix
    ([64], 64),                             # a first chunk
])
def test_split_body_prefill_matches_plain_and_b1_bitwise(lengths, Q):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    _held_split(_case_at(lengths, Q=Q))


@pytest.mark.cuda
def test_split_body_at_smoke_width_and_a_padded_table():
    """D = 16, T = 4 (the smoke configs), and a table wider than every
    length (the NULL block past each slot)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    _held_split(_case_at([1, 9, 300, 257], H=4, KV=2, D=16, T=4, nb=100))
    _held_split(_case_at([3, 9, 300, 257], H=4, KV=2, D=16, T=4, Q=3,
                         nb=100))
    _held_split(_case_at([200, 7], H=32, KV=8, D=64, T=8, Q=5, nb=40))


@pytest.mark.cuda
@pytest.mark.parametrize("kvd", ["int8", "fp8"])
@pytest.mark.parametrize("lengths,Q", [
    ([2048, 4096, 0, _P() - 1, _P() + 1], None),
    ([_P() + 30], 64),
    ([2 * _P() + 2, _P() + 1, 5], 5),
])
def test_split_body_narrow_pools_equal_their_dequantized_pools(kvd,
                                                              lengths, Q):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.serving import kvquant

    q, kp, vp, tables, lens = _case_at(lengths, Q=Q, dtype=torch.float32)
    out = [q.bfloat16()]
    scales = []
    for pool in (kp, vp):
        # NaN bytes (0x7f: NaN in fp8, 127 in int8) wherever the pool
        # held NaN, NaN scales on the rows that are NaN throughout.
        bad = torch.isnan(pool)
        x = torch.nan_to_num(pool)
        sc = kvquant.block_scale(x, (1, 3), kvd)
        w = kvquant.quantize(x, sc, kvd)
        kvquant.as_bytes(w)[bad] = 0x7F
        sc = sc[:, 0, :, 0].contiguous()
        sc[bad.flatten(1).all(1)] = float("nan")
        out.append(w)
        scales.append(sc)
    _held_split((out[0], out[1], out[2], tables, lens), narrow=scales)


# zamba2-2.7b's shared attention: H = KV = 32 (group 1, so a 16-row
# tile with one live row), head_dim 80 (2560 / 32: the split body's D =
# 128 instance, 5 of its k-steps and 10 n8 tiles of V live), T = 16; its
# phase-11 lengths (prompts of 129..200 tokens and 16 new) cross the
# 128-position partition, so every slot runs two partitions and the
# combine.
_ZAMBA2_LENGTHS = [129, _P(16, 80), _P(16, 80) + 1, 150, 200, 216, 1, 255]


@pytest.mark.cuda
@pytest.mark.parametrize("kvd", ["bf16", "int8"])
def test_split_body_at_zamba2_shape_matches_plain(kvd):
    """B1 (bf16 pool) and B1q (int8 pool) at zamba2's shape against the
    plain version; B1q bitwise equal to B1 on its dequantized pool."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.serving import kvquant

    assert ops.body(torch.bfloat16, torch.bfloat16, 80) == "split_mma"
    assert (ops.partition_positions(16, 80), ops.row_tile(1)) == (128, 16)
    case = _case_at(_ZAMBA2_LENGTHS, H=32, KV=32, D=80, T=16)
    if kvd == "bf16":
        _held_split(case)
        return
    q, kp, vp, tables, lens = _case_at(_ZAMBA2_LENGTHS, H=32, KV=32, D=80,
                                       T=16, dtype=torch.float32)
    words, scales = [], []
    for pool in (kp, vp):
        bad = torch.isnan(pool)
        x = torch.nan_to_num(pool)
        sc = kvquant.block_scale(x, (1, 3), kvd)
        w = kvquant.quantize(x, sc, kvd)
        kvquant.as_bytes(w)[bad] = 0x7F
        sc = sc[:, 0, :, 0].contiguous()
        sc[bad.flatten(1).all(1)] = float("nan")
        words.append(w)
        scales.append(sc)
    _held_split((q.bfloat16(), words[0], words[1], tables, lens),
                narrow=scales)


@pytest.mark.cuda
def test_f32_operands_still_run_the_cuda_core_body():
    """f32 q on f32 and bf16 pools, and bf16 q on an f32 pool, run the
    CUDA-core body, held to the plain version in f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    q, kp, vp, tables, lengths = _case_at([7, 300, 1024],
                                          dtype=torch.float32)
    bf, f32 = torch.bfloat16, torch.float32
    for q_dt, pool_dt in ((f32, f32), (f32, bf), (bf, f32)):
        args = (q.to(q_dt), kp.to(pool_dt), vp.to(pool_dt), tables, lengths)
        before = dict(ops.paged_attention.body_launches)
        got = ops.paged_attention(*args)
        torch.cuda.synchronize()
        assert ops.paged_attention.body_launches == {
            **before, "cuda_core": before["cuda_core"] + 1}
        want = ref.paged_attention_ref(*args)
        if q_dt == f32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=1.6e-2, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("kvd", ["int8", "fp8"])
@pytest.mark.parametrize("attn", ["gather", "kernel"])
def test_narrow_pool_engine_on_the_card_within_contract_of_the_cpu(kvd,
                                                                   attn):
    """The smoke qwen3-8b engine at O6 on an int8 / fp8 pool, chunked
    prefill 3, on the card and on the CPU from the same weights: tokens
    within the dtype's tolerance contract of each other, the card's
    bit-identical from run to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.core.optlevel import BestEffortConfig, OptLevel
    from repro_torch.models import get_model
    from repro_torch.serving import DecodeEngine, Request, kvquant
    from repro_torch.tree import map_tree

    cfg = dataclasses.replace(get_smoke("qwen3-8b"), compute_dtype="float32")
    params = get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    mix = [(rng.integers(1, cfg.vocab, int(rng.integers(1, 12))).tolist(),
            int(rng.integers(1, 8))) for _ in range(8)]

    def run(device):
        model = get_model(cfg, device=device)
        p = map_tree(lambda t: t.to(device), params)
        eng = DecodeEngine(model, p, batch_size=4, max_seq=32,
                           config=BestEffortConfig(
                               level=OptLevel.O6, paged_attn=attn,
                               kv_dtype=kvd, kv_block_size=4,
                               kv_pool_blocks=20, prefill_chunk=3))
        rids = [eng.submit(Request(prompt=list(pr), max_new_tokens=n))
                for pr, n in mix]
        fin = {r.rid: r.generated for r in eng.run()}
        return [fin[r] for r in rids]

    card = run("cuda")
    assert run("cuda") == card
    kvquant.assert_tokens_match(run("cpu"), card,
                                kvquant.tolerance_contract(kvd),
                                f"{kvd}/{attn} card vs cpu")


def _flash_case(B, S, S_kv, H, Hkv, D, *, dtype, seed=7):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    return mk(B, S, H, D), mk(B, S_kv, Hkv, D), mk(B, S_kv, Hkv, D)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,causal", [
    ((2, 1024, 1024, 15, 5, 64), True),    # smollm-360m's heads
    ((1, 512, 512, 32, 8, 128), True),     # qwen3-8b's heads
    ((2, 64, 1024, 4, 2, 64), True),       # rectangular causal offset
    ((2, 256, 256, 6, 2, 64), False),      # non-causal
    ((2, 1000, 1000, 6, 2, 128), True),    # ragged S
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_matches_plain(dims, causal, dtype):
    """B3 against its plain version: f32 within 1e-5 of each row's
    largest output (summation order), bf16 within two bf16 ulps of it
    (both round once from f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _flash_case(*dims, dtype=dtype)
    before = fops.flash_attention.launches
    bodies = dict(fops.flash_attention.body_launches)
    got = fops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fops.flash_attention.launches == before + 1
    bodies[fops.body(dtype)] += 1
    assert fops.flash_attention.body_launches == bodies
    want = flash_attention_ref(q, k, v, causal=causal).float()
    assert torch.isfinite(got).all()
    err = (got.float() - want).abs()
    row = want.abs().amax(dim=-1, keepdim=True)
    rtol = 1.6e-2 if dtype == torch.bfloat16 else 1e-5
    assert (err <= rtol * row).all(), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 17, 20, 32, 64, 128, 192, 256])
@pytest.mark.parametrize("dims,causal", [
    ((2, 1000, 1000, 4, 2), True),     # ragged S, GQA 2
    ((2, 64, 700, 6, 2), True),        # rectangular offset, GQA 3
    ((1, 300, 300, 4, 4), False),      # non-causal, G = 1
])
def test_flash_attention_mma_body_at_every_width(D, dims, causal):
    """The bf16 tensor-core body at every compiled width (16 and 17 pad
    to 32, 20 rows of 40 B take the element copies, 17 the scalar
    stores; 192 and 256 take the narrower key tile) against the plain
    version: within two bf16 ulps of each row's largest output (P's
    rounding to bf16 is a relative 2^-9 on top of it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q, k, v = _flash_case(*dims, D, dtype=torch.bfloat16, seed=D)
    before = dict(fops.flash_attention.body_launches)
    got = fops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fops.flash_attention.body_launches == {
        **before, "mma": before["mma"] + 1}
    want = flash_attention_ref(q, k, v, causal=causal).float()
    assert torch.isfinite(got).all()
    err = (got.float() - want).abs()
    row = want.abs().amax(dim=-1, keepdim=True)
    assert (err <= 1.6e-2 * row).all(), float((err / row).max())


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_other_head_dims():
    """Every head_dim up to 256 runs (16 and 20 are the smoke configs',
    20 bf16 values a 40-byte row that takes the scalar loads, 192
    nemotron-4-340b's), held to the plain version as above; 257 raises
    naming the limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    for D in (16, 20, 192):
        for dtype, rtol in ((torch.bfloat16, 1.6e-2), (torch.float32, 1e-5)):
            q, k, v = _flash_case(2, 200, 200, 4, 2, D, dtype=dtype)
            got = fops.flash_attention(q, k, v)
            torch.cuda.synchronize()
            want = flash_attention_ref(q, k, v).float()
            err = (got.float() - want).abs()
            row = want.abs().amax(dim=-1, keepdim=True)
            assert (err <= rtol * row).all(), (D, dtype, float(err.max()))
    q, k, v = _flash_case(1, 16, 16, 2, 1, 257, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim up to 256"):
        fops.flash_attention(q, k, v)


def _wkv_case(B, S, H, N, *, dtype, state, seed=3):
    """Inputs as the model makes them: r, k, v (B, S, H, N) and the
    log-decay lw in [-0.35, 0]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s, sc=0.5: (torch.randn(s, generator=g, device="cuda")
                             * sc).to(dtype)
    lw = -(torch.rand((B, S, H, N), generator=g, device="cuda")
           * 0.35).to(dtype)
    s0 = (torch.randn((B, H, N, N), generator=g, device="cuda") * 0.2
          if state else None)
    return mk(B, S, H, N), mk(B, S, H, N), mk(B, S, H, N), lw, \
        mk(H, N, sc=0.1), s0


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [
    (1, 1024, 40, 64, 128),     # rwkv6-3b's heads
    (2, 64, 4, 16, 64),         # smoke width
    (2, 96, 3, 16, 48),         # Q = 48
    (2, 64, 2, 8, 16),          # N = 8
    (1, 256, 2, 128, 128),      # the widest N, 16 value columns a block
    (1, 60, 2, 10, 30),         # N, Q not multiples of 4
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("state", [False, True])
def test_wkv_kernel_matches_plain(dims, dtype, state):
    """B4 against ``wkv_chunked_ref``: both compute in f32, so y in f32
    and the f32 state within 2e-5 of their largest magnitude; bf16 y
    within one bf16 ulp of each element plus 2e-5 of the scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.rwkv6_wkv import ops as wops
    from repro_torch.kernels.rwkv6_wkv.ref import wkv_chunked_ref

    B, S, H, N, Q = dims
    r, k, v, lw, u, s0 = _wkv_case(B, S, H, N, dtype=dtype, state=state)
    before = wops.wkv.launches
    bodies = dict(wops.wkv.body_launches)
    y, sf = wops.wkv(r, k, v, lw, u, init_state=s0, chunk=Q)
    torch.cuda.synchronize()
    assert wops.wkv.launches == before + 1
    which = wops.body(N, Q)
    assert wops.wkv.body_launches == {**bodies, which: bodies[which] + 1}
    wy, ws = wkv_chunked_ref(r, k, v, lw, u, init_state=s0, chunk=Q)
    assert y.dtype == dtype and sf.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(sf).all()
    es = (sf - ws).abs().max()
    assert es <= 2e-5 * ws.abs().max(), float(es)
    ey = (y.float() - wy.float()).abs()
    scale = wy.float().abs().max()
    if dtype == torch.float32:
        assert ey.max() <= 2e-5 * scale, float(ey.max())
    else:
        assert (ey <= 2.0 ** -7 * wy.float().abs() + 2e-5 * scale).all(), \
            float(ey.max())


@pytest.mark.cuda
def test_wkv_kernel_reads_strided_operands():
    """r, k, v and lw as views with other strides than (B, S, H, N)
    contiguous: the kernel reads them through their strides."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.rwkv6_wkv import ops as wops
    from repro_torch.kernels.rwkv6_wkv.ref import wkv_chunked_ref

    r, k, v, lw, u, s0 = _wkv_case(2, 128, 8, 32, dtype=torch.float32,
                                   state=True)
    wide = torch.cat([r, k], dim=2)          # (B, S, 2H, N)
    rv, kv = wide[:, :, :8], wide[:, :, 8:]
    vt = v.transpose(0, 1).contiguous().transpose(0, 1)
    y, sf = wops.wkv(rv, kv, vt, lw, u, init_state=s0, chunk=64)
    wy, ws = wkv_chunked_ref(r, k, v, lw, u, init_state=s0, chunk=64)
    assert (y - wy).abs().max() <= 2e-5 * wy.abs().max()
    assert (sf - ws).abs().max() <= 2e-5 * ws.abs().max()


@pytest.mark.cuda
def test_wkv_function_gradients_match_autograd_through_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.rwkv6_wkv import ops as wops
    from repro_torch.kernels.rwkv6_wkv.ref import wkv_chunked_ref

    ins = [t.requires_grad_() for t in _wkv_case(
        2, 128, 4, 16, dtype=torch.float32, state=True)]
    g = torch.Generator(device="cuda").manual_seed(8)
    wy = torch.randn(ins[0].shape, generator=g, device="cuda")
    grads = {}
    for name, fn in (("function", wops.wkv), ("plain", wkv_chunked_ref)):
        y, sf = fn(*ins[:5], init_state=ins[5], chunk=64)
        ((y * wy).sum() + sf.sum()).backward()
        grads[name] = [t.grad.clone() for t in ins]
        for t in ins:
            t.grad = None
    for got, want in zip(grads["function"], grads["plain"]):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _ssd_case(B, S, H, P, N, *, dtype, state, strong=False, seed=4):
    """Inputs as the model makes them: dt after softplus (4 dt + 1 under
    ``strong``, so the cumsum of dt A passes -100 within 32 rows), A
    negative, x, Bs, Cs (B, S, ...) and an f32 state or None."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s, sc=0.5: (torch.randn(s, generator=g, device="cuda")
                             * sc).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device="cuda"))
    if strong:
        dt = 4 * dt + 1
    A = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.3)
    s0 = (torch.randn((B, H, P, N), generator=g, device="cuda") * 0.2
          if state else None)
    return (mk(B, S, H, P), dt.to(dtype), A.to(dtype), mk(B, S, N),
            mk(B, S, N), s0)


def _ssd_close(got, want, dtype):
    """y within 2e-5 of its largest magnitude (bf16: plus one bf16 ulp of
    each element), the f32 state within 2e-5 of its largest magnitude:
    both sides compute in f32 and differ in summation order and in where
    the scan's chunks start."""
    (y, sf), (wy, ws) = got, want
    assert y.dtype == dtype and sf.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(sf).all()
    es = (sf - ws).abs().max()
    assert es <= 2e-5 * ws.abs().max(), float(es)
    ey = (y.float() - wy.float()).abs()
    scale = wy.float().abs().max()
    ulp = 2.0 ** -7 * wy.float().abs() if dtype == torch.bfloat16 else 0.0
    assert (ey <= 2e-5 * scale + ulp).all(), float(ey.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [
    (2, 1024, 16, 64, 128, 256),    # mamba2-2.7b's heads and state
    (2, 128, 4, 32, 16, 128),       # smoke width
    (2, 40, 2, 8, 8, 8),            # odd chunk count, S not a tile
    (1, 200, 3, 20, 10, 40),        # P, N not multiples of 4
    (2, 300, 4, 48, 128, 100),      # blocks of 32 and 16 P columns
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("state", [False, True])
def test_ssd_kernel_matches_plain(dims, dtype, state):
    """B5 against ``ssd_chunked_ref`` at the model's chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.mamba2_ssd import ops as sops
    from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked_ref

    B, S, H, P, N, Q = dims
    *ins, s0 = _ssd_case(B, S, H, P, N, dtype=dtype, state=state)
    before = sops.ssd.launches
    bodies = dict(sops.ssd.body_launches)
    got = sops.ssd(*ins, init_state=s0, chunk=Q)
    torch.cuda.synchronize()
    assert sops.ssd.launches == before + 1
    which = sops.body(P, N, Q)
    assert sops.ssd.body_launches == {**bodies, which: bodies[which] + 1}
    _ssd_close(got, ssd_chunked_ref(*ins, init_state=s0, chunk=Q), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_kernel_holds_a_strong_decay(dtype):
    """dt A sums past -100 inside one chunk: a kernel that factorised
    exp(cum_i - cum_j) as exp(cum_i) exp(-cum_j) would overflow."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.mamba2_ssd import ops as sops
    from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked_ref

    *ins, s0 = _ssd_case(2, 512, 4, 64, 128, dtype=dtype, state=True,
                         strong=True)
    cum = torch.cumsum((ins[1].float() * ins[2].float()).reshape(
        2, 2, 256, 4), dim=2)
    assert cum.min() < -100
    bodies = dict(sops.ssd.body_launches)
    got = sops.ssd(*ins, init_state=s0, chunk=256)
    assert sops.ssd.body_launches["chunk_tf32x3"] == \
        bodies["chunk_tf32x3"] + 1
    _ssd_close(got, ssd_chunked_ref(*ins, init_state=s0, chunk=256), dtype)


@pytest.mark.cuda
def test_ssd_kernel_reads_strided_operands():
    """x, Bs and Cs as column slices of one (B, S, H P + 2 N) tensor, as
    ``mamba2_apply`` passes them: the kernel reads them through their
    strides."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.mamba2_ssd import ops as sops
    from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked_ref

    B, S, H, P, N = 2, 512, 8, 64, 128
    x, dt, A, Bs, Cs, s0 = _ssd_case(B, S, H, P, N, dtype=torch.bfloat16,
                                     state=True)
    conv = torch.cat([x.reshape(B, S, H * P), Bs, Cs], dim=-1)
    xv = conv[..., :H * P].reshape(B, S, H, P)
    bv, cv = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    assert not xv.is_contiguous() and not bv.is_contiguous()
    got = sops.ssd(xv, dt, A, bv, cv, init_state=s0, chunk=256)
    _ssd_close(got, ssd_chunked_ref(x, dt, A, Bs, Cs, init_state=s0,
                                    chunk=256), torch.bfloat16)


@pytest.mark.cuda
def test_ssd_function_gradients_match_autograd_through_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.mamba2_ssd import ops as sops
    from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked_ref

    ins = [t.requires_grad_() for t in _ssd_case(
        2, 256, 4, 32, 16, dtype=torch.float32, state=True)]
    g = torch.Generator(device="cuda").manual_seed(8)
    wy = torch.randn(ins[0].shape, generator=g, device="cuda")
    grads = {}
    for name, fn in (("function", sops.ssd), ("plain", ssd_chunked_ref)):
        y, sf = fn(*ins[:5], init_state=ins[5], chunk=64)
        ((y * wy).sum() + sf.sum()).backward()
        grads[name] = [t.grad.clone() for t in ins]
        for t in ins:
            t.grad = None
    for got, want in zip(grads["function"], grads["plain"]):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
def test_ssd_kernel_rejects_wide_heads():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.mamba2_ssd import ops as sops

    *ins, _ = _ssd_case(1, 64, 2, 72, 16, dtype=torch.bfloat16,
                        state=False)
    with pytest.raises(ValueError, match="P <= 64"):
        sops.ssd(*ins)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [
    (2, 96, 3, 16, 32),         # the shortest chunk the body takes
    (1, 128, 2, 64, 128),       # one chunk: S = Q
    (2, 512, 5, 32, 64),
    (1, 256, 3, 48, 128),       # N = 48: 16-wide tiles
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("state", [False, True])
def test_wkv_chunk_body_matches_plain_at_chunk_edges(dims, dtype, state):
    """B4's chunk body at the edges of what it takes, held to
    ``wkv_chunked_ref`` as ``test_wkv_kernel_matches_plain`` holds it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.rwkv6_wkv import ops as wops
    from repro_torch.kernels.rwkv6_wkv.ref import wkv_chunked_ref

    B, S, H, N, Q = dims
    assert wops.body(N, Q) == "chunk_tf32x3"
    r, k, v, lw, u, s0 = _wkv_case(B, S, H, N, dtype=dtype, state=state)
    before = wops.wkv.body_launches["chunk_tf32x3"]
    got = wops.wkv(r, k, v, lw, u, init_state=s0, chunk=Q)
    torch.cuda.synchronize()
    assert wops.wkv.body_launches["chunk_tf32x3"] == before + 1
    _ssd_close(got, wkv_chunked_ref(r, k, v, lw, u, init_state=s0, chunk=Q),
               dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wkv_chunk_body_holds_the_strongest_decay(dtype):
    """lw at the clamp's edge, [-0.35, -0.3]: cum reaches ~-45 across a
    128-row chunk, and ri, kj span e^+-45."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.rwkv6_wkv import ops as wops
    from repro_torch.kernels.rwkv6_wkv.ref import wkv_chunked_ref

    r, k, v, _, u, s0 = _wkv_case(2, 512, 4, 64, dtype=dtype, state=True)
    g = torch.Generator(device="cuda").manual_seed(11)
    lw = (-0.3 - 0.05 * torch.rand(r.shape, generator=g, device="cuda")
          ).to(dtype)
    assert float(lw.float().reshape(2, 4, 128, 4, 64).sum(2).min()) < -38
    got = wops.wkv(r, k, v, lw, u, init_state=s0, chunk=128)
    _ssd_close(got, wkv_chunked_ref(r, k, v, lw, u, init_state=s0,
                                    chunk=128), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scan_chunk_bodies_read_unaligned_rows(dtype):
    """Operands whose rows are not 16-byte aligned (a view one element
    into a wider last axis): both chunk bodies read them element by
    element, and match the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.mamba2_ssd import ops as sops
    from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked_ref
    from repro_torch.kernels.rwkv6_wkv import ops as wops
    from repro_torch.kernels.rwkv6_wkv.ref import wkv_chunked_ref

    def shifted(t):
        wide = torch.zeros((*t.shape[:-1], t.shape[-1] + 1), dtype=t.dtype,
                           device=t.device)
        wide[..., 1:] = t
        return wide[..., 1:]

    r, k, v, lw, u, s0 = _wkv_case(2, 256, 4, 64, dtype=dtype, state=True)
    got = wops.wkv(*map(shifted, (r, k, v, lw)), u, init_state=s0,
                   chunk=128)
    _ssd_close(got, wkv_chunked_ref(r, k, v, lw, u, init_state=s0,
                                    chunk=128), dtype)
    x, dt, A, Bs, Cs, s0 = _ssd_case(2, 512, 4, 64, 128, dtype=dtype,
                                     state=True)
    got = sops.ssd(shifted(x), dt, A, shifted(Bs), shifted(Cs),
                   init_state=s0, chunk=256)
    _ssd_close(got, ssd_chunked_ref(x, dt, A, Bs, Cs, init_state=s0,
                                    chunk=256), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [
    (2, 256, 4, 32, 16, 64),        # the shortest chunk the body takes
    (1, 256, 3, 64, 32, 256),       # one chunk: S = Q; 3 heads
    (2, 512, 21, 64, 128, 128),     # heads past one block's group
    (1, 384, 2, 32, 48, 192),       # three row tiles; N = 48
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("state", [False, True])
def test_ssd_chunk_body_matches_plain_at_chunk_edges(dims, dtype, state):
    """B5's chunk body at the edges of what it takes, held to
    ``ssd_chunked_ref`` as ``test_ssd_kernel_matches_plain`` holds it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.mamba2_ssd import ops as sops
    from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked_ref

    B, S, H, P, N, Q = dims
    assert sops.body(P, N, Q) == "chunk_tf32x3"
    *ins, s0 = _ssd_case(B, S, H, P, N, dtype=dtype, state=state)
    before = sops.ssd.body_launches["chunk_tf32x3"]
    got = sops.ssd(*ins, init_state=s0, chunk=Q)
    torch.cuda.synchronize()
    assert sops.ssd.body_launches["chunk_tf32x3"] == before + 1
    _ssd_close(got, ssd_chunked_ref(*ins, init_state=s0, chunk=Q), dtype)


@pytest.mark.cuda
def test_scan_chunk_bodies_raise_on_what_they_do_not_take():
    """A body is picked before the launch and never falls back: the chunk
    body's entry point refuses odd widths, and the binding raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.mamba2_ssd import kernel as skernel
    from repro_torch.kernels.rwkv6_wkv import kernel as wkernel

    x, dt, A, Bs, Cs, _ = _ssd_case(1, 200, 3, 20, 10, dtype=torch.float32,
                                    state=False)
    y, sf = torch.empty_like(x), torch.empty((1, 3, 20, 10), device="cuda")
    with pytest.raises(RuntimeError, match="chunk_tf32x3"):
        skernel.launch(x, dt, A, Bs, Cs, None, y, sf, chunk=40,
                       body="chunk_tf32x3")
    r, k, v, lw, u, _ = _wkv_case(1, 60, 2, 10, dtype=torch.float32,
                                  state=False)
    y, sf = torch.empty_like(r), torch.empty((1, 2, 10, 10), device="cuda")
    with pytest.raises(RuntimeError, match="chunk_tf32x3"):
        wkernel.launch(r, k, v, lw, u, None, y, sf, chunk=30,
                       body="chunk_tf32x3")


# ---------------------------------------------------------------------------
# B6 / B7: the blocked matmul of the paper's ladder
# ---------------------------------------------------------------------------

# |kernel - plain| <= MATMUL_TOL * max|plain|: both sum f32 products (a
# bf16 product is exact in f32), in another order.
MATMUL_TOL = 1e-5


def _matmul_case(M, K, N, *, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((M, K)).astype(np.float32),
            r.standard_normal((K, N)).astype(np.float32))


def _matmul_close(got, want):
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = (got.cpu() - want.cpu()).abs().max()
    assert err <= MATMUL_TOL * want.abs().max().cpu(), float(err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32, 32), (64, 96, 128),
                                   (128, 64, 32), (48, 80, 112),
                                   (105, 105, 105), (256, 16, 256),
                                   (33, 35, 37)])
@pytest.mark.parametrize("lvl", range(6))
def test_matmul_kernels_match_plain_at_every_rung(shape, lvl):
    """Each rung on the card (B7 at O0, B6 above, one launch a call)
    against the same rung's plain version on the CPU.  (105, 105, 105)
    copies f32 rows 4 B at a time and, at O5, bf16 rows element by
    element; (256, 16, 256) walks a 256-wide tile in two sub-tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.tiled_matmul import ops as mops

    a, b = (torch.tensor(x) for x in _matmul_case(*shape, seed=lvl))
    counter = mops.matmul_whole if lvl == 0 else mops.matmul_tiled
    before = counter.launches
    got = mops.matmul(a.cuda(), b.cuda(), lvl)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    _matmul_close(got, mops.matmul(a, b, lvl))


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(16, 16, 16), (32, 64, 16),
                                    (64, 64, 64), (35, 21, 15),
                                    (105, 7, 105)])
@pytest.mark.parametrize("lvl", [1, 2, 3, 4, 5])
def test_matmul_explicit_blocks_match_plain(blocks, lvl):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.tiled_matmul import ops as mops

    n = 64 if max(blocks) <= 64 and 35 not in blocks else 105
    a, b = (torch.tensor(x) for x in _matmul_case(n, n, n, seed=11))
    got = mops.matmul(a.cuda(), b.cuda(), lvl, blocks=blocks)
    _matmul_close(got, mops.matmul(a, b, lvl, blocks=blocks))


@pytest.mark.cuda
def test_matmul_whole_takes_bf16_as_given():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.tiled_matmul import ops as mops

    a, b = (torch.tensor(x).to(torch.bfloat16)
            for x in _matmul_case(40, 72, 24, seed=12))
    _matmul_close(mops.matmul_whole(a.cuda(), b.cuda()),
                  mops.matmul_whole(a, b))
    with pytest.raises(TypeError):
        mops.matmul_whole(a.cuda().half(), b.cuda().half())


@pytest.mark.cuda
def test_matmul_reads_views_and_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.tiled_matmul import ops as mops

    a, b = (torch.tensor(x) for x in _matmul_case(96, 64, 80, seed=13))
    at = a.t().contiguous().cuda().t()      # a transposed view
    _matmul_close(mops.matmul(at, b.cuda(), 3), mops.matmul(a, b, 3))
    # O1 keeps K whole: 1 x 1 stripes of K = 32768 f32 exceed 232,448 B.
    wide = torch.ones(16, 32768, device="cuda")
    with pytest.raises(ValueError, match="O1 keeps K whole"):
        mops.matmul(wide, wide.t(), 1)
    # explicit blocks whose tiles overflow a block's shared memory
    big = torch.ones(512, 512, device="cuda")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        mops.matmul(big, big, 4, blocks=(256, 256, 256))


# The tensor-core body of B6 at the blocks the O5 rung picks (128^3 at
# 1024^3 and 4096^3), at explicit eligible blocks on a non-square shape
# (every wgmma width: bn 64, 128 and 256 one instruction; 48, 96 and 192
# three of 16, 32 and 64), at bm = 64 (one consumer warpgroup), with one
# stage and with one block walking every tile.
@pytest.mark.cuda
@pytest.mark.parametrize("shape,blocks,parallel_mn,double_buffer", [
    ((1024, 1024, 1024), None, True, True),
    ((4096, 4096, 4096), None, True, True),
    ((256, 384, 512), (64, 128, 64), True, True),
    ((256, 384, 512), (128, 256, 64), True, True),
    ((256, 384, 576), (64, 48, 64), True, True),
    ((256, 384, 576), (128, 96, 128), True, True),
    ((256, 384, 576), (64, 192, 64), True, True),
    ((256, 384, 512), (128, 64, 128), True, False),
    ((256, 384, 512), (64, 128, 128), False, True),
])
def test_matmul_wgmma_body_matches_plain(shape, blocks, parallel_mn,
                                         double_buffer):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.core.optlevel import OptLevel
    from repro_torch.kernels.tiled_matmul import ops as mops
    from repro_torch.kernels.tiled_matmul.ref import matmul_tiled_ref

    M, K, N = shape
    if blocks is None:
        blocks = mops.pick_blocks(M, N, K, level=OptLevel.O5, elem_bytes=2)
        assert blocks == (128, 128, 128)
    assert mops.body(torch.bfloat16, M, N, K, *blocks) == "wgmma"
    a, b = (torch.tensor(x, device="cuda").to(torch.bfloat16)
            for x in _matmul_case(M, K, N, seed=14))
    before = dict(mops.matmul_tiled.body_launches)
    bm, bn, bk = blocks
    got = mops.matmul_tiled(a, b, bm=bm, bn=bn, bk=bk,
                            parallel_mn=parallel_mn,
                            double_buffer=double_buffer)
    torch.cuda.synchronize()
    assert mops.matmul_tiled.body_launches == {
        **before, "wgmma": before["wgmma"] + 1}
    _matmul_close(got, matmul_tiled_ref(a, b, bk=bk))


@pytest.mark.cuda
def test_matmul_routes_o5_to_wgmma_and_the_f32_rungs_to_cuda_cores():
    """ops.matmul at O1..O5 on the card: one launch a call, O5 on the
    wgmma body, O3 and O4 (a block per tile) on the 3xTF32 body, O1 and
    O2 (one block walking every tile) on the CUDA-core body."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.tiled_matmul import ops as mops

    a, b = (torch.tensor(x, device="cuda")
            for x in _matmul_case(512, 512, 512, seed=15))
    for lvl, which in ((1, "cuda_core"), (2, "cuda_core"), (3, "tf32x3"),
                       (4, "tf32x3"), (5, "wgmma")):
        before = dict(mops.matmul_tiled.body_launches)
        mops.matmul(a, b, lvl)
        torch.cuda.synchronize()
        assert mops.matmul_tiled.body_launches == {
            **before, which: before[which] + 1}


@pytest.mark.cuda
def test_matmul_wgmma_body_takes_an_unaligned_view():
    """A contiguous bf16 view that starts 2 bytes past an allocation is
    copied to an aligned tensor for TMA; the wgmma body still runs it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.tiled_matmul import ops as mops
    from repro_torch.kernels.tiled_matmul.ref import matmul_tiled_ref

    a, b = (torch.tensor(x, device="cuda").to(torch.bfloat16)
            for x in _matmul_case(128, 128, 128, seed=16))
    base = torch.empty(a.numel() + 1, dtype=torch.bfloat16, device="cuda")
    view = base[1:].view(128, 128)
    view.copy_(a)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    before = dict(mops.matmul_tiled.body_launches)
    got = mops.matmul_tiled(view, b, bm=128, bn=128, bk=64,
                            parallel_mn=True, double_buffer=True)
    torch.cuda.synchronize()
    assert mops.matmul_tiled.body_launches == {
        **before, "wgmma": before["wgmma"] + 1}
    _matmul_close(got, matmul_tiled_ref(a, b, bk=64))


# B6's 3xTF32 body at O3 and O4: the reference's test shapes, odd
# divisor blocks (which the CUDA cores take), and the main path's 1024^3
# and 4096^3; each call's body is the one ops.body names.
@pytest.mark.cuda
@pytest.mark.parametrize("shape,blocks", [
    ((32, 32, 32), None), ((64, 96, 128), None), ((128, 64, 32), None),
    ((48, 80, 112), None), ((105, 105, 105), (35, 21, 15)),
    ((256, 256, 256), (32, 64, 8)), ((256, 384, 512), (64, 128, 24)),
    ((1024, 1024, 1024), None), ((4096, 4096, 4096), None),
])
@pytest.mark.parametrize("lvl", [3, 4])
def test_matmul_tf32x3_body_matches_plain(shape, blocks, lvl):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.core.optlevel import OptLevel
    from repro_torch.kernels.tiled_matmul import ops as mops
    from repro_torch.kernels.tiled_matmul.ref import matmul_tiled_ref

    M, K, N = shape
    args = mops.rung(OptLevel(lvl), M, N, K, blocks=blocks)
    which = mops.body(torch.float32, M, N, K, args["bm"], args["bn"],
                      args["bk"], parallel_mn=True,
                      double_buffer=args["double_buffer"])
    if blocks is None and shape != (48, 80, 112):
        assert which == "tf32x3"
    a, b = (torch.tensor(x, device="cuda")
            for x in _matmul_case(M, K, N, seed=17))
    before = dict(mops.matmul_tiled.body_launches)
    got = mops.matmul(a, b, lvl, blocks=blocks)
    torch.cuda.synchronize()
    assert mops.matmul_tiled.body_launches == {
        **before, which: before[which] + 1}
    _matmul_close(got, matmul_tiled_ref(a, b, bk=args["bk"]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["aes", "kmp", "nw"])
def test_machsuite_byte_kernels_on_the_card_equal_the_oracle(name):
    """Every level of aes, kmp and nw on the card, at the reference
    tests' scales (``TEST_SCALE``), exactly equal to the numpy oracle;
    kmp also with matches planted (the 16-character pattern finds none
    there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs the ladder on the card)")
    import importlib

    mod = importlib.import_module(f"repro_torch.machsuite.{name}")
    cases = [(mod.make_inputs(np.random.default_rng(seed), mod.TEST_SCALE),
              False) for seed in (0, 1234)]
    if name == "kmp":
        cases += [(mod.with_planted_matches(inp), True) for inp, _ in cases]
    for inp, planted in cases:
        want = np.asarray(mod.oracle(**inp))
        if planted:
            assert want >= mod.PE_NUM, want
        for level in range(6):
            out = mod.run(level, **inp)
            assert out.device.type == "cuda", (name, level)
            np.testing.assert_array_equal(out.cpu().numpy(), want,
                                          err_msg=f"{name} O{level}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bfs", "sort", "spmv", "viterbi"])
def test_machsuite_rest_on_the_card_equal_the_oracle(name):
    """Every level of bfs, sort, spmv and viterbi on the card, at the
    reference tests' scales (``TEST_SCALE``), seeds 0 and 1234, held to
    the numpy oracle: ints and viterbi exactly, spmv at the reference's
    tolerance; bfs also with a third of its nodes unreachable."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs the ladder on the card)")
    import importlib

    mod = importlib.import_module(f"repro_torch.machsuite.{name}")
    cases = [mod.make_inputs(np.random.default_rng(seed), mod.TEST_SCALE)
             for seed in (0, 1234)]
    if name == "bfs":
        cases += [mod.with_unreachable(inp) for inp in cases]
    for inp in cases:
        want = np.asarray(mod.oracle(**inp))
        for level in range(6):
            out = mod.run(level, **inp)
            assert out.device.type == "cuda", (name, level)
            if name == "spmv":
                np.testing.assert_allclose(out.cpu().numpy(), want,
                                           rtol=2e-4, atol=1e-5,
                                           err_msg=f"{name} O{level}")
            else:
                np.testing.assert_array_equal(out.cpu().numpy(), want,
                                              err_msg=f"{name} O{level}")


# A 2-layer cut of the full-width config in f32, on the card and on the
# CPU: max |dlogit| / max |logit| within this.  The two differ in the
# GEMMs' summation order (TF32 off), and an element of the bf16-stored
# state may round to its neighbouring bf16 value on one side.
RECURRENT_CARD_TOL = 2e-3


def _rel(a, b) -> float:
    return float((a.cpu() - b.cpu()).abs().max() / b.cpu().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-3b", "mamba2-2.7b"])
def test_recurrent_decode_and_scan_prefill_on_the_card(arch):
    """The decode step and the chunked prefill (``scan_prefill``) of a
    2-layer full-width cut in f32 on the card against the same steps on
    the CPU, within ``RECURRENT_CARD_TOL``; on the card, the prefill step
    bitwise equal to C decode steps (each slot's logits at its ``last``
    row and its state after ``last + 1`` steps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (holds the card against the CPU)")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.scan_prefill import batch_axes_of
    from repro_torch.tree import map_tree

    cfg = dataclasses.replace(get_config(arch), n_layers=2,
                              compute_dtype="float32")
    models = {"cpu": get_model(cfg, device="cpu"), "cuda": get_model(cfg)}
    params = {"cpu": models["cpu"].init(torch.Generator().manual_seed(0))}
    params["cuda"] = map_tree(lambda t: t.cuda(), params["cpu"])
    B, C = 4, 6
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(1, cfg.vocab, (B, C), generator=gen)
    last = torch.tensor([C - 1, 2, 0, C - 1])
    start = torch.zeros(B, dtype=torch.long)
    out = {}
    for dev, model in models.items():
        cache = model.init_cache(B, 16)
        steps = []
        for j in range(C):
            lg, cache = model.decode_step(params[dev], cache,
                                          toks[:, j:j + 1].to(dev),
                                          (start + j).to(dev))
            steps.append((lg, {k: v.clone() for k, v in cache.items()}))
        chunk = model.init_cache(B, 16)
        sel, chunk = model.prefill_step(params[dev], chunk, toks.to(dev),
                                        start.to(dev), last.to(dev))
        out[dev] = (steps, sel, chunk)
    for (a, _), (b, _) in zip(out["cuda"][0], out["cpu"][0]):
        assert a.device.type == "cuda"
        assert _rel(a, b) <= RECURRENT_CARD_TOL
    assert _rel(out["cuda"][1], out["cpu"][1]) <= RECURRENT_CARD_TOL
    steps, sel, chunk = out["cuda"]
    bax = batch_axes_of(models["cuda"].cache_axes())
    for b, j in enumerate(last.tolist()):
        logits, state = steps[j]
        assert torch.equal(sel[b], logits[b]), (arch, b)
        for name, leaf in chunk.items():
            assert torch.equal(leaf.select(bax[name], b),
                               state[name].select(bax[name], b)), (name, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,causal", [
    ((2, 1500, 1500, 8, 8, 64), False),    # whisper's encoder
    ((2, 64, 16, 8, 8, 64), False),        # cross: S_kv < S
    ((1, 300, 7, 4, 2, 64), False),        # S_kv below one key tile
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_non_causal_at_whisper_shapes(dims, causal, dtype):
    """B3 without a mask at the encoder's shape and with fewer keys than
    queries (a cross-attention's rows attend every key) against the
    plain version, at B3's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _flash_case(*dims, dtype=dtype)
    before = fops.flash_attention.launches
    got = fops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fops.flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal).float()
    assert torch.isfinite(got).all()
    err = (got.float() - want).abs()
    row = want.abs().amax(dim=-1, keepdim=True)
    rtol = 1.6e-2 if dtype == torch.bfloat16 else 1e-5
    assert (err <= rtol * row).all(), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_attention_at_whisper_decoder_shape(kv_dtype):
    """B1 / B1q at whisper-base's decoder self-attention (B=8, H=KV=8,
    D=64, T=16, lengths 5-130) on the split body against the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from repro_torch.serving import kvquant

    lengths = [5, 17, 33, 64, 80, 97, 120, 130]
    q, kp, vp, tables, lens = _case(8, 8, 8, 64, 16, 9,
                                    dtype=torch.bfloat16, lengths=lengths)
    case = (q, kp, vp, tables, lens)
    kw = {}
    if kv_dtype != "bf16":
        kp, vp = (torch.nan_to_num(p).float() for p in (kp, vp))
        scales = []
        words = []
        for p in (kp, vp):
            s = kvquant.block_scale(p, (1, 3), kv_dtype)     # (R, 1, KV, 1)
            words.append(kvquant.quantize(p, s, kv_dtype))
            scales.append(s[:, 0, :, 0].contiguous())
        case = (q, words[0], words[1], tables, lens)
        kw = dict(k_scale=scales[0], v_scale=scales[1])
    assert ops.body(q.dtype, case[1].dtype, 64) == "split_mma"
    before = dict(ops.paged_attention.body_launches)
    got = ops.paged_attention(*case, **kw)
    torch.cuda.synchronize()
    assert ops.paged_attention.body_launches["split_mma"] == \
        before["split_mma"] + 1
    want = ref.paged_attention_ref(*case, **kw).float()
    assert torch.isfinite(got).all()
    err = (got.float() - want).abs()
    assert (err <= 1e-3 + 1.6e-2 * want.abs()).all(), float(err.max())


@pytest.mark.cuda
def test_encdec_steps_on_the_card():
    """whisper-base cut to 2 layers at full width, f32: ``encode`` on the
    card against the CPU; over one cross K/V (``build_cross_cache`` of
    the CPU's encoder states) and f32 caches, the decode step, the
    mixed-pool paged step (B1 on an f32 pool of the self K/V) and a
    ragged ``prefill_step`` chunk on the card against the CPU, all within
    ``RECURRENT_CARD_TOL`` of each output's scale (a bf16 store would let
    a one-ulp rounding of a K element move the logits ~1e-2 in this
    model, ROADMAP C8); on the card the chunk equals its one-token steps
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (holds the card against the CPU)")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import encdec, get_model
    from repro_torch.serving.paged import PagedCacheManager
    from repro_torch.serving.scheduler import Request
    from repro_torch.tree import map_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("whisper-base"), n_layers=2,
                              n_enc_layers=2, compute_dtype="float32")
    models = {"cpu": get_model(cfg, device="cpu"), "cuda": get_model(cfg)}
    params = {"cpu": models["cpu"].init(torch.Generator().manual_seed(0))}
    params["cuda"] = map_tree(lambda t: t.cuda(), params["cpu"])
    B, C, S = 4, 6, 40
    gen = torch.Generator().manual_seed(1)
    frames = torch.randn((B, S, cfg.d_model), generator=gen) * 0.02
    toks = torch.randint(1, cfg.vocab, (B, C), generator=gen)
    last = torch.tensor([C - 1, 2, 0, C - 1])
    start = torch.zeros(B, dtype=torch.long)
    enc = {dev: encdec.encode(cfg, params[dev], frames.to(dev))
           for dev in models}
    assert _rel(enc["cuda"], enc["cpu"]) <= RECURRENT_CARD_TOL
    cross = {k: v.float() for k, v in encdec.build_cross_cache(
        cfg, params["cpu"], enc["cpu"]).items()}

    def fresh(dev):
        c = encdec.init_cache(cfg, B, S, device=dev, dtype=torch.float32)
        c.update({k: v.to(dev) for k, v in cross.items()})
        return c

    out = {}
    for dev, model in models.items():
        p = params[dev]
        cache = fresh(dev)
        steps = []
        for j in range(C):
            lg, cache = model.decode_step(p, cache, toks[:, j:j + 1].to(dev),
                                          (start + j).to(dev))
            steps.append((lg, {k: v.clone() for k, v in cache.items()}))
        mgr = PagedCacheManager(model, B, S, block_size=16)
        mgr.cache = {k: v.float() for k, v in mgr.cache.items()}
        for b in range(B):
            mgr.admit_slot(b, Request(prompt=[1] * C, max_new_tokens=1))
        tables, rows = mgr.step_extras()
        for name, leaf in cross.items():
            mgr.cache[name][:, rows.long()] = leaf.to(dev)
        paged = []
        for j in range(C):
            lg, _ = model.paged_decode_step(p, mgr.cache, tables, rows,
                                            toks[:, j:j + 1].to(dev),
                                            (start + j).to(dev))
            paged.append(lg)
        sel, chunk = model.prefill_step(p, fresh(dev), toks.to(dev),
                                        start.to(dev), last.to(dev))
        out[dev] = (steps, paged, sel, chunk)
    for (a, _), (b, _) in zip(out["cuda"][0], out["cpu"][0]):
        assert a.device.type == "cuda"
        assert _rel(a, b) <= RECURRENT_CARD_TOL
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert _rel(a, b) <= RECURRENT_CARD_TOL
    assert _rel(out["cuda"][2], out["cpu"][2]) <= RECURRENT_CARD_TOL
    steps, _, sel, chunk = out["cuda"]
    for b, j in enumerate(last.tolist()):
        logits, state = steps[j]
        assert torch.equal(sel[b], logits[b]), b
        for name, leaf in chunk.items():
            assert torch.equal(leaf[:, b], state[name][:, b]), (name, b)
