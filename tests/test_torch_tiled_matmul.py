"""Kernels B6/B7 (the blocked matmul of the paper's ladder): the port's
``ops.matmul`` on CPU tensors (the plain versions) against the JAX
``ops.matmul`` in interpret mode on the same numpy inputs, and the
port's block pickers against the reference's.  The CUDA kernels are held
to the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 3f)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.optlevel import OptLevel as JOptLevel
from repro.kernels.tiled_matmul import ops as jops
from repro_torch.core.hw import H100_SXM
from repro_torch.core.optlevel import OptLevel
from repro_torch.kernels.tiled_matmul import ops, ref

SHAPES = [(32, 32, 32), (64, 96, 128), (128, 64, 32), (48, 80, 112)]
EXPLICIT = [(16, 16, 16), (32, 64, 16), (64, 64, 64)]
# The reference's budget (ops.VMEM_BUDGET, half of a v5e core's VMEM).
TPU_BUDGET = jops.VMEM_BUDGET
# |port - JAX| <= TOL * max|JAX| at every rung: both sum f32 products
# (at O5 both round a and b to bf16 to nearest even, and a bf16 product
# is exact in f32), so only the summation order differs.
TOL = 1e-5


def _inputs(M, K, N, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((M, K)).astype(np.float32),
            r.standard_normal((K, N)).astype(np.float32))


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lvl", range(6))
def test_matmul_matches_jax_at_every_rung(shape, lvl):
    a, b = _inputs(*shape, seed=lvl)
    want = np.asarray(jops.matmul(jnp.asarray(a), jnp.asarray(b),
                                  JOptLevel(lvl)))
    got = ops.matmul(torch.tensor(a), torch.tensor(b), OptLevel(lvl))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) < TOL, (shape, lvl)


@pytest.mark.parametrize("blocks", EXPLICIT)
@pytest.mark.parametrize("lvl", [1, 2, 3, 4, 5])
def test_matmul_explicit_blocks_match_jax(blocks, lvl):
    a, b = _inputs(64, 64, 64, seed=7)
    want = np.asarray(jops.matmul(jnp.asarray(a), jnp.asarray(b),
                                  JOptLevel(lvl), blocks=blocks))
    got = ops.matmul(torch.tensor(a), torch.tensor(b), lvl, blocks=blocks)
    assert _rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("shape", SHAPES + [(4096, 4096, 4096)])
@pytest.mark.parametrize("lvl", range(6))
def test_pick_blocks_equal_the_reference_under_its_budget(
        shape, lvl, monkeypatch):
    M, K, N = shape
    monkeypatch.setattr(ops, "SMEM_BUDGET", TPU_BUDGET)
    elem = 2 if lvl >= 5 else 4
    assert (ops.pick_blocks(M, N, K, level=OptLevel(lvl), elem_bytes=elem)
            == jops.pick_blocks(M, N, K, level=JOptLevel(lvl),
                                elem_bytes=elem))


@pytest.mark.parametrize("shape", SHAPES + [(4096, 4096, 4096)])
def test_o1_blocks_are_the_reference_blocks_under_its_budget(
        shape, monkeypatch):
    """The reference's O1 takes pick_blocks' bm, bn with bk = K; under
    its budget those stripes fit, so the port's shrink leaves them."""
    M, K, N = shape
    monkeypatch.setattr(ops, "SMEM_BUDGET", TPU_BUDGET)
    bm, bn, _ = jops.pick_blocks(M, N, K, level=JOptLevel.O1)
    assert ops.pick_o1_blocks(M, N, K) == (bm, bn)


def test_card_budget_is_a_blocks_shared_memory():
    assert ops.SMEM_BUDGET == H100_SXM.smem_per_block == 232_448


@pytest.mark.parametrize("shape", [(1024, 1024, 1024), (4096, 4096, 4096)])
@pytest.mark.parametrize("lvl", [2, 3, 4, 5])
def test_pick_blocks_fit_the_card(shape, lvl):
    M, K, N = shape
    elem = 2 if lvl >= 5 else 4
    bm, bn, bk = ops.pick_blocks(M, N, K, level=OptLevel(lvl),
                                 elem_bytes=elem)
    n_buf = 2 if lvl >= 4 else 1
    assert n_buf * elem * (bm * bk + bk * bn + bm * bn) <= ops.SMEM_BUDGET
    assert M % bm == 0 and N % bn == 0 and K % bk == 0


def test_card_blocks_at_machsuite_size():
    """The blocks the card runs at 1024^3 (chip_smoke.py phase 3f
    records them): the parallel rungs take 128 x 128 f32 tiles, O4
    halves them for two buffers, and O1's K-whole stripes shrink to
    16 x 32 where the reference keeps 256 x 256."""
    n = 1024
    assert ops.pick_blocks(n, n, n, level=OptLevel.O3) == (128, 128, 128)
    assert ops.pick_blocks(n, n, n, level=OptLevel.O4) == (64, 128, 64)
    assert ops.pick_blocks(n, n, n, level=OptLevel.O5,
                           elem_bytes=2) == (128, 128, 128)
    assert ops.pick_o1_blocks(n, n, n) == (16, 32)
    assert jops.pick_blocks(n, n, n, level=JOptLevel.O1)[:2] == (256, 256)


def test_o1_shrink_keeps_stripes_in_budget_and_raises_past_it():
    for K in (1024, 4096, 29_000):
        bm, bn = ops.pick_o1_blocks(64, 64, K)
        assert 4 * (bm * K + K * bn + bm * bn) <= ops.SMEM_BUDGET
    with pytest.raises(ValueError, match="O1 keeps K whole"):
        ops.pick_o1_blocks(16, 16, 32768)
    a = torch.ones(16, 32768)
    with pytest.raises(ValueError, match="O1 keeps K whole"):
        ops.matmul(a, a.t(), OptLevel.O1)


@pytest.mark.parametrize("bk", [16, 32, 64])
def test_plain_tiled_walks_k_in_blocks_in_order(bk):
    """B6's plain version is the sum over K blocks in order, each block's
    product in f32: bit for bit what an explicit loop gives."""
    a, b = (torch.tensor(x) for x in _inputs(48, 64, 40, seed=3))
    want = torch.zeros(48, 40)
    for k0 in range(0, 64, bk):
        want = want + a[:, k0:k0 + bk] @ b[k0:k0 + bk]
    assert torch.equal(ref.matmul_tiled_ref(a, b, bk=bk), want)


def test_plain_bf16_products_are_exact_in_f32():
    a, b = (torch.tensor(x).to(torch.bfloat16)
            for x in _inputs(32, 48, 24, seed=4))
    want = a.double() @ b.double()
    got = ref.matmul_tiled_ref(a, b, bk=16)
    assert got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) < 1e-5 * float(
        want.abs().max())


def test_o0_takes_inputs_as_given_and_matches_jax_in_bf16():
    a, b = _inputs(40, 72, 24, seed=5)
    a16, b16 = (torch.tensor(x).to(torch.bfloat16) for x in (a, b))
    want = np.asarray(jops.matmul(jnp.asarray(a, jnp.bfloat16),
                                  jnp.asarray(b, jnp.bfloat16),
                                  JOptLevel.O0))
    got = ops.matmul(a16, b16, OptLevel.O0)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("bad", ["dtype", "mixed", "shape", "blocks",
                                 "device"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    a, b = (torch.tensor(x) for x in _inputs(32, 32, 32))
    if bad == "dtype":
        with pytest.raises(TypeError):
            ops.matmul_whole(a.double(), b.double())
    elif bad == "mixed":
        with pytest.raises(TypeError):
            ops.matmul_whole(a, b.to(torch.bfloat16))
    elif bad == "shape":
        with pytest.raises(ValueError):
            ops.matmul_tiled(a, b[:16], bm=16, bn=16, bk=16,
                             parallel_mn=True, double_buffer=False)
    elif bad == "blocks":
        with pytest.raises(ValueError, match="must divide"):
            ops.matmul_tiled(a, b, bm=24, bn=16, bk=16, parallel_mn=True,
                             double_buffer=False)
    else:
        with pytest.raises(ValueError, match="cuda or cpu"):
            ops.matmul_whole(a.to("meta"), b.to("meta"))


# B6's two bodies: ``ops.body`` routes by dtype, shape and blocks alone.
@pytest.mark.parametrize("n", [1024, 4096])
def test_o5_at_the_picked_blocks_runs_the_tensor_core_body(n):
    args = ops.rung(OptLevel.O5, n, n, n)
    assert (args["dtype"], args["bm"], args["bn"], args["bk"]) == (
        torch.bfloat16, 128, 128, 128)
    assert ops.body(args["dtype"], n, n, n, args["bm"], args["bn"],
                    args["bk"]) == "wgmma"


@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("lvl", [1, 2, 3, 4])
def test_f32_rungs_run_the_cuda_core_body(n, lvl):
    """The f32 rungs' routing: O1 and O2 (one block walking every tile)
    stay on the CUDA-core body; O3 and O4 (a block per tile) at their
    picked blocks run the 3xTF32 tensor-core body."""
    args = ops.rung(OptLevel(lvl), n, n, n)
    assert args["dtype"] == torch.float32
    want = "tf32x3" if lvl >= 3 else "cuda_core"
    assert ops.body(args["dtype"], n, n, n, args["bm"], args["bn"],
                    args["bk"], parallel_mn=args["parallel_mn"],
                    double_buffer=args["double_buffer"]) == want


@pytest.mark.parametrize("shape,blocks", [
    ((32, 32, 32), None),                 # bm 32: less than a warpgroup
    ((105, 105, 105), None),              # odd blocks
    ((105, 105, 105), (35, 21, 15)),
    ((256, 256, 512), (256, 128, 64)),    # bm 256: over two warpgroups
    ((128, 288, 128), (128, 288, 64)),    # bn over 256
    ((128, 128, 128), (128, 128, 32)),    # bk not a whole swizzle box
    ((128, 132, 128), (128, 128, 64)),    # N not a multiple of 8
    ((128, 128, 132), (128, 128, 64)),    # K not a multiple of 8
    ((128, 256, 512), (128, 256, 512)),   # a ring over shared memory
])
def test_ineligible_bf16_blocks_run_the_cuda_core_body(shape, blocks):
    M, N, K = shape
    if blocks is None:
        args = ops.rung(OptLevel.O5, M, N, K)
        blocks = (args["bm"], args["bn"], args["bk"])
    bm, bn, bk = blocks
    assert ops.body(torch.bfloat16, M, N, K, bm, bn, bk) == "cuda_core"


def test_wgmma_ring_fits_at_the_main_blocks_and_not_past_the_budget():
    assert ops.wgmma_smem_bytes(128, 128, 128) == 132_128
    assert ops.wgmma_smem_bytes(128, 256, 64) == 99_360
    # B's boxes are 64 columns wide: bn 16 stages as much as bn 64.
    assert ops.wgmma_smem_bytes(64, 16, 64) == ops.wgmma_smem_bytes(64, 64,
                                                                    64)
    assert ops.wgmma_smem_bytes(128, 256, 512) > ops.SMEM_BUDGET


@pytest.mark.parametrize("lvl", [3, 5])
def test_cpu_call_counts_no_launch_of_either_body(lvl):
    a, b = (torch.tensor(x) for x in _inputs(128, 128, 128, seed=6))
    before = (ops.matmul_tiled.launches, dict(ops.matmul_tiled.body_launches))
    ops.matmul(a, b, OptLevel(lvl))
    assert (ops.matmul_tiled.launches,
            ops.matmul_tiled.body_launches) == before
    assert set(before[1]) == {"cuda_core", "wgmma", "tf32x3"}


# B6's 3xTF32 body (``csrc/tiled_matmul_tf32x3.cu``) at O3 and O4.
@pytest.mark.parametrize("shape", SHAPES + [(512, 512, 512)])
@pytest.mark.parametrize("lvl", [3, 4])
def test_f32_rungs_with_a_block_per_tile_route_by_blocks(shape, lvl):
    """O3/O4 at the picked blocks: the 3xTF32 body takes bm and bn of
    32, 64 or 128 and bk a multiple of 8 (48 x 80 x 112 picks bm 48, so
    the CUDA cores run it); the same blocks with one block walking every
    tile stay on the CUDA cores."""
    M, K, N = shape
    args = ops.rung(OptLevel(lvl), M, N, K)
    bm, bn, bk = args["bm"], args["bn"], args["bk"]
    eligible = bm in (32, 64, 128) and bn in (32, 64, 128) and bk % 8 == 0
    assert ops.body(torch.float32, M, N, K, bm, bn, bk, parallel_mn=True,
                    double_buffer=args["double_buffer"]) == (
        "tf32x3" if eligible else "cuda_core")
    assert eligible == (shape != (48, 80, 112))
    assert ops.body(torch.float32, M, N, K, bm, bn, bk, parallel_mn=False,
                    double_buffer=args["double_buffer"]) == "cuda_core"


@pytest.mark.parametrize("shape,blocks,double_buffer", [
    ((256, 256, 256), (96, 64, 64), False),    # bm not 32, 64 or 128
    ((256, 256, 256), (64, 256, 64), False),   # bn over 128
    ((256, 256, 260), (64, 64, 20), False),    # bk not a multiple of 8
    ((256, 258, 256), (64, 64, 64), False),    # K not a multiple of 4
    ((1024, 1024, 1024), (128, 128, 128), True),   # two stages overflow
])
def test_ineligible_f32_blocks_run_the_cuda_core_body(shape, blocks,
                                                      double_buffer):
    M, K, N = shape
    assert ops.body(torch.float32, M, N, K, *blocks, parallel_mn=True,
                    double_buffer=double_buffer) == "cuda_core"
    assert ops.tf32x3_smem_bytes(128, 128, 128, 1) <= ops.SMEM_BUDGET


def _tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to 10 mantissa bits, to nearest
    with ties away from zero (the low 13 bits of the f32 pattern)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _truncated(x):
    """The TF32 value an MMA reads from an f32 register: the 13 low bits
    ignored (truncation toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32x3(a, b):
    """The 3xTF32 body's arithmetic in plain torch: big = tf32(x) (to
    nearest, ties away), small = x - big as the MMA reads it (truncated
    to TF32), and a_s b_b + a_b b_s + a_b b_b in f32."""
    a_b, b_b = _tf32(a), _tf32(b)
    a_s, b_s = _truncated(a - a_b), _truncated(b - b_b)
    return (a_s @ b_b + a_b @ b_s) + a_b @ b_b


def test_tf32_split_is_exact_where_it_must_be():
    x = torch.tensor(np.random.default_rng(0).standard_normal(4096)
                     .astype(np.float32))
    big = _tf32(x)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((x - big).abs() <= x.abs() * 2.0 ** -11).all()
    # big + small, as the MMA reads small, carries all but 2^-21 of x
    small = _truncated(x - big)
    assert ((x - big - small).abs() <= x.abs() * 2.0 ** -21).all()
    assert (small.abs() <= x.abs() * 2.0 ** -11).all()
    # ties round away from zero: 1 + 2^-11 is halfway between tf32 values
    half = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert _tf32(half).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


@pytest.mark.parametrize("shape", SHAPES + [(512, 512, 512)])
def test_tf32x3_emulation_within_matmul_tol_of_the_oracle(shape):
    """The split's error bound before the card runs it: 3xTF32 in plain
    torch stays within MATMUL_TOL = 1e-5 of max |oracle|."""
    a, b = (torch.tensor(x) for x in _inputs(*shape, seed=21))
    want = ref.matmul_ref(a, b).numpy()
    assert _rel(_tf32x3(a, b).numpy(), want) < TOL


def test_tf32_alone_breaks_matmul_tol():
    """One TF32 product keeps ~3 decimal digits: at 512^3 it misses
    1e-5 of max |oracle| by more than 10x, so the body needs all three."""
    a, b = (torch.tensor(x) for x in _inputs(512, 512, 512, seed=21))
    want = ref.matmul_ref(a, b).numpy()
    assert _rel((_tf32(a) @ _tf32(b)).numpy(), want) > 10 * TOL
