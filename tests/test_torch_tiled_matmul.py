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
    args = ops.rung(OptLevel(lvl), n, n, n)
    assert args["dtype"] == torch.float32
    assert ops.body(args["dtype"], n, n, n, args["bm"], args["bn"],
                    args["bk"]) == "cuda_core"


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
    assert set(before[1]) == {"cuda_core", "wgmma"}
