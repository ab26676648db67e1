"""The port's MachSuite ladder (gemm) against the reference's: the same
inputs from the same generator, and every level O0..O5 held to the
reference's ``run`` and to the float64 oracle with the reference's own
tolerance (``tests/test_machsuite.py``)."""

import numpy as np
import pytest
import torch

from repro.machsuite import KERNELS as JKERNELS
from repro.machsuite import gemm as jgemm
from repro_torch.core.costmodel import MACHSUITE_PROFILES
from repro_torch.core.optlevel import OptLevel
from repro_torch.machsuite import KERNELS, common, gemm

SCALE = 32 / 1024   # the reference tests' gemm scale: 32 x 32


def _close(out, ref, msg=""):
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=1e-5, err_msg=msg)


@pytest.mark.parametrize("seed", [0, 1234])
@pytest.mark.parametrize("scale", [SCALE, 64 / 1024])
def test_make_inputs_is_bit_identical_to_the_reference(seed, scale):
    mine = gemm.make_inputs(np.random.default_rng(seed), scale)
    theirs = jgemm.make_inputs(np.random.default_rng(seed), scale)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(mine[k], theirs[k])


def test_full_scale_size_is_table_3s():
    """scale 1.0 is the paper's Table 3 size (1024 x 1024), as in the
    reference; only the shape is checked here."""
    n = max(gemm.TILE, int(1024 * 1.0) // gemm.TILE * gemm.TILE)
    assert n == 1024


@pytest.mark.parametrize("lvl", range(6))
def test_level_matches_reference_and_oracle(lvl):
    inp = gemm.make_inputs(np.random.default_rng(lvl), SCALE)
    out = gemm.run(OptLevel(lvl), **inp, device="cpu")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    out = out.numpy()
    _close(out, gemm.oracle(**inp), f"O{lvl} vs oracle")
    _close(out, np.asarray(jgemm.run(lvl, **inp)), f"O{lvl} vs reference")


@pytest.mark.parametrize("lvl", [2, 3, 4, 5])
def test_level_matches_reference_at_a_wider_tile_grid(lvl):
    """48 x 48: a 3 x 3 x 3 tile grid for the batched and rotated levels."""
    inp = gemm.make_inputs(np.random.default_rng(9), 48 / 1024)
    out = gemm.run(lvl, **inp, device="cpu").numpy()
    _close(out, np.asarray(jgemm.run(lvl, **inp)))
    _close(out, gemm.oracle(**inp))


def test_gemm_identity():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((32, 32)).astype(np.float32)
    eye = np.eye(32, dtype=np.float32)
    for lvl in range(6):
        out = gemm.run(lvl, a, eye, device="cpu").numpy()
        _close(out, a, f"O{lvl}")


def test_oracle_equals_the_reference_oracle():
    inp = gemm.make_inputs(np.random.default_rng(3), SCALE)
    np.testing.assert_array_equal(gemm.oracle(**inp), jgemm.oracle(**inp))


def test_registry_and_profile():
    assert set(KERNELS) == {"aes", "bfs", "gemm", "kmp", "nw", "sort",
                            "spmv", "viterbi"} == set(JKERNELS)
    assert KERNELS["gemm"] is gemm
    assert gemm.PROFILE.name == "gemm"
    assert gemm.PROFILE == MACHSUITE_PROFILES["gemm"]


def test_rotate3_visits_slots_in_order():
    seen = common.rotate3(lambda i, slot, acc: acc + [(i, slot)], 5, [])
    assert seen == [(0, 0), (1, 1), (2, 2), (3, 0), (4, 1)]


def test_run_accepts_tensors_and_refuses_untiled_sizes():
    a = torch.ones(20, 20)
    assert torch.equal(gemm.run(0, a, a, device="cpu"),
                       torch.full((20, 20), 20.0))
    with pytest.raises(AssertionError):
        gemm.run(2, a, a, device="cpu")
