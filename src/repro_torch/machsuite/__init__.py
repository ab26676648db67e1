"""MachSuite kernels in PyTorch — the paper's benchmark substrate (port of
``repro/machsuite``).

Each kernel module exposes:

  make_inputs(rng, scale) -> dict      scaled-down inputs drawn from a
                                       numpy generator (scale=1.0 is the
                                       paper's Table 3 size), bit-identical
                                       to the reference's draws
  oracle(**inputs) -> array            pure-numpy reference
  run(level, **inputs, device=None)    torch implementation whose
                                       *structure* follows the paper's
                                       refinement ladder (O0 naive .. O5
                                       scratchpad-reorg); every level is
                                       output-identical; on the CUDA
                                       device unless given device="cpu"
  PROFILE                              the analytic-model profile
                                       (core.costmodel.MACHSUITE_PROFILES)

The level variants are the paper's Fig. 4 code walk:
  O0  element-at-a-time compute against device memory
  O1  explicit data caching: tile staging, then compute per element
  O2  customized pipelining: the tile contraction as one product
  O3  PE duplication: every tile at once (a batch dimension)
  O4  double buffering: explicit 3-slot load/compute/store rotation
  O5  scratchpad reorganization: packed wide-word staging buffers

Ported: gemm, and the three byte kernels aes, kmp and nw, whose O5
stages packed 32-bit words (``common.pack_u8_to_u32``).  Their CPU tests
hold every level to the reference's ``run`` and oracle
(``tests/test_torch_machsuite.py``, ``tests/test_torch_machsuite_bytes.py``);
``chip_smoke.py`` phase 9 runs every level of all four on the card
against the oracle, the byte kernels at their modules' ``TEST_SCALE``.  The other four (bfs, sort, spmv, viterbi) are
queued in ROADMAP A18b; the analytic model already covers all eight
(``python -m repro_torch.autotune --kernel all``).
"""

from repro_torch.machsuite import aes, gemm, kmp, nw

KERNELS = {
    "aes": aes,
    "gemm": gemm,
    "kmp": kmp,
    "nw": nw,
}

KERNEL_NAMES = tuple(KERNELS)
