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

All eight of the paper's kernels are ported: gemm; the byte kernels
aes, kmp and nw, whose O5 stages packed 32-bit words
(``common.pack_u8_to_u32``); and bfs, sort, spmv and viterbi, whose O5
equals O4 as in the reference (bfs stops at O2: its dependence chain
admits no PE duplication or double buffering).  Loops whose trip count
depends on the data (kmp O0/O1's backtracking, sort O0/O1's shifts,
bfs's queue and levels) read their condition back to the host each
trip.  Their CPU tests hold every level to the reference's ``run`` and
oracle (``tests/test_torch_machsuite.py``,
``tests/test_torch_machsuite_bytes.py``,
``tests/test_torch_machsuite_rest.py``); ``chip_smoke.py`` phase 9 runs
every level of all eight on the card against the oracle at their
modules' ``TEST_SCALE`` (gemm at 32 x 32), and bfs, sort, spmv and
viterbi's later rungs also at Table 3's sizes.  The analytic model covers
all eight (``python -m repro_torch.autotune --kernel all``).
"""

from repro_torch.machsuite import aes, bfs, gemm, kmp, nw, sort, spmv, viterbi

KERNELS = {
    "aes": aes,
    "bfs": bfs,
    "gemm": gemm,
    "kmp": kmp,
    "nw": nw,
    "sort": sort,
    "spmv": spmv,
    "viterbi": viterbi,
}

KERNEL_NAMES = tuple(KERNELS)
