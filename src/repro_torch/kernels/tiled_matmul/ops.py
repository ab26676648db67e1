"""Public wrapper: the best-effort ladder for the blocked matmul kernels
(port of ``repro/kernels/tiled_matmul/ops.py``).

``matmul(a, b, level)`` dispatches per OptLevel, as the reference does:
O0 runs B7 (``matmul_whole``), O1..O5 run B6 (``matmul_tiled``) with the
blocks and flags of the rung (see ``csrc/tiled_matmul.cu``).  Block sizes
follow the reference's rule under the card's shared-memory budget in
VMEM's place, with its feedback at O4 (two in-flight buffers per stream
must fit — the "shrink the cache size" feedback of paper §6).

``matmul_tiled`` and ``matmul_whole`` check what their kernel takes and
raise on anything else, then launch the CUDA kernel for CUDA tensors —
no fallback — or run the plain version (``ref.py``) for CPU tensors.
Each kernel launch adds one to its wrapper's ``launches``.

B6 has three bodies.  ``body`` picks one from dtype, shape, blocks and
the launch's grid and stages alone, before any launch: bf16 tiles the
tensor cores take (the O5 rung at the picked blocks) run
``csrc/tiled_matmul_wgmma.cu``; f32 tiles with a block per tile that the
3xTF32 body takes (O3 and O4 at the picked blocks) run
``csrc/tiled_matmul_tf32x3.cu``; everything else — O1 and O2, one block
walking every tile, the ladder's unrefined rungs — runs
``csrc/tiled_matmul.cu`` on the CUDA cores.  This is routing, not a
fallback: each body counts its launches in
``matmul_tiled.body_launches``, and a body that fails to build or launch
raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.hw import H100_SXM
from repro_torch.core.optlevel import OptLevel
from repro_torch.kernels.tiled_matmul import kernel
from repro_torch.kernels.tiled_matmul.ref import matmul_ref, matmul_tiled_ref

# Shared memory a block of B6 may claim: all 232,448 B a block can have.
# The reference keeps half of VMEM back for the pipeline's metadata and
# semaphores; B6 keeps nothing else in shared memory (its accumulator is
# in registers and cp.async needs no semaphores), and one block per SM is
# the occupancy the PE-duplication rung asks for.
SMEM_BUDGET = H100_SXM.smem_per_block

_DTYPES = (torch.float32, torch.bfloat16)
BODIES = ("cuda_core", "wgmma", "tf32x3")


def _fit(dim: int, want: int) -> int:
    """Largest divisor of ``dim`` that is <= want (prefers want itself)."""
    want = min(dim, want)
    for c in range(want, 0, -1):
        if dim % c == 0:
            return c
    return 1


def pick_blocks(M: int, N: int, K: int, *, level: OptLevel,
                elem_bytes: int = 4) -> tuple:
    """(bm, bn, bk) per the ladder's resource rules (the reference's
    rule, under ``SMEM_BUDGET``)."""
    bm = _fit(M, 256)
    bn = _fit(N, 256)
    bk = _fit(K, 512)
    n_buf = 2 if level >= OptLevel.O4 else 1   # double buffering in flight
    while n_buf * elem_bytes * (bm * bk + bk * bn + bm * bn) > SMEM_BUDGET:
        # shrink the largest contributor first (paper: shrink cache size,
        # spare BRAM for other strategies)
        if bk >= max(bm, bn) and bk > 1:
            bk = _fit(K, bk // 2)
        elif bm >= bn and bm > 1:
            bm = _fit(M, bm // 2)
        elif bn > 1:
            bn = _fit(N, bn // 2)
        else:
            break
    return bm, bn, bk


def pick_o1_blocks(M: int, N: int, K: int, *, elem_bytes: int = 4) -> tuple:
    """(bm, bn) of the O1 rung, whose stripes keep K whole.

    The reference takes ``pick_blocks``' bm and bn with bk = K: VMEM
    holds those stripes (2 MB at 1024^3 f32), a block's shared memory
    does not.  So bm and bn shrink by the same largest-first rule until
    (bm K + K bn + bm bn) x elem fits ``SMEM_BUDGET`` — under a budget
    that holds the reference's stripes this returns its blocks.  Raises
    if even 1 x 1 stripes do not fit."""
    bm, bn, _ = pick_blocks(M, N, K, level=OptLevel.O1,
                            elem_bytes=elem_bytes)
    while elem_bytes * (bm * K + K * bn + bm * bn) > SMEM_BUDGET:
        if bm >= bn and bm > 1:
            bm = _fit(M, bm // 2)
        elif bn > 1:
            bn = _fit(N, bn // 2)
        else:
            raise ValueError(
                f"O1 keeps K whole: 1 x 1 stripes of K = {K} take "
                f"{elem_bytes * (2 * K + 1)} B, over the {SMEM_BUDGET} B "
                f"of shared memory a block may use")
    return bm, bn


def wgmma_smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Shared memory of the tensor-core body's two-slot ring: per slot
    A's (bm x bk) tile and B's (bk x bn) tile as 64-column TMA boxes,
    bf16, plus 1 KB of alignment and two mbarriers a slot."""
    b_cols = -(-bn // 64) * 64
    return 2 * (bm * bk + bk * b_cols) * 2 + 1024 + 2 * 16


def tf32x3_smem_bytes(bm: int, bn: int, bk: int, stages: int) -> int:
    """Shared memory of the 3xTF32 body: per stage A's (bm x bk) tile
    with rows padded by 4 floats and B's (bk x bn) tile with rows padded
    by 8, f32."""
    return 4 * stages * (bm * (bk + 4) + bk * (bn + 8))


def body(dtype, M: int, N: int, K: int, bm: int, bn: int, bk: int, *,
         parallel_mn: bool = False, double_buffer: bool = False) -> str:
    """Which B6 body runs (M, K) @ (K, N) at blocks (bm, bn, bk) with
    the launch's ``parallel_mn`` and ``double_buffer`` (default: one
    block walking the tiles, one stage — the O2 launch):

    - ``"wgmma"`` (tensor cores, TMA) for bf16 with bm 64 or 128 (one or
      two warpgroups of 64 rows), bn a multiple of 16 up to 256 (the
      MMA's widths), bk a multiple of 64 (whole 128-byte swizzle boxes),
      N and K multiples of 8 (TMA's 16-byte row strides) and a two-slot
      ring that fits a block's shared memory;
    - ``"tf32x3"`` (tensor cores, 3xTF32 on mma.sync) for f32 with a
      block per tile (``parallel_mn``: O3 and O4), bm and bn 32, 64 or
      128 (8 warps of 16 x 8 tiles), bk a multiple of 8 (the MMA's
      depth), N and K multiples of 4 (16-byte copies) and the stages
      within a block's shared memory;
    - ``"cuda_core"`` otherwise (O1 and O2 among them)."""
    if (dtype == torch.bfloat16 and bm in (64, 128) and bn % 16 == 0
            and 16 <= bn <= 256 and bk % 64 == 0 and N % 8 == 0
            and K % 8 == 0
            and wgmma_smem_bytes(bm, bn, bk) <= SMEM_BUDGET):
        return "wgmma"
    if (dtype == torch.float32 and parallel_mn and bm in (32, 64, 128)
            and bn in (32, 64, 128) and bk % 8 == 0 and N % 4 == 0
            and K % 4 == 0
            and tf32x3_smem_bytes(bm, bn, bk, 2 if double_buffer else 1)
            <= SMEM_BUDGET):
        return "tf32x3"
    return "cuda_core"


def _check(a, b, *, blocks=None) -> None:
    """Raise unless a (M, K), b (K, N) are operands of B6/B7 (and
    ``blocks`` = (bm, bn, bk) divide M, N, K)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"want a (M, K), b (K, N); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if min(*a.shape, b.shape[1]) < 1:
        raise ValueError(f"empty operands {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"dtypes {a.dtype}, {b.dtype} (both float32 or "
                        f"both bfloat16)")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, "
                         f"{b.device}")
    if blocks is not None:
        dims = (a.shape[0], b.shape[1], a.shape[1])
        if any(x < 1 or d % x for x, d in zip(blocks, dims)):
            raise ValueError(f"blocks (bm, bn, bk) = {blocks} must divide "
                             f"(M, N, K) = {dims}")


def _on_card(a) -> bool:
    """True for CUDA operands, False for CPU ones; raises on any other."""
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the tiled matmul runs on cuda or cpu, not "
                         f"{a.device}")
    return a.device.type == "cuda"


def matmul_tiled(a, b, *, bm: int, bn: int, bk: int, parallel_mn: bool,
                 double_buffer: bool):
    """B6: blocked a @ b, a (M, K) and b (K, N) both f32 or both bf16 ->
    (M, N) float32, K walked in ``bk`` blocks with an f32 accumulator
    (bk = K is the O1 structure, K whole per tile).  ``parallel_mn``
    (O3+) gives each (M, N) tile a block of its own; otherwise one block
    walks them in order.  ``double_buffer`` (O4+) keeps the next
    k-block's copies in flight.  ``body`` picks the kernel."""
    _check(a, b, blocks=(bm, bn, bk))
    if not _on_card(a):
        return matmul_tiled_ref(a, b, bk=bk)
    M, K = a.shape
    N = b.shape[1]
    which = body(a.dtype, M, N, K, bm, bn, bk, parallel_mn=parallel_mn,
                 double_buffer=double_buffer)
    a, b = a.contiguous(), b.contiguous()
    if which != "cuda_core":
        # TMA and 16-byte cp.async read from 16-byte aligned addresses; a
        # view that starts elsewhere is copied (the body stays the same).
        a, b = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (a, b))
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    launch = {"wgmma": kernel.launch_wgmma, "tf32x3": kernel.launch_tf32x3,
              "cuda_core": kernel.launch_tiled}[which]
    launch(a, b, out, bm=bm, bn=bn, bk=bk,
           grid=(M // bm) * (N // bn) if parallel_mn else 1,
           stages=2 if double_buffer else 1)
    matmul_tiled.launches += 1
    matmul_tiled.body_launches[which] += 1
    return out


def matmul_whole(a, b):
    """B7: a (M, K) @ b (K, N), both f32 or both bf16 as given ->
    (M, N) float32, computed by one block against device memory."""
    _check(a, b)
    if not _on_card(a):
        return matmul_ref(a, b)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    kernel.launch_whole(a, b, out)
    matmul_whole.launches += 1
    return out


matmul_tiled.launches = 0
matmul_tiled.body_launches = dict.fromkeys(BODIES, 0)
matmul_whole.launches = 0


def rung(level: OptLevel, M: int, N: int, K: int, *,
         blocks: tuple = None) -> dict:
    """What B6 runs at ``level`` >= O1 for (M, K) @ (K, N): the operand
    dtype (f32 at O1..O4, bf16 from O5 on: the scratchpad
    reorganization) and ``matmul_tiled``'s arguments.  ``blocks`` =
    (bm, bn, bk) replaces the picked blocks; O1 reads only bm and bn, as
    its bk is K."""
    level = OptLevel(level)
    if level == OptLevel.O0:
        raise ValueError("O0 runs B7 (matmul_whole), which takes no blocks")
    dtype, elem = ((torch.bfloat16, 2) if level >= OptLevel.O5
                   else (torch.float32, 4))
    if level == OptLevel.O1:
        bm, bn = (blocks[:2] if blocks
                  else pick_o1_blocks(M, N, K, elem_bytes=elem))
        bk = K
    else:
        bm, bn, bk = blocks or pick_blocks(M, N, K, level=level,
                                           elem_bytes=elem)
    return {"dtype": dtype, "bm": bm, "bn": bn, "bk": bk,
            "parallel_mn": level >= OptLevel.O3,
            "double_buffer": level >= OptLevel.O4}


def matmul(a, b, level: OptLevel = OptLevel.O5, *, blocks: tuple = None):
    """Best-effort blocked matmul.  Returns float32 (M, N).

    O0 runs B7 on a and b as given (f32 or bf16); O1..O4 run B6 on them
    cast to f32 and O5 up on them cast to bf16, as the reference does
    (see ``rung``)."""
    level = OptLevel(level)
    if level == OptLevel.O0:
        return matmul_whole(a, b)
    args = rung(level, a.shape[0], b.shape[1], a.shape[1], blocks=blocks)
    dtype = args.pop("dtype")
    return matmul_tiled(a.to(dtype), b.to(dtype), **args)
