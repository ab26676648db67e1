"""Shared helpers for the MachSuite level ladder (port of
``repro/machsuite/common.py``): the 3-slot rotation every O4/O5 uses,
and the packed-word staging of the byte kernels' O5 (aes, kmp, nw).

The staged words are ``torch.int32``: the same 32 bits, little-endian,
as the reference's uint32 words, read as signed (a word whose byte 3 is
0x80 or more is negative).  ``torch.uint32`` is a thin dtype (its ``<<``
and ``>>`` are not implemented), so the packing widens to ``int64``,
shifts, ORs and masks there, and only the finished words are narrowed.
Every op on the way (``to``, ``<<``, ``>>``, ``|``, ``&``, ``^``, ``-``
on int64; ``to`` and slot writes on int32) exists on the CPU and CUDA.
Compare packed words with the reference's as uint32 bit patterns
(``words.numpy().view(np.uint32)``).
"""

from __future__ import annotations

import torch

from repro_torch.core.optlevel import OptLevel, Step

__all__ = ["OptLevel", "Step", "has", "rotate3", "pack_u8_to_u32",
           "unpack_u32_to_u8"]


def has(level: OptLevel, step: Step) -> bool:
    return level.has(step)


def rotate3(body, n_iters: int, init_bufs):
    """Paper Fig. 4(c): explicit 3-slot load/compute/store rotation.

    ``body(i, slot, bufs) -> bufs`` performs the load/compute/store trio for
    phase ``i`` against buffer group ``slot`` (= i % 3).  Numerically the
    rotation is an identity scheduling transform; the structure is what is
    faithful.
    """
    bufs = init_bufs
    for i in range(n_iters):
        bufs = body(i, i % 3, bufs)
    return bufs


def pack_u8_to_u32(x_u8: torch.Tensor) -> torch.Tensor:
    """Pack a (..., 4k) uint8 tensor into (..., k) little-endian 32-bit
    words — the paper's ap_uint<W> wide scratchpad word (§5.2).  The words
    are ``torch.int32`` holding the reference's uint32 bits."""
    assert x_u8.shape[-1] % 4 == 0, x_u8.shape
    x = x_u8.reshape(*x_u8.shape[:-1], -1, 4).to(torch.int64)
    w = (x[..., 0] | (x[..., 1] << 8) | (x[..., 2] << 16)
         | (x[..., 3] << 24))
    # [0, 2^32) -> [-2^31, 2^31) with the low 32 bits unchanged
    return ((w ^ 0x80000000) - 0x80000000).to(torch.int32)


def unpack_u32_to_u8(x_u32: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_u8_to_u32` (takes its int32 words)."""
    w = x_u32.to(torch.int64) & 0xFFFFFFFF
    parts = [(w >> (8 * i)) & 0xFF for i in range(4)]
    out = torch.stack(parts, dim=-1).to(torch.uint8)
    return out.reshape(*x_u32.shape[:-1], -1)
