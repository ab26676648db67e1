"""Shared helpers for the MachSuite level ladder (port of
``repro/machsuite/common.py``).

``pack_u8_to_u32`` / ``unpack_u32_to_u8`` come with the byte kernels
that use them (aes, kmp, nw; ROADMAP A18).
"""

from __future__ import annotations

from repro_torch.core.optlevel import OptLevel, Step

__all__ = ["OptLevel", "Step", "has", "rotate3"]


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
