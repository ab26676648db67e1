"""ctypes binding of the CUDA Mamba-2 SSD kernel (``csrc/``).

The kernel replaces ``repro/kernels/mamba2_ssd/kernel.py::ssd_pallas``
(B5); its design and bound are described in ``csrc/mamba2_ssd.cu``.  The
library is built with nvcc on first launch (``kernels/_build.py``), never
at import.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCES = (Path(__file__).parent / "csrc" / "mamba2_ssd.cu",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _bind(lib: ctypes.CDLL):
    """The C entry point of a built library, with its argument types."""
    fn = lib.mamba2_ssd_forward
    fn.argtypes = [_P] * 8 + [_I] * 7 + [_L] * 9 + [_P]
    fn.restype = _I
    return fn


@functools.cache
def _entry():
    """The bound C entry point, resolved once (see flash_attention)."""
    return _bind(_build.load_library("mamba2_ssd", SOURCES))


def launch(x, dt, A, Bs, Cs, s0, y, sf, *, chunk: int) -> None:
    """B5 on the current stream: x (B, S, H, P) with unit stride on P;
    dt (B, S, H) with unit stride on H; Bs, Cs (B, S, N) with unit
    stride on N; A (H,) contiguous; s0 (B, H, P, N) f32 contiguous or
    None; y (B, S, H, P) contiguous; sf (B, H, P, N) f32; ``chunk``
    the model's chunk length (at most 256, dividing S).  The caller has
    validated device, dtypes, shapes and strides and allocated y and sf.
    Raises if the launch was refused."""
    B, S, H, P = x.shape
    N = Bs.shape[-1]
    strides = (*x.stride()[:3], *dt.stride()[:2], *Bs.stride()[:2],
               *Cs.stride()[:2])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bs.data_ptr(),
                   Cs.data_ptr(), None if s0 is None else s0.data_ptr(),
                   y.data_ptr(), sf.data_ptr(), B, S, H, P, N, chunk,
                   int(x.dtype == torch.bfloat16), *strides, stream)
    if err != 0:
        raise RuntimeError(f"mamba2_ssd kernel launch failed: CUDA error "
                           f"{err}")
