"""ctypes binding of the CUDA RWKV-6 WKV kernel (``csrc/``).

The kernel replaces ``repro/kernels/rwkv6_wkv/kernel.py::wkv_pallas``
(B4); its design and bound are described in ``csrc/rwkv6_wkv.cu``.  The
library is built with nvcc on first launch (``kernels/_build.py``), never
at import.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCES = (Path(__file__).parent / "csrc" / "rwkv6_wkv.cu",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.cache
def _entry():
    """The bound C entry point, resolved once (see flash_attention)."""
    lib = _build.load_library("rwkv6_wkv", SOURCES)
    fn = lib.rwkv6_wkv_forward
    fn.argtypes = [_P] * 8 + [_I] * 6 + [_L] * 12 + [_P]
    fn.restype = _I
    return fn


def launch(r, k, v, lw, u, s0, y, sf, *, chunk: int) -> None:
    """B4 on the current stream: r, k, v, lw (B, S, H, N) with unit
    stride on N; u (H, N) and y (B, S, H, N) contiguous; s0 (B, H, N, N)
    f32 contiguous or None; sf (B, H, N, N) f32.  The caller has
    validated device, dtypes, shapes and strides and allocated y and sf.
    Raises if the launch was refused."""
    B, S, H, N = r.shape
    strides = [s for t in (r, k, v, lw) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                   u.data_ptr(), None if s0 is None else s0.data_ptr(),
                   y.data_ptr(), sf.data_ptr(), B, S, H, N, chunk,
                   int(r.dtype == torch.bfloat16), *strides, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed: CUDA error "
                           f"{err}")
