"""ctypes binding of the CUDA flash-attention kernel (``csrc/``).

The kernel replaces ``repro/kernels/flash_attention/kernel.py::
flash_attention_pallas`` (B3); its design and bound are described in
``csrc/flash_attention.cu``.  The library is built with nvcc on first
launch (``kernels/_build.py``), never at import.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCES = (Path(__file__).parent / "csrc" / "flash_attention.cu",)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _entry():
    """The bound C entry point, resolved once: building or finding the
    library hashes the sources, which a launch must not pay each time."""
    lib = _build.load_library("flash_attention", SOURCES)
    fn = lib.flash_attention_forward
    fn.argtypes = [_P] * 4 + [_I] * 8 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


def launch(q, k, v, out, *, causal: bool, scale: float) -> None:
    """B3 on the current stream: q and out (B, S, H, D), k and v
    (B, S_kv, Hkv, D).  The caller has validated device, dtypes, shapes
    and contiguity and allocated ``out``.  Raises if the
    launch was refused."""
    B, S, H, D = q.shape
    S_kv, Hkv = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, S, S_kv, H, Hkv, D, int(causal),
                   int(q.dtype == torch.bfloat16), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
