"""ctypes binding of the CUDA paged-decode kernel (``csrc/``).

The kernel replaces ``repro/kernels/paged_attention/kernel.py::
paged_attention_pallas``; its design and bound are described in
``csrc/paged_attention.cu``.  The library is built with nvcc on first
launch (``kernels/_build.py``), never at import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCES = (Path(__file__).parent / "csrc" / "paged_attention.cu",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 6 + [_I, _I, ctypes.c_float, _P]


def _entry():
    lib = _build.load_library("paged_attention", SOURCES)
    fn = lib.paged_attention_decode
    fn.argtypes = _ARGTYPES
    fn.restype = _I
    return fn


def launch(q, k_pool, v_pool, tables, lengths, out, scale: float) -> None:
    """Launch on the current stream; the caller has validated device,
    dtypes, shapes and contiguity and allocated ``out``.  Raises if the
    launch was refused."""
    B, H, D = q.shape
    _R, T, KV, _ = k_pool.shape
    nb = tables.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, H, KV, D, T, nb,
        int(q.dtype == torch.bfloat16), int(k_pool.dtype == torch.bfloat16),
        scale, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
