"""ctypes binding of the CUDA blocked-matmul kernels (``csrc/``).

``launch_tiled`` is B6's CUDA-core body, ``launch_wgmma`` its
tensor-core body for bf16 tiles and ``launch_tf32x3`` its tensor-core
body for the f32 rungs with a block per tile (all three replace
``repro/kernels/tiled_matmul/kernel.py::matmul_pallas``; ``ops.body``
picks one); ``launch_whole`` is B7 (replaces ``matmul_whole``).  Their
design and bound are described in ``csrc/tiled_matmul.cu``,
``csrc/tiled_matmul_wgmma.cu`` and ``csrc/tiled_matmul_tf32x3.cu``, each
built into a library of its own with nvcc on first launch
(``kernels/_build.py``), never at import.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCES = (Path(__file__).parent / "csrc" / "tiled_matmul.cu",)
WGMMA_SOURCES = (Path(__file__).parent / "csrc" / "tiled_matmul_wgmma.cu",)
TF32X3_SOURCES = (Path(__file__).parent / "csrc" /
                  "tiled_matmul_tf32x3.cu",)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _entries():
    """The two bound C entry points, resolved once (see flash_attention)."""
    lib = _build.load_library("tiled_matmul", SOURCES)
    tiled = lib.tiled_matmul_forward
    tiled.argtypes = [_P] * 3 + [_I] * 9 + [_P]
    tiled.restype = _I
    whole = lib.whole_matmul_forward
    whole.argtypes = [_P] * 3 + [_I] * 4 + [_P]
    whole.restype = _I
    return tiled, whole


@functools.cache
def _wgmma_entry():
    lib = _build.load_library("tiled_matmul_wgmma", WGMMA_SOURCES)
    fn = lib.tiled_matmul_wgmma_forward
    fn.argtypes = [_P] * 3 + [_I] * 8 + [_P]
    fn.restype = _I
    return fn


@functools.cache
def _tf32x3_entry():
    lib = _build.load_library("tiled_matmul_tf32x3", TF32X3_SOURCES)
    fn = lib.tiled_matmul_tf32x3_forward
    fn.argtypes = [_P] * 3 + [_I] * 8 + [_P]
    fn.restype = _I
    return fn


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def launch_tiled(a, b, out, *, bm: int, bn: int, bk: int, grid: int,
                 stages: int) -> None:
    """B6 on the current stream: a (M, K) and b (K, N) contiguous, both
    f32 or both bf16; out (M, N) f32 contiguous; bm, bn, bk divide M, N,
    K; ``grid`` blocks walk the (M/bm, N/bn) tiles in row-major order
    (1 for the one-SM rungs); ``stages`` 1 or 2 k-blocks in flight.  The
    caller has validated all of it and allocated ``out``.  Raises if the
    launch was refused (also when the tiles do not fit a block's shared
    memory)."""
    M, K = a.shape
    N = b.shape[1]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _entries()[0](a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                        bm, bn, bk, grid, stages,
                        int(a.dtype == torch.bfloat16), stream)
    _raise_on(err, "tiled_matmul")


def launch_wgmma(a, b, out, *, bm: int, bn: int, bk: int, grid: int,
                 stages: int) -> None:
    """B6's tensor-core body on the current stream: a (M, K) and b (K, N)
    bf16, contiguous and 16-byte aligned; out (M, N) f32 contiguous; the
    blocks divide the shape and meet ``ops.body``'s rule; ``grid`` and
    ``stages`` as for ``launch_tiled``.  Encodes the two TMA descriptors
    on the host.  Raises if the launch was refused."""
    M, K = a.shape
    N = b.shape[1]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _wgmma_entry()(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N,
                         K, bm, bn, bk, grid, stages, stream)
    _raise_on(err, "tiled_matmul_wgmma")


def launch_tf32x3(a, b, out, *, bm: int, bn: int, bk: int, grid: int,
                  stages: int) -> None:
    """B6's 3xTF32 body on the current stream: a (M, K) and b (K, N)
    f32, contiguous and 16-byte aligned; out (M, N) f32 contiguous; the
    blocks divide the shape and meet ``ops.body``'s rule; ``grid`` and
    ``stages`` as for ``launch_tiled``.  Raises if the launch was
    refused."""
    M, K = a.shape
    N = b.shape[1]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _tf32x3_entry()(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N,
                          K, bm, bn, bk, grid, stages, stream)
    _raise_on(err, "tiled_matmul_tf32x3")


def launch_whole(a, b, out) -> None:
    """B7 on the current stream: a (M, K), b (K, N) contiguous, both f32
    or both bf16; out (M, N) f32 contiguous, allocated by the caller.
    Raises if the launch was refused."""
    M, K = a.shape
    N = b.shape[1]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _entries()[1](a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                        int(a.dtype == torch.bfloat16), stream)
    _raise_on(err, "whole_matmul")
