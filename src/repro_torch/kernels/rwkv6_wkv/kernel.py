"""ctypes binding of the CUDA RWKV-6 WKV kernel's two bodies (``csrc/``).

Both replace ``repro/kernels/rwkv6_wkv/kernel.py::wkv_pallas`` (B4): the
chunk-parallel tensor-core body (``csrc/rwkv6_wkv_chunk.cu``: three
launches, 3xTF32 on mma.sync) and the CUDA-core body
(``csrc/rwkv6_wkv.cu``: one block walks one head's chunks); ``ops.body``
picks one and ``launch`` runs it.  Their design and bound are described
in the sources.  Each is built into a library of its own with nvcc on
first launch (``kernels/_build.py``), never at import.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCES = (Path(__file__).parent / "csrc" / "rwkv6_wkv.cu",)
CHUNK_SOURCES = (Path(__file__).parent / "csrc" / "rwkv6_wkv_chunk.cu",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def bind_chunk(lib: ctypes.CDLL, symbol: str = "rwkv6_wkv_chunk_forward"):
    """The chunk body's C entry point ``symbol`` of a built library (a
    design variant's in ``scripts/scan_body_ab.py``): the CUDA-core
    body's arguments with the scratch st, tot after sf."""
    fn = getattr(lib, symbol)
    fn.argtypes = [_P] * 10 + [_I] * 6 + [_L] * 12 + [_P]
    fn.restype = _I
    return fn


@functools.cache
def _entry(body: str = "cuda_core"):
    """The bound C entry point of ``body``, resolved once (see
    flash_attention)."""
    if body == "chunk_tf32x3":
        return bind_chunk(_build.load_library("rwkv6_wkv_chunk",
                                              CHUNK_SOURCES))
    lib = _build.load_library("rwkv6_wkv", SOURCES)
    fn = lib.rwkv6_wkv_forward
    fn.argtypes = [_P] * 8 + [_I] * 6 + [_L] * 12 + [_P]
    fn.restype = _I
    return fn


def scratch(B: int, S: int, H: int, N: int, Q: int, device):
    """The chunk body's f32 scratch: each chunk's state (B, nc, H, N, N)
    and its total decays (B, nc, H, N)."""
    nc = S // Q
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((B, nc, H, N, N), **f32),
            torch.empty((B, nc, H, N), **f32))


def launch(r, k, v, lw, u, s0, y, sf, *, chunk: int,
           body: str = "cuda_core") -> None:
    """B4's ``body`` on the current stream: r, k, v, lw (B, S, H, N) with
    unit stride on N; u (H, N) and y (B, S, H, N) contiguous; s0 (B, H,
    N, N) f32 contiguous (16-byte aligned for the chunk body) or None; sf
    (B, H, N, N) f32.  The caller has validated device, dtypes, shapes
    and strides, checked that ``body`` takes them (``ops.body``) and
    allocated y and sf; the chunk body's scratch is allocated here.
    Raises if a launch was refused."""
    B, S, H, N = r.shape
    strides = [s for t in (r, k, v, lw) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(r.device).cuda_stream
    ptrs = [t.data_ptr() for t in (r, k, v, lw, u)] + [
        None if s0 is None else s0.data_ptr(), y.data_ptr(), sf.data_ptr()]
    if body == "chunk_tf32x3":
        ptrs += [t.data_ptr() for t in scratch(B, S, H, N, chunk, r.device)]
    err = _entry(body)(*ptrs, B, S, H, N, chunk,
                       int(r.dtype == torch.bfloat16), *strides, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv ({body} body) kernel launch failed: "
                           f"CUDA error {err}")
