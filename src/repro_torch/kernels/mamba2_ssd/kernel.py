"""ctypes binding of the CUDA Mamba-2 SSD kernel's two bodies (``csrc/``).

Both replace ``repro/kernels/mamba2_ssd/kernel.py::ssd_pallas`` (B5): the
chunk-parallel tensor-core body (``csrc/mamba2_ssd_chunk.cu``: three
launches, 3xTF32 on mma.sync) and the CUDA-core body
(``csrc/mamba2_ssd.cu``: one block walks one head's chunks); ``ops.body``
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

SOURCES = (Path(__file__).parent / "csrc" / "mamba2_ssd.cu",)
CHUNK_SOURCES = (Path(__file__).parent / "csrc" / "mamba2_ssd_chunk.cu",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _bind(lib: ctypes.CDLL):
    """The CUDA-core body's C entry point of a built library, with its
    argument types."""
    fn = lib.mamba2_ssd_forward
    fn.argtypes = [_P] * 8 + [_I] * 7 + [_L] * 9 + [_P]
    fn.restype = _I
    return fn


def bind_chunk(lib: ctypes.CDLL, symbol: str = "mamba2_ssd_chunk_forward"):
    """The chunk body's C entry point ``symbol`` of a built library (a
    design variant's in ``scripts/scan_body_ab.py``): the CUDA-core
    body's arguments with the scratch st, cum, tot after sf."""
    fn = getattr(lib, symbol)
    fn.argtypes = [_P] * 11 + [_I] * 7 + [_L] * 9 + [_P]
    fn.restype = _I
    return fn


@functools.cache
def _entry(body: str = "cuda_core"):
    """The bound C entry point of ``body``, resolved once (see
    flash_attention)."""
    if body == "chunk_tf32x3":
        return bind_chunk(_build.load_library("mamba2_ssd_chunk",
                                              CHUNK_SOURCES))
    return _bind(_build.load_library("mamba2_ssd", SOURCES))


def scratch(B: int, S: int, H: int, P: int, N: int, Q: int, device):
    """The chunk body's f32 scratch: each chunk's state (B, nc, H, P, N),
    its cums (B, nc, H, Q) and its total decays (B, nc, H)."""
    nc = S // Q
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((B, nc, H, P, N), **f32),
            torch.empty((B, nc, H, Q), **f32), torch.empty((B, nc, H), **f32))


def launch(x, dt, A, Bs, Cs, s0, y, sf, *, chunk: int,
           body: str = "cuda_core") -> None:
    """B5's ``body`` on the current stream: x (B, S, H, P) with unit
    stride on P; dt (B, S, H) with unit stride on H; Bs, Cs (B, S, N)
    with unit stride on N; A (H,) contiguous; s0 (B, H, P, N) f32
    contiguous (16-byte aligned for the chunk body) or None; y (B, S, H,
    P) contiguous; sf (B, H, P, N) f32; ``chunk`` the model's chunk
    length (at most 256, dividing S).  The caller has validated device,
    dtypes, shapes and strides, checked that ``body`` takes them
    (``ops.body``) and allocated y and sf; the chunk body's scratch is
    allocated here.  Raises if a launch was refused."""
    B, S, H, P = x.shape
    N = Bs.shape[-1]
    strides = (*x.stride()[:3], *dt.stride()[:2], *Bs.stride()[:2],
               *Cs.stride()[:2])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [t.data_ptr() for t in (x, dt, A, Bs, Cs)] + [
        None if s0 is None else s0.data_ptr(), y.data_ptr(), sf.data_ptr()]
    if body == "chunk_tf32x3":
        ptrs += [t.data_ptr() for t in scratch(B, S, H, P, N, chunk,
                                               x.device)]
    err = _entry(body)(*ptrs, B, S, H, P, N, chunk,
                       int(x.dtype == torch.bfloat16), *strides, stream)
    if err != 0:
        raise RuntimeError(f"mamba2_ssd ({body} body) kernel launch failed: "
                           f"CUDA error {err}")
