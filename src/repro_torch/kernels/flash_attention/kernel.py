"""ctypes binding of the CUDA flash-attention kernel's two bodies
(``csrc/``).

Both replace ``repro/kernels/flash_attention/kernel.py::
flash_attention_pallas`` (B3): the bf16 tensor-core body
(``csrc/flash_attention_mma.cu``) and the f32 CUDA-core body
(``csrc/flash_attention.cu``); ``ops.body`` picks one by dtype and
``launch`` runs it.  Their design and bound are described in the
sources.  Each is built into a library of its own with nvcc on first
launch (``kernels/_build.py``), never at import.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCES = (Path(__file__).parent / "csrc" / "flash_attention.cu",)
MMA_SOURCES = (Path(__file__).parent / "csrc" / "flash_attention_mma.cu",)

_P = ctypes.c_void_p
_I = ctypes.c_int


def bind(fn):
    """Declare a body's C entry point's arguments: q, k, v, out, B, S,
    S_kv, H, Hkv, head_dim, causal, scale, stream."""
    fn.argtypes = [_P] * 4 + [_I] * 7 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


@functools.cache
def _entry(name: str):
    """The bound C entry point of body ``name``, resolved once: building
    or finding the library hashes the sources, which a launch must not
    pay each time."""
    if name == "mma":
        lib = _build.load_library("flash_attention_mma", MMA_SOURCES)
        return bind(lib.flash_attention_mma_forward)
    lib = _build.load_library("flash_attention", SOURCES)
    return bind(lib.flash_attention_forward)


def launch(q, k, v, out, *, causal: bool, scale: float, body: str) -> None:
    """B3's ``body`` ("mma" for bf16, "cuda_core" for f32) on the current
    stream: q and out (B, S, H, D), k and v (B, S_kv, Hkv, D), all of
    the body's dtype.  The caller has validated device, dtypes, shapes
    and contiguity and allocated ``out``.  Raises if the launch was
    refused."""
    B, S, H, D = q.shape
    S_kv, Hkv = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry(body)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), B, S, S_kv, H, Hkv, D, int(causal),
                       scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({body} body) kernel launch "
                           f"failed: CUDA error {err}")
