"""ctypes binding of the CUDA paged-attention kernel (``csrc/``).

The kernel replaces ``repro/kernels/paged_attention/kernel.py::
paged_attention_pallas`` (B1, ``launch``: one query per slot) and
``paged_prefill_attention_pallas`` (B2, ``launch_prefill``: Q queries
per slot), wide pools and the narrow (int8, fp8 e4m3) pools of their
quantized branch alike; its design and bound are described in
``csrc/paged_attention.cu``.  The library is built with nvcc on first
launch (``kernels/_build.py``), never at import.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCES = (Path(__file__).parent / "csrc" / "paged_attention.cu",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_TAIL = [_I, _I, ctypes.c_float, _P]     # q_bf16, kv_kind, scale, stream
# The kernel's PoolKind code of each pool dtype.
_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.float8_e4m3fn: 3}


@functools.cache
def _entry(name: str, n_ints: int):
    """The bound C entry point, resolved once: building or finding the
    library hashes the sources, which a launch must not pay each time."""
    lib = _build.load_library("paged_attention", SOURCES)
    fn = getattr(lib, name)
    fn.argtypes = [_P] * 8 + [_I] * n_ints + _TAIL
    fn.restype = _I
    return fn


def _run(fn, dims, q, k_pool, v_pool, k_scale, v_scale, tables, lengths,
         out, scale):
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scales = ((None, None) if k_scale is None
              else (k_scale.data_ptr(), v_scale.data_ptr()))
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *scales,
             tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), *dims,
             int(q.dtype == torch.bfloat16), _KV_KIND[k_pool.dtype], scale,
             stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")


def launch(q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out,
           scale: float) -> None:
    """B1 on the current stream: q and out (B, H, D); ``k_scale`` and
    ``v_scale`` the (R, KV) f32 scales of a narrow pool, else None.  The
    caller has validated device, dtypes, shapes and contiguity and
    allocated ``out``.  Raises if the launch was refused."""
    B, H, D = q.shape
    _R, T, KV, _ = k_pool.shape
    _run(_entry("paged_attention_decode", 6),
         (B, H, KV, D, T, tables.shape[1]),
         q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, scale)


def launch_prefill(q, k_pool, v_pool, k_scale, v_scale, tables, lengths,
                   out, scale: float) -> None:
    """B2 on the current stream: q and out (B, Q, H, D); same contract
    as :func:`launch`."""
    B, Q, H, D = q.shape
    _R, T, KV, _ = k_pool.shape
    _run(_entry("paged_attention_prefill", 7),
         (B, Q, H, KV, D, T, tables.shape[1]),
         q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, scale)
