"""ctypes binding of the CUDA paged-attention kernel's two bodies
(``csrc/``).

Both replace ``repro/kernels/paged_attention/kernel.py::
paged_attention_pallas`` (B1: one query per slot) and
``paged_prefill_attention_pallas`` (B2: Q queries per slot), wide pools
and the narrow (int8, fp8 e4m3) pools of their quantized branch alike.
``launch`` and ``launch_prefill`` run the CUDA-core body
(``csrc/paged_attention.cu``); ``launch_split`` runs the tensor-core
body for bf16 queries (``csrc/paged_attention_split.cu``: positions
split across blocks, mma.sync), B1 and B2 in one entry point, with its
workspace from a per-device, per-stream cache.  ``ops.body`` picks one.
Their design and bound are described in the sources; each is built into
a library of its own with nvcc on first launch (``kernels/_build.py``),
never at import.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCES = (Path(__file__).parent / "csrc" / "paged_attention.cu",)
SPLIT_SOURCES = (Path(__file__).parent / "csrc" / "paged_attention_split.cu",)

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


@functools.cache
def _split_entry():
    lib = _build.load_library("paged_attention_split", SPLIT_SOURCES)
    fn = lib.paged_attention_split
    fn.argtypes = [_P] * 11 + [_I] * 11 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


# The split body's workspace, grown on demand and kept per (device,
# stream): an f32 buffer for the rows' (m, l) and partial P V, and the
# tiles' arrival counters, which start at zero and which the kernel
# leaves at zero.  Calls on one stream run in order, so they share it.
# Each entry is (f32 buffer, counters, f32 pointer, counters pointer).
_WORKSPACE: dict = {}


def _workspace(device, stream: int, n_f32: int, n_counters: int):
    have = _WORKSPACE.get((device, stream))
    if have is None or have[0].numel() < n_f32 or have[1].numel() < \
            n_counters:
        f32 = torch.empty(max(n_f32, have[0].numel() if have else 0),
                          dtype=torch.float32, device=device)
        cnt = torch.zeros(max(n_counters, have[1].numel() if have else 0),
                          dtype=torch.int32, device=device)
        have = _WORKSPACE[(device, stream)] = (f32, cnt, f32.data_ptr(),
                                               cnt.data_ptr())
    return have


@functools.cache
def _split_plan(B, Q, H, KV, D, T, nb, rows, P):
    """(NP partitions, f32 words before the partials, f32 words and
    counters of the workspace) of one launch geometry."""
    NP = max(1, -(-nb * T // P))
    GQ = H // KV * Q
    n_ml = -(-2 * B * KV * GQ * NP // 4) * 4     # partials on 16 bytes
    return NP, n_ml, n_ml + B * KV * GQ * NP * D, B * KV * -(-GQ // rows)


def launch_split(q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out,
                 scale: float, *, Q: int, rows: int, P: int) -> None:
    """The split tensor-core body on the current stream, for B1 and B2
    alike: q and out (B, Q, H, D) bf16, or (B, H, D) with ``Q`` = 1, q
    16-byte aligned; ``rows`` the row tile (16, 32 or 64) and ``P`` the
    partition's positions (``ops.row_tile``, ``ops.partition_positions``);
    the rest as :func:`launch`.  Raises if the launch was refused."""
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    _R, T, KV, _ = k_pool.shape
    nb = tables.shape[1]
    NP, n_ml, n_f32, n_cnt = _split_plan(B, Q, H, KV, D, T, nb, rows, P)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _, _, f32, cnt = _workspace(q.device, stream, n_f32, n_cnt)
    scales = ((None, None) if k_scale is None
              else (k_scale.data_ptr(), v_scale.data_ptr()))
    err = _split_entry()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *scales,
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), f32,
        f32 + 4 * n_ml, cnt, B, Q, H, KV, D, T, nb, rows, P, NP,
        _KV_KIND[k_pool.dtype], scale, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention split kernel launch failed: "
                           f"CUDA error {err}")
