"""Public wrappers: paged attention straight off a KV block pool.

``paged_attention`` (one query per slot, kernel B1) and
``paged_prefill_attention`` (Q queries per slot, kernel B2) check what
the kernel takes and raise on anything else, then launch the CUDA kernel
for CUDA tensors — no fallback — or run the plain version (``ref``) for
CPU tensors.  Each kernel launch adds one to the wrapper's ``launches``.
Both read wide pools (bf16, f32) and, with ``k_scale``/``v_scale``,
narrow ones (int8, float8_e4m3fn): the quantized branch.

The kernel has two bodies.  ``body`` picks one from the q and pool
dtypes and the head width alone, before any launch: bf16 q on a bf16,
int8 or fp8 pool with head_dim a multiple of 16 up to 256 runs
``csrc/paged_attention_split.cu`` (``"split_mma"``: positions split into
partitions of ``partition_positions(T, D)`` across blocks, mma.sync,
two device kernels a call), everything else — f32 q, f32 pools —
``csrc/paged_attention.cu`` (``"cuda_core"``).  This is routing, not a
fallback: each body counts its launches in the wrapper's
``body_launches``, and a body that fails to build or launch raises.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels.paged_attention import kernel
from repro_torch.kernels.paged_attention.ref import (
    kernel_scale, paged_attention_ref, paged_prefill_attention_ref)

_DTYPES = (torch.bfloat16, torch.float32)
_NARROW = (torch.int8, torch.float8_e4m3fn)
_INTS = (torch.int32, torch.int64)
# Shared memory a block may use on Hopper (227 KB), and the kernel's
# (query row, dim) accumulator slots: 128 threads x 8 registers.
_SMEM_LIMIT = 232_448
_MAX_RD = 1024
BODIES = ("split_mma", "cuda_core")
# The split body: positions a chunk, and the partition's positions at
# T dividing 64 (scripts/paged_split_ab.py sweeps 64..512 at the decode,
# chunk and verify shapes).
_CHUNK = 64
_PARTITION = 128


@functools.cache
def body(q_dtype, pool_dtype, head_dim: int) -> str:
    """Which body runs: ``"split_mma"`` for bf16 q on a bf16, int8 or
    fp8 e4m3 pool with head_dim a multiple of 16 up to 256 (the mma's k
    step; wider would not keep a 64-row tile's accumulator in
    registers), ``"cuda_core"`` otherwise."""
    if (q_dtype == torch.bfloat16 and pool_dtype in (torch.bfloat16,)
            + _NARROW and head_dim % 16 == 0 and 16 <= head_dim <= 256):
        return "split_mma"
    return "cuda_core"


@functools.cache
def partition_positions(T: int, D: int) -> int:
    """Positions of one partition of the split body: whole 64-position
    chunks and whole pool blocks, fixed by (T, D) alone — never by Q, the
    row tile or a slot's length, so a row's partitions are a function of
    its positions only."""
    unit = math.lcm(_CHUNK, T)
    return unit * max(1, _PARTITION // unit)


def row_tile(rows: int) -> int:
    """Rows of one tile of the split body for a kv head's G Q rows: 16,
    32 or 64 (one to four m16 tiles)."""
    return 16 if rows <= 16 else 32 if rows <= 32 else 64


def _check_scales(k_pool, k_scale, v_scale):
    """Scales come together, for narrow pools only: (R, KV) f32,
    contiguous, on the pools' device."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    narrow = k_pool.dtype in _NARROW
    if narrow != (k_scale is not None):
        raise ValueError(f"a {k_pool.dtype} pool takes "
                         f"{'k_scale/v_scale' if narrow else 'no scales'}")
    if k_scale is None:
        return
    R, _T, KV, _D = k_pool.shape
    want = (R, KV)
    if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
        raise ValueError(f"scale shape mismatch: want {want}, got "
                         f"k {tuple(k_scale.shape)}, v "
                         f"{tuple(v_scale.shape)}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError(f"scales must be float32, got {k_scale.dtype}/"
                         f"{v_scale.dtype}")
    if not (k_scale.is_contiguous() and v_scale.is_contiguous()):
        raise ValueError("scales must be contiguous")
    if {k_scale.device, v_scale.device} != {k_pool.device}:
        raise ValueError(f"scales on {k_scale.device}/{v_scale.device}, "
                         f"pools on {k_pool.device}")


def _check(q, k_pool, v_pool, tables, lengths, k_scale=None, v_scale=None):
    """Raise unless the kernel takes these operands; q is (B, Q, H, D)."""
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(f"want q (B, [Q,] H, D) and pools (R, T, KV, D); "
                         f"got q {tuple(q.shape)}, k {tuple(k_pool.shape)}")
    B, Q, H, D = q.shape
    _R, T, KV, Dk = k_pool.shape
    if H % KV != 0:
        raise ValueError(f"H={H} must be a multiple of KV={KV}")
    if Dk != D or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool/query shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k_pool.shape)}, v {tuple(v_pool.shape)}")
    if tables.dim() != 2 or tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"tables/lengths shape mismatch: want (B, nb) and "
                         f"(B,) with B={B}, got {tuple(tables.shape)}, "
                         f"{tuple(lengths.shape)}")
    if q.dtype not in _DTYPES or k_pool.dtype not in _DTYPES + _NARROW \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"dtypes: q {q.dtype}, pools {k_pool.dtype}/"
                        f"{v_pool.dtype} (q bf16 or f32; pools alike, "
                        f"bf16, f32, int8 or float8_e4m3fn)")
    _check_scales(k_pool, k_scale, v_scale)
    if tables.dtype not in _INTS or lengths.dtype not in _INTS:
        raise TypeError(f"tables/lengths must be integer, got "
                        f"{tables.dtype}/{lengths.dtype}")
    devs = {t.device for t in (q, k_pool, v_pool, tables, lengths)}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {devs}")
    if not all(t.is_contiguous() for t in (q, k_pool, v_pool)):
        raise ValueError("q and the pools must be contiguous")
    # The kernel stages K/V rows with 16-byte loads: D a multiple of 16
    # for 1-byte pools, of 8 for bf16, of 4 for f32.
    if (D * k_pool.element_size()) % 16 or any(
            t.data_ptr() % 16 for t in (k_pool, v_pool)):
        raise ValueError(f"pool rows must be 16-byte multiples on 16-byte "
                         f"aligned pools (D={D}, {k_pool.dtype})")
    if body(q.dtype, k_pool.dtype, D) == "split_mma":
        return                   # the limits below are the CUDA cores'
    # A block holds R query rows, as many as its accumulator slots take.
    R = min(H // KV * Q, _MAX_RD // D)
    if R < 1:
        raise ValueError(f"head_dim {D} exceeds the kernel's {_MAX_RD} "
                         f"register accumulator slots per block")
    C = T * max(1, 64 // T)
    smem = (4 * (R * D + C * (D + 1) + R * C + 2 * R) + 4 * (R + C // T)
            + 8 * (C // T))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"R={R}, D={D}, T={T} need {smem} B of shared "
                         f"memory per block (limit {_SMEM_LIMIT})")


def paged_attention(q, k_pool, v_pool, tables, lengths, *, k_scale=None,
                    v_scale=None):
    """Decode attention off a paged KV block pool.

    q: (B, H, D) — one query token per slot, bf16 or f32.
    k_pool, v_pool: (R, T, KV, D) — the physical block pool (row 0 is the
        NULL block; its contents are write-garbage by design): bf16 or
        f32, or int8 / float8_e4m3fn with scales.
    tables: (B, nb) int — physical pool row of each logical block.
    lengths: (B,) int — valid positions per slot (the engine passes
        ``positions + 1``: the current token's K/V is already appended).
    k_scale, v_scale: (R, KV) f32 — the per-(row, kv head) absmax scales
        of a narrow pool, required with one and refused without; each
        staged block is dequantized at the gather path's rounding site.

    Returns (B, H, D) in q's dtype.  Every block the table references
    inside ``lengths[b]`` must be a real pool row.
    """
    if q.dim() != 3:
        raise ValueError(f"want q (B, H, D), got {tuple(q.shape)}")
    _check(q[:, None], k_pool, v_pool, tables, lengths, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, tables, lengths,
                                   k_scale, v_scale)
    tables, lengths = _on_card(q, tables, lengths)
    which = body(q.dtype, k_pool.dtype, q.shape[-1])
    if which == "split_mma":
        out = _split(q, 1, k_pool, v_pool, k_scale, v_scale, tables,
                     lengths)
    else:
        out = torch.empty_like(q)
        kernel.launch(q, k_pool, v_pool, k_scale, v_scale, tables, lengths,
                      out, kernel_scale(q.shape[-1], q.dtype))
    paged_attention.launches += 1
    paged_attention.body_launches[which] += 1
    return out


paged_attention.launches = 0
paged_attention.body_launches = dict.fromkeys(BODIES, 0)


def paged_prefill_attention(q, k_pool, v_pool, tables, lengths, *,
                            k_scale=None, v_scale=None):
    """Multi-query attention off a paged KV block pool: the chunked
    prefill and speculative-verify query mode.

    q: (B, Q, H, D) — Q consecutive query tokens per slot, bf16 or f32,
        causally masked: query ``qi`` attends positions ``< lengths[b] -
        (Q - 1 - qi)``, i.e. up to and including its own.
    k_pool, v_pool, tables, k_scale, v_scale: as
        :func:`paged_attention`; the Q tokens' K/V must already be
        appended at positions ``[start, start + Q)``.
    lengths: (B,) int — ``start + Q`` per slot.

    Returns (B, Q, H, D) in q's dtype.  Each row computes exactly what
    :func:`paged_attention` computes at that row's limit, bit for bit.
    """
    _check(q, k_pool, v_pool, tables, lengths, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(q, k_pool, v_pool, tables,
                                           lengths, k_scale, v_scale)
    tables, lengths = _on_card(q, tables, lengths)
    which = body(q.dtype, k_pool.dtype, q.shape[-1])
    if which == "split_mma":
        out = _split(q, q.shape[1], k_pool, v_pool, k_scale, v_scale,
                     tables, lengths)
    else:
        out = torch.empty_like(q)
        kernel.launch_prefill(q, k_pool, v_pool, k_scale, v_scale, tables,
                              lengths, out,
                              kernel_scale(q.shape[-1], q.dtype))
    paged_prefill_attention.launches += 1
    paged_prefill_attention.body_launches[which] += 1
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.body_launches = dict.fromkeys(BODIES, 0)


def _split(q, Q, k_pool, v_pool, k_scale, v_scale, tables, lengths):
    """The split body on q (B, Q, H, D) bf16, or B1's (B, H, D) as Q = 1:
    one instruction sequence per row for B1 and B2."""
    if q.data_ptr() % 16:
        q = q.clone()            # 16-byte copies of the query rows
    out = torch.empty_like(q)
    H, D = q.shape[-2], q.shape[-1]
    T, KV = k_pool.shape[1], k_pool.shape[2]
    kernel.launch_split(q, k_pool, v_pool, k_scale, v_scale, tables, lengths,
                        out, kernel_scale(D, q.dtype), Q=Q,
                        rows=row_tile(H // KV * Q),
                        P=partition_positions(T, D))
    return out


def _on_card(q, tables, lengths):
    """The int32 tables and lengths the kernel reads; raises unless q
    lies on a CUDA device."""
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cuda or cpu, not "
                         f"{q.device}")
    return (tables.to(torch.int32).contiguous(),
            lengths.to(torch.int32).contiguous())
