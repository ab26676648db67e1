"""Needleman-Wunsch — paper Table 3: 64K pairs of 128-nucleotide sequences
(port of ``repro/machsuite/nw.py``).

Scoring follows MachSuite: MATCH +1, MISMATCH -1, GAP -1.  Output: the
global-alignment score per pair (int32).

  O0  per-pair row-by-row DP, cell-at-a-time (the un-pipelined nest)
  O1  pairs staged in batches; same sequential per-pair DP
  O2  + anti-diagonal wavefront: all cells of a diagonal in parallel —
      the paper's II=1 pipeline for 2-D DP (NW gains 8.8x, Table 4)
  O3  + PE duplication across pairs (a batch dimension — NW is "fully
      parallel jobs")
  O4  + 3-slot rotation over pair batches
  O5  + the nucleotide bytes staged in packed 32-bit words, each sequence
      padded to a multiple of 4 (byte-typed buffers make NW/AES/KMP the
      big scratchpad-reorg winners)

O0 and O1 issue a few tensor operations per DP cell (L^2 a pair); O2 a
few per anti-diagonal (2L-1 a pair), O3-O5 a few per anti-diagonal per
batch of 16 pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.costmodel import MACHSUITE_PROFILES
from repro_torch.device import resolve_device
from repro_torch.machsuite.common import (OptLevel, pack_u8_to_u32, rotate3,
                                          unpack_u32_to_u8)

PROFILE = MACHSUITE_PROFILES["nw"]

MATCH, MISMATCH, GAP = 1, -1, -1
BATCH = 16
# the reference tests' scale (16 pairs of length 8): the port's tests
# and the card's check in chip_smoke.py run every level at it
TEST_SCALE = 1 / 4096


def oracle(seq_a: np.ndarray, seq_b: np.ndarray) -> np.ndarray:
    a = np.asarray(seq_a)
    b = np.asarray(seq_b)
    n_pairs, L = a.shape
    out = np.zeros(n_pairs, np.int32)
    for p in range(n_pairs):
        prev = np.arange(L + 1, dtype=np.int64) * GAP
        for i in range(1, L + 1):
            cur = np.empty(L + 1, np.int64)
            cur[0] = i * GAP
            sub = np.where(b[p] == a[p, i - 1], MATCH, MISMATCH)
            for j in range(1, L + 1):
                cur[j] = max(prev[j - 1] + sub[j - 1],
                             prev[j] + GAP, cur[j - 1] + GAP)
            prev = cur
        out[p] = prev[L]
    return out


# ---------------------------------------------------------------------------
# per-pair DP kernels
# ---------------------------------------------------------------------------

def _sub(x, y):
    return torch.where(x == y, MATCH, MISMATCH).to(torch.int32)


def _dp_rowwise_cells(a, b):
    """O0/O1: rows in turn; each row cell-at-a-time (the j-dependency
    serializes — the un-pipelined inner loop)."""
    L = a.shape[0]
    prev = torch.arange(L + 1, dtype=torch.int32, device=a.device) * GAP
    for i in range(L):
        sub = _sub(b, a[i])
        vals = torch.empty(L, dtype=torch.int32, device=a.device)
        left = torch.full((), (i + 1) * GAP, dtype=torch.int32,
                          device=a.device)
        for j in range(L):
            diag = prev[j] + sub[j]
            up = prev[j + 1] + GAP
            left = torch.maximum(torch.maximum(diag, up), left + GAP)
            vals[j] = left
        prev = torch.cat([prev.new_full((1,), (i + 1) * GAP), vals])
    return prev[L]


def _dp_wavefront(a, b):
    """O2+: anti-diagonal sweep — every cell on a diagonal is independent.
    ``a``, ``b``: (..., L) uint8; leading dims are pairs side by side.

    diag[d][k] = M[i, j] with i = k, j = d - k (1-based incl. borders).
    We carry two previous diagonals of length L+1 (padded)."""
    L = a.shape[-1]
    size = L + 1
    dev = a.device

    # borders: M[i,0] = i*GAP ; M[0,j] = j*GAP
    d0 = torch.zeros(a.shape[:-1] + (size,), dtype=torch.int32,
                     device=dev)                            # diagonal d=0
    d1 = torch.full(a.shape[:-1] + (size,), GAP, dtype=torch.int32,
                    device=dev)                             # d=1: (0,1),(1,0)

    i = torch.arange(size, device=dev)      # candidate row index on a diagonal
    ai = a[..., (i - 1).clamp(0, L - 1)]
    up_row = (i - 1).clamp(0, L)
    dm2, dm1 = d0, d1
    for d in range(2, 2 * L + 1):
        j = d - i
        valid = (i >= 1) & (j >= 1) & (i <= L) & (j <= L)
        bj = b[..., (j - 1).clamp(0, L - 1)]
        sub = _sub(ai, bj)
        # M[i-1, j-1] lives on dm2 at row i-1; M[i-1, j] on dm1 at i-1;
        # M[i, j-1] on dm1 at i.
        diag = dm2[..., up_row] + sub
        up = dm1[..., up_row] + GAP
        left = dm1 + GAP
        v = torch.maximum(torch.maximum(diag, up), left)
        border = torch.where(i == 0, j * GAP, i * GAP)  # i==0 or j==0 cells
        dm2, dm1 = dm1, torch.where(valid, v, border).to(torch.int32)
    return dm1[..., L]        # cell (L, L) sits at row L of diagonal 2L


# ---------------------------------------------------------------------------
# levels
# ---------------------------------------------------------------------------

def _run_sequential(seq_a, seq_b, per_pair, batched: bool):
    out = torch.empty(seq_a.shape[0], dtype=torch.int32, device=seq_a.device)
    if not batched:
        for p in range(seq_a.shape[0]):
            out[p] = per_pair(seq_a[p], seq_b[p])
        return out
    a_b = seq_a.reshape(-1, BATCH, seq_a.shape[1])
    b_b = seq_b.reshape(-1, BATCH, seq_b.shape[1])
    out = out.reshape(-1, BATCH)
    for k in range(a_b.shape[0]):
        a, b = a_b[k].clone(), b_b[k].clone()      # the batch staged
        for p in range(BATCH):
            out[k, p] = per_pair(a[p], b[p])
    return out.reshape(-1)


def _run_o3(seq_a, seq_b):
    a_b = seq_a.reshape(-1, BATCH, seq_a.shape[1])
    b_b = seq_b.reshape(-1, BATCH, seq_b.shape[1])
    out = torch.empty(a_b.shape[:2], dtype=torch.int32, device=seq_a.device)
    for k in range(a_b.shape[0]):
        out[k] = _dp_wavefront(a_b[k], b_b[k])     # the batch's pairs at once
    return out.reshape(-1)


def _run_o4(seq_a, seq_b, *, packed=False):
    """3-slot rotation over pair batches; the slots and the output are
    written in place (the reference updates them functionally)."""
    L = seq_a.shape[1]
    a_b = seq_a.reshape(-1, BATCH, L)
    b_b = seq_b.reshape(-1, BATCH, L)
    n = a_b.shape[0]
    if packed:
        pad = (-L) % 4
        pad_l = lambda x: torch.nn.functional.pad(x, (0, pad))
        a_st = pack_u8_to_u32(pad_l(a_b))
        b_st = pack_u8_to_u32(pad_l(b_b))
    else:
        a_st, b_st = a_b, b_b

    def compute(a_slab, b_slab):
        if packed:
            a_u8 = unpack_u32_to_u8(a_slab)[:, :L]
            b_u8 = unpack_u32_to_u8(b_slab)[:, :L]
        else:
            a_u8, b_u8 = a_slab, b_slab
        return _dp_wavefront(a_u8, b_u8)

    z = lambda x: torch.zeros((3,) + x.shape[1:], dtype=x.dtype,
                              device=x.device)
    bufs0 = {"a": z(a_st), "b": z(b_st),
             "out": torch.zeros((n, BATCH), dtype=torch.int32,
                                device=seq_a.device)}

    def body(i, slot, bufs):
        t = min(i, n - 1)
        bufs["a"][slot] = a_st[t]
        bufs["b"][slot] = b_st[t]
        c = (i - 1) % 3
        scores = compute(bufs["a"][c], bufs["b"][c])
        if i >= 1:
            bufs["out"][i - 1] = scores
        return bufs

    return rotate3(body, n + 1, bufs0)["out"].reshape(-1)


def run(level: OptLevel, seq_a, seq_b, *, device=None) -> torch.Tensor:
    """Global-alignment score of each pair of rows of ``seq_a`` and
    ``seq_b`` ((n_pairs, L) uint8, numpy arrays or tensors; n_pairs a
    multiple of BATCH from O1 up) at one opt level, an (n_pairs,) int32
    tensor on the CUDA device unless ``device="cpu"``."""
    dev = resolve_device(device)
    seq_a = torch.as_tensor(seq_a, dtype=torch.uint8, device=dev)
    seq_b = torch.as_tensor(seq_b, dtype=torch.uint8, device=dev)
    level = OptLevel(level)
    if level == OptLevel.O0:
        return _run_sequential(seq_a, seq_b, _dp_rowwise_cells, batched=False)
    if level == OptLevel.O1:
        return _run_sequential(seq_a, seq_b, _dp_rowwise_cells, batched=True)
    if level == OptLevel.O2:
        return _run_sequential(seq_a, seq_b, _dp_wavefront, batched=True)
    if level == OptLevel.O3:
        return _run_o3(seq_a, seq_b)
    if level == OptLevel.O4:
        return _run_o4(seq_a, seq_b, packed=False)
    return _run_o4(seq_a, seq_b, packed=True)


def make_inputs(rng: np.random.Generator, scale: float = 1.0) -> dict:
    n_pairs = max(BATCH, int(65536 * scale) // BATCH * BATCH)
    L = 128 if scale >= 1.0 else max(8, int(128 * min(1.0, scale * 16)))
    return {
        "seq_a": rng.integers(0, 4, (n_pairs, L), dtype=np.uint8),
        "seq_b": rng.integers(0, 4, (n_pairs, L), dtype=np.uint8),
    }
