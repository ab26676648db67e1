"""SPMV (ELLPACK) — paper Table 3: 4096x512 data/index matrices (port of
``repro/machsuite/spmv.py``).

y[i] = sum_l vals[i, l] * x[cols[i, l]], float32.

The paper rejects SPMV as communication-bound (Table 5, PCIe/CPU = 1.3) —
the ladder is still implemented, mirroring what a programmer would build
before the filter stops them.

  O0  per-(row, lane) scalar accumulation against the full operands
  O1  row tiles staged; per-element loops inside the tile
  O2  + vectorized tile compute (gather + row-sum, the II=1 pipeline)
  O3  + tiles in parallel (a batch dimension)
  O4  + 3-slot rotation over row tiles
  O5  kept == O4 (operands already wide words; paper §5.2: limited gain)

O0 and O1 issue a few tensor operations per (row, lane) cell; the column
index is a one-element ``int64`` slice (a 0-d index would be read back
to the host).  From O2 each row sums its lanes in one reduction, in
another order than O0's lane-by-lane adds: compare levels with the
reference's tolerance (rtol 2e-4, atol 1e-5).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.costmodel import MACHSUITE_PROFILES
from repro_torch.device import resolve_device
from repro_torch.machsuite.common import OptLevel, rotate3

PROFILE = MACHSUITE_PROFILES["spmv"]

TILE_ROWS = 64
# the reference tests' scale (64 rows of 8 lanes): the port's tests and
# the card's check in chip_smoke.py run every level at it
TEST_SCALE = 1 / 64


def oracle(vals: np.ndarray, cols: np.ndarray, x: np.ndarray) -> np.ndarray:
    v = np.asarray(vals, np.float64)
    return (v * np.asarray(x, np.float64)[cols]).sum(axis=1).astype(np.float32)


def _cells(vals, cols, x, y):
    """O0/O1: one scalar multiply-add into ``y`` per (row, lane), in lane
    order (``y`` is written in place)."""
    n, l = vals.shape
    for idx in range(n * l):
        i, j = idx // l, idx % l
        y[i:i + 1] += vals[i, j:j + 1] * x.index_select(0, cols[i, j:j + 1])
    return y


def _run_o0(vals, cols, x):
    y = torch.zeros(vals.shape[0], dtype=torch.float32, device=vals.device)
    return _cells(vals, cols, x, y)


def _run_o1(vals, cols, x):
    n, l = vals.shape
    y = torch.zeros(n, dtype=torch.float32, device=vals.device)
    for t in range(n // TILE_ROWS):
        rows = slice(t * TILE_ROWS, (t + 1) * TILE_ROWS)
        vt, ct = vals[rows].clone(), cols[rows].clone()     # the tile staged
        acc = torch.zeros(TILE_ROWS, dtype=torch.float32, device=vals.device)
        y[rows] = _cells(vt, ct, x, acc)
    return y


def _tile_compute(vt, ct, x):
    """Gather and row sum over the last axis; leading dims are rows (and
    tiles side by side)."""
    return (vt * x[ct]).sum(dim=-1)


def _tiled(vals, cols):
    return (vals.reshape(-1, TILE_ROWS, vals.shape[1]),
            cols.reshape(-1, TILE_ROWS, cols.shape[1]))


def _run_o2(vals, cols, x):
    vt, ct = _tiled(vals, cols)
    y = torch.empty(vt.shape[:2], dtype=torch.float32, device=vals.device)
    for t in range(vt.shape[0]):
        y[t] = _tile_compute(vt[t], ct[t], x)
    return y.reshape(-1)


def _run_o3(vals, cols, x):
    vt, ct = _tiled(vals, cols)
    return _tile_compute(vt, ct, x).reshape(-1)     # every tile at once


def _run_o4(vals, cols, x):
    """3-slot rotation over row tiles; the slots and the output are
    written in place (the reference updates them functionally).  Phase 0
    computes on the empty slot and stores nothing."""
    vt, ct = _tiled(vals, cols)
    nt = vt.shape[0]
    z = lambda a: torch.zeros((3,) + a.shape[1:], dtype=a.dtype,
                              device=a.device)
    bufs0 = {"v": z(vt), "c": z(ct),
             "y": torch.zeros(vt.shape[:2], dtype=torch.float32,
                              device=vals.device)}

    def body(i, slot, bufs):
        t = min(i, nt - 1)
        bufs["v"][slot] = vt[t]
        bufs["c"][slot] = ct[t]
        c = (i - 1) % 3
        yt = _tile_compute(bufs["v"][c], bufs["c"][c], x)
        if i >= 1:
            bufs["y"][i - 1] = yt
        return bufs

    return rotate3(body, nt + 1, bufs0)["y"].reshape(-1)


def run(level: OptLevel, vals, cols, x, *, device=None) -> torch.Tensor:
    """y = A x for the ELLPACK matrix (``vals`` (n, l) float32, ``cols``
    (n, l) int32, n a multiple of TILE_ROWS from O1 up) at one opt level,
    an (n,) float32 tensor on the CUDA device unless ``device="cpu"``;
    the operands are numpy arrays or tensors."""
    dev = resolve_device(device)
    vals = torch.as_tensor(vals, dtype=torch.float32, device=dev)
    cols = torch.as_tensor(cols, device=dev).to(torch.int64)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    level = OptLevel(level)
    if level == OptLevel.O0:
        return _run_o0(vals, cols, x)
    if level == OptLevel.O1:
        return _run_o1(vals, cols, x)
    if level == OptLevel.O2:
        return _run_o2(vals, cols, x)
    if level == OptLevel.O3:
        return _run_o3(vals, cols, x)
    return _run_o4(vals, cols, x)


def make_inputs(rng: np.random.Generator, scale: float = 1.0) -> dict:
    n = max(TILE_ROWS, int(4096 * scale) // TILE_ROWS * TILE_ROWS)
    l = max(8, int(512 * scale))
    return {
        "vals": rng.standard_normal((n, l), np.float32),
        "cols": rng.integers(0, n, (n, l), dtype=np.int32),
        "x": rng.standard_normal((n,), np.float32),
    }
