"""GEMM (N^3 algorithm) — paper Table 3: two 1024x1024 double matrices
(port of ``repro/machsuite/gemm.py``).

Ladder (paper §3.2 data-tiling example), each level the reference's
structure in eager PyTorch:

  O0  element-at-a-time triple loop against the full operands
  O1  explicit tiling: (TI, TK)x(TK, TJ) tiles staged, inner k-loop scalar
  O2  + pipelined tile compute (the tile contraction as one product)
  O3  + PE duplication: every output tile at once (the reference's vmaps
      written as a batch dimension)
  O4  + 3-slot rotation over the k tile loop (Fig. 4c)
  O5  scratchpad reorg: inputs already max-width words (paper: limited gain
      for wide types — kept identical to O4)

O0 and O1 issue one tensor operation per scalar multiply-add, as the
reference's loops do; they are meant for the small scales the tests use
(32x32), not for Table 3's size.  Tile products run in f32 (set
``torch.backends.cuda.matmul.allow_tf32 = False`` on the card, PyTorch's
default).

Float note: accumulation order differs across levels, so tests compare with
allclose against a float64 numpy oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.costmodel import MACHSUITE_PROFILES
from repro_torch.device import resolve_device
from repro_torch.machsuite.common import OptLevel, rotate3

PROFILE = MACHSUITE_PROFILES["gemm"]

TILE = 16   # staging tile (kept small so smoke inputs divide evenly)


def oracle(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (np.asarray(a, np.float64) @ np.asarray(b, np.float64)).astype(
        np.float32)


def _run_o0(a, b):
    n, k = a.shape
    m = b.shape[1]
    c = torch.zeros((n, m), dtype=torch.float32, device=a.device)
    for idx in range(n * m):
        i, j = idx // m, idx % m
        row = a[i:i + 1, :]
        col = b[:, j:j + 1]
        v = torch.zeros((), dtype=torch.float32, device=a.device)
        for p in range(k):
            v = v + row[0, p] * col[p, 0]
        c[i, j] = v
    return c


def _tiles(a, b):
    n, k = a.shape
    m = b.shape[1]
    assert n % TILE == 0 and m % TILE == 0 and k % TILE == 0, (n, k, m)
    return n // TILE, k // TILE, m // TILE


def _run_o1(a, b):
    nt, kt, mt = _tiles(a, b)
    c = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                    device=a.device)
    for idx in range(nt * mt):
        ti, tj = idx // mt, idx % mt
        acc = torch.zeros((TILE, TILE), dtype=torch.float32, device=a.device)
        for tk in range(kt):
            # explicit staging: the tiles are copied out of the operands
            at = a[ti * TILE:(ti + 1) * TILE, tk * TILE:(tk + 1) * TILE].clone()
            bt = b[tk * TILE:(tk + 1) * TILE, tj * TILE:(tj + 1) * TILE].clone()
            for cell in range(TILE * TILE):
                i, j = cell // TILE, cell % TILE
                s = torch.zeros((), dtype=torch.float32, device=a.device)
                for p in range(TILE):
                    s = s + at[i, p] * bt[p, j]
                acc[i, j] += s
        c[ti * TILE:(ti + 1) * TILE, tj * TILE:(tj + 1) * TILE] = acc
    return c


def _tile_view(a, b):
    nt, kt, mt = _tiles(a, b)
    at = a.reshape(nt, TILE, kt, TILE).permute(0, 2, 1, 3)  # (nt,kt,T,T)
    bt = b.reshape(kt, TILE, mt, TILE).permute(0, 2, 1, 3)  # (kt,mt,T,T)
    return at, bt, (nt, kt, mt)


def _untile(out, a, b):
    """(nt, mt, T, T) output tiles -> the (n, m) matrix."""
    return out.permute(0, 2, 1, 3).reshape(a.shape[0], b.shape[1])


def _run_o2(a, b):
    at, bt, (nt, kt, mt) = _tile_view(a, b)
    out = torch.empty((nt, mt, TILE, TILE), dtype=torch.float32,
                      device=a.device)
    for ti in range(nt):
        for tj in range(mt):
            acc = torch.zeros((TILE, TILE), dtype=torch.float32,
                              device=a.device)
            for tk in range(kt):
                acc = acc + at[ti, tk] @ bt[tk, tj]
            out[ti, tj] = acc
    return _untile(out, a, b)


def _run_o3(a, b):
    at, bt, (nt, kt, mt) = _tile_view(a, b)
    acc = torch.zeros((nt, mt, TILE, TILE), dtype=torch.float32,
                      device=a.device)
    for tk in range(kt):                # every (ti, tj) tile at once
        acc = acc + at[:, tk, None] @ bt[None, tk]
    return _untile(acc, a, b)


def _run_o4(a, b):
    """3-slot rotation over the k tile stream for every output tile.  The
    slots are written in place (the reference updates them functionally);
    the values each phase reads are the same."""
    at, bt, (nt, kt, mt) = _tile_view(a, b)
    z = lambda *s: torch.zeros((nt, mt, *s), dtype=torch.float32,
                               device=a.device)
    bufs0 = {"a": z(3, TILE, TILE), "b": z(3, TILE, TILE),
             "acc": z(TILE, TILE)}

    def body(i, slot, bufs):
        tk = min(i, kt - 1)
        bufs["a"][:, :, slot] = at[:, tk, None]
        bufs["b"][:, :, slot] = bt[None, tk]
        c = (i - 1) % 3
        contrib = bufs["a"][:, :, c] @ bufs["b"][:, :, c]
        bufs["acc"] = bufs["acc"] + (1.0 if i >= 1 else 0.0) * contrib
        return bufs

    return _untile(rotate3(body, kt + 1, bufs0)["acc"], a, b)


def run(level: OptLevel, a, b, *, device=None) -> torch.Tensor:
    """C = a @ b in f32 at ``level``, on the CUDA device unless
    ``device="cpu"``; ``a``, ``b`` are numpy arrays or tensors."""
    dev = resolve_device(device)
    a = torch.as_tensor(a, dtype=torch.float32, device=dev)
    b = torch.as_tensor(b, dtype=torch.float32, device=dev)
    level = OptLevel(level)
    if level == OptLevel.O0:
        return _run_o0(a, b)
    if level == OptLevel.O1:
        return _run_o1(a, b)
    if level == OptLevel.O2:
        return _run_o2(a, b)
    if level == OptLevel.O3:
        return _run_o3(a, b)
    return _run_o4(a, b)   # O4 == O5 (scratchpad reorg: no-op for f32/f64)


def make_inputs(rng: np.random.Generator, scale: float = 1.0) -> dict:
    n = max(TILE, int(1024 * scale) // TILE * TILE)
    return {
        "a": rng.standard_normal((n, n), np.float32),
        "b": rng.standard_normal((n, n), np.float32),
    }
