"""SORT (merge sort) — paper Table 3: 64 MB integer array (port of
``repro/machsuite/sort.py``).

Per the paper (§2.2), the FPGA's goal is every 1 MB chunk sorted; the CPU
merges the rest (tree-reduce parallelism dies off after a few layers).
Output here: the array with every chunk independently sorted (int32).

  O0  insertion sort per chunk, element-at-a-time against the full buffer
  O1  chunks staged; in-scratchpad insertion sort
  O2  + pipelined sorting network: bitonic stages, each stage one
      vectorized compare-exchange pass (the II=1 pipeline analog)
  O3  + PE duplication across chunks (a batch dimension)
  O4  + 3-slot rotation over chunks
  O5  kept == O4 (32-bit keys already word-wide; paper: SORT's scratchpad
      gain comes from caching-size choice, fixed at 1 MB — Fig. 6 note)

O0 and O1's shift loop has a data-dependent trip count: its condition is
evaluated on the host, one device-to-host read per trip (on the card a
synchronisation each time), as kmp's O0/O1 do.  The network of O2..O5
(log2(n) (log2(n) + 1) / 2 stages for a chunk of n) is fixed by the
chunk's length: its partners and directions are built once a call and
every chunk runs through them, in int32 throughout.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.costmodel import MACHSUITE_PROFILES
from repro_torch.device import resolve_device
from repro_torch.machsuite.common import OptLevel, rotate3

PROFILE = MACHSUITE_PROFILES["sort"]

# the reference tests' scale (2 chunks of 16): the port's tests and the
# card's check in chip_smoke.py run every level at it
TEST_SCALE = 64 / 262144 / 16


def oracle(data: np.ndarray, chunk: int) -> np.ndarray:
    d = np.asarray(data).reshape(-1, chunk)
    return np.sort(d, axis=1).reshape(-1)


def _insertion_sort(buf, lo: int, n: int):
    """Insertion sort of ``buf[lo:lo + n]`` in place, one element at a
    time; the shift loop's condition is read back to the host each trip."""
    for i in range(lo + 1, lo + n):
        key = buf[i].clone()
        j = i - 1
        while j >= lo and bool(buf[j] > key):
            buf[j + 1] = buf[j]
            j -= 1
        buf[j + 1] = key
    return buf


def network(n: int, device) -> list:
    """The bitonic network of a power-of-two chunk ``n``: one (partner,
    take_lo) pair a stage, ``take_lo`` True where the position keeps the
    smaller of itself and its partner."""
    assert (n & (n - 1)) == 0, f"bitonic needs power-of-two, got {n}"
    idx = torch.arange(n, device=device)
    stages = []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            partner = idx ^ j
            up = (idx & k) == 0
            stages.append((partner, (idx < partner) == up))
            j //= 2
        k *= 2
    return stages


def _bitonic_sort(buf, stages):
    """Sort the last axis of ``buf`` through the network: each stage one
    vectorized compare-exchange (the hardware pipeline); leading dims are
    chunks side by side."""
    for partner, take_lo in stages:
        b = buf.index_select(-1, partner)
        buf = torch.where(take_lo, torch.minimum(buf, b),
                          torch.maximum(buf, b))
    return buf


def _run_o0(data, chunk):
    buf = data.clone()                   # sorted in place, chunk by chunk
    for c in range(buf.shape[0] // chunk):
        _insertion_sort(buf, c * chunk, chunk)
    return buf


def _run_o1(data, chunk):
    chunks = data.reshape(-1, chunk)
    out = torch.empty_like(chunks)
    for c in range(chunks.shape[0]):
        out[c] = _insertion_sort(chunks[c].clone(), 0, chunk)  # staged
    return out.reshape(-1)


def _run_o2(data, chunk):
    chunks = data.reshape(-1, chunk)
    stages = network(chunk, data.device)
    out = torch.empty_like(chunks)
    for c in range(chunks.shape[0]):
        out[c] = _bitonic_sort(chunks[c], stages)
    return out.reshape(-1)


def _run_o3(data, chunk):
    chunks = data.reshape(-1, chunk)
    return _bitonic_sort(chunks, network(chunk, data.device)).reshape(-1)


def _run_o4(data, chunk):
    """3-slot rotation over chunks; the slots and the output are written
    in place (the reference updates them functionally).  Phase 0 sorts
    the empty slot and stores nothing."""
    chunks = data.reshape(-1, chunk)
    n = chunks.shape[0]
    stages = network(chunk, data.device)
    bufs0 = {"slots": torch.zeros((3, chunk), dtype=chunks.dtype,
                                  device=data.device),
             "out": torch.zeros_like(chunks)}

    def body(i, slot, bufs):
        bufs["slots"][slot] = chunks[min(i, n - 1)]
        s = _bitonic_sort(bufs["slots"][(i - 1) % 3], stages)
        if i >= 1:
            bufs["out"][i - 1] = s
        return bufs

    return rotate3(body, n + 1, bufs0)["out"].reshape(-1)


def run(level: OptLevel, data, chunk: int, *, device=None) -> torch.Tensor:
    """``data`` (int32, a numpy array or tensor; its length a multiple of
    ``chunk``, a power of two from O2 up) with every chunk sorted, at one
    opt level; an int32 tensor on the CUDA device unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    data = torch.as_tensor(data, dtype=torch.int32, device=dev)
    chunk = int(chunk)
    level = OptLevel(level)
    if level == OptLevel.O0:
        return _run_o0(data, chunk)
    if level == OptLevel.O1:
        return _run_o1(data, chunk)
    if level == OptLevel.O2:
        return _run_o2(data, chunk)
    if level == OptLevel.O3:
        return _run_o3(data, chunk)
    return _run_o4(data, chunk)


def make_inputs(rng: np.random.Generator, scale: float = 1.0) -> dict:
    # paper: 64 MB of int32 = 16M elements, 1 MB (256K-element) chunks
    chunk = 1 << max(4, int(np.log2(262_144 * scale)))
    n_chunks = max(2, int(64 * min(1.0, scale * 32)))
    return {
        "data": rng.integers(-2**31, 2**31 - 1, n_chunks * chunk,
                             dtype=np.int32),
        "chunk": chunk,
    }
