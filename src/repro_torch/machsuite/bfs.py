"""BFS (queue-based) — paper Table 3: 4K nodes, 64K edges (port of
``repro/machsuite/bfs.py``).

The paper's problem child: chain-dependent (no PE duplication, no double
buffering — §4.2/§5.1) and PCIe-bound (Table 5: 0.8 -> rejected by the
communication filter).  The ladder stops structurally at O2:

  O0  faithful queue-based scalar BFS: pop one node per while-iteration,
      walk its adjacency list element-at-a-time
  O1  level-synchronous with edge relaxation in staged tiles
  O2  + fully vectorized per-level relaxation (gather/scatter-min)
  O3..O5  == O2 (inapplicable; the dependence chain is the kernel)

Output: hop distance per node (int32), -1 if unreachable.

Both loops end on the data, so each trip reads its condition back to the
host (on the card a synchronisation each time): O0 one read a pop (the
popped node's adjacency bounds and the queue's tail together), O1..O5
one a level (whether any distance changed).  The scatter-min is
``scatter_reduce_(..., "amin", include_self=True)``, so a node's old
distance takes part, as in the reference's ``.at[v].min``.  With 256
edges or fewer O1 is one tile and takes O2's relaxation, as in the
reference; the tiles run from 512 edges.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from repro_torch.core.costmodel import MACHSUITE_PROFILES
from repro_torch.device import resolve_device
from repro_torch.machsuite.common import OptLevel

PROFILE = MACHSUITE_PROFILES["bfs"]

INF = np.int32(2**30)
EDGE_TILE = 256
# the reference tests' scale (16 nodes, 256 edges): the port's tests and
# the card's check in chip_smoke.py run every level at it
TEST_SCALE = 16 / 4096


def oracle(offsets: np.ndarray, neighbors: np.ndarray, edge_src: np.ndarray,
           source: int) -> np.ndarray:
    n = len(offsets) - 1
    dist = np.full(n, -1, np.int32)
    dist[source] = 0
    q = collections.deque([int(source)])
    while q:
        u = q.popleft()
        for v in neighbors[offsets[u]:offsets[u + 1]]:
            if dist[v] < 0:
                dist[v] = dist[u] + 1
                q.append(int(v))
    return dist


def _start(n: int, source: int, device):
    dist = torch.full((n,), int(INF), dtype=torch.int32, device=device)
    dist[source] = 0
    return dist


def _finish(dist):
    return torch.where(dist >= int(INF), -1, dist).to(torch.int32)


def _run_o0(offsets, neighbors, source):
    """Queue in a fixed-size array of n; one pop per outer trip.  A node
    is queued when its distance was INF before the min (``fresh``), so
    each node once and ``tail`` <= n; a stale write at ``tail`` = n goes
    to the last slot, rewriting it with its own value (the reference's
    out-of-bounds write is dropped)."""
    n = offsets.shape[0] - 1
    dev = offsets.device
    dist = _start(n, source, dev)
    queue = torch.zeros(n, dtype=torch.int64, device=dev)
    queue[0] = source
    tail = torch.ones(1, dtype=torch.int64, device=dev)
    head = 0
    while True:
        h = min(head, n - 1)        # head = n ends the loop below
        u = queue[h:h + 1]
        # one host read a pop: the adjacency bounds of u and the tail
        start, stop, n_queued = torch.cat(
            [offsets.index_select(0, u), offsets.index_select(0, u + 1),
             tail]).tolist()
        if head >= n_queued:
            break
        du1 = dist.index_select(0, u) + 1
        for e in range(start, stop):
            v = neighbors[e:e + 1]
            fresh = dist.index_select(0, v) >= int(INF)
            dist.scatter_reduce_(0, v, du1, "amin", include_self=True)
            at = tail.clamp(max=n - 1)
            queue.index_copy_(0, at,
                              torch.where(fresh, v, queue.index_select(0, at)))
            tail = tail + fresh.to(torch.int64)
        head += 1
    return _finish(dist)


def _relax(dist, level: int, src, dst):
    """One scatter-min of the edges (src -> dst) whose source is on the
    frontier; ``dist`` is updated in place."""
    cand = torch.where(dist.index_select(0, src) == level, level + 1,
                       int(INF)).to(torch.int32)
    return dist.scatter_reduce_(0, dst, cand, "amin", include_self=True)


def _relax_tiles(dist, level: int, edge_src, edge_dst, n_tiles: int):
    """One BFS level: relax edges tile-by-tile (O1 staging)."""
    src_t = edge_src.reshape(n_tiles, -1)
    dst_t = edge_dst.reshape(n_tiles, -1)
    for t in range(n_tiles):
        _relax(dist, level, src_t[t].clone(), dst_t[t].clone())  # staged
    return dist


def _run_levelsync(offsets, neighbors, edge_src, source, *, n_tiles: int):
    n = offsets.shape[0] - 1
    dist = _start(n, source, offsets.device)
    level, changed = 0, True
    while changed and level < n:
        new = dist.clone()
        if n_tiles == 1:
            _relax(new, level, edge_src, neighbors)
        else:
            _relax_tiles(new, level, edge_src, neighbors, n_tiles)
        changed = bool((new != dist).any())   # one host read a level
        dist, level = new, level + 1
    return _finish(dist)


def run(level: OptLevel, offsets, neighbors, edge_src, source, *,
        device=None) -> torch.Tensor:
    """Hop distance of every node from ``source`` (-1 if unreachable) in
    the CSR graph (``offsets`` (n+1,), ``neighbors`` and ``edge_src``
    (e,), int32 numpy arrays or tensors, edges sorted by source) at one
    opt level, an (n,) int32 tensor on the CUDA device unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    offsets = torch.as_tensor(offsets, device=dev).to(torch.int64)
    neighbors = torch.as_tensor(neighbors, device=dev).to(torch.int64)
    edge_src = torch.as_tensor(edge_src, device=dev).to(torch.int64)
    source = int(source)
    level = OptLevel(level)
    if level == OptLevel.O0:
        return _run_o0(offsets, neighbors, source)
    if level == OptLevel.O1:
        n_tiles = max(1, neighbors.shape[0] // EDGE_TILE)
        return _run_levelsync(offsets, neighbors, edge_src, source,
                              n_tiles=n_tiles)
    # O2..O5: vectorized level-synchronous relaxation (PE duplication and
    # double buffering are inapplicable — paper §4.2/§5.1)
    return _run_levelsync(offsets, neighbors, edge_src, source, n_tiles=1)


def with_unreachable(inp: dict) -> dict:
    """``inp``'s graph with half as many nodes again appended, isolated
    (the last offset repeated), so a third of the nodes are unreachable.
    The graphs ``make_inputs`` draws at the tests' scales reach every
    node from the source, so a rung that never wrote -1 would pass
    there."""
    offsets = np.asarray(inp["offsets"], np.int32)
    extra = (len(offsets) - 1) // 2
    return {**inp, "offsets": np.concatenate(
        [offsets, np.full(extra, offsets[-1], np.int32)])}


def make_inputs(rng: np.random.Generator, scale: float = 1.0) -> dict:
    n = max(16, int(4096 * scale))
    e = max(4 * n, int(65536 * scale))
    e = (e // EDGE_TILE) * EDGE_TILE if e >= EDGE_TILE else e
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    offsets = np.zeros(n + 1, np.int64)
    np.add.at(offsets[1:], src, 1)
    offsets = np.cumsum(offsets)
    return {
        "offsets": offsets.astype(np.int32),
        "neighbors": dst.astype(np.int32),
        "edge_src": src.astype(np.int32),
        "source": np.int32(0),
    }
