"""Viterbi — paper Table 3: 1M chains of 128 observations (64-state HMM)
(port of ``repro/machsuite/viterbi.py``).

MachSuite convention: negative-log-space, minimization.  Output: the
min-cost (float32) of the best path per chain.  The paper notes Viterbi's
pipeline II is limited by the float add/min chain per stage (3.2x, Table 4)
unlike NW's single-cycle integer cells.

  O0  per-chain, per-step, per-state scalar loops
  O1  chains staged in batches; same scalar DP
  O2  + vectorized state update: one (S x S) min-plus contraction per step
  O3  + PE duplication across chains (a batch dimension of BATCH chains)
  O4  + 3-slot rotation over chain batches
  O5  kept == O4 (float64-wide words already; paper: limited gain)

Every level does the same single float32 adds and takes exact minima, so
every level equals the oracle bit for bit.  O0 and O1 issue a few tensor
operations per (step, state, previous state); the emission column of a
step is gathered with a one-element ``int64`` slice of the observations
(a 0-d index would be read back to the host).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.costmodel import MACHSUITE_PROFILES
from repro_torch.device import resolve_device
from repro_torch.machsuite.common import OptLevel, rotate3

PROFILE = MACHSUITE_PROFILES["viterbi"]

BATCH = 8
# the reference tests' scale (16 chains of 4 steps, S = 8, M = 16): the
# port's tests and the card's check in chip_smoke.py run every level at it
TEST_SCALE = 1 / 62500


def oracle(obs: np.ndarray, init: np.ndarray, trans: np.ndarray,
           emit: np.ndarray) -> np.ndarray:
    obs = np.asarray(obs)
    n_chains, T = obs.shape
    out = np.zeros(n_chains, np.float32)
    for c in range(n_chains):
        llh = init + emit[:, obs[c, 0]]
        for t in range(1, T):
            llh = (llh[:, None] + trans).min(axis=0) + emit[:, obs[c, t]]
        out[c] = llh.min()
    return out.astype(np.float32)


def _emission(obs, t, emit_t):
    """The emission costs of step ``t``: (..., S) from ``obs`` (..., T)
    int64 and ``emit_t`` = emit transposed (M, S)."""
    return emit_t[obs[..., t:t + 1]].squeeze(-2)


def _chain_scalar(obs_c, init, trans, emit_t):
    """O0/O1: explicit per-state loops (the un-pipelined nest); the
    states' new costs are written in place."""
    S = init.shape[0]
    llh = init + _emission(obs_c, 0, emit_t)
    inf = torch.full((), float("inf"), dtype=torch.float32,
                     device=init.device)
    for t in range(1, obs_c.shape[0]):
        e = _emission(obs_c, t, emit_t)
        new = torch.zeros_like(llh)
        for s in range(S):
            best = inf
            for r in range(S):
                best = torch.minimum(best, llh[r] + trans[r, s])
            new[s] = best + e[s]
        llh = new
    best = inf
    for s in range(S):
        best = torch.minimum(best, llh[s])
    return best


def _chain_vector(obs, init, trans, emit_t):
    """O2+: min-plus contraction, all states in parallel per step.
    ``obs``: (..., T); leading dims are chains side by side."""
    llh = init + _emission(obs, 0, emit_t)
    for t in range(1, obs.shape[-1]):
        llh = ((llh[..., :, None] + trans).amin(dim=-2)
               + _emission(obs, t, emit_t))
    return llh.amin(dim=-1)


def _run_sequential(obs, init, trans, emit_t, per_chain, batched):
    out = torch.empty(obs.shape[0], dtype=torch.float32, device=obs.device)
    if not batched:
        for c in range(obs.shape[0]):
            out[c] = per_chain(obs[c], init, trans, emit_t)
        return out
    ob = obs.reshape(-1, BATCH, obs.shape[1])
    out = out.reshape(-1, BATCH)
    for k in range(ob.shape[0]):
        o = ob[k].clone()                        # the batch staged
        for c in range(BATCH):
            out[k, c] = per_chain(o[c], init, trans, emit_t)
    return out.reshape(-1)


def _run_o3(obs, init, trans, emit_t):
    ob = obs.reshape(-1, BATCH, obs.shape[1])
    out = torch.empty(ob.shape[:2], dtype=torch.float32, device=obs.device)
    for k in range(ob.shape[0]):
        out[k] = _chain_vector(ob[k], init, trans, emit_t)  # BATCH at once
    return out.reshape(-1)


def _run_o4(obs, init, trans, emit_t):
    """3-slot rotation over chain batches; the slots and the output are
    written in place (the reference updates them functionally).  Phase 0
    computes on the empty slot and stores nothing."""
    ob = obs.reshape(-1, BATCH, obs.shape[1])
    n = ob.shape[0]
    bufs0 = {"slots": torch.zeros((3,) + ob.shape[1:], dtype=ob.dtype,
                                  device=ob.device),
             "out": torch.zeros((n, BATCH), dtype=torch.float32,
                                device=ob.device)}

    def body(i, slot, bufs):
        bufs["slots"][slot] = ob[min(i, n - 1)]
        vals = _chain_vector(bufs["slots"][(i - 1) % 3], init, trans, emit_t)
        if i >= 1:
            bufs["out"][i - 1] = vals
        return bufs

    return rotate3(body, n + 1, bufs0)["out"].reshape(-1)


def run(level: OptLevel, obs, init, trans, emit, *,
        device=None) -> torch.Tensor:
    """The min cost of each chain's best path (``obs`` (n_chains, T) int32
    observations, n_chains a multiple of BATCH from O1 up; ``init`` (S,),
    ``trans`` (S, S) and ``emit`` (S, M) negative-log float32) at one opt
    level, an (n_chains,) float32 tensor on the CUDA device unless
    ``device="cpu"``; the operands are numpy arrays or tensors."""
    dev = resolve_device(device)
    obs = torch.as_tensor(obs, device=dev).to(torch.int64)
    init = torch.as_tensor(init, dtype=torch.float32, device=dev)
    trans = torch.as_tensor(trans, dtype=torch.float32, device=dev)
    emit_t = torch.as_tensor(emit, dtype=torch.float32, device=dev).t()
    level = OptLevel(level)
    if level == OptLevel.O0:
        return _run_sequential(obs, init, trans, emit_t, _chain_scalar,
                               False)
    if level == OptLevel.O1:
        return _run_sequential(obs, init, trans, emit_t, _chain_scalar, True)
    if level == OptLevel.O2:
        return _run_sequential(obs, init, trans, emit_t, _chain_vector, True)
    if level == OptLevel.O3:
        return _run_o3(obs, init, trans, emit_t)
    return _run_o4(obs, init, trans, emit_t)


def make_inputs(rng: np.random.Generator, scale: float = 1.0, *,
                n_chains: int | None = None) -> dict:
    """The reference's draws at ``scale``; ``n_chains`` replaces the
    chain count and keeps the scale's T, S and M (the card's Table 3 cut:
    ``make_inputs(rng, 1.0, n_chains=64)`` draws 64 chains of Table 3's
    HMM, S = M = 64, T = 128)."""
    if n_chains is None:
        n_chains = max(BATCH, int(1e6 * scale) // BATCH * BATCH)
    T = 128 if scale >= 1.0 else max(4, int(128 * min(1.0, scale * 64)))
    S, M = 64, 64
    if scale < 1.0:
        S, M = 8, 16
    return {
        "obs": rng.integers(0, M, (n_chains, T), dtype=np.int32),
        "init": -np.log(rng.dirichlet(np.ones(S))).astype(np.float32),
        "trans": -np.log(rng.dirichlet(np.ones(S), S)).astype(np.float32),
        "emit": -np.log(rng.dirichlet(np.ones(M), S)).astype(np.float32),
    }
