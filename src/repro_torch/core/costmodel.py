"""Analytic performance model of the paper's CPU-FPGA platform (port copy).

A framework-free copy of ``repro/core/costmodel.py``: the same formulas,
profiles and numbers, so the port's autotuner walks the paper's ladder
exactly as the reference's does.  Its times are the model's times on the
paper's 2012 platform, never the card's.

The paper reports wall-clock speedups measured on a Xilinx Virtex-7 @200 MHz
next to a Xeon E5-2420 @1.9 GHz (Table 2).  Neither is at hand, so the
*faithful* reproduction validates against an analytic model built from
the paper's own published constants and mechanisms:

  * DRAM burst:    100-cycle initiation + ~1 cycle/beat            (paper 3.2)
  * naive port:    every element access pays the 100-cycle init    (paper 3.1)
  * pipelining:    loop time N*L -> N*II + L                       (paper 4.1)
  * PE duplication: compute time / min(PE, available parallelism)  (paper 4.2)
  * double buffer: total = max(load, compute, store) per iteration (paper 5.1)
  * scratchpad:    DRAM<->BRAM beats scale with word width         (paper 5.2)
  * PCIe offload:  payload / 8 GB/s, counted in system speedup     (paper 6)

Each MachSuite kernel is described by a ``KernelProfile`` capturing its
operational characteristics (element count, ops/element, iteration latency,
achievable II, parallelism structure, word width).  The model then evaluates
time at every OptLevel — reproducing Figures 1/6/9/12 and Tables 4/5.

The model is *mechanistic*, not a curve fit: the same five formulas the paper
narrates, with per-kernel parameters taken from MachSuite's documented input
sizes (Table 3) and per-kernel loop structure.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hw import FPGA_2012, FpgaSpec
from repro_torch.core.optlevel import OptLevel, Step


@dataclasses.dataclass(frozen=True)
class KernelProfile:
    """Operational profile of one MachSuite kernel on the paper's platform.

    Attributes:
      name: kernel id.
      bytes_in / bytes_out: total DRAM traffic (one pass over the input set).
      n_iters: trip count of the dominant (innermost pipelined) loop.
      iter_latency: latency L (cycles) of one iteration un-pipelined.
      ii: initiation interval achievable by `#pragma HLS pipeline` alone.
      parallel_jobs: number of independent jobs for PE duplication
        (0 => PE duplication inapplicable, e.g. BFS).
      tree_reduce: SORT-style halving parallelism across levels.
      word_bytes: natural element width of the kernel's data type.
      cpu_time_s: single-thread Xeon baseline (derived from ops at a
        per-kernel effective IPC on the 1.9 GHz core).
      max_pe: resource-bound PE cap on the Virtex-7 for this kernel.
      dram_bound_after_o1: fraction of time that is DRAM even after caching.
    """

    name: str
    bytes_in: float
    bytes_out: float
    n_iters: float
    iter_latency: float
    ii: float
    parallel_jobs: float
    cpu_time_s: float
    word_bytes: int = 4
    max_pe: int = 128
    tree_reduce: bool = False
    compute_scale: float = 1.0   # extra per-iteration compute weight
    naive_accesses_per_iter: float = 2.0  # DRAM touches per loop body at O0
    pcie_bytes: float = 0.0      # host<->device payload; 0 => bytes_in+out
                                 # (differs when tiling re-reads DRAM, GEMM)
    overlappable: bool = True    # False: next iter depends on prev (BFS)
    pack_compute: bool = False   # byte kernels: O5 packs 4 bytes/op (paper:
                                 # 'bit packing' is the software counterpart)
    max_word_bits: int = 512     # BRAM-resource cap on scratchpad width


def _dram_naive(p: KernelProfile, hw: FpgaSpec) -> float:
    """O0: every operand reference in the loop body is its own 100-cycle-init
    DRAM transaction (paper §3.1: 'Every data access has to physically go
    off chip') — the loop body's loads/stores, sbox lookups, bookkeeping
    arrays etc. all live in DRAM in the naive port."""
    accesses = p.n_iters * p.naive_accesses_per_iter
    return accesses * (hw.dram_init_cycles + 1) * hw.cycle_s


def _dram_batched(
    p: KernelProfile, hw: FpgaSpec, cache_bytes: float, width_bits: int
) -> float:
    """O1+: burst transfers of ``cache_bytes`` payloads at ``width_bits``."""
    total = p.bytes_in + p.bytes_out
    if total <= 0:
        return 0.0
    n_bursts = max(1.0, math.ceil(total / cache_bytes))
    per_burst_payload = total / n_bursts
    return n_bursts * hw.burst_time(per_burst_payload, width_bits)


def _compute_time(
    p: KernelProfile, hw: FpgaSpec, level: OptLevel, pe: int
) -> float:
    """Sequential / pipelined / duplicated compute time."""
    n, latency = p.n_iters, p.iter_latency * p.compute_scale
    if level.has(Step.PIPELINING):
        cycles = n * p.ii + latency          # paper: N*L -> N*II + L
    else:
        cycles = n * latency
    if level.has(Step.PE_DUPLICATION) and p.parallel_jobs > 0:
        eff = min(pe, p.max_pe, p.parallel_jobs)
        if p.tree_reduce:
            # SORT: log2(n) merge levels, level k exposes jobs/2^k
            # independent merges (paper §4.2: parallelism halves per layer).
            levels = max(1.0, math.log2(max(2.0, p.parallel_jobs)))
            par = sum(
                1.0 / min(eff, max(1.0, p.parallel_jobs / 2**k))
                for k in range(int(levels))
            )
            cycles = cycles * (par / levels)
        else:
            cycles = cycles / eff
    return cycles * hw.cycle_s


def kernel_time(
    p: KernelProfile,
    level: OptLevel,
    hw: FpgaSpec = FPGA_2012,
    *,
    cache_bytes: float = 64 * 1024,
    pe: int = 128,
    word_bits: int = None,
) -> dict:
    """Evaluate the model at one optimization level.

    Returns dict with dram_s, compute_s, total_s, pcie_s (system offload).
    """
    natural_bits = p.word_bytes * 8
    if word_bits is None:
        word_bits = p.max_word_bits if level.has(Step.SCRATCHPAD_REORG) else natural_bits
    if not level.has(Step.SCRATCHPAD_REORG):
        word_bits = natural_bits

    if level.has(Step.DATA_CACHING):
        dram = _dram_batched(p, hw, cache_bytes, word_bits)
    else:
        dram = _dram_naive(p, hw)

    comp = _compute_time(p, hw, level, pe)
    if level.has(Step.SCRATCHPAD_REORG) and p.pack_compute:
        comp /= 4.0  # 4 bytes per 32-bit word-op once buffers are widened

    if level.has(Step.DOUBLE_BUFFERING) and p.overlappable:
        # 3-stage coarse pipeline: steady-state is the max stage; one
        # fill + one drain of the shorter stage remain exposed.
        total = max(dram, comp) + min(dram, comp) / max(
            1.0, (p.bytes_in + p.bytes_out) / cache_bytes
        )
    else:
        total = dram + comp

    pcie = (p.pcie_bytes or (p.bytes_in + p.bytes_out)) / hw.pcie_bw
    return {
        "dram_s": dram,
        "compute_s": comp,
        "kernel_s": total,
        "pcie_s": pcie,
        "system_s": total + pcie,
        "speedup_vs_cpu": p.cpu_time_s / (total + pcie),
    }


# ---------------------------------------------------------------------------
# Resource model + feedback (paper Table 6 / §5.2).
# ---------------------------------------------------------------------------

MIN_CACHE_BYTES = 4 * 1024      # below this, burst init dominates (paper §3.2)


def bram_blocks(capacity_bytes: float, width_bits: int,
                hw: FpgaSpec = FPGA_2012) -> int:
    """18 Kb BRAM blocks to build a ``width_bits``-wide buffer of the given
    capacity: a block supplies <=36 bits of width, so wider words gang
    ceil(w/36) blocks; the total must also cover the capacity."""
    by_width = math.ceil(width_bits / hw.bram_block_max_width)
    by_cap = math.ceil(capacity_bytes * 8 / hw.bram_block_bits)
    return max(by_width, by_cap)


def bram_demand(p: KernelProfile, level: OptLevel, hw: FpgaSpec = FPGA_2012,
                *, cache_bytes: float, pe: int, word_bits: int) -> int:
    """Modeled BRAM block demand of one configuration (paper §5.2's
    feasibility check: buffers x PEs x blocks-per-buffer)."""
    if not level.has(Step.DATA_CACHING):
        return 0                     # no on-chip buffers in the naive port
    n_pe = (min(pe, p.max_pe)
            if level.has(Step.PE_DUPLICATION) and p.parallel_jobs > 0 else 1)
    width = word_bits if level.has(Step.SCRATCHPAD_REORG) else p.word_bytes * 8
    bufs = 3 if (level.has(Step.DOUBLE_BUFFERING) and p.overlappable) else 1
    per_pe = max(1.0, cache_bytes / n_pe)
    return bufs * n_pe * bram_blocks(per_pe, width, hw)


def _halvings(top, floor):
    out = []
    v = top
    while v >= floor:
        out.append(v)
        if v == floor:
            break
        v = max(floor, v // 2)
    return out


def fit_resources(p: KernelProfile, level: OptLevel,
                  hw: FpgaSpec = FPGA_2012, *,
                  cache_bytes: int = 64 * 1024, pe: int = 128,
                  word_bits: int = None) -> dict:
    """Paper Table 6 resource feedback: on a modeled BRAM conflict, do NOT
    stop the walk — shrink the knobs and re-measure.

    The shrink space follows the guideline's order (cache size first, then
    PE count, trading scratchpad width last) as halving grids; every
    feasible candidate is *re-measured* on the model and the fastest one
    wins, so a width-bound conflict (where shrinking the cache frees no
    blocks) correctly resolves by narrowing the scratchpad word or folding
    PEs rather than thrashing the cache.
    """
    natural = p.word_bytes * 8
    want_w = (word_bits if word_bits is not None
              else (p.max_word_bits if level.has(Step.SCRATCHPAD_REORG)
                    else natural))
    demand = bram_demand(p, level, hw, cache_bytes=cache_bytes, pe=pe,
                         word_bits=want_w)
    fit = {
        "cache_bytes": cache_bytes, "pe": pe, "word_bits": want_w,
        "demand_blocks": demand, "budget_blocks": hw.bram_blocks,
        "shrunk": False,
    }
    if demand <= hw.bram_blocks:
        return fit

    requested = dict(cache_bytes=cache_bytes, pe=pe, word_bits=want_w,
                     demand_blocks=demand)
    best = None
    for c in _halvings(cache_bytes, MIN_CACHE_BYTES):
        for q in _halvings(pe, 1):
            for w in _halvings(want_w, natural):
                d = bram_demand(p, level, hw, cache_bytes=c, pe=q,
                                word_bits=w)
                if d > hw.bram_blocks:
                    continue
                t = kernel_time(p, level, hw, cache_bytes=c, pe=q,
                                word_bits=w)["system_s"]
                key = (t, -c, -q, -w)
                if best is None or key < best[0]:
                    best = (key, dict(cache_bytes=c, pe=q, word_bits=w,
                                      demand_blocks=d))
    if best is None:
        # Even the floor config over-subscribes (pathological profile);
        # take the floor and report the overrun rather than stopping.
        c, q, w = MIN_CACHE_BYTES, 1, natural
        best = (None, dict(
            cache_bytes=c, pe=q, word_bits=w,
            demand_blocks=bram_demand(p, level, hw, cache_bytes=c, pe=q,
                                      word_bits=w)))
    fit.update(best[1])
    fit["shrunk"] = True
    fit["requested"] = requested
    return fit


def refinement_curve(
    p: KernelProfile, hw: FpgaSpec = FPGA_2012, **kw
) -> dict:
    """Times at every level O0..O5 — one paper Fig. 12 bar group.  The
    curve is paper-scoped: it stops at O5 (the serving-only O6 paged rung
    has no FPGA analog and would render as a duplicate O5 bar)."""
    return {int(lvl): kernel_time(p, lvl, hw, **kw)
            for lvl in OptLevel if lvl <= OptLevel.O5}


# ---------------------------------------------------------------------------
# MachSuite kernel profiles (inputs from paper Table 3).
#
# cpu_time_s derivations assume the Xeon executes the kernel's scalar op
# stream at an effective throughput consistent with the paper's Table 5
# PCIe-to-CPU-runtime ratios, which pin absolute CPU runtimes:
#   AES:  134 MB / 8 GB/s / 2.2e-3  = 7.6 s    (64 MB in+out through PCIe)
#   GEMM: 25.2 MB / 8GB/s / 6.0e-4  = 5.2 s
#   KMP:  128 MB / 8 GB/s / 5.9e-2  = 0.27 s
#   NW:   33.6 MB / 8GB/s / 1.5e-3  = 2.8 s
#   SORT: 134 MB / 8 GB/s / 4.9e-3  = 3.4 s
#   SPMV: 16.8MB / 8 GB/s / 1.3     = 1.6e-3 s
#   BFS:  0.84MB / 8 GB/s / 0.8     = 1.3e-4 s
#   VITERBI: 1.03GB / 8GB/s / 1.4e-2 = 9.2 s
# These anchor the model to the paper's own measurements.
# ---------------------------------------------------------------------------

MACHSUITE_PROFILES = {
    # AES ECB over 64 MB: 4M blocks x 14 rounds x 16 byte-ops.  Pipelining
    # gains 1.4x (Table 4) => L/ii ~= 7/5.  Naive port touches state/sbox/key
    # in DRAM (~1.25 effective transactions per byte-op after trivial
    # coalescing by the HLS scheduler).
    "aes": KernelProfile(
        name="aes",
        bytes_in=64e6, bytes_out=64e6,
        n_iters=4e6 * 14 * 16,
        iter_latency=7, ii=5,
        parallel_jobs=4e6, cpu_time_s=7.6,
        word_bytes=1, max_pe=128,
        naive_accesses_per_iter=1.25, pack_compute=True,
    ),
    # Queue-based BFS: 4K nodes, 64K edges; chain-dependent -> no PE dup,
    # no double buffering (next frontier depends on this one).
    # Pipelining 1.4x (Table 4) => 10/7.
    "bfs": KernelProfile(
        name="bfs",
        bytes_in=0.84e6, bytes_out=0.016e6,
        n_iters=64e3 + 4e3,
        iter_latency=5, ii=3.5,      # irregular accesses limit II
        parallel_jobs=0, cpu_time_s=1.3e-4,
        word_bytes=4, max_pe=1,
        naive_accesses_per_iter=2.5, overlappable=False,
    ),
    # 1024^3 double GEMM; pipelining 10.5x (Table 4) => L=11, II=1.
    # Tiled traffic: 2*N^3/T * 8B at T=64 => ~0.27 GB.
    "gemm": KernelProfile(
        name="gemm",
        bytes_in=2 * 1024**3 / 64 * 8, bytes_out=1024 * 1024 * 8,
        pcie_bytes=3 * 1024 * 1024 * 8,   # the two inputs + the output
        n_iters=1024**3,
        iter_latency=11, ii=1,
        parallel_jobs=1024 * 1024, cpu_time_s=5.2,
        word_bytes=8, max_pe=64,     # DSP-bound for double-precision
        naive_accesses_per_iter=3.0,
    ),
    # KMP over 128 MB text; pipelining 7.0x (Table 4) => L=7, II=1.
    "kmp": KernelProfile(
        name="kmp",
        bytes_in=128e6, bytes_out=4,
        n_iters=128e6,
        iter_latency=7, ii=1,
        parallel_jobs=64,            # segment the text into chunks
        cpu_time_s=0.27, word_bytes=1, max_pe=64,
        naive_accesses_per_iter=2.0, pack_compute=True, max_word_bits=256,
    ),
    # NW: 64K pairs of 128-nt sequences; pipelining 8.8x => L=9, II=1.
    "nw": KernelProfile(
        name="nw",
        bytes_in=64e3 * 256, bytes_out=64e3 * 256,
        n_iters=64e3 * 128 * 128,    # DP cells
        iter_latency=9, ii=1,
        parallel_jobs=64e3, cpu_time_s=2.8,
        word_bytes=1, max_pe=128,
        naive_accesses_per_iter=2.0,
    ),
    # Merge sort of 64 MB ints, 1 MB (256K-element) chunks; pipelining
    # 1.8x (Table 4) => 9/5; tree-reduce parallelism within each chunk.
    "sort": KernelProfile(
        name="sort",
        bytes_in=64e6, bytes_out=64e6,
        n_iters=64 * (256e3 * 18),   # 64 chunks x n log n
        iter_latency=9, ii=5,
        parallel_jobs=256e3,         # merges at the leaf level of a chunk
        cpu_time_s=3.4, word_bytes=4, max_pe=64, tree_reduce=True,
        naive_accesses_per_iter=2.5,
    ),
    # SPMV ELLPACK 4096x512; pipelining 10.9x => L=11, II=1.  val/col
    # streams coalesce even naively => ~1 transaction per element.
    "spmv": KernelProfile(
        name="spmv",
        bytes_in=4096 * 512 * (8 + 4), bytes_out=4096 * 8,
        n_iters=4096 * 512,
        iter_latency=11, ii=1,
        parallel_jobs=4096, cpu_time_s=1.6e-3,
        word_bytes=8, max_pe=64,
        naive_accesses_per_iter=1.0,
    ),
    # Viterbi: 1M chains x 128 steps (64 states unrolled in-stage);
    # float add/mul/cmp chain -> pipelining 3.2x (Table 4) => 40/12.
    "viterbi": KernelProfile(
        name="viterbi",
        bytes_in=1e6 * 128 * 8, bytes_out=1e6 * 4,
        n_iters=1e6 * 128,
        iter_latency=40, ii=12,
        parallel_jobs=1e6, cpu_time_s=9.2,
        word_bytes=8, max_pe=32,
        naive_accesses_per_iter=12,   # state vector mostly register-held
    ),
}


def paper_validation_table(hw: FpgaSpec = FPGA_2012) -> dict:
    """Model outputs in the shape of the paper's headline numbers.

    Returns per-kernel naive slowdown, final speedup, naive->final
    improvement, plus the aggregate gmean stats the abstract quotes.
    """
    rows = {}
    for name, prof in MACHSUITE_PROFILES.items():
        t0 = kernel_time(prof, OptLevel.O0, hw)
        t5 = kernel_time(prof, OptLevel.O5, hw)
        rows[name] = {
            "naive_speedup": t0["speedup_vs_cpu"],
            "final_speedup": t5["speedup_vs_cpu"],
            "improvement": t0["system_s"] / t5["system_s"],
            "pcie_over_cpu": t0["pcie_s"] / prof.cpu_time_s,
        }
    sl = [1.0 / r["naive_speedup"] for r in rows.values()]
    sp = [r["final_speedup"] for r in rows.values()]
    imp = [r["improvement"] for r in rows.values()]
    gmean = lambda xs: math.exp(sum(math.log(x) for x in xs) / len(xs))
    rows["_aggregate"] = {
        "gmean_naive_slowdown": gmean(sl),
        "gmean_final_speedup": gmean(sp),
        "mean_improvement": sum(imp) / len(imp),
        "min_improvement": min(imp),
        "max_improvement": max(imp),
    }
    return rows
