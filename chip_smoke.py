#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

  1. card   — the card's name and power limit (nvidia-smi), torch, CUDA
              and nvcc versions;
  2. build  — compile every kernel of the port from this checkout's
              sources with nvcc, all at once;
  3. kernel — B1, the paged-decode CUDA kernel, against its plain PyTorch
              version at the main path's shapes (qwen3-8b decode: B=8,
              H=32, KV=8, D=128, T=16, ragged lengths 1..2048, shuffled
              pool rows, NaN in the NULL block, unused rows and stale
              tails) and at edges (length 1, lengths a multiple of T,
              G=1, f32 pools, a zero-length slot), each case's body
              logged and asserted (bf16 q: the split mma.sync body; f32
              q or pools: the CUDA-core body);
     3b.    — B2, the multi-query kernel (same source), against its plain
              version at the slice's shapes (chunked prefill B=1, Q=64
              from starts 0, 37 and 960, a padded final chunk past the
              table; verify B=8, Q=5 over the phase-3 lengths) and edges
              (G=1, f32 pools, a window across a block boundary, smoke
              width); B2 at Q=1 and every row of a chunk and of a verify
              window bitwise equal to B1 at that row's limit.  For both
              kernels: device times of the kernel, the plain version and
              one PyTorch library call (``scaled_dot_product_attention``
              on a pre-gathered dense view — a yardstick the port never
              calls), the wrapper's host time per call, and the bound;
              beside them the CUDA-core body's time at the same shape
              and the split body's at partitions of 64..512 positions;
     3g.    — the quantized branch of B1 and B2 (B1q, B2q: int8 and fp8
              e4m3 pools with (row, kv head) f32 scales, bf16 q) against
              the plain versions at the main path's shapes (B1 decode;
              B2 chunk B=1, Q=64 from 960; verify B=8, Q=5) and edges
              (G=1, f32 q, smoke width), with NaN in the NULL block, the
              unused rows and their scale rows, stale tails and a
              zero-scale row; every output bitwise equal to the kernel on
              the pool dequantized with ``kvquant.dequantize``; device
              times of the kernel (and of the CUDA-core body and the
              split body's partition sizes), the plain version and
              ``scaled_dot_product_attention`` on the pre-dequantized
              gathered view, the wrapper's host time, and the bound;
     3c.    — B3, the flash-attention kernel, against its plain version
              (TF32 off) at smollm-360m's training shape (B=8, S=4096,
              H=15, Hkv=5, D=64, causal), qwen3-8b's heads (H=32, Hkv=8,
              D=128, S=2048), a rectangular causal offset (S=64,
              S_kv=1024), a non-causal case and a ragged S=1000, each in
              bf16 and f32; its autograd Function's gradients against
              autograd through the plain version at the smollm layer
              shape; device times of the kernel, the plain version and
              ``scaled_dot_product_attention(is_causal=True,
              enable_gqa=True)`` (the yardstick), the wrapper's host
              time, and the bound; then (C9) at head_dim 16, 20, 192 and
              256 (B=2, S=1000, causal, bf16 and f32), and the Function's
              gradients at head_dim 20.  Every case logs the body that
              ran (bf16: the mma.sync tensor-core body; f32: the CUDA-core
              body, also timed at the training shape);
     3d.    — B4, the RWKV-6 WKV kernel, against its plain version
              (``wkv_chunked_ref``) at rwkv6-3b's training shape (B=4,
              S=4096, H=40, N=64, chunk 128) and at edges (the smoke
              width N=16 with chunk 64, chunk 48, N=8, lw at the clamp's
              edge), each in bf16 and f32, with and without an initial
              state, each case's body asserted and logged (the
              chunk-parallel 3xTF32 body where ``ops.body`` sends it; the
              CUDA-core body at chunk 48 and N=8); its autograd
              Function's gradients against autograd through the plain
              version; device times of the kernel, the CUDA-core body at
              the same shape and the plain version (no PyTorch call
              computes the recurrence, so no library time), the wrapper's
              host time, and the bound (3xTF32's products, and the bf16
              bound of earlier PRs beside it);
     3e.    — B5, the Mamba-2 SSD kernel, against its plain version
              (``ssd_chunked_ref``) at mamba2-2.7b's training shape (B=4,
              S=4096, H=80, P=64, N=128, chunk 256) and at edges (the
              smoke width P=32, N=16 with chunk 128; P=8, N=8 with chunk 8
              and S=40; a strong decay whose cumsum passes -100 inside a
              chunk), each in bf16 and f32, with and without an initial
              state, each case's body asserted and logged (the
              chunk-parallel 3xTF32 body; the CUDA-core body at P=8,
              N=8); its autograd Function's gradients against autograd
              through the plain version; device times of the kernel, the
              CUDA-core body at the same shape, the plain version and the
              Function's forward and backward (no PyTorch call computes
              the scan, so no library time), the wrapper's host time, and
              the bound (as for B4);
     3f.    — B7 (the O0 rung) and B6 (O1..O5), the blocked matmul of
              the paper's Fig. 4 ladder, against their plain versions
              at every rung at MachSuite's 1024^3, at O3..O5 at 4096^3,
              and at edges (the four shapes of the reference's tests at
              every rung, odd divisor blocks whose rows copy 4 B or one
              bf16 element at a time, a 256-wide tile in two sub-tiles,
              bf16 operands at O0, and O1 stripes over the shared-memory
              budget, which must raise); for each rung the blocks it ran,
              device times of the kernel, the plain version and
              ``torch.matmul`` (f32 with TF32 off; bf16 at O5), the
              wrapper's host time, and the bound (f32 rungs: 3xTF32's
              three tensor-core products at the 495 TFLOP/s TF32 peak).
              Every case logs the B6 body that ran; O5 at 1024^3 and
              4096^3 must run the wgmma body, O3 and O4 the 3xTF32 body,
              O1 and O2 the CUDA-core body; each tensor-core body's time
              is read beside the CUDA-core body's at the same blocks;
  4. ladder — smoke-width qwen3-8b on the card at O0, O1, O2, O4, O5,
              O6-gather, O6-kernel, with chunked prefill (chunks 3 and 8)
              on O5, O6-gather and O6-kernel, and at O7 with the
              smollm-360m smoke drafter (K = 2, 4; gather and kernel
              verify): identical greedy tokens on a mixed request set
              with mid-flight arrivals and planted eos; a self-draft run
              must accept every draft; prefill -> insert -> generate on
              O5, O6-gather and O6-kernel with chunks of 8 and on O0, each
              with the prestaged run's tokens; ``compact()`` after every
              tick on O6-kernel, blocks conserved, tokens unchanged;
  5. full   — qwen3-8b at its published widths in bf16 with random
              weights from a seed, 8 requests (prompts 16-256, 32 new
              tokens each) at batch 8, max_seq 1024, T=16, O6-kernel:
              (a) a teacher-forced run of the gather step and the kernel
              step over a shared random KV prefix, logits compared tick by
              tick, at 2 layers (tight) and 36 (held to the drift of the
              kernel's plain version); (b) ``serve_demo`` with prompts fed
              a token per tick, B1 launches = layers x ticks, every
              B1/B2 launch of (b), (d), (e) and (f) on the split body
              (asserted); (c) a
              ``torch.profiler`` reading of device time per tick;
              (d) chunked prefill at ``prefill_chunk=64``: TTFT in ticks
              and ms, B2 launches = layers x chunk dispatches and B1
              launches = layers x decode dispatches, and a teacher-forced
              check of the chunk step against the decode step fed one
              token at a time (2 layers tight, 36 held to B2's plain
              version's drift); (e) O7 at ``draft_k=4`` with the target
              drafting for itself (the published qwen3-8b -> smollm-360m
              pair must be refused at full scale): acceptance, tokens per
              window, B2 launches = layers x verify dispatches, the share
              of tokens equal to (d)'s, and a teacher-forced comparison of
              verify rows with decode rows that says where their bits
              part; (f) served from int8 and fp8 pools of (b)'s pool
              bytes (about twice the rows) through B1q/B2q: (b)'s 8
              requests prestaged, B1 launches = layers x ticks; 16
              requests at batch 16 from bf16, int8 and fp8 pools (the
              most admitted at once); on int8 (d) chunk 64 and (e) O7
              K=4; a profile of int8 ticks; the int8 kernel step
              teacher-forced against its plain version (2 layers tight,
              36 loose); smoke width on the card against the CPU under
              ``kvquant.tolerance_contract``; token agreement with the
              bf16 runs reported;
     5o.    — the un-pipelined rungs at full width: 4 requests (prompts
              16-64, 8 new tokens) at batch 4, max_seq 256, served at O0
              (a batch-1 call per request per tick, the cache rebuilt at
              each admission), O1, O2 and O5: ms per tick, tokens/s and
              peak memory per rung, no kernel launched; O2's tokens equal
              O5's; where O0/O1's part from O5's, the first divergent
              position's batch-1 logits are held to the batched step's
              within 3e-2 of their scale (ROADMAP C12);
     5s.    — the async server (``launch.server``) over phase 5's engine
              (O6-kernel, chunk 64, batch 8, run (b)'s pool): 16 requests
              (prompts 16-256, 16-32 new tokens) drained closed-loop for
              the drain rate, then replayed open-loop through
              ``serve_trace`` at 0.5x and 2x that rate (poisson) and 1x
              (bursty): each run's ``latency_metrics`` row (TTFT and TPOT
              p50/p99, tok/s, goodput at the reference's SLOs), every
              request finished with the closed-loop tokens, B1 and B2
              launched, all on the split body; then ``prefill`` ->
              ``insert`` of a 720-token prompt (B2 on a private pool)
              while 7 others decode, and ``generate``, with the tokens of
              submitting it;
  6. train  — smollm-360m at its published widths (32 layers, d_model
              960, 15 heads, 5 kv heads, head_dim 64, d_ff 2560, vocab
              49,152), f32 masters, bf16 compute, remat full, trained 5
              steps through ``repro_torch.launch.train.train`` on the
              synthetic stream from seed 0 at seq 4096, global batch 8
              (train_4k's 256 cut to 8) from random weights: per-step
              loss, grad_norm, lr and wall time, tokens/s, peak memory,
              and B3's launches (32 forward + 32 remat recompute a step,
              all on the mma body, asserted); step 0's loss and
              grad_norm computed once with B3 and once with the plain
              attention in its place;
     6b.    — ``train()`` on the smoke configs of qwen3-8b (head_dim 16),
              smollm-360m (head_dim 20), rwkv6-3b (N=16) and mamba2-2.7b
              (P=32, N=16), 3 steps at batch 8 x 128 on the card and on
              the CPU: the losses held together, B3 / B4 / B5 launches
              counted;
  7. rwkv   — rwkv6-3b at its published widths (32 layers, d_model 2560,
              40 heads of 64, d_ff 8960, vocab 65,536), f32 masters, bf16
              compute, remat full, trained 5 steps through ``train()`` on
              the synthetic stream from seed 0 at seq 4096, global batch
              4 (train_4k's 256 cut to 4): per-step loss, grad_norm, wall
              time, tokens/s, peak memory and B4's launches (32 forward +
              32 remat recompute a step, all on the chunk body,
              asserted); step 0 with B4 and
              with its plain version in its place at 32 and 2 layers; a
              ``torch.profiler`` reading of one step;
  8. mamba  — mamba2-2.7b at its published widths (64 layers, d_model
              2560, 80 heads of 64, state 128, expand 2, conv 4, vocab
              50,288), f32 masters, bf16 compute, remat full, trained 5
              steps through ``train()`` on the synthetic stream from seed
              0 at seq 4096, global batch 4 (train_4k's 256 cut to 4):
              per-step loss, grad_norm, wall time, tokens/s, peak memory
              and B5's launches (64 forward + 64 remat recompute a step,
              all on the chunk body, asserted); step 0 with B5 and with
              its plain version in its
              place at 64 and 2 layers; a ``torch.profiler`` reading of
              one step;
  9. paper  — the paper's ladder on the card: ``ops.matmul(a, b, level)``
              for O0..O5 at 1024^3 and O3..O5 at 4096^3, one B7 or B6
              launch a call (asserted; O5 on B6's wgmma body, O3 and O4
              on its 3xTF32 body, O1 and O2 on its CUDA-core body), each
              held to its plain version; the Fig. 4 analogue (device ms
              per rung, speedup over O0 and over the rung before, beside
              the analytic model's), with O2 -> O3 read in two steps
              (PE duplication on the CUDA cores, then the tensor cores);
              ``machsuite.gemm.run`` at every level on the card at 32 x
              32, held to the float64 oracle;
 10. walk   — ``python -m repro_torch.autotune --serve --arch qwen3-8b``
              in this process at the reference's defaults (smoke width,
              O0 -> O7, the paged-attention, prefill-chunk, draft-K and
              pool-dtype races): each round's level, wall, tok/s and the
              races' walls; tokens identical across the kept bf16 rungs;
              B1 launched by the paged-attention race, all on the split
              body.

Prints each phase's wall, the card line and a JSON object of kernel
numbers on lines before the last, writes the detailed numbers to
``chiprun_out/chip_smoke.json`` (and phase 10's trajectory under
``chiprun_out/autotune/``),
and ends with ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the rest of this repository beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (dense): HBM bytes/s and bf16 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# Dense TF32 FLOP/s of the tensor cores (H100 SXM data sheet, 495
# TFLOP/s).  The least time the card needs for an f32 matmul is 3xTF32's
# three tensor-core products at this rate (the f32 CUDA-core peak, 67
# TFLOP/s, is slower): the bound of B6's f32 rungs and of B7.
TF32_FLOPS = 495e12
# Clock cycles of the spin kernel that holds the device ahead of a timed
# launch: about 5 ms at the H100's 1.98 GHz boost clock.
SPIN_CYCLES = 10_000_000

KERNEL_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
# The tensor-core body of B1/B2/B1q/B2q (bf16 q, the main path's).
SPLIT_SOURCE = ("src/repro_torch/kernels/paged_attention/csrc/"
                "paged_attention_split.cu")
B1_REPLACES = "src/repro/kernels/paged_attention/kernel.py:318"
B2_REPLACES = "src/repro/kernels/paged_attention/kernel.py:254"
# The quantized branch of both: _dequant and the ks/vs scale operands.
BQ_REPLACES = "src/repro/kernels/paged_attention/kernel.py:64"
# |kernel - plain| <= ATOL + RTOL * |plain|: two bf16 ulps for bf16
# outputs; reduction-order noise for f32.  B2 takes |plain| as the
# largest |plain| of the element's row (one query head): its short rows
# (a prefill chunk's first queries attend a handful of positions) carry
# probabilities near 1, and a one-ulp difference in one of them, from
# the order the softmax denominator is summed in, moves every output of
# the row at the row's scale, also where the output cancels to near 0.
TOL = {"bf16": (1e-3, 1.6e-2), "f32": (1e-5, 1e-4)}
B3_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention_mma.cu")
B3_F32_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                 "flash_attention.cu")
B3_REPLACES = "src/repro/kernels/flash_attention/kernel.py:89"
# |kernel - plain| <= RTOL * (the row's largest |plain|): two bf16 ulps
# for bf16 (both round once from f32, so only a near-tie rounds apart);
# summation order for f32.
B3_TOL = {"bf16": 1.6e-2, "f32": 1e-5}
# Phase 6: step 0 with B3 against the plain attention (relative).  Both
# compute in f32 and round once to bf16, so only near-ties round apart.
# The loss is held to 1e-3 at 32 layers and at 2.  The gradient is held
# tight at 2 layers only: with the reference's initialiser (fan-in taken
# as shape[-2], so wq/wk/wv draw with std 1/sqrt(H) instead of
# 1/sqrt(d)) the step-0 gradient grows exponentially with depth and is
# chaotic — on the CPU in f32, at full width, JAX and the port on the
# same weights give grad_norms 404 / 404 at 2 layers, 21,924 / 23,175 at
# 4 and 1.2e7 / 2.0e6 at 8 (tools/grad_by_depth.py) — so at 32 layers
# grad_norm is held only to be finite and within a factor of 10.
TRAIN_TOL = {32: {"loss": 1e-3, "grad_norm_factor": 10.0},
             2: {"loss": 1e-3, "grad_norm": 1e-2}}
# B4's chunk-parallel tensor-core body (the main path's) and its CUDA-core
# body (other widths and chunks).
B4_SOURCE = "src/repro_torch/kernels/rwkv6_wkv/csrc/rwkv6_wkv_chunk.cu"
B4_CORE_SOURCE = "src/repro_torch/kernels/rwkv6_wkv/csrc/rwkv6_wkv.cu"
B4_REPLACES = "src/repro/kernels/rwkv6_wkv/kernel.py:73"
# |kernel - plain| <= WKV_TOL * (the largest |plain|) for y and for the
# f32 state, for B4 and for B5: both sides compute in f32 and differ only
# in summation order (B5 and its plain version sum the same cums, so
# their decays round alike); bf16 y may also round one bf16 ulp of
# itself the other way.
WKV_TOL = 2e-5
# Phase 7's global batch (train_4k's 256 cut to one card; PERF.md §4).
RWKV_BATCH = 4
B5_SOURCE = "src/repro_torch/kernels/mamba2_ssd/csrc/mamba2_ssd_chunk.cu"
B5_CORE_SOURCE = "src/repro_torch/kernels/mamba2_ssd/csrc/mamba2_ssd.cu"
B5_REPLACES = "src/repro/kernels/mamba2_ssd/kernel.py:66"
# Phase 8's global batch (train_4k's 256 cut to one card; PERF.md §4).
MAMBA_BATCH = 4
# Phase 6b: each smoke loss on the card within this of the CPU's
# (relative).  Both run bf16 compute from the same weights and batches;
# they differ in the GEMMs' summation order and in B3/B4 against their
# plain versions (each rounds once from f32), over 3 small steps.
SMOKE_TRAIN_TOL = 5e-3
# Phase 7: step 0 with B4 against its plain version (relative).  Both
# compute the WKV in f32 and round y once to bf16.  rwkv's projections
# are 2-D, so the initialiser's fan-in is right (unlike smollm's, C8);
# grad_norm is held at 2 layers and read at 32.
RWKV_TRAIN_TOL = {32: {"loss": 1e-3}, 2: {"loss": 1e-3, "grad_norm": 1e-2}}
# Phase 8: step 0 with B5 against its plain version (relative).  Both
# compute the scan in f32 and round y once to bf16; mamba2's projections
# are 2-D (C8 does not apply), so grad_norm is held at both depths.
MAMBA_TRAIN_TOL = {64: {"loss": 1e-3, "grad_norm": 1e-2},
                   2: {"loss": 1e-3, "grad_norm": 1e-2}}
B6_SOURCE = "src/repro_torch/kernels/tiled_matmul/csrc/tiled_matmul.cu"
B6_WGMMA_SOURCE = ("src/repro_torch/kernels/tiled_matmul/csrc/"
                   "tiled_matmul_wgmma.cu")
B6_TF32X3_SOURCE = ("src/repro_torch/kernels/tiled_matmul/csrc/"
                    "tiled_matmul_tf32x3.cu")
B6_REPLACES = "src/repro/kernels/tiled_matmul/kernel.py:63"
B7_REPLACES = "src/repro/kernels/tiled_matmul/kernel.py:121"
# |kernel - plain| <= MATMUL_TOL * max|plain| for B6 and B7 at every
# rung: both sum f32 products (a bf16 product is exact in f32) in another
# order; at K = 4096 that order moves the sum by ~1e-6 of its scale.
MATMUL_TOL = 1e-5
# The ladder's sizes: MachSuite's gemm (paper Table 3, 1024 x 1024), and
# 4096^3 for the parallel rungs, whose 1024^3 grid (64 tiles of 128 x
# 128) leaves half the card's 132 SMs idle.
LADDER_N = 1024
LADDER_BIG = 4096
# The one-SM rungs (O0..O2) take tens of ms at 1024^3 by design: timed
# with a few repetitions, and never at 4096^3.
SLOW_RUNGS = (0, 1, 2)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def time_ms(fn, *, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``reps`` launches (CUDA
    events), with the 50 MB L2 flushed before each so every launch finds
    its operands in HBM, as a decode layer does.  A spin kernel of about
    5 ms queued ahead of the start event holds the device while the host
    enqueues ``fn``'s launches, so the wrapper's host time (checks,
    ctypes, Python) is not counted: the events bracket device work
    only."""
    import torch

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, *, reps: int = 200) -> float:
    """Host time per call of ``fn()``: the wall clock over ``reps``
    calls enqueued back to back, behind a spin kernel long enough that
    the device never waits for the host and the launch queue never
    fills, so the clock reads the wrapper's own cost."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES * 20)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


# ---------------------------------------------------------------------------
# Phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

def paged_case(B, H, KV, D, T, lengths, *, dtype, q_dtype=None, seed=0,
               extra_rows=16, device="cuda", q_len=None, nb=None):
    """A pool whose referenced rows are shuffled, whose NULL block,
    unused rows and per-slot tails past the length hold NaN.  ``q_len``
    gives q a query axis (B, q_len, H, D); ``nb`` widens the tables past
    the longest length, or narrows them below it."""
    import numpy as np
    import torch

    r = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    nb = nb or max(1, -(-int(lengths.max()) // T))
    R = 1 + B * nb + extra_rows
    g = torch.Generator(device=device).manual_seed(seed)
    kp = torch.randn((R, T, KV, D), generator=g, device=device).to(dtype)
    vp = torch.randn((R, T, KV, D), generator=g, device=device).to(dtype)
    q = torch.randn((B, H, D) if q_len is None else (B, q_len, H, D),
                    generator=g, device=device).to(q_dtype or dtype)
    tables = np.zeros((B, nb), np.int32)
    free = list(range(1, R))
    r.shuffle(free)
    used = set()
    for b in range(B):
        for j in range(min(nb, -(-int(lengths[b]) // T))):
            tables[b, j] = free.pop()
            used.add(int(tables[b, j]))
    for row in range(R):
        if row not in used:
            kp[row] = float("nan")
            vp[row] = float("nan")
    for b in range(B):
        L = int(lengths[b])
        if L % T and L < nb * T:
            kp[int(tables[b, L // T]), L % T:] = float("nan")
            vp[int(tables[b, L // T]), L % T:] = float("nan")
    return (q, kp, vp, torch.tensor(tables, device=device),
            torch.tensor(lengths, device=device))


def paged_call(fn, case):
    """``fn`` on a case: (q, k_pool, v_pool, tables, lengths), or a narrow
    pool's case with its (k_scale, v_scale) after them."""
    if len(case) == 7:
        return fn(*case[:5], k_scale=case[5], v_scale=case[6])
    return fn(*case)


def check_case(name, case, kind, *, prefill=False):
    """Kernel vs plain on one case; returns (max |kernel - plain|, the
    kernel's output)."""
    import torch
    from repro_torch.kernels.paged_attention import ops, ref

    fn, plain = ((ops.paged_prefill_attention,
                  ref.paged_prefill_attention_ref) if prefill else
                 (ops.paged_attention, ref.paged_attention_ref))
    which = ops.body(case[0].dtype, case[1].dtype, case[0].shape[-1])
    before = dict(fn.body_launches)
    out = paged_call(fn, case)
    torch.cuda.synchronize()
    if fn.body_launches != {**before, which: before[which] + 1}:
        raise AssertionError(f"kernel case {name}: bodies "
                             f"{fn.body_launches}, before {before}, want "
                             f"one {which}")
    got, want = out.float(), plain(*case).float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"kernel case {name}: non-finite output")
    err = (got - want).abs()
    atol, rtol = TOL[kind]
    scale = (want.abs().amax(dim=-1, keepdim=True) if prefill
             else want.abs())
    bad = err > atol + rtol * scale
    if bad.any():
        raise AssertionError(
            f"kernel case {name}: {int(bad.sum())} elements beyond "
            f"{atol} + {rtol}*|plain| (max err {float(err.max())})")
    tag = ("B2" if prefill else "B1") + ("q" if len(case) == 7 else "")
    log(f"[kernel] {tag} {name}, {which} body: max |kernel - plain| "
        f"= {float(err.max()):.3e} (tolerance {atol} + {rtol}*|plain|"
        f"{' of the row' if prefill else ''})")
    return float(err.max()), out


def bound(nbytes: int, flops: int, peak: float = BF16_FLOPS,
          tf32_flops: int = 0) -> tuple:
    """(least time in ms, what bounds it) on an H100 SXM: the bytes at
    the memory rate against the operations, ``flops`` at ``peak`` FLOP/s
    (bf16 unless given) plus ``tf32_flops`` at the TF32 peak.  A caller
    counts a 3xTF32 product in ``tf32_flops`` once for each tensor-core
    pass it needs at f32's accuracy: three where both operands are f32,
    two where one is exact in TF32 (a widened bf16 value has no small
    part)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / peak + tf32_flops / TF32_FLOPS) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernel() -> tuple:
    """B1 against its plain version; returns its kernel-line entry and
    the main case (phase 3b holds B2 at Q=1 against it)."""
    import numpy as np
    import torch

    B, H, KV, D, T = 8, 32, 8, 128, 16
    r = np.random.default_rng(0)
    lengths = r.integers(1, 2049, B)
    lengths[0], lengths[-1] = 1, 2048
    bf = torch.bfloat16
    main = paged_case(B, H, KV, D, T, lengths, dtype=bf)
    err, _ = check_case(f"main path B={B} H={H} KV={KV} D={D} T={T} "
                        f"lengths={lengths.tolist()}", main, "bf16")
    check_case("length 1 everywhere",
               paged_case(B, H, KV, D, T, [1] * B, dtype=bf, seed=1), "bf16")
    check_case("lengths multiples of T",
               paged_case(B, H, KV, D, T, [16, 32, 64, 256, 512, 16, 48, 96],
                          dtype=bf, seed=2), "bf16")
    check_case("G=1 (H=KV=8)",
               paged_case(4, 8, 8, D, T, [5, 17, 300, 64], dtype=bf, seed=3),
               "bf16")
    check_case("f32 q and pool",
               paged_case(4, H, KV, D, T, [7, 130, 1024, 33],
                          dtype=torch.float32, seed=4), "f32")
    check_case("f32 q, bf16 pool",
               paged_case(4, H, KV, D, T, [7, 130, 1024, 33], dtype=bf,
                          q_dtype=torch.float32, seed=5), "f32")
    check_case("smoke width (H=4, KV=2, D=16, T=4)",
               paged_case(3, 4, 2, 16, 4, [1, 9, 32], dtype=bf, seed=6),
               "bf16")
    zero = paged_case(3, H, KV, D, T, [0, 40, 3], dtype=bf, seed=7)
    check_case("a zero-length slot", zero, "bf16")

    t = time_decode(main)
    out = {
        "name": "paged_attention",
        "route": "cuda",
        "source": SPLIT_SOURCE,
        "replaces": B1_REPLACES,
        "launches": None,
        "max_abs_err": err,
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "wrapper_host_ms",
                             "cuda_core_ms", "p", "p_sweep")},
        "cuda_core_source": KERNEL_SOURCE,
    }
    log(f"[kernel] B1 main path: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, library (sdpa on a gathered view) "
        f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}: {t['bytes']} B, {t['flops']} FLOP); the "
        f"wrapper's host time per call {t['wrapper_host_ms']:.4f} ms")
    log_bodies("B1 main path", t)
    return out, main


def kv_bytes(case, n_tok: int, blocks: int) -> int:
    """Bytes of K and V a paged case reads for ``n_tok`` positions over
    ``blocks`` pool blocks: the words, and a narrow pool's (row, head)
    scales of those blocks."""
    kp = case[1]
    KV, D = kp.shape[2], kp.shape[3]
    scales = 2 * blocks * KV * 4 if len(case) == 7 else 0
    return 2 * n_tok * KV * D * kp.element_size() + scales


def wide_case(case):
    """A narrow pool's case with its pools dequantized to q's dtype (the
    kvquant rounding site) and no scales; a wide case as it is."""
    if len(case) == 5:
        return case
    from repro_torch.serving import kvquant

    q, kw, vw, tables, lens, ks, vs = case
    return (q, kvquant.dequantize(kw, ks[:, None, :, None], q.dtype),
            kvquant.dequantize(vw, vs[:, None, :, None], q.dtype), tables,
            lens)


# The split body's partition sizes that phases 3, 3b and 3g time beside
# the one ops.partition_positions picks (scripts/paged_split_ab.py times
# them in turns).
SPLIT_PS = (64, 128, 256, 512)


def paged_variants(case):
    """({variant: launch}, out) for one paged case (3-D q is B1): the
    split body at each P of ``SPLIT_PS`` and the CUDA-core body, launched
    straight through the binding into ``out`` (not routed, not
    counted)."""
    import torch
    from repro_torch.kernels.paged_attention import kernel, ops, ref

    q, kp, vp, tables, lens = case[:5]
    ks, vs = case[5:] if len(case) == 7 else (None, None)
    q4 = q if q.dim() == 4 else q[:, None]
    out = torch.empty_like(q4)
    scale = ref.kernel_scale(q.shape[-1], q.dtype)
    Q = q4.shape[1]
    rows = ops.row_tile(q4.shape[2] // kp.shape[2] * Q)
    runs = {f"split P={P}": (lambda P=P: kernel.launch_split(
        q4, kp, vp, ks, vs, tables, lens, out, scale, Q=Q, rows=rows, P=P))
        for P in SPLIT_PS}
    core = kernel.launch if q.dim() == 3 else kernel.launch_prefill
    out3 = out[:, 0] if q.dim() == 3 else out
    runs["cuda_core"] = lambda: core(q, kp, vp, ks, vs, tables, lens, out3,
                                     scale)
    return runs, out


def body_timings(case) -> dict:
    """For a case the split body takes: the CUDA-core body's device time
    on it (``cuda_core_ms``: the body the split body replaced) and the
    split body's at each P of ``SPLIT_PS`` (``p_sweep``), each output
    held to the plain version at the bf16 tolerance."""
    from repro_torch.kernels.paged_attention import ops, ref

    q = case[0]
    if ops.body(q.dtype, case[1].dtype, q.shape[-1]) != "split_mma":
        return {}
    plain = (ref.paged_attention_ref if q.dim() == 3
             else ref.paged_prefill_attention_ref)
    want = plain(*case).float()
    want = want[:, None] if q.dim() == 3 else want
    atol, rtol = TOL["bf16"]
    runs, out = paged_variants(case)
    res = {"p": ops.partition_positions(case[1].shape[1], q.shape[-1]),
           "p_sweep": {}}
    for k, fn in runs.items():
        out.fill_(float("nan"))
        fn()
        err = (out.float() - want).abs()
        if not (err <= atol + rtol * want.abs().amax(-1, keepdim=True)).all():
            raise AssertionError(f"{k}: max |err| {float(err.max())} over "
                                 f"the tolerance")
        t = time_ms(fn, reps=15)
        if k == "cuda_core":
            res["cuda_core_ms"] = t
        else:
            res["p_sweep"][int(k.split("=")[1])] = t
    return res


def log_bodies(what: str, t: dict) -> None:
    if t.get("p_sweep"):
        log(f"[kernel] {what}: the CUDA-core body {t['cuda_core_ms']:.4f} ms; "
            f"the split body at P = " + ", ".join(
                f"{P}: {ms:.4f}" for P, ms in t["p_sweep"].items())
            + f" ms (P = {t['p']} routed)")


def time_decode(case) -> dict:
    """B1's kernel, plain and library times on one case (wide, or narrow
    with its scales), the wrapper's host time, and the bound.  The
    library call is ``scaled_dot_product_attention`` on the gathered —
    for a narrow pool pre-dequantized — dense view."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops, ref

    q, kp, _, tables, lens = case[:5]
    B, H, D = q.shape
    T = kp.shape[1]
    kd, vd = dense_view(wide_case(case))
    mask = (torch.arange(kd.shape[2], device="cuda")[None] < lens[:, None])[
        :, None, None, :]
    q4 = q[:, :, None, :]
    res = {
        "ms": time_ms(lambda: paged_call(ops.paged_attention, case)),
        "wrapper_host_ms": host_ms(
            lambda: paged_call(ops.paged_attention, case)),
        "plain_ms": time_ms(lambda: ref.paged_attention_ref(*case)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask, enable_gqa=True)),
    }
    res.update(body_timings(case))
    n_tok = int(lens.sum())
    blocks = int(sum(-(-int(x) // T) for x in lens.tolist()))
    nbytes = (q.numel() * q.element_size() * 2           # q in, out
              + kv_bytes(case, n_tok, blocks)            # K, V (+ scales)
              + blocks * 4 + B * 4)                      # tables, lengths
    flops = 4 * H * D * n_tok                            # QK and PV
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops)
    res.update(bytes=nbytes, flops=flops)
    return res


def dense_view(case):
    """The slot-major dense (B, KV, S, D) K and V a table gathers, NaN
    zeroed: what ``scaled_dot_product_attention`` reads as a yardstick."""
    import torch

    q, kp, vp, tables, _ = case[:5]
    B, nb = tables.shape
    _, T, KV, D = kp.shape
    rows = tables.reshape(-1).long()
    return tuple(torch.nan_to_num(p.index_select(0, rows)).reshape(
        B, nb * T, KV, D).permute(0, 2, 1, 3).contiguous() for p in (kp, vp))


def row_limits(case):
    """(B, Q) causal limit of every query row of a B2 case."""
    import torch

    q, _, _, tables, lens = case[:5]
    Q = q.shape[1]
    lim = lens.long()[:, None] - (Q - 1 - torch.arange(Q, device=q.device))
    return lim.clamp(max=tables.shape[1] * case[1].shape[1])


def time_prefill(case) -> dict:
    """B2's kernel, plain and library times on one case, and its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops, ref

    q, kp, vp, tables, lens = case[:5]
    B, Q, H, D = q.shape
    KV = kp.shape[2]
    kd, vd = dense_view(wide_case(case))
    lim = row_limits(case)
    mask = (torch.arange(kd.shape[2], device="cuda")[None, None]
            < lim[:, :, None])[:, None]                       # (B,1,Q,S)
    qh = q.transpose(1, 2)                                    # (B,H,Q,D)
    res = {
        "ms": time_ms(lambda: paged_call(ops.paged_prefill_attention, case)),
        "wrapper_host_ms": host_ms(
            lambda: paged_call(ops.paged_prefill_attention, case)),
        "plain_ms": time_ms(lambda: ref.paged_prefill_attention_ref(*case)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qh, kd, vd, attn_mask=mask, enable_gqa=True)),
    }
    res.update(body_timings(case))
    span = lim.max(dim=1).values.clamp(min=0)                 # per slot
    n_tok = int(span.sum())
    blocks = int(sum(-(-int(x) // kp.shape[1]) for x in span))
    nbytes = (q.numel() * q.element_size() * 2                # q in, out
              + kv_bytes(case, n_tok, blocks)                 # K, V (+ scales)
              + blocks * 4 + B * 4)                           # tables, lengths
    flops = 4 * H * D * int(lim.clamp(min=0).sum())           # QK and PV
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops)
    res.update(bytes=nbytes, flops=flops,
               shape=f"B={B} Q={Q} H={H} KV={KV} D={D} T={kp.shape[1]} "
                     f"lengths={lens.tolist()}")
    return res


def phase_prefill_kernel(b1_main) -> dict:
    """Phase 3b: B2 against its plain version at the slice's shapes
    (chunked prefill B=1, Q=64; verify B=8, Q=5) and edges, Q=1 and
    every verify row bitwise equal to B1; times of the prefill shape,
    with the verify shape's beside them."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import ops

    H, KV, D, T = 32, 8, 128, 16
    bf = torch.bfloat16
    def rows_are_b1(name, case, got):
        """Every query row of a B2 output is B1 at that row's limit."""
        q, kp, vp, tables, lens = case
        Q = q.shape[1]
        for qi in range(Q):
            one = ops.paged_attention(q[:, qi].contiguous(), kp, vp, tables,
                                      lens - (Q - 1 - qi))
            if not torch.equal(one, got[:, qi]):
                raise AssertionError(
                    f"B2 {name}: row {qi} differs from B1 at its limit in "
                    f"{int((one != got[:, qi]).sum())} elements")
        log(f"[kernel] B2 {name}: every row bitwise equal to B1 at its "
            f"limit")

    errs = []
    chunks = {}
    for start, nb in ((0, None), (37, None), (960, 64), (960, 63)):
        what = (f"chunked prefill B=1 Q=64 start={start}" + (
            f" (padded final chunk past the {nb * T}-position table)"
            if nb == 63 else ""))
        case = paged_case(1, H, KV, D, T, [start + 64], dtype=bf, q_len=64,
                          seed=10 + start % 7, nb=nb)
        err, got = check_case(what, case, "bf16", prefill=True)
        errs.append(err)
        chunks[(start, nb)] = case
        rows_are_b1(what, case, got)

    r = np.random.default_rng(0)
    lengths3 = r.integers(1, 2049, 8)
    lengths3[0], lengths3[-1] = 1, 2048
    verify = paged_case(8, H, KV, D, T, lengths3 + 4, dtype=bf, q_len=5,
                        seed=20)
    what = f"verify B=8 Q=5 lengths={(lengths3 + 4).tolist()}"
    err, got = check_case(what, verify, "bf16", prefill=True)
    errs.append(err)
    rows_are_b1("verify", verify, got)
    # Q=1 is B1, bit for bit.
    q, kp, vp, tables, lens = b1_main
    one = ops.paged_prefill_attention(q[:, None].contiguous(), kp, vp,
                                      tables, lens)
    if not torch.equal(one[:, 0], ops.paged_attention(*b1_main)):
        raise AssertionError("B2 at Q=1 differs from B1")
    log("[kernel] B2 at Q=1 bitwise equal to B1 on B1's main case")

    errs.append(check_case(
        "G=1 (H=KV=8) Q=7", paged_case(3, 8, 8, D, T, [7, 40, 300],
                                       dtype=bf, q_len=7, seed=21),
        "bf16", prefill=True)[0])
    check_case("f32 q and pool Q=5",
               paged_case(3, H, KV, D, T, [9, 130, 1024], q_len=5,
                          dtype=torch.float32, seed=22), "f32", prefill=True)
    errs.append(check_case(
        "window across a block boundary (starts 14, 30, 46; Q=5)",
        paged_case(3, H, KV, D, T, [19, 35, 51], dtype=bf, q_len=5,
                   seed=23), "bf16", prefill=True)[0])
    errs.append(check_case(
        "smoke width (H=4, KV=2, D=16, T=4) Q=3",
        paged_case(3, 4, 2, 16, 4, [3, 9, 32], dtype=bf, q_len=3, seed=24),
        "bf16", prefill=True)[0])

    main = time_prefill(chunks[(960, 64)])
    vt = time_prefill(verify)
    out = {
        "name": "paged_prefill_attention",
        "route": "cuda",
        "source": SPLIT_SOURCE,
        "replaces": B2_REPLACES,
        "launches": None,
        "max_abs_err": max(errs),
        **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "wrapper_host_ms",
                                "cuda_core_ms", "p", "p_sweep", "shape")},
        "cuda_core_source": KERNEL_SOURCE,
        "verify": vt,
    }
    for what, t in (("chunk", main), ("verify", vt)):
        log(f"[kernel] B2 {what} ({t['shape']}): kernel {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, library (sdpa with a causal "
            f"mask on a gathered view) {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} B, "
            f"{t['flops']} FLOP); the wrapper's host time per call "
            f"{t['wrapper_host_ms']:.4f} ms")
        log_bodies(f"B2 {what}", t)
    return out


# ---------------------------------------------------------------------------
# Phase 3g: the quantized branch of B1/B2 against its plain version
# ---------------------------------------------------------------------------

def quant_case(case, kvd, *, zero_scale_row=True):
    """A wide ``paged_case`` quantized per (row, kv head) block to an int8
    or fp8 pool: (q, k words, v words, tables, lengths, k_scale,
    v_scale).  Rows no table references inside a length (the NULL block
    among them) get NaN scales; their words and each slot's stale tail
    get NaN bytes (0x7f) in an fp8 pool, 127 in an int8 one.  With
    ``zero_scale_row`` the first block of the longest slot has scale 0,
    as a never-written row has: it dequantizes to zeros."""
    import torch
    from repro_torch.serving import kvquant

    q, kp, vp, tables, lens = case
    out = []
    for pool in (kp, vp):
        bad = torch.isnan(pool)
        x = torch.nan_to_num(pool.float())
        s = kvquant.block_scale(x, (1, 3), kvd)
        w = kvquant.quantize(x, s, kvd)
        kvquant.as_bytes(w)[bad] = 0x7F
        s = s[:, 0, :, 0].contiguous()
        s[bad.flatten(1).all(1)] = float("nan")
        if zero_scale_row:
            s[int(tables[int(lens.argmax()), 0])] = 0.0
        out += [w, s]
    kw, ks, vw, vs = out
    return q, kw, vw, tables, lens, ks, vs


def phase_quant_kernel() -> dict:
    """Phase 3g: the quantized branch of B1 and B2 (int8 and fp8 e4m3
    pools, bf16 q) against the plain versions at the main path's shapes —
    B1 at qwen3-8b decode, B2 at the chunk (B=1, Q=64, start 960) and the
    verify window (B=8, Q=5) — and edges (G=1, f32 q, smoke width); each
    output also bitwise equal to the kernel on the same pool dequantized
    to q's dtype (bf16 on the main path) with no scales.  Returns the B1q
    and B2q kernel-line entries: int8's times, fp8's beside them."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import ops

    B, H, KV, D, T = 8, 32, 8, 128, 16
    bf = torch.bfloat16
    r = np.random.default_rng(0)
    lengths = r.integers(1, 2049, B)
    lengths[0], lengths[-1] = 1, 2048

    def held(name, case, kvd, prefill=False):
        err, got = check_case(f"{kvd} {name}", case, "bf16" if case[0].dtype
                              == bf else "f32", prefill=prefill)
        fn = ops.paged_prefill_attention if prefill else ops.paged_attention
        wide = fn(*wide_case(case))
        if not torch.equal(got, wide):
            raise AssertionError(
                f"B{2 if prefill else 1}q {kvd} {name}: differs from the "
                f"kernel on the dequantized pool in "
                f"{int((got != wide).sum())} elements")
        return err

    res = {}
    for kvd in ("int8", "fp8"):
        errs = {"b1": [], "b2": []}
        main = quant_case(paged_case(B, H, KV, D, T, lengths, dtype=bf),
                          kvd)
        errs["b1"].append(held(f"main path B={B} H={H} KV={KV} D={D} T={T} "
                               f"lengths={lengths.tolist()}", main, kvd))
        errs["b1"].append(held("G=1 (H=KV=8)", quant_case(paged_case(
            4, 8, 8, D, T, [5, 17, 300, 64], dtype=bf, seed=3), kvd), kvd))
        held("f32 q", quant_case(paged_case(
            4, H, KV, D, T, [7, 130, 1024, 33], dtype=bf,
            q_dtype=torch.float32, seed=5), kvd), kvd)
        errs["b1"].append(held("smoke width (H=4, KV=2, D=16, T=4)",
                               quant_case(paged_case(
                                   3, 4, 2, 16, 4, [1, 9, 32], dtype=bf,
                                   seed=6), kvd), kvd))
        chunk = quant_case(paged_case(1, H, KV, D, T, [960 + 64], dtype=bf,
                                      q_len=64, seed=13, nb=64), kvd)
        errs["b2"].append(held("chunked prefill B=1 Q=64 start=960", chunk,
                               kvd, prefill=True))
        verify = quant_case(paged_case(8, H, KV, D, T, lengths + 4, dtype=bf,
                                       q_len=5, seed=20), kvd)
        errs["b2"].append(held(f"verify B=8 Q=5 lengths="
                               f"{(lengths + 4).tolist()}", verify, kvd,
                               prefill=True))
        errs["b2"].append(held("G=1 (H=KV=8) Q=7", quant_case(paged_case(
            3, 8, 8, D, T, [7, 40, 300], dtype=bf, q_len=7, seed=21), kvd),
            kvd, prefill=True))
        q, kw, vw, tables, lens, ks, vs = main
        one = ops.paged_prefill_attention(q[:, None].contiguous(), kw, vw,
                                          tables, lens, k_scale=ks,
                                          v_scale=vs)
        if not torch.equal(one[:, 0], paged_call(ops.paged_attention, main)):
            raise AssertionError(f"B2q {kvd} at Q=1 differs from B1q")
        log(f"[kernel] B2q {kvd} at Q=1 bitwise equal to B1q; every case "
            f"bitwise equal to the kernel on its dequantized pool")
        b1 = time_decode(main)
        b2 = time_prefill(chunk)
        b2["verify"] = time_prefill(verify)
        res[kvd] = {"b1": b1, "b2": b2, "b1_err": max(errs["b1"]),
                    "b2_err": max(errs["b2"])}
        for what, t in (("B1q decode", b1), ("B2q chunk", b2),
                        ("B2q verify", b2["verify"])):
            log(f"[kernel] {what} {kvd}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, library (sdpa on a pre-dequantized "
                f"gathered view) {t['library_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} B, "
                f"{t['flops']} FLOP); the wrapper's host time per call "
                f"{t['wrapper_host_ms']:.4f} ms")
            log_bodies(f"{what} {kvd}", t)
        del main, chunk, verify
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "wrapper_host_ms", "cuda_core_ms", "p", "p_sweep")
    out = []
    for name, which, replaces in (
            ("paged_attention_quantized", "b1", BQ_REPLACES),
            ("paged_prefill_attention_quantized", "b2", BQ_REPLACES)):
        t = res["int8"][which]
        entry = {"name": name, "route": "cuda", "source": SPLIT_SOURCE,
                 "cuda_core_source": KERNEL_SOURCE,
                 "replaces": replaces, "launches": None,
                 "max_abs_err": max(res[k][f"{which}_err"] for k in res),
                 **{k: t[k] for k in keys}, "kv_dtype": "int8",
                 "fp8": {k: res["fp8"][which][k] for k in keys}}
        if which == "b2":
            entry["verify"] = {kvd: {k: res[kvd]["b2"]["verify"][k]
                                     for k in keys} for kvd in res}
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# Phase 3c: B3 against its plain version
# ---------------------------------------------------------------------------

def flash_case(B, S, S_kv, H, Hkv, D, *, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(
        dtype)
    return mk(B, S, H, D), mk(B, S_kv, Hkv, D), mk(B, S_kv, Hkv, D)


def check_flash(name, case, causal, kind) -> float:
    """B3 vs its plain version on one case; max |kernel - plain|."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref

    before = dict(ops.flash_attention.body_launches)
    got = ops.flash_attention(*case, causal=causal)
    torch.cuda.synchronize()
    which = ops.body(case[0].dtype)
    if ops.flash_attention.body_launches != {**before,
                                             which: before[which] + 1}:
        raise AssertionError(f"B3 {name} {kind}: body launches "
                             f"{ops.flash_attention.body_launches}, "
                             f"before {before}")
    want = ref.flash_attention_ref(*case, causal=causal).float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"B3 {name}: non-finite output")
    err = (got.float() - want).abs()
    row = want.abs().amax(dim=-1, keepdim=True)
    bad = err > B3_TOL[kind] * row
    if bad.any():
        raise AssertionError(
            f"B3 {name}: {int(bad.sum())} elements beyond {B3_TOL[kind]} "
            f"of their row's largest |plain| (max err {float(err.max())})")
    log(f"[kernel] B3 {name} {kind} ({which} body): max |kernel - plain| = "
        f"{float(err.max()):.3e}, at most {float((err / row).max()):.3e} of "
        f"the row's largest |plain| (tolerance {B3_TOL[kind]})")
    return float(err.max())


def attended_pairs(S, S_kv, causal) -> int:
    """(query row, key) pairs one head attends: rows r < S see keys
    <= r + S_kv - S under a causal mask."""
    if not causal:
        return S * S_kv
    off = S_kv - S
    return sum(min(S_kv, r + off + 1) for r in range(S))


def grad_errors(label: str, function, plain, ins, w, names) -> list:
    """Each input's gradient through ``function`` (a kernel's autograd
    Function) against autograd through ``plain`` on the same inputs, as a
    share of the gradient's largest magnitude; raises beyond 1e-5.  The
    loss weights the first output by ``w`` and sums any others."""
    grads = []
    for fn in (function, plain):
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        ((out[0] * w).sum() + sum(o.sum() for o in out[1:])).backward()
        grads.append([t.grad.detach().clone() for t in ins])
        for t in ins:
            t.grad = None
    errs = []
    for got, want, what in zip(*grads, names):
        e = float((got - want).abs().max() / want.abs().max())
        errs.append(e)
        if not e <= 1e-5:
            raise AssertionError(f"{label}: d{what} off autograd through "
                                 f"the plain version by {e:.3e} of its "
                                 f"scale")
    log(f"[kernel] {label} vs autograd through the plain version, f32: "
        + ", ".join(f"d{n} {e:.3e}" for n, e in zip(names, errs))
        + " of each gradient's scale (tolerance 1e-5)")
    return errs


def phase_flash_kernel() -> dict:
    """Phase 3c: B3 against its plain version at the training shapes and
    edges, in bf16 and f32; the autograd Function's gradients against
    autograd through the plain version; times at smollm-360m's training
    shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref

    log(f"[kernel] B3 checks with torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    main_dims = (8, 4096, 4096, 15, 5, 64)
    cases = [
        ("smollm-360m training shape B=8 S=4096 H=15 Hkv=5 D=64 causal",
         main_dims, True),
        ("qwen3-8b heads B=2 S=2048 H=32 Hkv=8 D=128 causal",
         (2, 2048, 2048, 32, 8, 128), True),
        ("rectangular offset B=4 S=64 S_kv=1024 H=15 Hkv=5 D=64 causal",
         (4, 64, 1024, 15, 5, 64), True),
        ("non-causal B=2 S=1024 H=15 Hkv=5 D=64",
         (2, 1024, 1024, 15, 5, 64), False),
        ("ragged B=2 S=1000 H=32 Hkv=8 D=128 causal",
         (2, 1000, 1000, 32, 8, 128), True),
    ]
    errs = {}
    for i, (name, dims, causal) in enumerate(cases):
        for kind, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            case = flash_case(*dims, dtype=dt, seed=30 + i)
            errs[f"{name} {kind}"] = check_flash(name, case, causal, kind)
            del case
    torch.cuda.empty_cache()

    # The Function's chunked-recompute gradients (q_chunk 1024, as the
    # full-width config runs) against autograd through the plain version
    # in one piece, f32, at the smollm layer shape.
    q, k, v = (t.requires_grad_() for t in flash_case(
        *main_dims, dtype=torch.float32, seed=40))
    w = torch.randn(q.shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(41))
    grad_err = grad_errors(
        "B3 Function gradients (chunks of 1024 query rows, smollm layer "
        "shape)",
        lambda: ops.flash_attention(q, k, v, causal=True, q_chunk=1024),
        lambda: ref.flash_attention_ref(q, k, v, causal=True),
        (q, k, v), w, "qkv")
    del q, k, v, w
    torch.cuda.empty_cache()

    B, S, S_kv, H, Hkv, D = main_dims
    q, k, v = flash_case(*main_dims, dtype=torch.bfloat16, seed=30)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    res = {
        "ms": time_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
        "wrapper_host_ms": host_ms(
            lambda: ops.flash_attention(q, k, v, causal=True), reps=20),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                            causal=True),
                            reps=10),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True)),
    }
    # The f32 CUDA-core body at the same shape, for the record (f32
    # callers only; the main path trains in bf16).
    q32, k32, v32 = (t.float() for t in (q, k, v))
    res["cuda_core_f32_ms"] = time_ms(
        lambda: ops.flash_attention(q32, k32, v32, causal=True), reps=10)
    del q32, k32, v32
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    flops = 4 * B * H * D * attended_pairs(S, S_kv, True)   # QK and PV
    bound_ms, bound_by = bound(nbytes, flops)
    main_key = f"{cases[0][0]} bf16"
    out = {
        "name": "flash_attention",
        "route": "cuda",
        "source": B3_SOURCE,
        "cuda_core_source": B3_F32_SOURCE,
        "replaces": B3_REPLACES,
        "launches": None,
        "max_abs_err": errs[main_key],
        **res,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "shape": cases[0][0] + " bf16",
        "bytes": nbytes,
        "flops": flops,
        "errors": errs,
        "grad_rel_err": grad_err,
    }
    log(f"[kernel] B3 ({out['shape']}, mma body): kernel {res['ms']:.4f} "
        f"ms, plain {res['plain_ms']:.4f} ms, library (sdpa, is_causal, "
        f"enable_gqa) {res['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes} B, {flops} FLOP), "
        f"{bound_ms / res['ms'] * 100:.2f}% of it; the wrapper's host time "
        f"per call {res['wrapper_host_ms']:.4f} ms; the f32 CUDA-core body "
        f"at the same shape in f32 {res['cuda_core_f32_ms']:.4f} ms")
    del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    return out


def phase_flash_widths() -> dict:
    """Phase 3c, head widths (C9): B3 against its plain version at
    head_dim 16 (qwen3-8b smoke), 20 (smollm-360m smoke; 40-byte bf16
    rows, the element copies), 192 (nemotron-4-340b) and 256 (the widest
    instance; 192 and 256 take the mma body's narrower key tile), bf16
    and f32, causal; the Function's gradients at head_dim 20."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref

    errs = {}
    for i, (H, Hkv, D) in enumerate(((4, 2, 16), (3, 1, 20), (8, 2, 192),
                                     (4, 2, 256))):
        name = f"head_dim {D} B=2 S=1000 H={H} Hkv={Hkv} causal"
        for kind, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            case = flash_case(2, 1000, 1000, H, Hkv, D, dtype=dt,
                              seed=50 + i)
            errs[f"{name} {kind}"] = check_flash(name, case, True, kind)
    q, k, v = (t.requires_grad_() for t in flash_case(
        2, 512, 512, 3, 1, 20, dtype=torch.float32, seed=55))
    w = torch.randn(q.shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(56))
    grad_err = grad_errors(
        "B3 Function gradients at head_dim 20 (B=2, S=512, H=3, Hkv=1, "
        "chunks of 128 rows)",
        lambda: ops.flash_attention(q, k, v, causal=True, q_chunk=128),
        lambda: ref.flash_attention_ref(q, k, v, causal=True),
        (q, k, v), w, "qkv")
    torch.cuda.empty_cache()
    return {"errors": errs, "grad_rel_err_head_dim_20": grad_err}


# ---------------------------------------------------------------------------
# Phase 3d: B4 against its plain version
# ---------------------------------------------------------------------------

def wkv_case(B, S, H, N, *, dtype, state: bool, seed: int,
             strong: bool = False):
    """r, k, v (B, S, H, N), the log-decay lw in [-0.35, 0] (the model's
    clamp; in [-0.35, -0.3], its edge, under ``strong``), u (H, N) and an
    f32 state or None."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s, sc=0.5: (torch.randn(s, generator=g, device="cuda")
                             * sc).to(dtype)
    lw = -(torch.rand((B, S, H, N), generator=g, device="cuda")
           * (0.05 if strong else 0.35) + (0.3 if strong else 0.0)).to(dtype)
    s0 = (torch.randn((B, H, N, N), generator=g, device="cuda") * 0.2
          if state else None)
    return (mk(B, S, H, N), mk(B, S, H, N), mk(B, S, H, N), lw,
            mk(H, N, sc=0.1), s0)


def scan_held_to_plain(label: str, got, want, kind: str) -> float:
    """A chunked scan's (y, f32 final state) from its kernel against its
    plain version's, held to WKV_TOL; max |y difference|."""
    import torch

    (y, sf), (wy, ws) = got, want
    if not (torch.isfinite(y).all() and torch.isfinite(sf).all()):
        raise AssertionError(f"{label} {kind}: non-finite output")
    wy = wy.float()
    ey = (y.float() - wy).abs()
    scale = wy.abs().max()
    es = float((sf - ws).abs().max() / ws.abs().max())
    rel_y = float(ey.max() / scale)
    bad_y = ey > WKV_TOL * scale + (2.0 ** -7 * wy.abs() if kind == "bf16"
                                    else 0.0)
    if bad_y.any() or not es <= WKV_TOL:
        raise AssertionError(
            f"{label} {kind}: {int(bad_y.sum())} y elements beyond "
            f"tolerance (max err {float(ey.max())}), state off by {es:.3e} "
            f"of its scale")
    log(f"[kernel] {label} {kind}: max |y kernel - plain| = "
        f"{float(ey.max()):.3e} ({rel_y:.3e} of the largest |y|), state "
        f"{es:.3e} of its largest |S| (tolerance {WKV_TOL} of the scale"
        f"{', plus one bf16 ulp of each y' if kind == 'bf16' else ''})")
    return float(ey.max())


def body_ran(label: str, fn, which: str, before: dict) -> None:
    """The call since ``before`` ran one launch of ``which`` (the body
    its router picked) and none of another."""
    if fn.body_launches != {**before, which: before[which] + 1}:
        raise AssertionError(f"{label}: bodies {fn.body_launches}, before "
                             f"{before}, want one {which}")


def check_wkv(name, case, Q, kind) -> float:
    """B4 vs ``wkv_chunked_ref`` on one case, through the body its router
    picks (asserted and logged); max |y difference|."""
    import torch
    from repro_torch.kernels.rwkv6_wkv import ops, ref

    r, k, v, lw, u, s0 = case
    which = ops.body(r.shape[-1], Q)
    before = dict(ops.wkv.body_launches)
    got = ops.wkv(r, k, v, lw, u, init_state=s0, chunk=Q)
    torch.cuda.synchronize()
    body_ran(f"B4 {name}", ops.wkv, which, before)
    return scan_held_to_plain(
        f"B4 {name}, {which} body", got,
        ref.wkv_chunked_ref(r, k, v, lw, u, init_state=s0, chunk=Q), kind)


def phase_wkv_kernel() -> dict:
    """Phase 3d: B4 against its plain version at rwkv6-3b's training
    shape (B = phase 7's batch, S=4096, H=40, N=64, chunk 128) in bf16
    and f32, with and without a state, and at edges (the smoke width
    N=16 with Q=64, Q=48, N=8, the clamp's edge), each through the body
    its router picks (the chunk body, or the CUDA-core body at Q=48 and
    N=8); the Function's gradients against autograd through the plain
    version; times at the training shape, the CUDA-core body's beside
    the chunk body's."""
    import torch
    from repro_torch.kernels.rwkv6_wkv import kernel, ops, ref

    B = RWKV_BATCH
    main = (B, 4096, 40, 64)
    cases = [
        (f"rwkv6-3b training shape B={B} S=4096 H=40 N=64 Q=128", main, 128,
         False),
        ("smoke width B=4 S=64 H=4 N=16 Q=64", (4, 64, 4, 16), 64, False),
        ("Q=48 B=2 S=96 H=6 N=64", (2, 96, 6, 64), 48, False),
        ("N=8 B=2 S=256 H=8 N=8 Q=128", (2, 256, 8, 8), 128, False),
        ("lw at the clamp's edge [-0.35, -0.3] B=2 S=1024 H=8 N=64 Q=128",
         (2, 1024, 8, 64), 128, True),
    ]
    errs = {}
    for i, (name, dims, Q, strong) in enumerate(cases):
        for kind, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            for state in (False, True):
                case = wkv_case(*dims, dtype=dt, state=state, seed=60 + i,
                                strong=strong)
                label = f"{name}{' s0' if state else ''}"
                errs[f"{label} {kind}"] = check_wkv(label, case, Q, kind)
                del case
    torch.cuda.empty_cache()

    # The Function: kernel forward, gradients recomputed through the
    # plain version; against autograd through the plain version.
    ins = [t.requires_grad_() for t in wkv_case(
        2, 512, 8, 64, dtype=torch.float32, state=True, seed=70)]
    w = torch.randn(ins[0].shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(71))
    grad_err = grad_errors(
        "B4 Function gradients (B=2, S=512, H=8, N=64, s0)",
        lambda: ops.wkv(*ins[:5], init_state=ins[5], chunk=128),
        lambda: ref.wkv_chunked_ref(*ins[:5], init_state=ins[5], chunk=128),
        ins, w, ("r", "k", "v", "lw", "u", "s0"))
    del ins, w
    torch.cuda.empty_cache()

    Bm, S, H, N = main
    r, k, v, lw, u, _ = wkv_case(*main, dtype=torch.bfloat16, state=False,
                                 seed=60)
    y_, sf_ = torch.empty_like(r), torch.empty((Bm, H, N, N), device="cuda")
    res = {
        "ms": time_ms(lambda: ops.wkv(r, k, v, lw, u, chunk=128)),
        "cuda_core_ms": time_ms(lambda: kernel.launch(
            r, k, v, lw, u, None, y_, sf_, chunk=128, body="cuda_core")),
        "wrapper_host_ms": host_ms(lambda: ops.wkv(r, k, v, lw, u,
                                                   chunk=128), reps=20),
        "plain_ms": time_ms(lambda: ref.wkv_chunked_ref(r, k, v, lw, u,
                                                        chunk=128), reps=10),
        "library_ms": None,
    }
    # Forward and backward of the Function at the same shape: its
    # backward recomputes through the plain version in f32 under
    # autograd, once per layer a training step.
    ins = [t.requires_grad_() for t in (r, k, v, lw, u)]
    gy = torch.randn_like(r)
    res["function_fwd_bwd_ms"] = time_ms(
        lambda: torch.autograd.grad(ops.wkv(*ins, chunk=128)[0], ins, gy),
        reps=5, warmup=1)
    del ins, gy
    del y_, sf_
    # Bytes: r, k, v, lw read once and y written once (u and the state
    # are 1e-4 of that).  Operations of the chunked form, per (b, h,
    # chunk): the chunk's state kj^T v and the entering state's read ri S
    # (Q N^2 FMA each), A = ri kj^T below the diagonal (Q (Q - 1) / 2
    # entries of N FMA; the diagonal is the bonus term) and A v over the
    # causal triangle (Q (Q + 1) / 2 N FMA).  At f32's accuracy a product
    # of two f32 operands (ri, kj, the state) takes 3xTF32's three
    # tensor-core passes, one with v (bf16 here, exact in TF32) two.
    # bound_bf16_ms is the bound of earlier PRs, the same operations at
    # the bf16 peak.
    nbytes = sum(t.numel() * t.element_size() for t in (r, k, v, lw, r))
    Q = 128
    per = Bm * H * (S // Q)
    fma_qnn = Q * N * N               # kj^T v, and ri S
    fma_a = Q * (Q - 1) // 2 * N      # A below the diagonal
    fma_av = Q * (Q + 1) // 2 * N     # A v
    flops = 2 * per * (2 * fma_qnn + fma_a + fma_av)
    tf32_flops = 2 * per * (2 * fma_qnn + 3 * fma_qnn + 3 * fma_a
                            + 2 * fma_av)
    bound_ms, bound_by = bound(nbytes, 0, tf32_flops=tf32_flops)
    bound_bf16_ms = bound(nbytes, flops)[0]
    main_key = f"{cases[0][0]} bf16"
    out = {
        "name": "rwkv6_wkv",
        "route": "cuda",
        "source": B4_SOURCE,
        "cuda_core_source": B4_CORE_SOURCE,
        "replaces": B4_REPLACES,
        "launches": None,
        "max_abs_err": errs[main_key],
        **res,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_bf16_ms": bound_bf16_ms,
        "shape": main_key,
        "bytes": nbytes,
        "flops": flops,
        "errors": errs,
        "grad_rel_err": grad_err,
    }
    log(f"[kernel] B4 ({out['shape']}): kernel (chunk_tf32x3 body) "
        f"{res['ms']:.4f} ms, CUDA-core body {res['cuda_core_ms']:.4f} ms, "
        f"plain {res['plain_ms']:.4f} ms, library: none (no PyTorch call "
        f"computes the WKV recurrence), bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes} B, {flops} FLOP as {tf32_flops} of "
        f"TF32 passes; "
        f"{bound_bf16_ms:.4f} ms at the bf16 peak); the wrapper's host time "
        f"per call {res['wrapper_host_ms']:.4f} ms; the Function's forward "
        f"and backward (recomputed through the plain version) "
        f"{res['function_fwd_bwd_ms']:.4f} ms")
    del r, k, v, lw, u
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 3e: B5 against its plain version
# ---------------------------------------------------------------------------

def ssd_case(B, S, H, P, N, *, dtype, state: bool, seed: int,
             strong: bool = False):
    """x (B, S, H, P), dt (B, S, H) after softplus (4 dt + 1 under
    ``strong``), A (H,) negative, Bs, Cs (B, S, N) and an f32 state or
    None, as the model makes them."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: (torch.randn(s, generator=g, device="cuda")
                     * 0.5).to(dtype)
    dt = F.softplus(torch.randn((B, S, H), generator=g, device="cuda"))
    if strong:
        dt = 4 * dt + 1
    A = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.3)
    s0 = (torch.randn((B, H, P, N), generator=g, device="cuda") * 0.2
          if state else None)
    return (mk(B, S, H, P), dt.to(dtype), A.to(dtype), mk(B, S, N),
            mk(B, S, N), s0)


def check_ssd(name, case, Q, kind) -> float:
    """B5 vs ``ssd_chunked_ref`` on one case, through the body its router
    picks (asserted and logged); max |y difference|."""
    import torch
    from repro_torch.kernels.mamba2_ssd import ops, ref

    *ins, s0 = case
    which = ops.body(ins[0].shape[-1], ins[3].shape[-1], Q)
    before = dict(ops.ssd.body_launches)
    got = ops.ssd(*ins, init_state=s0, chunk=Q)
    torch.cuda.synchronize()
    body_ran(f"B5 {name}", ops.ssd, which, before)
    return scan_held_to_plain(
        f"B5 {name}, {which} body", got,
        ref.ssd_chunked_ref(*ins, init_state=s0, chunk=Q), kind)


def phase_ssd_kernel() -> dict:
    """Phase 3e: B5 against its plain version at mamba2-2.7b's training
    shape (B = phase 8's batch, S=4096, H=80, P=64, N=128, chunk 256) in
    bf16 and f32, with and without a state, and at edges (the smoke
    width with chunk 128, P=8 N=8 with chunk 8 and S=40, a strong
    decay), each through the body its router picks (the chunk body, or
    the CUDA-core body at P=8 N=8); the Function's gradients against
    autograd through the plain version; times at the training shape, the
    CUDA-core body's beside the chunk body's."""
    import torch
    from repro_torch.kernels.mamba2_ssd import kernel, ops, ref

    B = MAMBA_BATCH
    main = (B, 4096, 80, 64, 128)
    cases = [
        (f"mamba2-2.7b training shape B={B} S=4096 H=80 P=64 N=128 Q=256",
         main, 256, False),
        ("smoke width B=8 S=128 H=4 P=32 N=16 Q=128", (8, 128, 4, 32, 16),
         128, False),
        ("P=8 N=8 B=2 S=40 H=2 Q=8", (2, 40, 2, 8, 8), 8, False),
        ("strong decay (4 dt + 1) B=2 S=1024 H=8 P=64 N=128 Q=256",
         (2, 1024, 8, 64, 128), 256, True),
    ]
    errs = {}
    for i, (name, dims, Q, strong) in enumerate(cases):
        for kind, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            for state in (False, True):
                case = ssd_case(*dims, dtype=dt, state=state, seed=80 + i,
                                strong=strong)
                if strong and not state and kind == "f32":
                    cum = torch.cumsum((case[1] * case[2]).reshape(
                        dims[0], -1, Q, dims[2]), dim=2)
                    log(f"[kernel] B5 {name}: the cumsum of dt A reaches "
                        f"{float(cum.min()):.1f} inside a chunk")
                    if not cum.min() < -100:
                        raise AssertionError("the strong decay is not strong")
                label = f"{name}{' s0' if state else ''}"
                errs[f"{label} {kind}"] = check_ssd(label, case, Q, kind)
                del case
    torch.cuda.empty_cache()

    # The Function: kernel forward, gradients recomputed through the
    # plain version; against autograd through the plain version.
    ins = [t.requires_grad_() for t in ssd_case(
        2, 512, 8, 64, 128, dtype=torch.float32, state=True, seed=90)]
    w = torch.randn(ins[0].shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(91))
    grad_err = grad_errors(
        "B5 Function gradients (B=2, S=512, H=8, P=64, N=128, s0)",
        lambda: ops.ssd(*ins[:5], init_state=ins[5], chunk=256),
        lambda: ref.ssd_chunked_ref(*ins[:5], init_state=ins[5], chunk=256),
        ins, w, ("x", "dt", "A", "Bs", "Cs", "s0"))
    del ins, w
    torch.cuda.empty_cache()

    Bm, S, H, P, N = main
    Q = 256
    x, dt, A, Bs, Cs, _ = ssd_case(*main, dtype=torch.bfloat16, state=False,
                                   seed=80)
    y_, sf_ = torch.empty_like(x), torch.empty((Bm, H, P, N), device="cuda")
    res = {
        "ms": time_ms(lambda: ops.ssd(x, dt, A, Bs, Cs, chunk=Q)),
        "cuda_core_ms": time_ms(lambda: kernel.launch(
            x, dt, A, Bs, Cs, None, y_, sf_, chunk=Q, body="cuda_core")),
        "wrapper_host_ms": host_ms(lambda: ops.ssd(x, dt, A, Bs, Cs,
                                                   chunk=Q), reps=20),
        "plain_ms": time_ms(lambda: ref.ssd_chunked_ref(x, dt, A, Bs, Cs,
                                                        chunk=Q), reps=10),
        "library_ms": None,
    }
    # Forward and backward of the Function at the same shape: its
    # backward recomputes through the plain version in f32 under
    # autograd, once per layer a training step.
    ins = [t.requires_grad_() for t in (x, dt, A, Bs, Cs)]
    gy = torch.randn_like(x)
    res["function_fwd_bwd_ms"] = time_ms(
        lambda: torch.autograd.grad(ops.ssd(*ins, chunk=Q)[0], ins, gy),
        reps=5, warmup=1)
    del ins, gy
    del y_, sf_
    # Bytes: x, dt, Bs, Cs read once, y and the f32 final state written
    # once (A is 160 B).  Operations of the chunked form at the model's
    # chunk: per (b, chunk) C B^T over the causal triangle (Q (Q + 1) / 2
    # N FMA), and per head the triangle's product M x (Q (Q + 1) / 2 P
    # FMA), the read of the entering state C S^T and the state's update
    # (Q N P FMA each).  C B^T of bf16 operands is exact in one bf16
    # pass; every per-head product has one f32 operand (M, the state,
    # x dt exp(...)) and one bf16 operand (x, C, B: exact in TF32), so at
    # f32's accuracy each takes two of 3xTF32's tensor-core passes.
    # bound_bf16_ms is the bound of earlier PRs, every operation at the
    # bf16 peak.
    nbytes = (sum(t.numel() * t.element_size()
                  for t in (x, dt, A, Bs, Cs, x)) + Bm * H * P * N * 4)
    tri = Q * (Q + 1) // 2
    cb_flops = 2 * Bm * (S // Q) * tri * N
    head_flops = 2 * Bm * (S // Q) * H * (tri * P + 2 * Q * N * P)
    flops = cb_flops + head_flops
    bound_ms, bound_by = bound(nbytes, cb_flops, tf32_flops=2 * head_flops)
    bound_bf16_ms = bound(nbytes, flops)[0]
    main_key = f"{cases[0][0]} bf16"
    out = {
        "name": "mamba2_ssd",
        "route": "cuda",
        "source": B5_SOURCE,
        "cuda_core_source": B5_CORE_SOURCE,
        "replaces": B5_REPLACES,
        "launches": None,
        "max_abs_err": errs[main_key],
        **res,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_bf16_ms": bound_bf16_ms,
        "shape": main_key,
        "bytes": nbytes,
        "flops": flops,
        "errors": errs,
        "grad_rel_err": grad_err,
    }
    log(f"[kernel] B5 ({out['shape']}): kernel (chunk_tf32x3 body) "
        f"{res['ms']:.4f} ms, CUDA-core body {res['cuda_core_ms']:.4f} ms, "
        f"plain {res['plain_ms']:.4f} ms, library: none (no PyTorch call "
        f"computes the SSD scan), bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes} B, {head_flops} FLOP in two TF32 passes and {cb_flops} "
        f"at the bf16 peak; {bound_bf16_ms:.4f} ms all at the bf16 peak); the "
        f"wrapper's host time per call "
        f"{res['wrapper_host_ms']:.4f} ms; the Function's forward and "
        f"backward (recomputed through the plain version) "
        f"{res['function_fwd_bwd_ms']:.4f} ms")
    del x, dt, A, Bs, Cs
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 3f: B6 and B7 against their plain versions, rung by rung
# ---------------------------------------------------------------------------

def matmul_case(M, K, N, *, seed):
    """f32 a (M, K), b (K, N) on the card from a numpy generator."""
    import numpy as np
    import torch

    r = np.random.default_rng(seed)
    return (torch.tensor(r.standard_normal((M, K)).astype(np.float32),
                         device="cuda"),
            torch.tensor(r.standard_normal((K, N)).astype(np.float32),
                         device="cuda"))


def rung_call(level: int, a, b, blocks=None):
    """The kernel call ``ops.matmul(a, b, level)`` makes, on operands
    already cast as the rung casts them, with its plain version, one
    PyTorch library call computing the same product (``torch.matmul``:
    f32 with TF32 off, or bf16 at O5), the operands and the blocks."""
    import torch
    from repro_torch.kernels.tiled_matmul import ops, ref

    if level == 0:
        return (lambda: ops.matmul_whole(a, b),
                lambda: ref.matmul_ref(a, b),
                lambda: torch.matmul(a, b), (a, b), None)
    args = ops.rung(level, a.shape[0], b.shape[1], a.shape[1],
                    blocks=blocks)
    dtype = args.pop("dtype")
    ac, bc = a.to(dtype), b.to(dtype)
    return (lambda: ops.matmul_tiled(ac, bc, **args),
            lambda: ref.matmul_tiled_ref(ac, bc, bk=args["bk"]),
            lambda: torch.matmul(ac, bc), (ac, bc),
            {k: args[k] for k in ("bm", "bn", "bk", "parallel_mn",
                                  "double_buffer")})


def rung_body(level: int, ac, bc, blk) -> str:
    """The kernel a rung's call runs: B7 at O0, else B6's body as
    ``ops.body`` routes it."""
    from repro_torch.kernels.tiled_matmul import ops

    if level == 0:
        return "B7"
    return ops.body(ac.dtype, ac.shape[0], bc.shape[1], ac.shape[1],
                    blk["bm"], blk["bn"], blk["bk"],
                    parallel_mn=blk["parallel_mn"],
                    double_buffer=blk["double_buffer"])


def cuda_core_at(ac, bc, blk):
    """A launch of B6's CUDA-core body at a rung's blocks, grid and
    stages, straight through the binding (not the router, not counted):
    the body a tensor-core rung ran before it took the tensor cores."""
    import torch
    from repro_torch.kernels.tiled_matmul import kernel

    M, N = ac.shape[0], bc.shape[1]
    c = torch.empty((M, N), dtype=torch.float32, device="cuda")
    grid = (M // blk["bm"]) * (N // blk["bn"]) if blk["parallel_mn"] else 1
    return c, lambda: kernel.launch_tiled(
        ac, bc, c, bm=blk["bm"], bn=blk["bn"], bk=blk["bk"], grid=grid,
        stages=2 if blk["double_buffer"] else 1)


def check_matmul(name: str, level: int, a, b, blocks=None) -> dict:
    """One rung on the card against its plain version (MATMUL_TOL); the
    B6 body that ran is read from its launch counters."""
    import torch
    from repro_torch.kernels.tiled_matmul import ops

    kern, plain, _, (ac, bc), blk = rung_call(level, a, b, blocks)
    which = rung_body(level, ac, bc, blk)
    before = dict(ops.matmul_tiled.body_launches)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if level and ops.matmul_tiled.body_launches != {
            **before, which: before[which] + 1}:
        raise AssertionError(f"{name} O{level}: B6 body launches "
                             f"{ops.matmul_tiled.body_launches}, before "
                             f"{before}, want one {which}")
    if got.dtype != torch.float32 or got.shape != want.shape:
        raise AssertionError(f"{name} O{level}: {got.dtype} "
                             f"{tuple(got.shape)}")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= MATMUL_TOL * scale:
        raise AssertionError(f"[kernel] B{7 if level == 0 else 6} {name} "
                             f"O{level}: max |kernel - plain| {err:.3e} > "
                             f"{MATMUL_TOL} * {scale:.3e}")
    return {"max_abs_err": err, "rel_err": err / scale, "blocks": blk,
            "body": which}


def time_rung(level: int, a, b) -> dict:
    """Device times of one rung's kernel, plain version and library call,
    the wrapper's host time, and the bound (bytes: operands as the
    kernel reads them once and the f32 output written once; operations:
    2 M N K at the bf16 peak at O5, and for the f32 rungs 3 x 2 M N K at
    the TF32 peak, 3xTF32's three tensor-core products, the least time
    the card needs for the same f32 work); where the rung runs a
    tensor-core body of B6 (wgmma, tf32x3), also the CUDA-core body's
    time at its blocks, grid and stages."""
    kern, plain, lib, (ac, bc), blk = rung_call(level, a, b)
    which = rung_body(level, ac, bc, blk)
    slow = level in SLOW_RUNGS
    reps, warm = (2, 1) if slow else (30, 3)
    M, K = ac.shape
    N = bc.shape[1]
    nbytes = (ac.numel() * ac.element_size() + bc.numel() * bc.element_size()
              + M * N * 4)
    flops = 2 * M * N * K
    bound_ms, bound_by = (bound(nbytes, flops) if level >= 5 else
                          bound(nbytes, 3 * flops, TF32_FLOPS))
    out = {"ms": time_ms(kern, reps=reps, warmup=warm),
           "plain_ms": time_ms(plain, reps=5 if slow else 10, warmup=1),
           "library_ms": time_ms(lib, reps=10, warmup=2),
           "wrapper_host_ms": host_ms(kern, reps=3 if slow else 200),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "flops": flops, "blocks": blk, "body": which}
    if which in ("wgmma", "tf32x3"):
        c, core = cuda_core_at(ac, bc, blk)
        out["cuda_core_ms"] = time_ms(core, reps=10)
        want = plain()
        err = float((c - want).abs().max())
        if not err <= MATMUL_TOL * float(want.abs().max()):
            raise AssertionError(f"O{level} CUDA-core body at the {which} "
                                 f"blocks off its plain version by {err}")
    return out


def phase_matmul_kernel() -> tuple:
    """Phase 3f: B7 (O0) and B6 (O1..O5) against their plain versions at
    MachSuite's 1024^3, O3..O5 at 4096^3, and at edges: the four shapes
    of the reference's tests at every rung, odd divisor blocks (105^3,
    whose rows copy 4 B at a time in f32 and element by element in
    bf16; explicit (35, 21, 15) and (105, 7, 105)), K whole at O1, a
    256-wide tile walked in two sub-tiles, bf16 operands at O0, and O1
    stripes that cannot fit (must raise).  Times of every rung at 1024^3
    and of O3..O5 at 4096^3.  Returns the B6 and B7 entries of the
    kernels line."""
    import torch
    from repro_torch.kernels.tiled_matmul import ops

    log(f"[kernel] B6/B7 checks with torch.backends.cuda.matmul.allow_tf32"
        f" = {torch.backends.cuda.matmul.allow_tf32} (the library's f32 "
        f"yardstick runs without TF32)")
    errs = {}
    n = LADDER_N
    a, b = matmul_case(n, n, n, seed=60)
    for level in range(6):
        errs[f"{n}^3 O{level}"] = check_matmul(f"{n}^3", level, a, b)
    big = matmul_case(LADDER_BIG, LADDER_BIG, LADDER_BIG, seed=61)
    for level in (3, 4, 5):
        errs[f"{LADDER_BIG}^3 O{level}"] = check_matmul(
            f"{LADDER_BIG}^3", level, *big)
    edges = [(32, 32, 32), (64, 96, 128), (128, 64, 32), (48, 80, 112),
             (105, 105, 105), (256, 16, 256), (33, 35, 37)]
    for i, (M, K, N) in enumerate(edges):
        ea, eb = matmul_case(M, K, N, seed=62 + i)
        for level in range(6):
            errs[f"{M}x{K}x{N} O{level}"] = check_matmul(
                f"M={M} K={K} N={N}", level, ea, eb)
    ea, eb = matmul_case(105, 105, 105, seed=70)
    for blocks in ((35, 21, 15), (105, 7, 105)):
        for level in (1, 2, 3, 4, 5):
            errs[f"105^3 blocks {blocks} O{level}"] = check_matmul(
                f"105^3 blocks {blocks}", level, ea, eb, blocks)
    a16, b16 = a[:256, :512].bfloat16(), b[:512, :128].bfloat16()
    errs["bf16 as given O0"] = check_matmul("bf16 operands", 0, a16, b16)
    wide = torch.ones(16, 32768, device="cuda")
    try:
        ops.matmul(wide, wide.t(), 1)
    except ValueError as e:
        log(f"[kernel] B6 O1 at K = 32768 refused as it must: {e}")
    else:
        raise AssertionError("O1 with stripes over the budget did not raise")
    del wide
    worst = max(errs.values(), key=lambda r: r["rel_err"])
    log(f"[kernel] B6/B7: {len(errs)} cases within {MATMUL_TOL} of max "
        f"|plain|; worst {worst['rel_err']:.3e} "
        f"({max(errs, key=lambda k: errs[k]['rel_err'])})")
    for body in ("wgmma", "tf32x3", "cuda_core", "B7"):
        keys = [k for k, r in errs.items() if r["body"] == body]
        if not keys:
            continue
        w = max(keys, key=lambda k: errs[k]["rel_err"])
        log(f"[kernel] B6/B7 {body}: {len(keys)} cases, worst "
            f"{errs[w]['rel_err']:.3e} of max |plain| ({w}); cases: "
            + ", ".join(keys))
    for key, want in ((f"{n}^3 O5", "wgmma"), (f"{LADDER_BIG}^3 O5", "wgmma"),
                      (f"{n}^3 O3", "tf32x3"), (f"{n}^3 O4", "tf32x3"),
                      (f"{LADDER_BIG}^3 O3", "tf32x3"),
                      (f"{LADDER_BIG}^3 O4", "tf32x3"),
                      (f"{n}^3 O1", "cuda_core"), (f"{n}^3 O2", "cuda_core")):
        if errs[key]["body"] != want:
            raise AssertionError(f"{key} ran B6's {errs[key]['body']} body, "
                                 f"not the {want} body")

    rungs = {}
    for level in range(6):
        rungs[f"O{level} {n}^3"] = time_rung(level, a, b)
    for level in (3, 4, 5):
        rungs[f"O{level} {LADDER_BIG}^3"] = time_rung(level, *big)
    for key, r in rungs.items():
        old = (f" (the CUDA-core body at these blocks {r['cuda_core_ms']:.4f}"
               f" ms)" if "cuda_core_ms" in r else "")
        log(f"[kernel] B{7 if key.startswith('O0') else 6} {key} blocks "
            f"{r['blocks']}, {r['body']} body: kernel {r['ms']:.4f} ms{old}, "
            f"plain {r['plain_ms']:.4f} ms, torch.matmul {r['library_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['bound_ms'] / r['ms'] * 100:.2f}% of it; the wrapper's "
            f"host time per call {r['wrapper_host_ms']:.4f} ms")
    del a, b, big
    torch.cuda.empty_cache()

    def entry(name, replaces, key, err_keys, source):
        r = rungs[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": None,
                "max_abs_err": max(errs[k]["max_abs_err"] for k in err_keys),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "wrapper_host_ms": r["wrapper_host_ms"], "shape": key,
                "blocks": r["blocks"]}

    main_keys = [k for k in errs if k.startswith(("1024^3", "4096^3"))]
    b6 = entry("tiled_matmul", B6_REPLACES, f"O5 {n}^3",
               [k for k in main_keys if not k.endswith("O0")],
               B6_WGMMA_SOURCE)
    b6["cuda_core_source"] = B6_SOURCE
    b6["tf32x3_source"] = B6_TF32X3_SOURCE
    b6["rungs"] = {k: v for k, v in rungs.items() if not k.startswith("O0")}
    b6["errors"] = {k: v for k, v in errs.items() if not k.endswith("O0")}
    b7 = entry("matmul_whole", B7_REPLACES, f"O0 {n}^3", [f"{n}^3 O0"],
               B6_SOURCE)
    b7["errors"] = {k: v for k, v in errs.items() if k.endswith("O0")}
    return b6, b7


# ---------------------------------------------------------------------------
# Phase 4: the ladder at smoke width
# ---------------------------------------------------------------------------

def drive(engine, mix, *, eos=None, late_from=None):
    """Submit ``mix`` ((prompt, max_new) pairs), the tail after two ticks;
    run to the end; tokens in submission order."""
    from repro_torch.serving import Request

    eos = eos or {}
    head = mix if late_from is None else mix[:late_from]
    rids = [engine.submit(Request(prompt=list(p), max_new_tokens=n,
                                  eos_id=eos.get(k)))
            for k, (p, n) in enumerate(head)]
    if late_from is not None:
        for _ in range(2):
            engine.step()
        rids += [engine.submit(Request(prompt=list(p), max_new_tokens=n,
                                       eos_id=eos.get(late_from + k)))
                 for k, (p, n) in enumerate(mix[late_from:])]
    fin = {r.rid: r.generated for r in engine.run()}
    return [fin[rid] for rid in rids]


def phase_ladder(device="cuda") -> dict:
    """Smoke-width qwen3-8b on the card: every rung, chunked prefill on
    O5 / O6-gather / O6-kernel with chunks 3 and 8, and O7 with the
    smollm-360m smoke drafter (K = 2, 4; gather and kernel verify), all
    with the O5 greedy tokens; a self-draft run that must accept every
    draft; prefill -> insert -> generate on O5, O6-gather and O6-kernel
    with chunks and on O0, each with the prestaged run's tokens; and
    ``compact()`` after every tick on O6-kernel."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core.optlevel import BestEffortConfig, OptLevel
    from repro_torch.models import get_model
    from repro_torch.serving import DecodeEngine, Request

    cfg = get_smoke("qwen3-8b")
    model = get_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(1)
    mix = [(rng.integers(1, cfg.vocab, int(rng.integers(1, 12))).tolist(),
            int(rng.integers(1, 8))) for _ in range(10)]
    pool = dict(kv_block_size=4, kv_pool_blocks=20)
    rungs = {
        "O5": dict(level=OptLevel.O5),
        "O0": dict(level=OptLevel.O0),
        "O1": dict(level=OptLevel.O1),
        "O2": dict(level=OptLevel.O2),
        "O4": dict(level=OptLevel.O4),
        "O6-gather": dict(level=OptLevel.O6, **pool),
        "O6-kernel": dict(level=OptLevel.O6, paged_attn="kernel", **pool),
    }
    for chunk in (3, 8):
        rungs[f"O5 chunk {chunk}"] = dict(level=OptLevel.O5,
                                          prefill_chunk=chunk)
        rungs[f"O6-gather chunk {chunk}"] = dict(level=OptLevel.O6,
                                                 prefill_chunk=chunk, **pool)
        rungs[f"O6-kernel chunk {chunk}"] = dict(
            level=OptLevel.O6, paged_attn="kernel", prefill_chunk=chunk,
            **pool)
    for k in (2, 4):
        for attn in ("gather", "kernel"):
            rungs[f"O7-{attn} K={k}"] = dict(
                level=OptLevel.O7, paged_attn=attn, draft_k=k,
                draft_model="smollm-360m", **pool)

    def run(rung, **kw):
        eng = DecodeEngine(model, params, batch_size=4, max_seq=32,
                           config=BestEffortConfig(**rungs[rung]))
        return eng, drive(eng, mix, **kw)

    first = run("O5")[1]
    eos = {k: g[len(g) // 2] for k, g in enumerate(first)
           if k % 2 == 0 and len(g) > 1}
    ref = run("O5", eos=eos, late_from=6)[1]
    spec = {}
    for rung in rungs:
        eng, got = run(rung, eos=eos, late_from=6)
        if got != ref:
            raise AssertionError(f"ladder: {rung} tokens {got} != O5 {ref}")
        what = ""
        if "chunk" in rung and eng.prefill_mode != "chunked":
            raise AssertionError(f"ladder: {rung} ran {eng.prefill_mode}")
        if rung.startswith("O7"):
            if eng.spec_mode != "draft":
                raise AssertionError(f"ladder: {rung} ran spec "
                                     f"{eng.spec_mode}")
            spec[rung] = eng.spec_stats
            what = (f" (accept_rate {spec[rung]['accept_rate']:.3f}, "
                    f"{spec[rung]['drafted']} drafted)")
        log(f"[ladder] {rung}: {sum(map(len, got))} tokens identical to "
            f"O5{what}")

    for attn in ("gather", "kernel"):
        eng = DecodeEngine(model, params, batch_size=4, max_seq=32,
                           config=BestEffortConfig(
                               level=OptLevel.O7, paged_attn=attn,
                               draft_k=4, **pool),
                           draft_model=model, draft_params=params)
        got = drive(eng, mix, eos=eos, late_from=6)
        st = eng.spec_stats
        if got != ref or st["accept_rate"] != 1.0:
            raise AssertionError(f"ladder: O7-{attn} self-draft: accept_rate "
                                 f"{st['accept_rate']}, tokens equal to O5: "
                                 f"{got == ref}")
        spec[f"O7-{attn} self-draft K=4"] = st
        log(f"[ladder] O7-{attn} self-draft K=4: accept_rate 1.0, "
            f"{st['eff_tok_per_step']:.2f} tokens per window, tokens "
            f"identical to O5")

    # prefill -> insert -> generate: the first four requests prefilled
    # on standalone batch-1 caches, inserted, drained — the tokens of
    # submitting them (first[:4], the prestaged O5 run).
    sub = mix[:4]
    inserted = {}
    for name in ("O5 chunk 8", "O6-gather chunk 8", "O6-kernel chunk 8",
                 "O0"):
        eng = DecodeEngine(model, params, batch_size=4, max_seq=32,
                           config=BestEffortConfig(**rungs[name]))
        results = [eng.prefill(p, max_new_tokens=n) for p, n in sub]
        for r in results:
            eng.insert(r)
        fin = {r.rid: r.generated for r in eng.generate()}
        got = [fin[r.request.rid] for r in results]
        firsts = [r.first_token for r in results]
        if got != first[:4] or firsts != [g[0] for g in first[:4]]:
            raise AssertionError(f"ladder: prefill->insert->generate on "
                                 f"{name}: {got} != prestaged {first[:4]}")
        inserted[name] = sum(map(len, got))
        log(f"[ladder] prefill->insert->generate {name}: "
            f"{inserted[name]} tokens identical to the prestaged run")

    # compact() after every tick on O6-kernel: live blocks move to the
    # lowest ids, every block accounted for, tokens unchanged.
    eng = DecodeEngine(model, params, batch_size=4, max_seq=32,
                       config=BestEffortConfig(**rungs["O6-kernel"]))
    rids = [eng.submit(Request(prompt=list(p), max_new_tokens=n))
            for p, n in mix]
    moved = 0
    while eng.step() or eng.queue:
        before = eng.cache_mgr.tables.copy()
        eng.cache_mgr.compact()
        eng.cache_mgr.check_conservation()
        moved += int((before != eng.cache_mgr.tables).sum())
    fin = {r.rid: r.generated for r in eng.finished}
    if [fin[rid] for rid in rids] != first or not moved:
        raise AssertionError(f"ladder: compact on O6-kernel moved {moved} "
                             f"table entries; tokens equal to O5: "
                             f"{[fin[rid] for rid in rids] == first}")
    log(f"[ladder] O6-kernel compact() after every tick: {moved} table "
        f"entries moved, blocks conserved, tokens identical to O5")
    return {"requests": len(mix), "tokens": sum(map(len, ref)),
            "rungs": list(rungs), "spec": spec, "inserted": inserted,
            "compact_moved": moved}


# ---------------------------------------------------------------------------
# Phase 5: qwen3-8b at full width
# ---------------------------------------------------------------------------

def teacher_forced(model, params, *, B=8, max_seq=1024, T=16, ticks=8,
                   seed=0) -> dict:
    """The gather step, the kernel step and the kernel step with the
    kernel's plain version in its place, fed the same tokens over the
    same random KV prefix (a different length per slot); logits compared
    every tick.  The plain-version step measures how far two
    implementations that differ only in reduction order drift apart
    through this stack, which is what the kernel step is judged by."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.models import attention
    from repro_torch.serving import Request
    from repro_torch.serving.paged import PagedCacheManager

    cfg = model.cfg
    dev = model.device
    r = np.random.default_rng(seed)
    prefix = r.integers(1, max_seq - ticks, B)
    gather, kern, plain = mgrs = [
        PagedCacheManager(model, B, max_seq, block_size=T) for _ in range(3)]
    for mgr in mgrs:
        for b in range(B):
            mgr.admit_slot(b, Request(prompt=[1] * int(prefix[b]),
                                      max_new_tokens=ticks))
    assert all((m.tables == gather.tables).all() for m in mgrs)
    g = torch.Generator(device=dev).manual_seed(seed)
    for b in range(B):
        for j in range(-(-int(prefix[b]) // T)):
            row = int(gather.tables[b, j])
            for name in ("k", "v"):
                blk = torch.randn(gather.cache[name][:, row].shape,
                                  generator=g, device=dev)
                for mgr in mgrs:
                    mgr.cache[name][:, row] = blk.to(torch.bfloat16)
    (tables,) = gather.step_extras()
    rel = {"kernel_vs_gather": 0.0, "plain_vs_gather": 0.0,
           "kernel_vs_plain": 0.0}
    agree = 0
    for t in range(ticks):
        toks = torch.tensor(r.integers(1, cfg.vocab, (B, 1)), device=dev)
        pos = torch.tensor(prefix + t, device=dev)
        dense = gather.plan.gather(gather.cache, tables)
        lg, dense = model.decode_step(params, dense, toks, pos)
        gather.plan.scatter(gather.cache, tables, dense, pos)
        del dense
        lk, _ = model.paged_decode_step(params, kern.cache, tables, toks, pos)
        kernel_fn = attention.paged_attention
        attention.paged_attention = ref.paged_attention_ref
        try:
            lp, _ = model.paged_decode_step(params, plain.cache, tables, toks,
                                            pos)
        finally:
            attention.paged_attention = kernel_fn
        if not all(torch.isfinite(x).all() for x in (lg, lk, lp)):
            raise AssertionError("full width: non-finite logits")
        for key, (a, b) in {"kernel_vs_gather": (lk, lg),
                            "plain_vs_gather": (lp, lg),
                            "kernel_vs_plain": (lk, lp)}.items():
            rel[key] = max(rel[key],
                           float((a - b).abs().max() / b.abs().max()))
        agree += int((lk.argmax(-1) == lg.argmax(-1)).sum())
    return {"layers": cfg.n_layers, "ticks": ticks, "batch": B,
            "prefix": prefix.tolist(), "max_rel_logit_diff": rel,
            "argmax_agree": agree, "argmax_total": ticks * B}


def profile_ticks(model, params, reqs, *, B, max_seq, T, pool_blocks,
                  warm=24, ticks=8, kv_dtype="bf16") -> dict:
    """Device time per decode tick by kernel name, from ``torch.profiler``
    (CUDA activity only, to keep host overhead down) over ``ticks`` ticks
    of a fresh O6-kernel engine serving ``reqs`` from a ``kv_dtype``
    pool, after ``warm`` ticks, and the device kernels launched per
    tick.  Profiled ticks run slower on the host than unprofiled ones, so
    the idle share read here is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.optlevel import BestEffortConfig, OptLevel
    from repro_torch.serving import DecodeEngine, Request

    eng = DecodeEngine(model, params, batch_size=B, max_seq=max_seq,
                       config=BestEffortConfig(
                           level=OptLevel.O6, paged_attn="kernel",
                           kv_block_size=T, kv_pool_blocks=pool_blocks,
                           kv_dtype=kv_dtype))
    for prompt, n in reqs:
        eng.submit(Request(prompt=list(prompt), max_new_tokens=n))
    for _ in range(warm):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    by_name = {}
    launched = 0
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", 0)
              or getattr(ev, "self_cuda_time_total", 0))
        if us:
            by_name[ev.key] = us / 1e3 / ticks
            launched += ev.count
    busy = sum(by_name.values())
    paged = sum(v for k, v in by_name.items()
                if "paged_rows_kernel" in k or "paged_split_kernel" in k)
    return {"ticks": ticks, "after_ticks": warm, "kv_dtype": kv_dtype,
            "wall_ms_per_tick": wall_ms,
            "device_ms_per_tick": busy if busy else None,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "paged_kernel_ms_per_tick": paged if busy else None,
            "device_kernels_per_tick": launched / ticks if busy else None,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}


def log_profile(tag: str, prof: dict) -> None:
    if prof["device_ms_per_tick"] is None:
        log(f"{tag} profile ({prof['kv_dtype']} pool): the profiler "
            f"recorded no device time (not measured)")
        return
    log(f"{tag} profile of {prof['ticks']} ticks after "
        f"{prof['after_ticks']} ({prof['kv_dtype']} pool): wall "
        f"{prof['wall_ms_per_tick']:.2f} ms/tick, device busy "
        f"{prof['device_ms_per_tick']:.2f} ms/tick (idle share <= "
        f"{prof['idle_share']:.3f}), {prof['device_kernels_per_tick']:.0f} "
        f"device kernels/tick, paged kernel "
        f"{prof['paged_kernel_ms_per_tick']:.3f} ms/tick; top: "
        + "; ".join(f"{k[:60]} {v:.3f}" for k, v in prof["top"]))


def first_layers(cfg, params, n: int):
    """The config and param views of the first ``n`` layers."""
    import dataclasses

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:n]

    return (dataclasses.replace(cfg, n_layers=n),
            dict(params, layers=cut(params["layers"])))


def serve_counted(engine, reqs) -> dict:
    """Submit ``reqs`` to ``engine`` and tick it to the end, recording
    the tick at which each request's first token lands (TTFT in ticks;
    its TTFT in ms is the request's own stamps, all submitted at once)
    and the most requests admitted at once."""
    import torch
    from repro_torch.serving import Request

    objs = [Request(prompt=list(p), max_new_tokens=n) for p, n in reqs]
    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    for r in objs:
        engine.submit(r)
    ticks, first, peak = 0, {}, 0
    while True:
        stepped = engine.step()
        ticks += stepped
        peak = max(peak, sum(s.active for s in engine.slots))
        for r in objs:
            if r.generated and r.rid not in first:
                first[r.rid] = ticks
        if not stepped and not engine.queue:
            break
    sync()
    wall = time.perf_counter() - t0
    tokens = sum(len(r.generated) for r in objs)
    return {"ticks": ticks, "dispatches": engine.n_steps, "wall_s": wall,
            "tokens": tokens, "tok_per_s": tokens / wall,
            "ms_per_tick": wall / ticks * 1e3,
            "ttft_ticks": [first[r.rid] for r in objs],
            "ttft_ms": [r.ttft_s * 1e3 for r in objs],
            "peak_admitted": peak,
            "generated": [list(r.generated) for r in objs]}


def _pool(model, n_rows: int, T: int) -> dict:
    import torch

    cfg = model.cfg
    shape = (cfg.n_layers, n_rows, T, cfg.n_kv_heads, cfg.head_dim)
    return {k: torch.zeros(shape, dtype=torch.bfloat16, device=model.device)
            for k in "kv"}


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def teacher_forced_chunks(model, params, *, P=150, C=64, T=16,
                          seed=0) -> dict:
    """``paged_prefill_step`` (kernel B2) logits at each chunk's last real
    row — the last chunk padded — against the kernel decode step (B1)
    fed the same prompt one token at a time, over the same table; and
    the chunk step with B2's plain version in its place against the same
    decode logits, the drift the kernel is judged by."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.models import attention

    cfg, dev = model.cfg, model.device
    r = np.random.default_rng(seed)
    toks = torch.tensor(r.integers(1, cfg.vocab, P), device=dev)
    nb = -(-(P + C) // T)
    tables = torch.arange(1, nb + 1, dtype=torch.int32, device=dev)[None]
    starts = list(range(0, P, C))
    lasts = [min(st + C, P) - 1 for st in starts]

    def chunks():
        pool, out = _pool(model, nb + 1, T), []
        for st in starts:
            n = min(C, P - st)
            tk = torch.zeros((1, C), dtype=torch.long, device=dev)
            tk[0, :n] = toks[st:st + n]
            lg, pool = model.paged_prefill_step(
                params, pool, tables, tk, torch.tensor([st], device=dev),
                torch.tensor([n - 1], device=dev))
            out.append(lg)
        return torch.cat(out)

    kern = chunks()
    kernel_fn = attention.paged_prefill_attention
    attention.paged_prefill_attention = ref.paged_prefill_attention_ref
    try:
        plain = chunks()
    finally:
        attention.paged_prefill_attention = kernel_fn
    pool, dec = _pool(model, nb + 1, T), []
    for p in range(P):
        lg, pool = model.paged_decode_step(
            params, pool, tables, toks[p:p + 1][None],
            torch.tensor([p], device=dev))
        if p in lasts:
            dec.append(lg)
    dec = torch.cat(dec)
    if not all(torch.isfinite(x).all() for x in (kern, plain, dec)):
        raise AssertionError("chunked prefill: non-finite logits")
    return {"layers": cfg.n_layers, "prompt": P, "chunk": C,
            "chunk_lasts": lasts,
            "max_rel_logit_diff": {"kernel_vs_decode": _rel(kern, dec),
                                   "plain_vs_decode": _rel(plain, dec),
                                   "kernel_vs_plain": _rel(kern, plain)},
            "argmax_agree": int((kern.argmax(-1) == dec.argmax(-1)).sum()),
            "argmax_total": len(lasts)}


def teacher_forced_verify(model, params, *, B=8, W=5, T=16, max_seq=1024,
                          seed=0) -> dict:
    """Where verify rows and decode rows part: one ``paged_verify_step``
    (B2) over a W-token window against W kernel decode steps (B1) fed the
    same tokens, over the same random KV prefix; per row, the logits'
    relative difference, how many logits differ in bits and whether the
    argmax agrees.  Beside it, each GEMM shape of a layer and the norm
    applied to M = B*W rows against the same B rows alone: the bits that
    differ there are what the window's wider products change."""
    import numpy as np
    import torch
    from repro_torch.models.layers import rms_norm

    cfg, dev = model.cfg, model.device
    r = np.random.default_rng(seed)
    prefix = r.integers(1, max_seq - W, B)
    nb = -(-max_seq // T)
    R = 1 + B * nb
    tables = torch.arange(1, R, dtype=torch.int32, device=dev).reshape(
        B, nb)
    g = torch.Generator(device=dev).manual_seed(seed)
    pool_v = _pool(model, R, T)
    for k in "kv":
        pool_v[k].copy_(torch.randn(pool_v[k].shape, generator=g,
                                    device=dev))
    pool_d = {k: v.clone() for k, v in pool_v.items()}
    toks = torch.tensor(r.integers(1, cfg.vocab, (B, W)), device=dev)
    start = torch.tensor(prefix, device=dev)
    lv, _ = model.paged_verify_step(params, pool_v, tables, toks, start)
    rows = []
    for j in range(W):
        ld, _ = model.paged_decode_step(params, pool_d, tables,
                                        toks[:, j:j + 1], start + j)
        rows.append({"row": j, "rel": _rel(lv[:, j], ld),
                     "logits_differing": int((lv[:, j] != ld).sum()),
                     "argmax_agree": int((lv[:, j].argmax(-1)
                                          == ld.argmax(-1)).sum())})
    lp, d = params["layers"], cfg.d_model
    shapes = {"wq": lp["attn"]["wq"][0].reshape(d, -1),
              "wk": lp["attn"]["wk"][0].reshape(d, -1),
              "wo(attn)": lp["attn"]["wo"][0].reshape(-1, d),
              "wi": lp["mlp"]["wi"][0], "wo(mlp)": lp["mlp"]["wo"][0]}
    probe = {}
    for name, w in shapes.items():
        x = torch.randn((B * W, w.shape[0]), generator=g,
                        device=dev).to(w.dtype)
        wide = (x @ w)[::W]                  # row j=0 of each slot
        alone = x[::W].contiguous() @ w
        probe[name] = {"M": [B * W, B], "N": w.shape[1], "K": w.shape[0],
                       "elements_differing": int((wide != alone).sum()),
                       "of": wide.numel()}
    nw = params["final_norm"]
    x = torch.randn((B, W, cfg.d_model), generator=g, device=dev).to(
        nw.dtype)
    wide = rms_norm(x, nw)[:, :1]
    alone = rms_norm(x[:, :1].contiguous(), nw)
    probe["rms_norm"] = {"elements_differing": int((wide != alone).sum()),
                         "of": wide.numel()}
    return {"rows": rows, "probe": probe, "prefix": prefix.tolist()}


def phase_full(card: str) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.optlevel import OptLevel
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.launch.serve import demo_requests, serve_demo
    from repro_torch.models import get_model
    from repro_torch.serving.paged import blocks_for

    cfg = get_config("qwen3-8b")
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[full] qwen3-8b {cfg.n_layers}L d={cfg.d_model} H={cfg.n_heads} "
        f"KV={cfg.n_kv_heads} dh={cfg.head_dim} ff={cfg.d_ff} vocab="
        f"{cfg.vocab}: {n_params} params in bf16 drawn in "
        f"{time.perf_counter() - t0:.1f} s")

    # Two layers at full width: a tight check of the kernel step against
    # the gather step.  All 36: with random weights the stack amplifies
    # reduction-order differences of one bf16 ulp layer by layer, so
    # there the kernel step is held to the drift of its own plain
    # version, with a loose bound.
    cut_cfg, cut_params = first_layers(cfg, params, 2)
    tf = {"2": teacher_forced(get_model(cut_cfg), cut_params),
          "36": teacher_forced(model, params)}
    for n, res in tf.items():
        log(f"[full] teacher-forced {n} layers, {res['ticks']} ticks "
            f"(prefixes {res['prefix']}): max |dlogit| / max |logit| "
            + ", ".join(f"{k} {v:.3e}" for k, v in
                        res["max_rel_logit_diff"].items())
            + f"; argmax agree {res['argmax_agree']}/{res['argmax_total']}")
    if tf["2"]["max_rel_logit_diff"]["kernel_vs_gather"] > 2e-2:
        raise AssertionError(f"full width, 2 layers: kernel step logits "
                             f"differ from the gather step: {tf['2']}")
    deep = tf["36"]["max_rel_logit_diff"]
    if deep["kernel_vs_gather"] > max(0.15, 2 * deep["plain_vs_gather"]):
        raise AssertionError(f"full width, 36 layers: kernel step drifts "
                             f"from the gather step beyond its plain "
                             f"version's drift: {tf['36']}")
    torch.cuda.empty_cache()

    B, max_seq, T, n_req = 8, 1024, 16, 8
    kw = dict(seed=0, prompt_len=(16, 257), max_new=(32, 33))
    reqs = demo_requests(cfg, n_req, **kw)
    pool_blocks = sum(blocks_for(len(p) + n, T) for p, n in reqs)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = serve_demo(cfg, batch_size=B, max_seq=max_seq, n_requests=n_req,
                     level=OptLevel.O6, paged_attn="kernel",
                     kv_block_size=T, kv_pool_blocks=pool_blocks,
                     params=params, **kw)
    launches = ops.paged_attention.launches
    b2_launches = ops.paged_prefill_attention.launches
    bodies = paged_bodies("(b)")
    no_training_kernels("(b)")
    peak = torch.cuda.max_memory_allocated()
    if out["paged_attn"] != "kernel":
        raise AssertionError(f"full width: served through "
                             f"{out['paged_attn']}")
    if launches != cfg.n_layers * out["ticks"]:
        raise AssertionError(f"full width: {launches} kernel launches, want "
                             f"{cfg.n_layers} x {out['ticks']} ticks")
    if b2_launches:
        raise AssertionError(f"full width: the prestaged run launched B2 "
                             f"{b2_launches} times, want 0")
    fin = out["finished"]
    if len(fin) != n_req or any(len(r.generated) != 32 for r in fin):
        raise AssertionError("full width: not every request got 32 tokens")
    vp = model.defs()["lm_head"].shape[1]
    if any(not 0 <= t < vp for r in fin for t in r.generated):
        raise AssertionError("full width: token id out of range")
    prof = profile_ticks(model, params, reqs, B=B, max_seq=max_seq, T=T,
                         pool_blocks=pool_blocks)
    log_profile("[full]", prof)
    res = {
        "card": card, "batch": B, "max_seq": max_seq, "requests": n_req,
        "prompt_lens": sorted(len(p) for p, _ in reqs), "new_tokens": 32,
        "ticks": out["ticks"], "tokens": out["tokens"],
        "wall_s": out["wall_s"], "tok_per_s": out["tok_per_s"],
        "ms_per_tick": out["wall_s"] / out["ticks"] * 1e3,
        "kernel_launches": launches, "b2_launches": b2_launches,
        "body_launches": bodies, "peak_bytes": peak,
        "pool": out["pool"], "teacher_forced": tf, "profile": prof,
    }
    log(f"[full] serve O6/kernel on {card}: {n_req} requests (prompts "
        f"{res['prompt_lens']}, 32 new each), {out['tokens']} tokens in "
        f"{out['ticks']} ticks / {out['wall_s']:.2f} s = "
        f"{out['tok_per_s']:.1f} tok/s ({res['ms_per_tick']:.2f} ms/tick), "
        f"kernel launches {launches} = {cfg.n_layers} x {out['ticks']} "
        f"(bodies {bodies['paged_attention']}), "
        f"peak {peak / 2**30:.2f} GiB, pool {out['pool']['pool_rows']} rows "
        f"x {T} tokens ({out['pool']['pool_mb']:.1f} MiB)")
    torch.cuda.empty_cache()
    geo = dict(B=B, max_seq=max_seq, T=T, pool_blocks=pool_blocks)
    prestaged = [g for _, g in sorted((r.rid, r.generated) for r in fin)]
    res["chunked"] = run_chunked(model, params, cut_cfg, cut_params, reqs,
                                 prestaged_tokens=prestaged, **geo)
    res["spec"] = run_spec(model, params, reqs,
                           chunked_tokens=res["chunked"]["generated"], **geo)
    torch.cuda.empty_cache()
    res["narrow"] = phase_narrow(model, params, cut_cfg, cut_params, reqs,
                                 prestaged_tokens=prestaged,
                                 bf16_ms_per_tick=res["ms_per_tick"], **geo)
    torch.cuda.empty_cache()
    res["unpipelined"] = phase_unpipelined(model, params, card)
    res["server"] = phase_server(model, params, card,
                                 pool_blocks=pool_blocks)
    return res


def _same_tokens(a, b) -> list:
    """[greedy tokens equal position by position, tokens in ``b``]."""
    return [sum(x == y for ga, gb in zip(a, b) for x, y in zip(ga, gb)),
            sum(len(g) for g in b)]


def run_chunked(model, params, cut_cfg, cut_params, reqs, *, prestaged_tokens,
                B, max_seq, T, pool_blocks, C=64) -> dict:
    """Run (d): chunked prefill at ``prefill_chunk=C`` on O6-kernel, with
    B2 launches = layers x chunk dispatches and B1 launches = layers x
    decode dispatches, the share of greedy tokens equal to run (b)'s
    (prompts fed a token per tick), and the teacher-forced
    chunk-vs-decode check."""
    import torch
    from repro_torch.core.optlevel import BestEffortConfig, OptLevel
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.models import get_model
    from repro_torch.serving import DecodeEngine

    cfg = model.cfg
    L = cfg.n_layers
    tf = {"2": teacher_forced_chunks(get_model(cut_cfg), cut_params, C=C,
                                     T=T),
          "36": teacher_forced_chunks(model, params, C=C, T=T)}
    for n, t in tf.items():
        log(f"[full] (d) teacher-forced chunked prefill, {n} layers, prompt "
            f"{t['prompt']} in chunks of {C} (last rows {t['chunk_lasts']}): "
            f"max |dlogit| / max |logit| " + ", ".join(
                f"{k} {v:.3e}" for k, v in t["max_rel_logit_diff"].items())
            + f"; argmax agree {t['argmax_agree']}/{t['argmax_total']}")
    if tf["2"]["max_rel_logit_diff"]["kernel_vs_decode"] > 2e-2:
        raise AssertionError(f"(d) 2 layers: chunk-step logits differ from "
                             f"the decode step's: {tf['2']}")
    deep = tf["36"]["max_rel_logit_diff"]
    if deep["kernel_vs_decode"] > max(0.15, 2 * deep["plain_vs_decode"]):
        raise AssertionError(f"(d) 36 layers: the chunk step drifts from the "
                             f"decode step beyond B2's plain version's "
                             f"drift: {tf['36']}")
    torch.cuda.empty_cache()

    eng = DecodeEngine(model, params, batch_size=B, max_seq=max_seq,
                       config=BestEffortConfig(
                           level=OptLevel.O6, paged_attn="kernel",
                           kv_block_size=T, kv_pool_blocks=pool_blocks,
                           prefill_chunk=C))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = serve_counted(eng, reqs)
    b1, b2 = ops.paged_attention.launches, ops.paged_prefill_attention.launches
    bodies = paged_bodies("(d)")
    no_training_kernels("(d)")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    chunks = sum(-(-len(p) // C) for p, _ in reqs)
    if eng.prefill_mode != "chunked":
        raise AssertionError(f"(d) prefill ran {eng.prefill_mode}")
    if b2 != L * chunks or b1 != L * out["dispatches"]:
        raise AssertionError(f"(d) launches B2 {b2} (want {L} x {chunks} "
                             f"chunks), B1 {b1} (want {L} x "
                             f"{out['dispatches']} decode dispatches)")
    if any(len(g) != n for g, (_, n) in zip(out["generated"], reqs)):
        raise AssertionError("(d) not every request got its tokens")
    out.update(launches={"paged_attention": b1,
                         "paged_prefill_attention": b2},
               body_launches=bodies,
               chunk=C, chunk_dispatches=chunks, teacher_forced=tf,
               equal_to_prestaged=_same_tokens(out["generated"],
                                               prestaged_tokens))
    log(f"[full] (d) chunked prefill C={C}, O6/kernel: {out['tokens']} "
        f"tokens in {out['ticks']} ticks / {out['wall_s']:.2f} s = "
        f"{out['tok_per_s']:.1f} tok/s ({out['ms_per_tick']:.2f} ms/tick); "
        f"TTFT ticks {out['ttft_ticks']}, TTFT ms "
        f"{[round(x, 1) for x in out['ttft_ms']]} (prompts "
        f"{[len(p) for p, _ in reqs]}); launches B2 {b2} = {L} x {chunks} "
        f"chunks, B1 {b1} = {L} x {out['dispatches']} decode dispatches; "
        f"greedy tokens equal to (b)'s: {out['equal_to_prestaged'][0]}/"
        f"{out['equal_to_prestaged'][1]}; peak "
        f"{out['peak_bytes'] / 2**30:.2f} GiB")
    return out


def run_spec(model, params, reqs, *, chunked_tokens, B, max_seq, T,
             pool_blocks, K=4) -> dict:
    """Run (e): O7 at ``draft_k=K`` on O6-kernel.  The published pair
    qwen3-8b -> smollm-360m is not token-compatible at full scale, so
    the target drafts for itself (its API and params); B2 launches =
    layers x verify dispatches.  Reports acceptance, tokens per window,
    tok/s, the share of greedy tokens equal to run (d)'s, and the
    teacher-forced verify-vs-decode comparison that says where rows
    differ."""
    import torch
    from repro_torch.core.optlevel import BestEffortConfig, OptLevel
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.models.model_zoo import compatible_drafter
    from repro_torch.serving import DecodeEngine

    cfg = model.cfg
    L = cfg.n_layers
    try:
        compatible_drafter(cfg, "smollm-360m")
    except ValueError as e:
        log(f"[full] (e) qwen3-8b -> smollm-360m refused: {e}")
    else:
        raise AssertionError("(e) compatible_drafter accepted qwen3-8b -> "
                             "smollm-360m at full scale")
    tfv = teacher_forced_verify(model, params, B=B, W=K + 1, T=T,
                                max_seq=max_seq)
    log(f"[full] (e) teacher-forced verify window of {K + 1} vs decode, "
        f"prefixes {tfv['prefix']}: " + "; ".join(
            f"row {x['row']}: rel {x['rel']:.3e}, {x['logits_differing']} "
            f"logits differ, argmax agree {x['argmax_agree']}/{B}"
            for x in tfv["rows"]))
    log("[full] (e) M = B*W rows vs B rows alone, elements differing: "
        + "; ".join(f"{k} {v['elements_differing']}/{v['of']}"
                    for k, v in tfv["probe"].items()))
    torch.cuda.empty_cache()

    eng = DecodeEngine(model, params, batch_size=B, max_seq=max_seq,
                       config=BestEffortConfig(
                           level=OptLevel.O7, paged_attn="kernel",
                           kv_block_size=T, kv_pool_blocks=pool_blocks,
                           draft_k=K),
                       draft_model=model, draft_params=params)
    if eng.spec_mode != "draft":
        raise AssertionError(f"(e) speculation {eng.spec_mode}")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = serve_counted(eng, reqs)
    b1, b2 = ops.paged_attention.launches, ops.paged_prefill_attention.launches
    bodies = paged_bodies("(e)")
    no_training_kernels("(e)")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if b2 % L or b1 % L or b1 // L + b2 // L != out["dispatches"]:
        raise AssertionError(f"(e) launches B2 {b2}, B1 {b1}: want {L} x "
                             f"the {out['dispatches']} verify and boundary "
                             f"dispatches")
    if b2 == 0:
        raise AssertionError("(e) no verify window ran through B2")
    if any(len(g) != n for g, (_, n) in zip(out["generated"], reqs)):
        raise AssertionError("(e) not every request got its tokens")
    same, total = _same_tokens(out["generated"], chunked_tokens)
    st = eng.spec_stats
    out.update(launches={"paged_attention": b1,
                         "paged_prefill_attention": b2},
               body_launches=bodies,
               verify_dispatches=b2 // L, spec=st, draft_k=K,
               equal_to_chunked=[same, total], teacher_forced=tfv)
    log(f"[full] (e) O7 self-draft K={K}, O6/kernel: accept_rate "
        f"{st['accept_rate']:.4f} ({st['accepted']}/{st['drafted']}), "
        f"{st['eff_tok_per_step']:.3f} tokens per window, {out['tokens']} "
        f"tokens in {out['ticks']} ticks / {out['wall_s']:.2f} s = "
        f"{out['tok_per_s']:.1f} tok/s ({out['ms_per_tick']:.2f} ms/tick); "
        f"TTFT ticks {out['ttft_ticks']}; greedy tokens equal to (d)'s: "
        f"{same}/{total}; launches B2 {b2} = {L} x {b2 // L} verify "
        f"dispatches, B1 {b1}; peak {out['peak_bytes'] / 2**30:.2f} GiB")
    return out


# ---------------------------------------------------------------------------
# Phase 5f: qwen3-8b at full width served from int8 and fp8 pools
# ---------------------------------------------------------------------------

# 5f: the teacher-forced int8 kernel step against the same step through
# the plain version (max |dlogit| / max |logit|).  At 2 layers both read
# the same dequantized bf16 values and differ in reduction order only, as
# phase 5a's kernel and plain steps do.  At 36 layers random weights
# amplify that one-ulp noise layer by layer (C6), so there the bound
# only catches a broken scale or rounding site, which moves logits by
# their own scale.
NARROW_TF_TOL = {"2": 2e-2, "36": 0.5}


def teacher_forced_quant(model, params, *, kvd="int8", B=8, max_seq=1024,
                         T=16, ticks=8, seed=0) -> dict:
    """The narrow kernel decode step against the same step with B1's
    plain version in its place, fed the same tokens over the same random
    KV prefix quantized per block (a different length per slot); logits
    compared every tick."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.models import attention
    from repro_torch.serving import Request, kvquant
    from repro_torch.serving.paged import PagedCacheManager

    cfg, dev = model.cfg, model.device
    r = np.random.default_rng(seed)
    prefix = r.integers(1, max_seq - ticks, B)
    kern, plain = mgrs = [
        PagedCacheManager(model, B, max_seq, block_size=T, kv_dtype=kvd)
        for _ in range(2)]
    for mgr in mgrs:
        for b in range(B):
            mgr.admit_slot(b, Request(prompt=[1] * int(prefix[b]),
                                      max_new_tokens=ticks))
    g = torch.Generator(device=dev).manual_seed(seed)
    for b in range(B):
        for j in range(-(-int(prefix[b]) // T)):
            row = int(kern.tables[b, j])
            for name in ("k", "v"):
                blk = torch.randn(kern.cache["pool"][name][:, row].shape,
                                  generator=g, device=dev)
                sc = kvquant.block_scale(blk, (1, 3), kvd)
                words = kvquant.as_bytes(kvquant.quantize(blk, sc, kvd))
                for mgr in mgrs:
                    kvquant.as_bytes(mgr.cache["pool"][name])[:, row] = words
                    mgr.cache["scale"][name][:, row] = sc[:, 0, :, 0]
    (tables,) = kern.step_extras()
    rel, agree = 0.0, 0
    for t in range(ticks):
        toks = torch.tensor(r.integers(1, cfg.vocab, (B, 1)), device=dev)
        pos = torch.tensor(prefix + t, device=dev)
        lk = model.paged_decode_step(params, kern.cache["pool"], tables, toks,
                                     pos, scales=kern.cache["scale"],
                                     kv_dtype=kvd)[0]
        kernel_fn = attention.paged_attention
        attention.paged_attention = ref.paged_attention_ref
        try:
            lp = model.paged_decode_step(
                params, plain.cache["pool"], tables, toks, pos,
                scales=plain.cache["scale"], kv_dtype=kvd)[0]
        finally:
            attention.paged_attention = kernel_fn
        if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
            raise AssertionError(f"5f {kvd}: non-finite logits")
        rel = max(rel, _rel(lk, lp))
        agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
    return {"layers": cfg.n_layers, "kv_dtype": kvd, "ticks": ticks,
            "batch": B, "prefix": prefix.tolist(),
            "max_rel_logit_diff_kernel_vs_plain": rel,
            "argmax_agree": agree, "argmax_total": ticks * B}


def smoke_card_vs_cpu(kvd: str) -> dict:
    """Smoke-width qwen3-8b (f32 compute) served at O6-kernel with
    chunked prefill 3 from a ``kvd`` pool, on the card and on the CPU
    from the same weights: the card's tokens within the dtype's tolerance
    contract of the CPU's (the CPU runs B1/B2's plain versions)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core.optlevel import BestEffortConfig, OptLevel
    from repro_torch.models import get_model
    from repro_torch.serving import DecodeEngine, kvquant
    from repro_torch.tree import map_tree

    cfg = dataclasses.replace(get_smoke("qwen3-8b"), compute_dtype="float32")
    params = get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    mix = [(rng.integers(1, cfg.vocab, int(rng.integers(1, 12))).tolist(),
            int(rng.integers(1, 8))) for _ in range(10)]
    out = {}
    for device in ("cuda", "cpu"):
        eng = DecodeEngine(
            get_model(cfg, device=device),
            map_tree(lambda t: t.to(device), params), batch_size=4,
            max_seq=32, config=BestEffortConfig(
                level=OptLevel.O6, paged_attn="kernel", kv_dtype=kvd,
                kv_block_size=4, kv_pool_blocks=20, prefill_chunk=3))
        out[device] = drive(eng, mix)
    agreement = kvquant.assert_tokens_match(
        out["cpu"], out["cuda"], kvquant.tolerance_contract(kvd),
        f"5f smoke {kvd} card vs cpu")
    return {"kv_dtype": kvd, "agreement": agreement,
            "tokens": sum(map(len, out["cuda"]))}


def phase_narrow(model, params, cut_cfg, cut_params, reqs, *,
                 prestaged_tokens, bf16_ms_per_tick, B, max_seq, T,
                 pool_blocks) -> dict:
    """Phase 5f: qwen3-8b at full width served at O6-kernel from int8 and
    fp8 pools holding the bytes of run (b)'s bf16 pool (so about twice
    its block rows): (b) the same 8 requests prestaged at batch 8 through
    ``serve_demo``, B1 launches = layers x ticks; the same at batch 16
    with 16 requests beside a bf16 pool of run (b)'s size, to show the
    requests each admits at once; on int8, (d) chunked prefill at 64 and
    (e) O7 self-draft K=4; a profile of int8 ticks; the teacher-forced
    int8 kernel step against its plain version; and the smoke width on
    the card against the CPU.  Token agreement with the bf16 runs is
    reported, not gated: 36 random layers amplify one ulp (C6)."""
    import torch
    from repro_torch.core.optlevel import BestEffortConfig, OptLevel
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.launch.serve import demo_requests, serve_demo
    from repro_torch.models import get_model
    from repro_torch.serving import DecodeEngine, kvquant
    from repro_torch.serving.paged import BlockPagingPlan

    cfg = model.cfg
    L = cfg.n_layers
    res = {"teacher_forced": {}}
    for n, (m, p) in (("2", (get_model(cut_cfg), cut_params)),
                      ("36", (model, params))):
        tf = teacher_forced_quant(m, p, B=B, max_seq=max_seq, T=T)
        res["teacher_forced"][n] = tf
        log(f"[full] 5f teacher-forced int8 kernel step vs plain, {n} "
            f"layers, {tf['ticks']} ticks (prefixes {tf['prefix']}): max "
            f"|dlogit| / max |logit| "
            f"{tf['max_rel_logit_diff_kernel_vs_plain']:.3e} (bound "
            f"{NARROW_TF_TOL[n]}); argmax agree {tf['argmax_agree']}/"
            f"{tf['argmax_total']}")
        if tf["max_rel_logit_diff_kernel_vs_plain"] > NARROW_TF_TOL[n]:
            raise AssertionError(f"5f: the int8 kernel step drifts from its "
                                 f"plain version at {n} layers: {tf}")
    torch.cuda.empty_cache()

    # Pool rows of equal bytes: the bf16 pool of run (b), pool_blocks + 1
    # rows (the NULL block among them), against narrow rows of half the
    # words plus their scales.
    bf16 = BlockPagingPlan(model, B, max_seq, T, pool_blocks).geometry
    plan = BlockPagingPlan(model, B, max_seq, T, pool_blocks,
                           kv_dtype="int8")
    row_bytes = T * plan.token_bytes + plan.scale_bytes_per_block
    narrow_blocks = bf16["pool_bytes"] // row_bytes - 1
    kw = dict(seed=0, prompt_len=(16, 257), max_new=(32, 33))
    reqs16 = demo_requests(cfg, 16, **kw)
    if reqs16[:len(reqs)] != reqs:
        raise AssertionError("5f: the 16 requests do not extend run (b)'s")

    def count(run, fn, *a, **k):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out = fn(*a, **k)
        out["launches"] = {"paged_attention": ops.paged_attention.launches,
                           "paged_prefill_attention":
                               ops.paged_prefill_attention.launches}
        out["body_launches"] = paged_bodies(run)
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        no_training_kernels(run)
        return out

    def engine(kvd, batch, blocks, level=OptLevel.O6, eng_kw=None,
               **cfg_kw):
        return DecodeEngine(model, params, batch_size=batch, max_seq=max_seq,
                            config=BestEffortConfig(
                                level=level, paged_attn="kernel",
                                kv_block_size=T, kv_pool_blocks=blocks,
                                kv_dtype=kvd, **cfg_kw), **(eng_kw or {}))

    runs = {}
    for kvd in ("int8", "fp8"):
        out = count(f"5f (b) {kvd}", serve_demo, cfg, batch_size=B,
                    max_seq=max_seq, n_requests=len(reqs), level=OptLevel.O6,
                    paged_attn="kernel", kv_block_size=T,
                    kv_pool_blocks=narrow_blocks, kv_dtype=kvd,
                    params=params, **kw)
        fin = sorted((r.rid, r.generated) for r in out.pop("finished"))
        out["generated"] = [g for _, g in fin]
        b1, b2 = (out["launches"][k] for k in ("paged_attention",
                                               "paged_prefill_attention"))
        if out["paged_attn"] != "kernel" or out["kv_dtype"] != kvd:
            raise AssertionError(f"5f (b) {kvd}: served {out['paged_attn']} "
                                 f"from {out['kv_dtype']}")
        if b1 != L * out["ticks"] or b2:
            raise AssertionError(f"5f (b) {kvd}: launches B1 {b1} (want {L} "
                                 f"x {out['ticks']} ticks), B2 {b2} (want 0)")
        if any(len(g) != 32 for g in out["generated"]):
            raise AssertionError(f"5f (b) {kvd}: not every request got 32 "
                                 f"tokens")
        out.update(ms_per_tick=out["wall_s"] / out["ticks"] * 1e3,
                   equal_to_bf16=_same_tokens(out["generated"],
                                              prestaged_tokens),
                   agreement_with_bf16=kvquant.token_agreement(
                       prestaged_tokens, out["generated"]))
        runs[f"b {kvd}"] = out
        log(f"[full] 5f (b) {kvd} pool, {len(reqs)} requests at batch {B}: "
            f"{out['tokens']} tokens in {out['ticks']} ticks / "
            f"{out['wall_s']:.2f} s = {out['tok_per_s']:.1f} tok/s "
            f"({out['ms_per_tick']:.2f} ms/tick; bf16 (b) "
            f"{bf16_ms_per_tick:.2f} in this run); pool "
            f"{out['pool']['pool_rows']} rows ({out['pool']['pool_mb']:.1f} "
            f"MiB; bf16 {bf16['pool_rows']} rows, {bf16['pool_mb']:.1f} MiB), "
            f"{out['pool']['scale_bytes_per_block']} B of scales a row; B1 "
            f"launches {b1} = {L} x {out['ticks']}; greedy tokens equal to "
            f"bf16 (b)'s {out['equal_to_bf16'][0]}/{out['equal_to_bf16'][1]}, "
            f"prefix agreement {out['agreement_with_bf16']:.3f}; peak "
            f"{out['peak_bytes'] / 2**30:.2f} GiB")
        torch.cuda.empty_cache()

    for kvd, blocks in (("bf16", pool_blocks), ("int8", narrow_blocks),
                        ("fp8", narrow_blocks)):
        eng = engine(kvd, 2 * B, blocks)
        out = count(f"5f batch {2 * B} {kvd}", serve_counted, eng, reqs16)
        out["pool"] = eng.cache_mgr.geometry
        if out["launches"]["paged_attention"] != L * out["dispatches"]:
            raise AssertionError(f"5f batch {2 * B} {kvd}: B1 launches "
                                 f"{out['launches']} vs {out['dispatches']} "
                                 f"dispatches")
        if any(len(g) != n for g, (_, n) in zip(out["generated"], reqs16)):
            raise AssertionError(f"5f batch {2 * B} {kvd}: not every "
                                 f"request got its tokens")
        runs[f"batch{2 * B} {kvd}"] = out
        log(f"[full] 5f {len(reqs16)} requests at batch {2 * B} from a "
            f"{kvd} pool of {out['pool']['pool_rows']} rows "
            f"({out['pool']['pool_mb']:.1f} MiB): at most "
            f"{out['peak_admitted']} admitted at once; {out['tokens']} "
            f"tokens in {out['ticks']} ticks / {out['wall_s']:.2f} s = "
            f"{out['tok_per_s']:.1f} tok/s ({out['ms_per_tick']:.2f} "
            f"ms/tick); peak {out['peak_bytes'] / 2**30:.2f} GiB")
        del eng
        torch.cuda.empty_cache()

    C = 64
    eng = engine("int8", B, narrow_blocks, prefill_chunk=C)
    out = count("5f (d) int8", serve_counted, eng, reqs)
    chunks = sum(-(-len(p) // C) for p, _ in reqs)
    b1, b2 = (out["launches"][k] for k in ("paged_attention",
                                           "paged_prefill_attention"))
    if eng.prefill_mode != "chunked" or b2 != L * chunks \
            or b1 != L * out["dispatches"]:
        raise AssertionError(f"5f (d) int8: {eng.prefill_mode}, launches B2 "
                             f"{b2} (want {L} x {chunks}), B1 {b1} (want {L} "
                             f"x {out['dispatches']})")
    out.update(chunk=C, chunk_dispatches=chunks,
               equal_to_bf16_prestaged=_same_tokens(out["generated"],
                                                    prestaged_tokens))
    runs["d int8"] = out
    log(f"[full] 5f (d) int8 chunked prefill C={C}: {out['tokens']} tokens "
        f"in {out['ticks']} ticks / {out['wall_s']:.2f} s = "
        f"{out['tok_per_s']:.1f} tok/s ({out['ms_per_tick']:.2f} ms/tick); "
        f"TTFT ticks {out['ttft_ticks']}; launches B2 {b2} = {L} x {chunks} "
        f"chunks, B1 {b1} = {L} x {out['dispatches']}; greedy tokens equal "
        f"to bf16 (b)'s {out['equal_to_bf16_prestaged'][0]}/"
        f"{out['equal_to_bf16_prestaged'][1]}")
    del eng
    torch.cuda.empty_cache()

    K = 4
    eng = engine("int8", B, narrow_blocks, level=OptLevel.O7, draft_k=K,
                 eng_kw=dict(draft_model=model, draft_params=params))
    if eng.spec_mode != "draft":
        raise AssertionError(f"5f (e) int8: speculation {eng.spec_mode}")
    out = count("5f (e) int8", serve_counted, eng, reqs)
    b1, b2 = (out["launches"][k] for k in ("paged_attention",
                                           "paged_prefill_attention"))
    if b2 == 0 or b1 % L or b2 % L \
            or b1 // L + b2 // L != out["dispatches"]:
        raise AssertionError(f"5f (e) int8: launches B2 {b2}, B1 {b1} vs "
                             f"{out['dispatches']} dispatches")
    out.update(spec=eng.spec_stats, draft_k=K,
               equal_to_bf16_prestaged=_same_tokens(out["generated"],
                                                    prestaged_tokens))
    runs["e int8"] = out
    st = eng.spec_stats
    log(f"[full] 5f (e) int8 O7 self-draft K={K}: accept_rate "
        f"{st['accept_rate']:.4f}, {st['eff_tok_per_step']:.3f} tokens per "
        f"window, {out['tokens']} tokens in {out['ticks']} ticks / "
        f"{out['wall_s']:.2f} s = {out['tok_per_s']:.1f} tok/s "
        f"({out['ms_per_tick']:.2f} ms/tick); launches B2 {b2} = {L} x "
        f"{b2 // L} verify dispatches, B1 {b1}")
    del eng
    torch.cuda.empty_cache()

    res["profile"] = profile_ticks(model, params, reqs, B=B, max_seq=max_seq,
                                   T=T, pool_blocks=narrow_blocks,
                                   kv_dtype="int8")
    log_profile("[full] 5f", res["profile"])
    res["smoke"] = [smoke_card_vs_cpu(kvd) for kvd in ("int8", "fp8")]
    for sm in res["smoke"]:
        log(f"[full] 5f smoke width {sm['kv_dtype']}, O6-kernel chunk 3: "
            f"{sm['tokens']} tokens on the card, prefix agreement with the "
            f"CPU {sm['agreement']:.3f} (contract floor "
            f"{kvquant.tolerance_contract(sm['kv_dtype'])['min_agreement']})")
    for out in runs.values():
        out.pop("generated", None)
    res.update(runs=runs, narrow_blocks=narrow_blocks,
               bf16_pool=bf16, requests16=len(reqs16))
    return res


# ---------------------------------------------------------------------------
# Phase 5o: the un-pipelined rungs O0/O1 at full width
# ---------------------------------------------------------------------------

# 5o: where O0/O1's bf16 tokens part from O5's, the logits of the first
# divergent position, batch-1 (O0/O1's M = 1 products) against the
# batched step (M = B), within C5's bound of the logits' scale.
C12_TOL = 3e-2


def unpipelined_divergence(model, params, reqs, want, got, *, B,
                           max_seq) -> dict:
    """The first (request, token) where ``got`` parts from ``want``: the
    request's history up to it (prompt + ``want``'s tokens before it) fed
    a token at a time through a batch-1 decode step and through a
    batch-``B`` one (the request in row 0; the other rows' contents do
    not enter row 0), and the two logits at its last position compared
    (max |dlogit| / max |logit|)."""
    import torch

    k = next(i for i, (w, g) in enumerate(zip(want, got)) if w != g)
    j = next(t for t, (a, b) in enumerate(zip(want[k], got[k])) if a != b)
    hist = list(reqs[k][0]) + list(want[k][:j])
    dev = model.device
    one, batch = model.init_cache(1, max_seq), model.init_cache(B, max_seq)
    toks = torch.zeros((B, 1), dtype=torch.long, device=dev)
    for p, tok in enumerate(hist):
        l1, _ = model.decode_step(params, one,
                                  torch.tensor([[tok]], device=dev),
                                  torch.tensor([p], device=dev))
        toks[0, 0] = tok
        lb, _ = model.decode_step(params, batch, toks,
                                  torch.full((B,), p, device=dev))
    a, b = l1[0], lb[0]
    return {"request": k, "token": j, "position": len(hist) - 1,
            "rel": _rel(a, b), "logits_differing": int((a != b).sum()),
            "argmax_batch1": int(a.argmax()),
            "argmax_batched": int(b.argmax()),
            "want": want[k][j], "got": got[k][j]}


def phase_unpipelined(model, params, card: str) -> dict:
    """Phase 5o: qwen3-8b at full width served at O0 (per-request loop,
    a fresh cache at every admission), O1 (the same loop on a
    persistent cache), O2 (one batched step) and O5: 4 requests (prompts
    16-64, 8 new tokens) at batch 4, max_seq 256, bf16.  ms per tick,
    tokens/s and peak memory per rung; O2's tokens must equal O5's; where
    O0/O1's part from O5's, the first divergent position's logits are
    held to the batched step's within ``C12_TOL`` (ROADMAP C12)."""
    import torch
    from repro_torch.core.optlevel import BestEffortConfig, OptLevel
    from repro_torch.launch.serve import demo_requests
    from repro_torch.serving import DecodeEngine

    t_phase = time.perf_counter()
    cfg = model.cfg
    B, max_seq = 4, 256
    reqs = demo_requests(cfg, 4, seed=0, prompt_len=(16, 65),
                         max_new=(8, 9))
    cache_bytes = sum(math.prod(shape) * dt.itemsize for shape, dt in
                      model.cache_spec(B, max_seq).values())
    runs = {}
    for level in (OptLevel.O5, OptLevel.O0, OptLevel.O1, OptLevel.O2):
        name = f"O{int(level)}"
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng = DecodeEngine(model, params, batch_size=B, max_seq=max_seq,
                           config=BestEffortConfig(level=level))
        reset_launches()
        out = serve_counted(eng, reqs)
        launches = read_launches()
        if any(launches.values()):
            raise AssertionError(f"5o {name}: the contiguous rungs run no "
                                 f"kernel, launched {launches}")
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["peak_over_weights_bytes"] = out["peak_bytes"] - base
        if any(len(g) != n for g, (_, n) in zip(out["generated"], reqs)):
            raise AssertionError(f"5o {name}: not every request got its "
                                 f"tokens")
        runs[name] = out
        log(f"[5o] {name} on {card}: {out['tokens']} tokens in "
            f"{out['ticks']} ticks / {out['wall_s']:.3f} s = "
            f"{out['tok_per_s']:.1f} tok/s, {out['ms_per_tick']:.2f} "
            f"ms/tick, {out['dispatches']} dispatches; peak "
            f"{out['peak_bytes'] / 2**30:.3f} GiB "
            f"({out['peak_over_weights_bytes'] / 2**30:.3f} GiB over what "
            f"was allocated before; the cache is "
            f"{cache_bytes / 2**30:.3f} GiB)")
        del eng
        torch.cuda.empty_cache()
    want = runs["O5"]["generated"]
    if runs["O2"]["generated"] != want:
        raise AssertionError(f"5o: O2 tokens {runs['O2']['generated']} != "
                             f"O5 {want}")
    c12 = {}
    for name in ("O0", "O1"):
        got = runs[name]["generated"]
        same = _same_tokens(got, want)
        runs[name]["equal_to_o5"] = same
        if got == want:
            log(f"[5o] {name}: tokens identical to O5")
            continue
        d = unpipelined_divergence(model, params, reqs, want, got, B=B,
                                   max_seq=max_seq)
        c12[name] = d
        log(f"[5o] {name}: {same[0]}/{same[1]} tokens equal to O5; first "
            f"divergence request {d['request']} token {d['token']} "
            f"(position {d['position']}): O5 {d['want']}, {name} "
            f"{d['got']}; batch-1 vs batch-{B} logits there: max |dlogit| "
            f"/ max |logit| {d['rel']:.3e} (bound {C12_TOL}), "
            f"{d['logits_differing']} logits differ, argmax "
            f"{d['argmax_batch1']} / {d['argmax_batched']}")
        if not d["rel"] <= C12_TOL:
            raise AssertionError(f"5o {name}: batch-1 logits part from the "
                                 f"batched step's beyond {C12_TOL}: {d}")
    for out in runs.values():
        out.pop("generated")
    wall = time.perf_counter() - t_phase
    log(f"[5o] done in {wall:.1f} s")
    return {"card": card, "batch": B, "max_seq": max_seq,
            "prompt_lens": [len(p) for p, _ in reqs], "new_tokens": 8,
            "cache_bytes": cache_bytes, "runs": runs, "c12": c12,
            "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 5s: the async server at full width
# ---------------------------------------------------------------------------

def _trace_line(tag: str, m: dict, card: str) -> str:
    return (f"{tag} on {card}: {m['requests']} requests, {m['tokens']} "
            f"tokens in {m['makespan_s']:.3f} s, {m['ticks']} ticks; TTFT "
            f"p50 {m['ttft_p50_s'] * 1e3:.1f} / p99 "
            f"{m['ttft_p99_s'] * 1e3:.1f} ms, TPOT p50 "
            f"{m['tpot_p50_s'] * 1e3:.2f} / p99 {m['tpot_p99_s'] * 1e3:.2f} "
            f"ms, {m['tok_per_s']:.1f} tok/s, goodput "
            f"{m['goodput_rps']:.3f} req/s ({m['good_requests']}/"
            f"{m['requests']} within TTFT {m['slo_ttft_s']} s and TPOT "
            f"{m['slo_tpot_s']} s)")


def phase_server(model, params, card: str, *, pool_blocks: int) -> dict:
    """Phase 5s: phase 5's engine (O6, ``paged_attn="kernel"``, chunk 64,
    batch 8, max_seq 1024, T=16, run (b)'s bf16 pool) behind the async
    server.  A fixed set of 16 requests (prompts 16-256, 16-32 new
    tokens, from ``make_trace``'s seed 7) drained closed-loop gives the
    engine's drain rate; ``serve_trace`` then replays them open-loop at
    0.5x and 2x that rate (poisson) and at 1x (bursty), each row's
    ``latency_metrics`` at the reference's SLOs, every request finished
    with the closed-loop run's tokens, B1 and B2 launched, all on the
    split body.  Then ``prefill`` -> ``insert`` of a 720-token prompt
    while 7 others decode, and ``generate``: the tokens of submitting
    it at the same tick."""
    import dataclasses

    import numpy as np
    from repro_torch.core.optlevel import BestEffortConfig, OptLevel
    from repro_torch.launch.server import (latency_metrics, make_trace,
                                           serve_trace)
    from repro_torch.serving import DecodeEngine, Request
    from repro_torch.serving.paged import blocks_for

    t_phase = time.perf_counter()
    cfg = model.cfg
    L = cfg.n_layers
    B, max_seq, T, C, n = 8, 1024, 16, 64, 16
    eng = DecodeEngine(model, params, batch_size=B, max_seq=max_seq,
                       config=BestEffortConfig(
                           level=OptLevel.O6, paged_attn="kernel",
                           kv_block_size=T, kv_pool_blocks=pool_blocks,
                           prefill_chunk=C))
    shape = dict(n_requests=n, seed=7, vocab=cfg.vocab,
                 prompt_len=(16, 257), max_new=(16, 33))
    fixed = [(t.prompt, t.max_new_tokens) for t in make_trace(rate=1.0,
                                                              **shape)]
    reset_launches()
    closed = serve_counted(eng, fixed)
    closed["launches"] = read_launches()
    closed["body_launches"] = paged_bodies("5s closed loop")
    drain_rps = n / closed["wall_s"]
    want = {tuple(p): g for (p, _), g in zip(fixed, closed["generated"])}
    log(f"[5s] closed loop on {card}: {n} requests (prompts "
        f"{sorted(len(p) for p, _ in fixed)}), {closed['tokens']} tokens in "
        f"{closed['ticks']} ticks / {closed['wall_s']:.3f} s = "
        f"{closed['tok_per_s']:.1f} tok/s ({closed['ms_per_tick']:.2f} "
        f"ms/tick): drain rate {drain_rps:.4f} req/s; launches B1 "
        f"{closed['launches']['paged_attention']}, B2 "
        f"{closed['launches']['paged_prefill_attention']}")
    rows = {}
    for pattern, factor in (("poisson", 0.5), ("poisson", 2.0),
                            ("bursty", 1.0)):
        tag = f"{pattern} {factor:g}x"
        trace = make_trace(rate=factor * drain_rps, pattern=pattern,
                           **shape)
        drawn = [(t.prompt, t.max_new_tokens) for t in trace]
        if pattern == "poisson" and drawn != fixed:
            raise AssertionError("5s: a poisson trace drew other requests "
                                 "than the fixed set")
        trace = [dataclasses.replace(t, prompt=list(p), max_new_tokens=m)
                 for t, (p, m) in zip(trace, fixed)]
        reset_launches()
        res = serve_trace(eng, trace)
        launches = read_launches()
        bodies = paged_bodies(f"5s {tag}")
        fin = res["finished"]
        if len(fin) != n or any(r.truncated or
                                len(r.generated) != r.max_new_tokens
                                for r in fin):
            raise AssertionError(f"5s {tag}: not every request finished")
        got = {tuple(r.prompt): r.generated for r in fin}
        if got != want:
            raise AssertionError(f"5s {tag}: tokens differ from the "
                                 f"closed-loop run's")
        if not (launches["paged_attention"]
                and launches["paged_prefill_attention"]):
            raise AssertionError(f"5s {tag}: launches {launches}")
        m = latency_metrics(fin, makespan_s=res["makespan_s"])
        m.update(pattern=pattern, factor=factor,
                 rate_rps=factor * drain_rps, ticks=res["ticks"],
                 span_s=trace[-1].at_s,
                 launches={k: launches[k] for k in (
                     "paged_attention", "paged_prefill_attention")},
                 body_launches=bodies)
        rows[tag] = m
        log(_trace_line(f"[5s] {tag} ({m['rate_rps']:.4f} req/s offered "
                        f"over {m['span_s']:.2f} s)", m, card)
            + f"; launches B1 {launches['paged_attention']}, B2 "
            f"{launches['paged_prefill_attention']}, all split")

    # prefill -> insert of one long prompt while 7 others decode, then
    # generate; against submitting it at the same tick.
    rng = np.random.default_rng(11)
    long_req = (rng.integers(1, cfg.vocab, 720).tolist(), 16)
    others = [(rng.integers(1, cfg.vocab, int(rng.integers(16, 41))
                            ).tolist(), 16) for _ in range(7)]
    need = sum(blocks_for(len(p) + m, T) for p, m in others + [long_req])
    if need > pool_blocks:
        raise AssertionError(f"5s: the insert run needs {need} blocks of "
                             f"{pool_blocks}")

    def with_long(insert: bool) -> dict:
        rids = [eng.submit(Request(prompt=list(p), max_new_tokens=m))
                for p, m in others]
        for _ in range(len(others) + 2):        # all 7 chunked, decoding
            eng.step()
        decoding = sum(s.active and s.pos >= s.req.n_prompt
                       for s in eng.slots)
        reset_launches()
        t0 = time.perf_counter()
        if insert:
            # prefill reads its first token back to the host, so the
            # clock stops after the device finished.
            res = eng.prefill(long_req[0], max_new_tokens=long_req[1])
            t_prefill = time.perf_counter() - t0
            eng.insert(res)
            rid, first = res.request.rid, res.first_token
        else:
            rid = eng.submit(Request(prompt=list(long_req[0]),
                                     max_new_tokens=long_req[1]))
            t_prefill, first = None, None
        fin = {r.rid: r.generated for r in eng.generate()}
        return {"decoding_at_insert": decoding, "rid": rid,
                "first_token": first, "prefill_s": t_prefill,
                "wall_s": time.perf_counter() - t0,
                "launches": read_launches(),
                "body_launches": paged_bodies(
                    "5s insert" if insert else "5s submit"),
                "long": fin[rid], "others": [fin[r] for r in rids]}

    ins, sub = with_long(True), with_long(False)
    if ins["decoding_at_insert"] != 7:
        raise AssertionError(f"5s: {ins['decoding_at_insert']} requests "
                             f"decoding at the insert, want 7")
    if (ins["long"], ins["others"]) != (sub["long"], sub["others"]) or \
            ins["first_token"] != sub["long"][0]:
        raise AssertionError(f"5s: prefill->insert->generate tokens "
                             f"{ins['long']} != submitted {sub['long']}")
    chunks = -(-len(long_req[0]) // C)
    if ins["launches"]["paged_prefill_attention"] != L * chunks:
        raise AssertionError(f"5s: the prefill launched B2 "
                             f"{ins['launches']['paged_prefill_attention']} "
                             f"times, want {L} x {chunks} chunks")
    log(f"[5s] prefill -> insert of a {len(long_req[0])}-token prompt while "
        f"7 decode, then generate, on {card}: prefill "
        f"{ins['prefill_s'] * 1e3:.1f} ms ({chunks} chunks, B2 launches "
        f"{ins['launches']['paged_prefill_attention']} = {L} x {chunks}); "
        f"its {len(ins['long'])} tokens and the others' identical to "
        f"submitting it")
    for key in ("long", "others"):
        ins.pop(key)
        sub.pop(key)
    closed.pop("generated")
    wall = time.perf_counter() - t_phase
    log(f"[5s] done in {wall:.1f} s")
    return {"card": card, "batch": B, "max_seq": max_seq, "block": T,
            "chunk": C, "pool_blocks": pool_blocks, "closed": closed,
            "drain_rps": drain_rps, "traces": rows,
            "insert": {"inserted": ins, "submitted": sub,
                       "prompt": len(long_req[0]), "chunks": chunks},
            "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 6: train smollm-360m at full width
# ---------------------------------------------------------------------------

def _counted():
    """Every kernel wrapper of the port (each counts its launches)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba2_ssd import ops as sops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.rwkv6_wkv import ops as wops
    from repro_torch.kernels.tiled_matmul import ops as mops

    return (pops.paged_attention, pops.paged_prefill_attention,
            fops.flash_attention, wops.wkv, sops.ssd, mops.matmul_tiled,
            mops.matmul_whole)


def reset_launches() -> None:
    for fn in _counted():
        fn.launches = 0
        for body in getattr(fn, "body_launches", {}):
            fn.body_launches[body] = 0


def no_training_kernels(run: str) -> None:
    """Serving never runs the training kernels (B3, B4, B5)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba2_ssd import ops as sops
    from repro_torch.kernels.rwkv6_wkv import ops as wops

    for name, fn in (("B3", fops.flash_attention), ("B4", wops.wkv),
                     ("B5", sops.ssd)):
        if fn.launches:
            raise AssertionError(f"{run}: {name} launched {fn.launches} "
                                 f"times in a serving run")


def paged_bodies(run: str) -> dict:
    """B1's and B2's launches by body since the last reset; a serving
    run's bf16 q on a bf16, int8 or fp8 pool must have run the split
    body every time (asserted)."""
    from repro_torch.kernels.paged_attention import ops

    got = {}
    for fn in (ops.paged_attention, ops.paged_prefill_attention):
        if fn.body_launches["split_mma"] != fn.launches or \
                fn.body_launches["cuda_core"]:
            raise AssertionError(f"{run}: {fn.__name__} launched "
                                 f"{fn.launches} times, bodies "
                                 f"{fn.body_launches}: want all split_mma")
        got[fn.__name__] = dict(fn.body_launches)
    return got


def read_launches() -> dict:
    return {fn.__name__: fn.launches for fn in _counted()}


def read_body_launches() -> dict:
    """Launches of each body of the wrappers that have more than one
    (B1, B2, B3, B4, B5, B6)."""
    return {fn.__name__: dict(fn.body_launches) for fn in _counted()
            if hasattr(fn, "body_launches")}


def profile_train_step(art, params, opt, batch) -> dict:
    """Device time of one training step by kernel name, from
    ``torch.profiler`` (CUDA activity only), after one unprofiled step.
    The profiled step runs slower on the host than an unprofiled one, so
    the idle share read here is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    float(art.step_fn(params, opt, batch)[2]["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(art.step_fn(params, opt, batch)[2]["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", 0)
              or getattr(ev, "self_cuda_time_total", 0))
        if us:
            by_name[ev.key] = us / 1e3
    busy = sum(by_name.values())
    kinds = {}
    for k, v in by_name.items():
        kinds[_kernel_kind(k)] = kinds.get(_kernel_kind(k), 0.0) + v
    return {"wall_ms": wall_ms, "device_ms": busy or None,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "by_kind_ms": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:10]}


def _kernel_kind(name: str) -> str:
    """A coarse class of a device kernel's name, for the step breakdown."""
    low = name.lower()
    if "flash_mma_kernel" in name or "flash_fwd_kernel" in name:
        return "B3"
    if any(f"wkv_{k}_kernel" in name for k in ("fwd", "state", "scan", "out")):
        return "B4"
    if any(f"ssd_{k}_kernel" in name for k in ("fwd", "state", "scan", "out")):
        return "B5"
    if any(t in low for t in ("gemm", "nvjet", "cutlass")):
        return "GEMM f32" if "f32f32" in low or "sgemm" in low \
            else "GEMM bf16"
    if "softmax" in low:
        return "softmax"
    if "masked_fill" in low:
        return "masked_fill"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if "reduce" in low:
        return "reductions"
    if "elementwise" in low:
        return "other elementwise"
    return "other"


def train_full_width(cfg, want: dict, B: int, *, kernel, ops_module, plain,
                     tol: dict, tag: str) -> dict:
    """Phases 6, 7 and 8: ``cfg`` (checked against ``want``) at its
    published widths, f32 masters, bf16 compute, remat full, global batch
    ``B`` at seq 4096.  Step 0's loss and grad_norm computed once with
    the kernel and once with its plain version in its place (patched in
    as ``ops_module._forward``: same Function, same backward), at the
    full depth and at 2 layers, held to ``tol``; then 5 steps of
    ``train()`` as a user calls it, the launches of ``kernel`` (the
    counted wrapper) read step by step: one forward and one remat
    recompute a layer; then one profiled step."""
    import contextlib
    import dataclasses
    from unittest import mock

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.launch.train import train
    from repro_torch.optim import adamw

    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise AssertionError(f"{cfg.name} config {got}, want {want}")
    S, n_steps = 4096, 5
    shape = ShapeConfig(f"train_4k cut to batch {B}", S, B, "train")
    L = cfg.n_layers
    name = kernel.__name__

    batch = {k: v.cuda() for k, v in
             SyntheticLM(cfg.vocab, S, B, seed=0).batch_at(0).items()}
    step0 = {}
    for depth in (L, 2):
        c = dataclasses.replace(cfg, n_layers=depth)
        art = steps.build_train(c, shape)
        params = art.init_params(
            torch.Generator(device="cuda").manual_seed(0))
        if depth == L:
            n_params = sum(p.numel() for p in _leaves(params))
        got = {}
        for run in ("kernel", "plain"):
            reset_launches()
            patch = (mock.patch.object(ops_module, "_forward", plain)
                     if run == "plain" else contextlib.nullcontext())
            with patch:
                loss, grads = steps.value_and_grad(art.model.loss, params,
                                                   batch)
            got[run] = {"loss": float(loss),
                        "grad_norm": float(adamw.global_norm(grads)),
                        "launches": kernel.launches}
            del grads
            torch.cuda.empty_cache()
        if got["kernel"]["launches"] != 2 * depth or \
                got["plain"]["launches"] != 0:
            raise AssertionError(f"step 0 at {depth} layers: {name} "
                                 f"launches {got}")
        t = tol[depth]
        k_, p_ = got["kernel"], got["plain"]
        rel = {x: abs(k_[x] - p_[x]) / abs(p_[x])
               for x in ("loss", "grad_norm")}
        got["rel"] = rel
        step0[depth] = got
        log(f"[{tag}] step 0 at {depth} layers, kernel {name}: loss "
            f"{k_['loss']:.6f}, grad_norm {k_['grad_norm']:.6e}; plain "
            f"version: loss {p_['loss']:.6f}, grad_norm "
            f"{p_['grad_norm']:.6e}; relative differences: loss "
            f"{rel['loss']:.3e}, grad_norm {rel['grad_norm']:.3e} "
            f"(tolerances {t})")
        ratio = k_["grad_norm"] / p_["grad_norm"]
        if not (rel["loss"] <= t["loss"]
                and math.isfinite(k_["grad_norm"])
                and rel["grad_norm"] <= t.get("grad_norm", math.inf)
                and 1 / t.get("grad_norm_factor", math.inf) <= ratio
                <= t.get("grad_norm_factor", math.inf)):
            raise AssertionError(f"step 0 at {depth} layers: {name} and "
                                 f"plain differ beyond {t}: {got}")
        del params, art
        torch.cuda.empty_cache()
    del batch

    # The main path: train() as a user calls it, its step function
    # wrapped to read the kernel's launches step by step.
    per_step = []
    build = steps.build_train

    def counting_build(*args, **kwargs):
        art = build(*args, **kwargs)
        step_fn = art.step_fn

        def counted(*a):
            before = kernel.launches
            res = step_fn(*a)
            per_step.append(kernel.launches - before)
            return res

        art.step_fn = counted
        return art

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with mock.patch.object(steps, "build_train", counting_build):
        out = train(cfg, shape, steps=n_steps, seed=0)
    launches = read_launches()
    body_launches = read_body_launches()
    peak = torch.cuda.max_memory_allocated()
    if per_step != [2 * L] * n_steps or launches[name] != n_steps * 2 * L:
        raise AssertionError(
            f"{name} launches per step {per_step} (total {launches[name]}); "
            f"want {2 * L} a step ({L} forward + {L} remat recompute)")
    if any(n for k, n in launches.items() if k != name):
        raise AssertionError(f"other kernels ran in {cfg.name} training: "
                             f"{launches}")
    out_metrics = out["metrics"]
    losses = [m["loss"] for m in out_metrics]
    if len(losses) != n_steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"losses {losses}")
    step_ms = [t * 1e3 for t in out["step_s"]]
    steady = step_ms[1:]
    tok_s = B * S / (statistics.mean(steady) / 1e3)
    for m, ms in zip(out_metrics, step_ms):
        log(f"[{tag}] step {m['step']}: loss {m['loss']:.6f}, grad_norm "
            f"{m['grad_norm']:.6e}, lr {m['lr']:.4e}, wall {ms:.1f} ms")
    log(f"[{tag}] {cfg.name} full width ({n_params} params), B={B} x "
        f"S={S}, remat full: steps 2-{n_steps} {statistics.mean(steady):.1f} "
        f"ms a step (each {', '.join(f'{x:.1f}' for x in steady)}), "
        f"{tok_s:.0f} tokens/s; peak device memory {peak / 2**30:.2f} GiB; "
        f"{name} launches {launches[name]}, per step {per_step} ({L} "
        f"forward + {L} recompute); step 0 loss equal to the kernel "
        f"check's: {losses[0] == step0[L]['kernel']['loss']}")
    del out
    torch.cuda.empty_cache()

    art = steps.build_train(cfg, shape)
    params = art.init_params(torch.Generator(device="cuda").manual_seed(0))
    batch = {k: v.cuda() for k, v in
             SyntheticLM(cfg.vocab, S, B, seed=0).batch_at(0).items()}
    prof = profile_train_step(art, params, art.init_opt(params), batch)
    del params, batch, art
    torch.cuda.empty_cache()
    if prof["device_ms"]:
        log(f"[{tag}] profile of one step: wall {prof['wall_ms']:.1f} ms, "
            f"device busy {prof['device_ms']:.1f} ms (idle share <= "
            f"{prof['idle_share']:.3f}); by kind: " + "; ".join(
                f"{k} {v:.1f}" for k, v in prof["by_kind_ms"].items())
            + "; top: " + "; ".join(
                f"{k[:60]} {v:.1f}" for k, v in prof["top"]))
    else:
        log(f"[{tag}] profile of one step: the profiler saw no device time")
    return {"config": want, "params": n_params, "batch": B, "seq": S,
            "steps": n_steps, "metrics": out_metrics, "step_ms": step_ms,
            "steady_ms": statistics.mean(steady), "tokens_per_s": tok_s,
            "peak_bytes": peak, "launches": launches,
            "body_launches": body_launches, "launches_per_step": per_step,
            "step0": step0, "profile": prof}


def phase_train() -> dict:
    """Phase 6: smollm-360m at its published widths, global batch 8, B3
    at the core of every layer's attention (``train_full_width``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    want = dict(n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
                head_dim=64, d_ff=2560, vocab=49_152, param_dtype="float32",
                compute_dtype="bfloat16", remat=True, q_chunk=1024)
    out = train_full_width(
        get_config("smollm-360m"), want, 8, kernel=fops.flash_attention,
        ops_module=fops,
        plain=lambda q, k, v, causal: fref.flash_attention_ref(
            q, k, v, causal=causal),
        tol=TRAIN_TOL, tag="train")
    # bf16 compute: every launch on the tensor-core body.
    bodies = out["body_launches"]["flash_attention"]
    n = out["launches"]["flash_attention"]
    if bodies != {"cuda_core": 0, "mma": n} or n == 0:
        raise AssertionError(f"smollm training ran B3's bodies {bodies}; "
                             f"want all {n} launches on the mma body")
    log(f"[train] B3 bodies in the training run: {bodies}")
    return out


# ---------------------------------------------------------------------------
# Phase 6b: smoke-width training on the card against the CPU
# ---------------------------------------------------------------------------

def phase_smoke_train() -> dict:
    """Phase 6b (C9, B4 and B5): ``train()`` on the smoke configs of
    qwen3-8b (head_dim 16), smollm-360m (head_dim 20), rwkv6-3b (N = 16)
    and mamba2-2.7b (P = 32, N = 16), 3 steps at the training CLI's smoke
    shape (batch 8 x 128), on the card and on the CPU from the same
    weights; the losses held to SMOKE_TRAIN_TOL."""
    import contextlib
    import io
    from unittest import mock

    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.train import train
    from repro_torch.models import get_model
    from repro_torch.models.transformer import param_dtype
    from repro_torch.tree import map_tree

    shape = ShapeConfig("smoke_train", 128, 8, "train")
    n_steps = 3
    build = steps.build_train

    def same_weights(*args, **kwargs):
        # A CUDA generator draws other numbers than a CPU one from the
        # same seed: both runs draw the weights on the CPU, seed 0.
        art = build(*args, **kwargs)
        cpu = get_model(art.cfg, device="cpu")
        art.init_params = lambda generator: map_tree(
            lambda t: t.to(art.model.device),
            cpu.init(torch.Generator().manual_seed(0),
                     dtype=param_dtype(art.cfg)))
        return art

    out = {}
    for arch, kernel in (("qwen3-8b", "flash_attention"),
                         ("smollm-360m", "flash_attention"),
                         ("rwkv6-3b", "wkv"),
                         ("mamba2-2.7b", "ssd")):
        cfg = get_smoke(arch)
        runs = {}
        for dev in ("cuda", "cpu"):
            reset_launches()
            with contextlib.redirect_stdout(io.StringIO()), \
                    mock.patch.object(steps, "build_train", same_weights):
                res = train(cfg, shape, steps=n_steps, seed=0, device=dev)
            runs[dev] = {"losses": [m["loss"] for m in res["metrics"]],
                         "grad_norms": [m["grad_norm"]
                                        for m in res["metrics"]],
                         "launches": read_launches()}
        # Smoke configs run without remat: one launch a layer a step.
        want = {k: 0 for k in runs["cuda"]["launches"]}
        want[kernel] = n_steps * cfg.n_layers
        if runs["cuda"]["launches"] != want or any(
                runs["cpu"]["launches"].values()):
            raise AssertionError(f"{arch} smoke training launches: card "
                                 f"{runs['cuda']['launches']}, cpu "
                                 f"{runs['cpu']['launches']}; want {want} "
                                 f"on the card, none on the CPU")
        rel = [abs(a - b) / abs(b) for a, b in
               zip(runs["cuda"]["losses"], runs["cpu"]["losses"])]
        if len(rel) != n_steps or not max(rel) <= SMOKE_TRAIN_TOL:
            raise AssertionError(f"{arch} smoke training: card losses "
                                 f"{runs['cuda']['losses']} vs CPU "
                                 f"{runs['cpu']['losses']}")
        log(f"[train] {arch} smoke, batch 8 x 128, 3 steps: card losses "
            + ", ".join(f"{x:.6f}" for x in runs["cuda"]["losses"])
            + "; CPU " + ", ".join(f"{x:.6f}" for x in runs["cpu"]["losses"])
            + f"; at most {max(rel):.3e} apart (tolerance "
            f"{SMOKE_TRAIN_TOL}); {kernel} launches on the card "
            f"{want[kernel]}")
        out[arch] = {**runs, "rel": rel}
    return out


# ---------------------------------------------------------------------------
# Phase 7: train rwkv6-3b at full width
# ---------------------------------------------------------------------------

def phase_rwkv_train() -> dict:
    """Phase 7: rwkv6-3b at its published widths, global batch
    RWKV_BATCH, B4 at the core of every layer's time-mix
    (``train_full_width``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_wkv import ops as wops
    from repro_torch.kernels.rwkv6_wkv import ref as wref

    want = dict(n_layers=32, d_model=2560, d_ff=8960, vocab=65_536,
                rwkv_head_dim=64, param_dtype="float32",
                compute_dtype="bfloat16", remat=True)
    out = train_full_width(
        get_config("rwkv6-3b"), want, RWKV_BATCH, kernel=wops.wkv,
        ops_module=wops,
        plain=lambda r, k, v, lw, u, s0, Q: wref.wkv_chunked_ref(
            r, k, v, lw, u, init_state=s0, chunk=Q),
        tol=RWKV_TRAIN_TOL, tag="rwkv")
    all_on_chunk_body(out, "wkv", "rwkv")
    return out


def all_on_chunk_body(out: dict, wrapper: str, tag: str) -> None:
    """Phases 7 and 8: every launch of the training run on the chunk
    body (asserted)."""
    bodies = out["body_launches"][wrapper]
    n = out["launches"][wrapper]
    if bodies != {"cuda_core": 0, "chunk_tf32x3": n} or n == 0:
        raise AssertionError(f"{tag} training ran {wrapper}'s bodies "
                             f"{bodies}; want all {n} launches on the "
                             f"chunk_tf32x3 body")
    log(f"[{tag}] {wrapper} bodies in the training run: {bodies}")


# ---------------------------------------------------------------------------
# Phase 8: train mamba2-2.7b at full width
# ---------------------------------------------------------------------------

def phase_mamba_train() -> dict:
    """Phase 8: mamba2-2.7b at its published widths, global batch
    MAMBA_BATCH, B5 at the core of every layer (``train_full_width``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba2_ssd import ops as sops
    from repro_torch.kernels.mamba2_ssd import ref as sref

    want = dict(n_layers=64, d_model=2560, vocab=50_288, ssm_state=128,
                ssm_head_dim=64, ssm_expand=2, conv_width=4,
                param_dtype="float32", compute_dtype="bfloat16", remat=True)
    out = train_full_width(
        get_config("mamba2-2.7b"), want, MAMBA_BATCH, kernel=sops.ssd,
        ops_module=sops,
        plain=lambda x, dt, A, Bs, Cs, s0, Q: sref.ssd_chunked_ref(
            x, dt, A, Bs, Cs, init_state=s0, chunk=Q),
        tol=MAMBA_TRAIN_TOL, tag="mamba")
    all_on_chunk_body(out, "ssd", "mamba")
    return out


# ---------------------------------------------------------------------------
# Phase 9: the paper's ladder on the card
# ---------------------------------------------------------------------------

def phase_paper_ladder() -> dict:
    """Phase 9: ``ops.matmul(a, b, level)`` for O0..O5 at MachSuite's
    1024^3 and O3..O5 at 4096^3 through the public wrapper, one B7 or B6
    launch a call (asserted), each output held to its rung's plain
    version; the Fig. 4 analogue (device ms per rung, speedup over O0
    and over the rung before, beside the paper model's); then
    ``machsuite.gemm.run`` at every level on the card at the reference
    tests' scale (32 x 32) held to the float64 oracle."""
    import numpy as np
    import torch
    from repro_torch.core import costmodel
    from repro_torch.kernels.tiled_matmul import ops
    from repro_torch.machsuite import gemm

    n, nb = LADDER_N, LADDER_BIG
    a, b = matmul_case(n, n, n, seed=90)
    big = matmul_case(nb, nb, nb, seed=91)
    calls = [(level, n, (a, b)) for level in range(6)] + [
        (level, nb, big) for level in (3, 4, 5)]
    reset_launches()
    outs = []
    for level, size, (x, y) in calls:
        before = (ops.matmul_whole.launches, ops.matmul_tiled.launches,
                  dict(ops.matmul_tiled.body_launches))
        outs.append(ops.matmul(x, y, level))
        got = (ops.matmul_whole.launches - before[0],
               ops.matmul_tiled.launches - before[1])
        if got != ((1, 0) if level == 0 else (0, 1)):
            raise AssertionError(f"O{level} {size}^3: launches (B7, B6) "
                                 f"{got}")
        # O5's bf16 tiles run the wgmma body, O3 and O4 (a block per
        # tile) the 3xTF32 body, O1 and O2 the CUDA cores.
        which = ("wgmma" if level == 5 else "tf32x3" if level >= 3
                 else "cuda_core")
        if level and ops.matmul_tiled.body_launches != {
                **before[2], which: before[2][which] + 1}:
            raise AssertionError(f"O{level} {size}^3: B6 bodies "
                                 f"{ops.matmul_tiled.body_launches}, want "
                                 f"one more {which}")
    torch.cuda.synchronize()
    launches = read_launches()
    body_launches = read_body_launches()["matmul_tiled"]
    log(f"[paper] B6 bodies in the ladder: {body_launches}")
    if (launches["matmul_whole"], launches["matmul_tiled"]) != (1, 8) or any(
            v for k, v in launches.items()
            if k not in ("matmul_whole", "matmul_tiled")):
        raise AssertionError(f"ladder launches {launches}")
    for (level, size, (x, y)), out in zip(calls, outs):
        _, plain, _, _, _ = rung_call(level, x, y)
        want = plain()
        err = float((out - want).abs().max())
        if not err <= MATMUL_TOL * float(want.abs().max()):
            raise AssertionError(f"ladder O{level} {size}^3 off its plain "
                                 f"version by {err:.3e}")
    del outs

    ms = {}
    for level, size, (x, y) in calls:
        slow = level in SLOW_RUNGS
        ms[f"O{level} {size}^3"] = time_ms(
            lambda: ops.matmul(x, y, level), reps=2 if slow else 30,
            warmup=1 if slow else 3)
    # O2 -> O3 is now two steps: PE duplication (a block per tile, on the
    # CUDA cores) and the tensor cores (3xTF32).  The CUDA-core body at
    # O3's blocks, grid and stage, launched straight through the binding
    # (not counted), reads the first step apart.
    for size, (x, y) in ((n, (a, b)), (nb, big)):
        _, _, _, (xc, yc), blk = rung_call(3, x, y)
        _, core = cuda_core_at(xc, yc, blk)
        ms[f"O3 {size}^3 cuda_core"] = time_ms(core, reps=10)
    model = costmodel.refinement_curve(costmodel.MACHSUITE_PROFILES["gemm"])
    log(f"[paper] Fig. 4 analogue on the card, {n}^3 f32 (O5 bf16 "
        f"operands), device ms through ops.matmul; the analytic model's "
        f"speedups are the paper's 2012 FPGA platform, not the card:")
    rows = []
    for level in range(6):
        t = ms[f"O{level} {n}^3"]
        prev = ms[f"O{level - 1} {n}^3"] if level else t
        m0 = model[0]["kernel_s"] / model[level]["kernel_s"]
        rows.append({"level": level, "ms": t, "x_vs_O0": ms[f"O0 {n}^3"] / t,
                     "x_vs_prev": prev / t, "model_x_vs_O0": m0})
        log(f"[paper]   O{level}: {t:10.4f} ms  {rows[-1]['x_vs_O0']:9.1f}x "
            f"vs O0  {rows[-1]['x_vs_prev']:7.2f}x vs O{max(level - 1, 0)}"
            f"  (model {m0:.1f}x vs O0)")
    for level in (3, 4, 5):
        log(f"[paper]   O{level} at {nb}^3: {ms[f'O{level} {nb}^3']:.4f} ms")
    split = {}
    for size in (n, nb):
        core = ms[f"O3 {size}^3 cuda_core"]
        split[f"{size}^3"] = {
            "O3_cuda_core_ms": core,
            "pe_duplication_x": (ms[f"O2 {size}^3"] / core
                                 if size == n else None),
            "tensor_core_x": core / ms[f"O3 {size}^3"]}
        pe = split[f"{size}^3"]["pe_duplication_x"]
        log(f"[paper]   O2 -> O3 at {size}^3 in two steps: "
            + (f"PE duplication (O2 -> O3 on the CUDA cores, {core:.4f} ms)"
               f" {pe:.2f}x, " if pe else
               f"O3 on the CUDA cores {core:.4f} ms, ")
            + f"then the tensor cores (3xTF32) "
            f"{split[f'{size}^3']['tensor_core_x']:.2f}x")
    del a, b, big
    torch.cuda.empty_cache()

    inp = gemm.make_inputs(np.random.default_rng(0), 32 / 1024)
    want = gemm.oracle(**inp)
    machsuite = {}
    for level in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gemm.run(level, **inp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if out.device.type != "cuda":
            raise AssertionError(f"gemm O{level} ran on {out.device}")
        np.testing.assert_allclose(out.cpu().numpy(), want, rtol=2e-4,
                                   atol=1e-5, err_msg=f"gemm O{level}")
        machsuite[f"O{level}"] = {
            "wall_s": wall,
            "max_abs_err": float(np.abs(out.cpu().numpy() - want).max())}
    log(f"[paper] machsuite gemm 32x32 on the card, every level held to "
        f"the oracle (rtol 2e-4, atol 1e-5); wall s: "
        f"{ {k: round(v['wall_s'], 4) for k, v in machsuite.items()} }")
    return {"launches": launches, "body_launches": body_launches, "ms": ms,
            "fig4": rows, "o2_to_o3": split, "machsuite_gemm": machsuite}


# ---------------------------------------------------------------------------
# Phase 10: the autotuner's measured serving walk
# ---------------------------------------------------------------------------

def phase_serving_walk(card: str) -> dict:
    """Phase 10: ``python -m repro_torch.autotune --serve --arch
    qwen3-8b`` in this process at the reference's defaults (smoke width,
    batch 4, max_seq 48, 12 requests, 8 new tokens, 3 repeats, O0 -> O7
    with the paged-attention, prefill-chunk, draft-K and pool-dtype races
    on wall clock).  Each round's level, wall, tok/s and the races'
    walls are logged; the tokens must be identical across every bf16
    rung the walk kept, and the paged-attention race must have run B1
    (its kernel engine runs the workload whichever wins), all on the
    split body."""
    from repro_torch.autotune.__main__ import main as autotune_main
    from repro_torch.autotune.trajectory import (read_trajectory,
                                                 trajectory_path)

    t_phase = time.perf_counter()
    out_dir = ROOT / "chiprun_out" / "autotune"
    reset_launches()
    rc = autotune_main(["--serve", "--arch", "qwen3-8b", "--out",
                        str(out_dir)])
    launches = read_launches()
    bodies = paged_bodies("10 serving walk")
    no_training_kernels("10 serving walk")
    if rc != 0:
        raise AssertionError(f"10: the serving walk returned {rc}: tokens "
                             f"differ across its rungs")
    recs = read_trajectory(trajectory_path("serve/qwen3-8b", str(out_dir)))
    metas = [r["measurement"]["meta"] for r in recs]
    if [m["level"] for m in metas] != list(range(8)):
        raise AssertionError(f"10: walked {[m['level'] for m in metas]}")
    base = metas[0]["generated"]
    kept_bf16 = [m["level"] for m in metas if m["kv_dtype"] == "bf16"]
    if any(m["generated"] != base for m in metas
           if m["kv_dtype"] == "bf16"):
        raise AssertionError("10: tokens differ across the kept bf16 rungs")
    if not launches["paged_attention"]:
        raise AssertionError(f"10: the paged_attn race never launched B1: "
                             f"{launches}")
    rounds = []
    for rec, m in zip(recs, metas):
        row = {k: m.get(k) for k in (
            "level", "tok_per_s", "ticks", "layout", "paged_attn",
            "prefill_chunk", "kv_dtype", "ttft_s", "itl_s", "kv_capacity",
            "draft_k", "accept_rate", "paged_attn_walls",
            "prefill_chunk_walls", "draft_k_walls", "kv_dtype_walls")}
        row["wall_s"] = rec["measurement"]["compute_s"]
        rounds.append(row)
        races = "; ".join(
            f"{k[:-6]} " + ", ".join(f"{a}: {b:.4f} s" for a, b in
                                     m[k].items())
            for k in ("paged_attn_walls", "prefill_chunk_walls",
                      "draft_k_walls", "kv_dtype_walls") if m.get(k))
        log(f"[walk] O{m['level']} on {card}: wall {row['wall_s']:.4f} s, "
            f"{m['tok_per_s']:.1f} tok/s, {m['ticks']} ticks, layout "
            f"{m['layout']}"
            + (f", kept paged_attn {m['paged_attn']!r}, chunk "
               f"{m['prefill_chunk']}, kv {m['kv_dtype']}"
               if m["level"] >= 6 else "")
            + (f", K={m.get('draft_k')}" if m["level"] == 7 else "")
            + (f"; races: {races}" if races else ""))
    wall = time.perf_counter() - t_phase
    log(f"[walk] tokens identical across the kept bf16 rungs "
        f"{kept_bf16}; launches B1 {launches['paged_attention']}, B2 "
        f"{launches['paged_prefill_attention']}, all split; done in "
        f"{wall:.1f} s")
    return {"card": card, "rounds": rounds, "kept_bf16": kept_bf16,
            "launches": {k: launches[k] for k in (
                "paged_attention", "paged_prefill_attention")},
            "body_launches": bodies, "wall_s": wall}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    log(f"[card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {nvcc}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = _build.build_all(kernels.SOURCES)
    log(f"[build] {len(libs)} kernel(s) built in "
        f"{time.perf_counter() - t0:.1f} s")
    for path, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if any(w in line for w in ("properties for", "registers",
                                       "spill")):
                log(f"[build] {Path(path).name}: {line.strip()}")

    walls = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t
        log(f"[wall] phase {name}: {walls[name]:.1f} s")
        return out

    b1, b1_main = timed("3", phase_kernel)
    b2 = timed("3b", phase_prefill_kernel, b1_main)
    del b1_main
    b1q, b2q = timed("3g", phase_quant_kernel)
    b3 = timed("3c", phase_flash_kernel)
    b3["widths"] = timed("3c widths", phase_flash_widths)
    b4 = timed("3d", phase_wkv_kernel)
    b5 = timed("3e", phase_ssd_kernel)
    b6, b7 = timed("3f", phase_matmul_kernel)
    ladder = timed("4", phase_ladder)
    full = timed("5", phase_full, card)
    torch.cuda.empty_cache()
    trained = timed("6", phase_train)
    smoke_trained = timed("6b", phase_smoke_train)
    rwkv = timed("7", phase_rwkv_train)
    mamba = timed("8", phase_mamba_train)
    torch.cuda.empty_cache()
    paper = timed("9", phase_paper_ladder)
    walk = timed("10", phase_serving_walk, card)
    # Launches on the main path: B1 in run (b), B2 in run (d); each
    # run's counts beside them.
    runs = {"b": {"paged_attention": full["kernel_launches"],
                  "paged_prefill_attention": full["b2_launches"]},
            "d": full["chunked"]["launches"], "e": full["spec"]["launches"],
            "5s closed": full["server"]["closed"]["launches"],
            **{f"5s {tag}": row["launches"]
               for tag, row in full["server"]["traces"].items()},
            "5s insert": full["server"]["insert"]["inserted"]["launches"],
            "10 walk": walk["launches"]}
    for k in (b1, b2):
        k["launches_by_run"] = {run: n[k["name"]] for run, n in runs.items()}
    b1["launches"] = runs["b"]["paged_attention"]
    b2["launches"] = runs["d"]["paged_prefill_attention"]
    for k, run in ((b1, full), (b2, full["chunked"])):
        for body, count in run["body_launches"][k["name"]].items():
            k[f"launches_{body}"] = count
    # The quantized branch on its main path: phase 5f's narrow runs (not
    # its bf16 batch-16 run), B1q in the int8 run (b), B2q in the int8
    # run (d).
    narrow = {run: n for run, n in full["narrow"]["runs"].items()
              if "bf16" not in run}
    for k, wrapper, main_run in ((b1q, "paged_attention", "b int8"),
                                 (b2q, "paged_prefill_attention", "d int8")):
        k["launches_by_run"] = {run: n["launches"][wrapper]
                                for run, n in narrow.items()}
        k["launches"] = k["launches_by_run"][main_run]
        for body, count in narrow[main_run]["body_launches"][wrapper].items():
            k[f"launches_{body}"] = count
    # B3 on its main path: phase 6's train() run, by body.
    b3["launches"] = trained["launches"]["flash_attention"]
    b3["launches_by_run"] = {"train": b3["launches"]}
    for body, count in trained["body_launches"]["flash_attention"].items():
        b3[f"launches_{body}"] = count
    # B4 on its main path: phase 7's train() run.
    b4["launches"] = rwkv["launches"]["wkv"]
    b4["launches_by_run"] = {"train rwkv6-3b": b4["launches"]}
    for body, count in rwkv["body_launches"]["wkv"].items():
        b4[f"launches_{body}"] = count
    # B5 on its main path: phase 8's train() run.
    b5["launches"] = mamba["launches"]["ssd"]
    b5["launches_by_run"] = {"train mamba2-2.7b": b5["launches"]}
    for body, count in mamba["body_launches"]["ssd"].items():
        b5[f"launches_{body}"] = count
    # B6 and B7 on their main path: phase 9's ladder.
    for k, wrapper in ((b6, "matmul_tiled"), (b7, "matmul_whole")):
        k["launches"] = paper["launches"][wrapper]
        k["launches_by_run"] = {"paper ladder": k["launches"]}
    for body, count in paper["body_launches"].items():
        b6[f"launches_{body}"] = count
    kerns = [b1, b2, b1q, b2q, b3, b4, b5, b6, b7]

    result = {"card": card, "kernels": kerns, "ladder": ladder,
              "full": full, "train": trained, "smoke_train": smoke_trained,
              "train_rwkv": rwkv, "train_mamba": mamba, "paper": paper,
              "walk": walk, "walls": walls,
              "seconds": time.perf_counter() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kerns}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
