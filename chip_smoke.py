#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

  1. card   — the card's name and power limit (nvidia-smi), torch, CUDA
              and nvcc versions;
  2. build  — compile every kernel of the port from this checkout's
              sources with nvcc, all at once;
  3. kernel — the paged-decode CUDA kernel against its plain PyTorch
              version at the main path's shapes (qwen3-8b decode: B=8,
              H=32, KV=8, D=128, T=16, ragged lengths 1..2048, shuffled
              pool rows, NaN in the NULL block, unused rows and stale
              tails) and at edges (length 1, lengths a multiple of T,
              G=1, f32 pools, a zero-length slot); times of the kernel,
              the plain version and one PyTorch library call
              (``scaled_dot_product_attention`` on a pre-gathered dense
              view — a yardstick the port never calls), and the bound;
  4. ladder — smoke-width qwen3-8b served at O2, O4, O5, O6-gather and
              O6-kernel on the card: identical greedy tokens on a mixed
              request set with mid-flight arrivals and planted eos;
  5. full   — qwen3-8b at its published widths in bf16 with random
              weights from a seed: (a) a teacher-forced run of the gather
              step and the kernel step over a shared random KV prefix,
              logits compared tick by tick, at 2 layers (tight) and 36
              (held to the drift of the kernel's plain version); (b)
              ``serve_demo`` at O6 with ``paged_attn="kernel"`` answering
              8 requests, with the kernel's launches counted (they must
              equal layers x ticks);
              (c) a ``torch.profiler`` reading of device time per tick.

Prints the card line and a JSON object of kernel numbers on lines before
the last, writes the detailed numbers to ``chiprun_out/chip_smoke.json``,
and ends with ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the rest of this repository beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
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

KERNEL_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
KERNEL_REPLACES = "src/repro/kernels/paged_attention/kernel.py:318"
# |kernel - plain| <= ATOL + RTOL * |plain|: two bf16 ulps for bf16
# outputs; reduction-order noise for f32.
TOL = {"bf16": (1e-3, 1.6e-2), "f32": (1e-5, 1e-4)}


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
    its operands in HBM, as a decode layer does."""
    import torch

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

def paged_case(B, H, KV, D, T, lengths, *, dtype, q_dtype=None, seed=0,
               extra_rows=16, device="cuda"):
    """A pool whose referenced rows are shuffled, whose NULL block,
    unused rows and per-slot tails past the length hold NaN."""
    import numpy as np
    import torch

    r = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int32)
    nb = max(1, -(-int(lengths.max()) // T))
    R = 1 + B * nb + extra_rows
    g = torch.Generator(device=device).manual_seed(seed)
    kp = torch.randn((R, T, KV, D), generator=g, device=device).to(dtype)
    vp = torch.randn((R, T, KV, D), generator=g, device=device).to(dtype)
    q = torch.randn((B, H, D), generator=g, device=device).to(
        q_dtype or dtype)
    tables = np.zeros((B, nb), np.int32)
    free = list(range(1, R))
    r.shuffle(free)
    used = set()
    for b in range(B):
        for j in range(-(-int(lengths[b]) // T)):
            tables[b, j] = free.pop()
            used.add(int(tables[b, j]))
    for row in range(R):
        if row not in used:
            kp[row] = float("nan")
            vp[row] = float("nan")
    for b in range(B):
        L = int(lengths[b])
        if L % T:
            kp[int(tables[b, L // T]), L % T:] = float("nan")
            vp[int(tables[b, L // T]), L % T:] = float("nan")
    return (q, kp, vp, torch.tensor(tables, device=device),
            torch.tensor(lengths, device=device))


def check_case(name, case, kind):
    """Kernel vs plain on one case; returns max |kernel - plain|."""
    import torch
    from repro_torch.kernels.paged_attention import ops, ref

    got = ops.paged_attention(*case)
    torch.cuda.synchronize()
    want = ref.paged_attention_ref(*case)
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"kernel case {name}: non-finite output")
    err = (got - want).abs()
    atol, rtol = TOL[kind]
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(
            f"kernel case {name}: {int(bad.sum())} elements beyond "
            f"{atol} + {rtol}*|plain| (max err {float(err.max())})")
    log(f"[kernel] {name}: max |kernel - plain| = {float(err.max()):.3e} "
        f"(tolerance {atol} + {rtol}*|plain|)")
    return float(err.max())


def phase_kernel() -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops, ref

    B, H, KV, D, T = 8, 32, 8, 128, 16
    r = np.random.default_rng(0)
    lengths = r.integers(1, 2049, B)
    lengths[0], lengths[-1] = 1, 2048
    bf = torch.bfloat16
    main = paged_case(B, H, KV, D, T, lengths, dtype=bf)
    err = check_case(f"main path B={B} H={H} KV={KV} D={D} T={T} lengths="
                     f"{lengths.tolist()}", main, "bf16")
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

    # Times at the main path's shapes.
    ms = time_ms(lambda: ops.paged_attention(*main))
    plain_ms = time_ms(lambda: ref.paged_attention_ref(*main))
    q, kp, vp, tables, lens = main
    S = tables.shape[1] * T
    rows = tables.reshape(-1).long()
    kd = torch.nan_to_num(kp.index_select(0, rows)).reshape(
        B, S, KV, D).permute(0, 2, 1, 3).contiguous()
    vd = torch.nan_to_num(vp.index_select(0, rows)).reshape(
        B, S, KV, D).permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(S, device="cuda")[None] < lens[:, None])[
        :, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask, enable_gqa=True))

    n_tok = int(lens.sum())
    blocks = int(sum(-(-int(x) // T) for x in lens.tolist()))
    nbytes = (q.numel() * q.element_size() * 2           # q in, out
              + 2 * n_tok * KV * D * kp.element_size()   # K and V read
              + blocks * 4 + B * 4)                      # tables, lengths
    flops = 4 * H * D * n_tok                            # QK and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    out = {
        "name": "paged_attention",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }
    log(f"[kernel] main path: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (sdpa on a gathered view) {library_ms:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}: {nbytes} B, "
        f"{flops} FLOP)")
    return out


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
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core.optlevel import BestEffortConfig, OptLevel
    from repro_torch.models import get_model
    from repro_torch.serving import DecodeEngine

    cfg = get_smoke("qwen3-8b")
    model = get_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(1)
    mix = [(rng.integers(1, cfg.vocab, int(rng.integers(1, 12))).tolist(),
            int(rng.integers(1, 8))) for _ in range(10)]
    rungs = {
        "O5": dict(level=OptLevel.O5),
        "O2": dict(level=OptLevel.O2),
        "O4": dict(level=OptLevel.O4),
        "O6-gather": dict(level=OptLevel.O6, kv_block_size=4,
                          kv_pool_blocks=20),
        "O6-kernel": dict(level=OptLevel.O6, kv_block_size=4,
                          kv_pool_blocks=20, paged_attn="kernel"),
    }

    def run(rung, **kw):
        eng = DecodeEngine(model, params, batch_size=4, max_seq=32,
                           config=BestEffortConfig(**rungs[rung]))
        return drive(eng, mix, **kw)

    first = run("O5")
    eos = {k: g[len(g) // 2] for k, g in enumerate(first)
           if k % 2 == 0 and len(g) > 1}
    ref = run("O5", eos=eos, late_from=6)
    for rung in rungs:
        got = run(rung, eos=eos, late_from=6)
        if got != ref:
            raise AssertionError(f"ladder: {rung} tokens {got} != O5 {ref}")
        log(f"[ladder] {rung}: {sum(map(len, got))} tokens identical to O5")
    return {"requests": len(mix), "tokens": sum(map(len, ref)),
            "rungs": list(rungs)}


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
                  warm=24, ticks=8) -> dict:
    """Device time per decode tick by kernel name, from ``torch.profiler``
    (CUDA activity only, to keep host overhead down) over ``ticks`` ticks
    of a fresh O6-kernel engine serving ``reqs``, after ``warm`` ticks.
    Profiled ticks run slower on the host than unprofiled ones, so the
    idle share read here is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.optlevel import BestEffortConfig, OptLevel
    from repro_torch.serving import DecodeEngine, Request

    eng = DecodeEngine(model, params, batch_size=B, max_seq=max_seq,
                       config=BestEffortConfig(
                           level=OptLevel.O6, paged_attn="kernel",
                           kv_block_size=T, kv_pool_blocks=pool_blocks))
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
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", 0)
              or getattr(ev, "self_cuda_time_total", 0))
        if us:
            by_name[ev.key] = us / 1e3 / ticks
    busy = sum(by_name.values())
    paged = sum(v for k, v in by_name.items() if "paged_decode_kernel" in k)
    return {"ticks": ticks, "after_ticks": warm, "wall_ms_per_tick": wall_ms,
            "device_ms_per_tick": busy if busy else None,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "paged_kernel_ms_per_tick": paged if busy else None,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}


def first_layers(cfg, params, n: int):
    """The config and param views of the first ``n`` layers."""
    import dataclasses

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:n]

    return (dataclasses.replace(cfg, n_layers=n),
            dict(params, layers=cut(params["layers"])))


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
    ops.paged_attention.launches = 0
    out = serve_demo(cfg, batch_size=B, max_seq=max_seq, n_requests=n_req,
                     level=OptLevel.O6, paged_attn="kernel",
                     kv_block_size=T, kv_pool_blocks=pool_blocks,
                     params=params, **kw)
    launches = ops.paged_attention.launches
    peak = torch.cuda.max_memory_allocated()
    if out["paged_attn"] != "kernel":
        raise AssertionError(f"full width: served through "
                             f"{out['paged_attn']}")
    if launches != cfg.n_layers * out["ticks"]:
        raise AssertionError(f"full width: {launches} kernel launches, want "
                             f"{cfg.n_layers} x {out['ticks']} ticks")
    fin = out["finished"]
    if len(fin) != n_req or any(len(r.generated) != 32 for r in fin):
        raise AssertionError("full width: not every request got 32 tokens")
    vp = model.defs()["lm_head"].shape[1]
    if any(not 0 <= t < vp for r in fin for t in r.generated):
        raise AssertionError("full width: token id out of range")
    prof = profile_ticks(model, params, reqs, B=B, max_seq=max_seq, T=T,
                         pool_blocks=pool_blocks)
    if prof["device_ms_per_tick"] is None:
        log("[full] profile: the profiler recorded no device time "
            "(not measured)")
    else:
        log(f"[full] profile of {prof['ticks']} ticks after "
            f"{prof['after_ticks']}: wall {prof['wall_ms_per_tick']:.2f} "
            f"ms/tick, device busy {prof['device_ms_per_tick']:.2f} ms/tick "
            f"(idle share <= {prof['idle_share']:.3f}), paged kernel "
            f"{prof['paged_kernel_ms_per_tick']:.3f} ms/tick; top: "
            + "; ".join(f"{k[:60]} {v:.3f}" for k, v in prof["top"]))
    res = {
        "card": card, "batch": B, "max_seq": max_seq, "requests": n_req,
        "prompt_lens": sorted(len(p) for p, _ in reqs), "new_tokens": 32,
        "ticks": out["ticks"], "tokens": out["tokens"],
        "wall_s": out["wall_s"], "tok_per_s": out["tok_per_s"],
        "ms_per_tick": out["wall_s"] / out["ticks"] * 1e3,
        "kernel_launches": launches, "peak_bytes": peak,
        "pool": out["pool"], "teacher_forced": tf, "profile": prof,
    }
    log(f"[full] serve O6/kernel on {card}: {n_req} requests (prompts "
        f"{res['prompt_lens']}, 32 new each), {out['tokens']} tokens in "
        f"{out['ticks']} ticks / {out['wall_s']:.2f} s = "
        f"{out['tok_per_s']:.1f} tok/s ({res['ms_per_tick']:.2f} ms/tick), "
        f"kernel launches {launches} = {cfg.n_layers} x {out['ticks']}, "
        f"peak {peak / 2**30:.2f} GiB, pool {out['pool']['pool_rows']} rows "
        f"x {T} tokens ({out['pool']['pool_mb']:.1f} MiB)")
    return res


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
            if "registers" in line or "spill" in line:
                log(f"[build] {Path(path).name}: {line.strip()}")

    kern = phase_kernel()
    ladder = phase_ladder()
    full = phase_full(card)
    kern["launches"] = full["kernel_launches"]

    result = {"card": card, "kernels": [kern], "ladder": ladder,
              "full": full, "seconds": time.perf_counter() - t_start}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": [kern]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
