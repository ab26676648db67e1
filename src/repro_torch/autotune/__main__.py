"""CLI for the closed-loop autotuner.

MachSuite kernels (the paper's analytic model, instant):

  PYTHONPATH=src python -m repro_torch.autotune --kernel gemm
  PYTHONPATH=src python -m repro_torch.autotune --kernel all --frontier

The serving engine itself (measured tokens/sec, smoke config, the full
O0->O7 ladder walk — O6 races the paged-attention implementation, the
prefill chunk and the pool dtype, O7 the draft window K in {0,2,4,8},
each kept only when it wins), on the card, or on the CPU with
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.autotune --serve --arch qwen3-8b

Each run prints the per-round walk and writes a JSONL trajectory under
``experiments/autotune/`` (or ``--out``).  The reference's LM cost twin
(``--arch`` without ``--serve``) is still to port and raises
``NotImplementedError`` naming ROADMAP A19 and A20.
"""

import argparse
import os
import sys


def _run_one(backend, args, *, ladder: bool = False):
    from repro_torch.autotune.trajectory import render_rounds, write_trajectory
    from repro_torch.autotune.tuner import autotune

    result = autotune(backend, frontier=args.frontier, ladder=ladder,
                      max_rounds=args.max_rounds)
    path = write_trajectory(result, out_dir=args.out)
    print(f"== {result.target} ({result.mode}) ==")
    print(render_rounds(result.to_records()))
    if result.rejected:
        print(f"VERDICT: REJECT — {result.target} is communication-bound "
              "(paper Table 5); no refinement attempted")
    else:
        print(f"VERDICT: {result.final_label} via "
              f"{' -> '.join(result.steps_taken) or 'no steps'} "
              f"({result.final_speedup:.1f}x vs start)")
    print(f"trajectory: {os.path.relpath(path)}")
    return result


def _serve(args) -> int:
    """The measured serving walk; returns 1 unless the generated tokens
    are identical across the bf16 rungs (narrow rungs: within their
    tolerance contract)."""
    from repro_torch.autotune.measurement import ServingBackend

    backend = ServingBackend(
        args.arch, batch_size=args.batch, max_seq=args.max_seq,
        n_requests=args.requests, max_new=args.max_new,
        repeats=args.repeats, policy=args.policy,
        kv_block_size=args.kv_block,
        kv_pool_blocks=args.kv_pool_blocks,
        paged_attn=args.paged_attn, draft_model=args.draft_model,
        draft_k=args.draft_k, kv_dtype=args.kv_dtype,
        traffic_rate=args.traffic_rate,
        traffic_pattern=args.traffic_pattern,
        ttft_slo_s=args.ttft_slo_ms / 1e3,
        tpot_slo_s=args.tpot_slo_ms / 1e3, device=args.device)
    result = _run_one(backend, args, ladder=True)
    levels = [r.measurement.meta for r in result.rounds]
    # Bit-identity is the contract for bf16 rungs only; a rung that
    # shipped a narrow pool is held to its tolerance contract
    # against the bf16 baseline instead.
    from repro_torch.serving.kvquant import (token_agreement,
                                             tolerance_contract)
    base = levels[0]["generated"]
    same = True
    for m in levels:
        if m.get("kv_dtype", "bf16") == "bf16":
            same = same and m["generated"] == base
        else:
            tc = tolerance_contract(m["kv_dtype"])
            same = same and (token_agreement(base, m["generated"])
                             >= tc["min_agreement"])
    print(f"generated tokens identical across levels "
          f"(narrow rungs: within tolerance contract): {same}")
    caps = {m["level"]: m.get("kv_capacity") for m in levels}
    print(f"decode-cache capacity (token positions) per level: {caps}")
    cells = {m["level"]: f"{m.get('layout')}x{m.get('devices')}dev"
             for m in levels}
    print(f"layout x placement per level: {cells}")
    for m in levels:
        if m.get("traffic"):
            t = m["traffic"]
            print(f"O{m['level']} traffic @{t['rate_rps']:g}/s "
                  f"({t['pattern']}): goodput {t['goodput_rps']:.2f}/s "
                  f"({t['goodput_frac'] * 100:.0f}%), ttft p50/p99 "
                  f"{t['ttft_p50_s'] * 1e3:.0f}/"
                  f"{t['ttft_p99_s'] * 1e3:.0f}ms, tpot p50/p99 "
                  f"{t['tpot_p50_s'] * 1e3:.1f}/"
                  f"{t['tpot_p99_s'] * 1e3:.1f}ms")
    for m in levels:
        if m.get("paged_attn_walls"):
            walls = {k: f"{v:.4f}s"
                     for k, v in m["paged_attn_walls"].items()}
            print(f"O{m['level']} paged_attn measured {walls} -> "
                  f"kept {m['paged_attn']!r}")
        if m.get("draft_k_walls"):
            walls = {k: f"{v:.4f}s"
                     for k, v in m["draft_k_walls"].items()}
            print(f"O{m['level']} draft_k measured {walls} -> kept "
                  f"K={m['draft_k']} (accept {m['accept_rate']:.2f}, "
                  f"{m['eff_tok_per_step']:.2f} tok/step)")
        if m.get("kv_dtype_walls"):
            walls = {k: f"{v:.4f}s"
                     for k, v in m["kv_dtype_walls"].items()}
            print(f"O{m['level']} kv_dtype measured {walls} -> kept "
                  f"{m['kv_dtype']!r} (agreement "
                  f"{m['kv_agreement']:.2f})")
    return 0 if same else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.autotune")
    target = ap.add_mutually_exclusive_group(required=True)
    target.add_argument("--kernel",
                        help="MachSuite kernel name, or 'all'")
    target.add_argument("--arch",
                        help="LM architecture (repro_torch.configs); the "
                             "cost twin without --serve is not ported yet")
    ap.add_argument("--serve", action="store_true",
                    help="walk the serving engine itself O0->O7 on "
                         "measured tokens/sec (requires --arch; smoke "
                         "config; O6 = paged KV blocks, O7 = speculative "
                         "decoding)")
    ap.add_argument("--frontier", action="store_true",
                    help="AutoDSE-style mode: measure every remaining "
                         "candidate step per round, keep the best")
    ap.add_argument("--max-rounds", type=int, default=12)
    ap.add_argument("--out", default=None,
                    help="trajectory dir (default experiments/autotune)")
    # serving-walk knobs (--serve):
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=48)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--policy", default="fcfs",
                    choices=("fcfs", "spf", "deadline"))
    ap.add_argument("--traffic-rate", type=float, default=0.0,
                    help="autotune against OPEN-LOOP traffic at this "
                         "arrival rate (req/s) instead of a fixed batch: "
                         "each level replays a Poisson/bursty trace "
                         "through the async front end and the objective "
                         "becomes goodput under the latency SLOs "
                         "(0 = classic closed-loop drain wall)")
    ap.add_argument("--traffic-pattern", default="poisson",
                    choices=("poisson", "bursty"))
    ap.add_argument("--ttft-slo-ms", type=float, default=500.0,
                    help="traffic-mode TTFT SLO (milliseconds)")
    ap.add_argument("--tpot-slo-ms", type=float, default=100.0,
                    help="traffic-mode per-token latency SLO "
                         "(milliseconds)")
    ap.add_argument("--kv-block", type=int, default=16,
                    help="O6 paged-cache block size in tokens")
    ap.add_argument("--kv-pool-blocks", type=int, default=0,
                    help="O6 pool size in blocks (0 = auto: equal "
                         "worst-case capacity to the contiguous cache)")
    ap.add_argument("--paged-attn", default="auto",
                    choices=("auto", "gather", "kernel"),
                    help="O6 attention implementation: auto measures "
                         "gather vs the gather-free block-table kernel "
                         "and keeps the winner (gather on tie/loss)")
    ap.add_argument("--draft", default="smollm-360m", dest="draft_model",
                    help="O7 drafter arch (must share the target's vocab)")
    ap.add_argument("--draft-k", default="auto",
                    help="O7 speculation window: 'auto' races K in "
                         "{0,2,4,8} and keeps the winner; an int pins it "
                         "(0 disables speculation)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the serving walk runs (default cuda; "
                         "there is no fallback to the CPU)")
    ap.add_argument("--kv-dtype", default="auto",
                    choices=("auto", "bf16", "int8", "fp8"),
                    help="O6 pool stored dtype: auto races bf16 vs an "
                         "int8 twin at equal pool memory and keeps "
                         "narrow only when it wins; bf16/int8/fp8 pin it")
    args = ap.parse_args(argv)
    if args.draft_k != "auto":
        try:
            args.draft_k = int(args.draft_k)
        except ValueError:
            ap.error(f"--draft-k must be 'auto' or an int "
                     f"(got {args.draft_k!r})")

    if args.serve:
        if not args.arch:
            ap.error("--serve needs --arch (e.g. --serve --arch qwen3-8b)")
        return _serve(args)
    if args.arch:
        raise NotImplementedError(
            "the LM cost twin (--arch without --serve) needs "
            "CostTwinBackend (ROADMAP A20) and a torch counterpart of the "
            "HLO cost analysis (ROADMAP A19), which the port does not "
            "have yet")

    from repro_torch.autotune.measurement import KernelModelBackend
    from repro_torch.core.costmodel import MACHSUITE_PROFILES

    names = (sorted(MACHSUITE_PROFILES) if args.kernel == "all"
             else [args.kernel])
    for name in names:
        if name not in MACHSUITE_PROFILES:
            ap.error(f"unknown kernel {name!r}; "
                     f"choices: {', '.join(sorted(MACHSUITE_PROFILES))}")
        _run_one(KernelModelBackend(MACHSUITE_PROFILES[name]), args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
