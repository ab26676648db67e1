"""End-to-end serving driver: slot-based continuous batching at a rung of
the best-effort ladder (port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --batch 8 --max-seq 1024 --requests 8 --level 6 --paged-attn kernel

runs qwen3-8b at its published widths with random weights on the CUDA
device; ``--smoke`` serves the reduced config and ``--device cpu`` runs
on the CPU (the kernel path then uses the kernels' plain versions).
``--prefill-chunk N`` consumes prompts N tokens per tick; ``--level 7
--draft smollm-360m`` decodes speculatively (the drafter must share the
target's vocab at the scale served, so the pair works with ``--smoke``
only); ``--level 6 --kv-dtype int8`` (or ``fp8``) stores the paged pool
in 1-byte words with one f32 scale per (block row, kv head), half the
bytes a token.  ``--level 0`` / ``1`` serve the un-pipelined loop, one
batch-1 model call per request per tick (O0 also rebuilds the cache at
each admission).  ``launch.server`` puts an async open-loop front end
over the same engine.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.core.optlevel import BestEffortConfig, OptLevel
from repro_torch.models import get_model
from repro_torch.serving import DecodeEngine, Request, SamplerConfig


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def demo_requests(cfg, n_requests: int, *, seed: int = 0,
                  prompt_len=(2, 12), max_new=(4, 16)) -> list:
    """The ``(prompt, max_new_tokens)`` pairs ``serve_demo`` submits:
    lengths drawn from the half-open ranges, tokens from ``[1, vocab)``,
    all from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_requests):
        plen = int(rng.integers(*prompt_len))
        new = int(rng.integers(*max_new))
        out.append((rng.integers(1, cfg.vocab, plen).tolist(), new))
    return out


def serve_demo(cfg, *, batch_size: int, max_seq: int, n_requests: int,
               seed: int = 0, prompt_len=(2, 12), max_new=(4, 16),
               level: OptLevel = OptLevel.O5, policy: str = "fcfs",
               sampler: SamplerConfig = None, pe: int = 8,
               kv_block_size: int = 16, kv_pool_blocks: int = 0,
               paged_attn: str = "gather", prefill_chunk: int = 0,
               draft_model: str = "", draft_k: int = 4,
               kv_dtype: str = "bf16", device=None, params=None) -> dict:
    """Serve the ``demo_requests`` drawn from ``seed`` and return the
    finished requests with tick / wall / token counts, the prefill mode
    and the speculation counters.  ``params`` defaults to random weights
    drawn on the device from ``seed``."""
    model = get_model(cfg, device=device)
    if params is None:
        gen = torch.Generator(device=model.device)
        gen.manual_seed(seed)
        params = model.init(gen)
    engine = DecodeEngine(model, params, batch_size=batch_size,
                          max_seq=max_seq,
                          config=BestEffortConfig(
                              level=level, pe=pe,
                              kv_block_size=kv_block_size,
                              kv_pool_blocks=kv_pool_blocks,
                              paged_attn=paged_attn,
                              prefill_chunk=prefill_chunk,
                              draft_model=draft_model, draft_k=draft_k,
                              kv_dtype=kv_dtype),
                          policy=policy, sampler=sampler)

    for prompt, new in demo_requests(cfg, n_requests, seed=seed,
                                     prompt_len=prompt_len, max_new=max_new):
        engine.submit(Request(prompt=prompt, max_new_tokens=new))

    _sync(model.device)
    t0 = time.perf_counter()
    finished = engine.run()
    _sync(model.device)
    wall = time.perf_counter() - t0
    total_new = sum(len(r.generated) for r in finished)
    geometry = getattr(engine.cache_mgr, "geometry", None)
    return {
        "finished": finished,
        "ticks": engine.n_steps,
        "wall_s": wall,
        "tokens": total_new,
        "tok_per_s": total_new / wall if wall > 0 else 0.0,
        "layout": engine.layout.name,
        "devices": engine.placement.n_devices,
        "device": str(model.device),
        "paged_attn": engine.layout.attn_impl,
        "kv_dtype": kv_dtype,
        "pool": geometry,
        "pool_mb": geometry["pool_mb"] if geometry else None,
        "scale_bytes_per_block": (geometry["scale_bytes_per_block"]
                                  if geometry else None),
        "prefill_mode": engine.prefill_mode,
        "spec_mode": engine.spec_mode,
        "spec": engine.spec_stats,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to serve (default cuda; there is no "
                         "fallback to the CPU)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--level", type=int, default=5, choices=range(8),
                    help="OptLevel to build the engine at: 0-1 the "
                         "un-pipelined per-request loop, 2-5 batched, 6 = "
                         "paged KV blocks, 7 = speculative decoding — "
                         "needs --draft")
    ap.add_argument("--policy", default="fcfs",
                    choices=("fcfs", "spf", "deadline"))
    ap.add_argument("--sampler", default="greedy",
                    choices=("greedy", "temperature", "top_k"))
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--pe", type=int, default=8,
                    help="PE duplication degree (O3+); clipped to the one "
                         "device the port serves on")
    ap.add_argument("--kv-block", type=int, default=16,
                    help="O6 paged-cache block size in tokens")
    ap.add_argument("--kv-pool-blocks", type=int, default=0,
                    help="O6 pool size in blocks (0 = auto)")
    ap.add_argument("--paged-attn", default="gather",
                    choices=("gather", "kernel"),
                    help="O6 attention: gather re-materializes the dense "
                         "KV view per tick; kernel runs the CUDA "
                         "paged-decode kernel on the raw pool")
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=("bf16", "int8", "fp8"),
                    help="O6 pool stored dtype: bf16, or int8 / fp8 (e4m3) "
                         "words with per-block f32 scales")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: consume prompts in chunks of "
                         "this many tokens, one chunk per tick, "
                         "interleaved with decode (0 = one prompt token "
                         "per tick; greedy tokens identical either way)")
    ap.add_argument("--draft", default="", dest="draft_model",
                    help="O7 drafter arch (e.g. smollm-360m): proposes "
                         "--draft-k tokens per slot per tick for the "
                         "target to verify in one batched forward; must "
                         "share the target's vocab at the same smoke/full "
                         "scale.  Empty disables speculation")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="speculation window: drafted tokens per slot per "
                         "verify step (0 disables)")
    ap.add_argument("--expect-devices", type=int, default=0,
                    help="exit 1 unless the engine's placement landed on "
                         "exactly this many devices")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    sampler = SamplerConfig(kind=args.sampler, temperature=args.temperature,
                            top_k=args.top_k, seed=args.seed)
    out = serve_demo(cfg, batch_size=args.batch, max_seq=args.max_seq,
                     n_requests=args.requests, seed=args.seed,
                     level=OptLevel(args.level), policy=args.policy,
                     sampler=sampler, pe=args.pe,
                     kv_block_size=args.kv_block,
                     kv_pool_blocks=args.kv_pool_blocks,
                     paged_attn=args.paged_attn,
                     prefill_chunk=args.prefill_chunk,
                     draft_model=args.draft_model, draft_k=args.draft_k,
                     kv_dtype=args.kv_dtype, device=args.device)
    for r in out["finished"][:4]:
        print(f"[serve] req {r.rid}: prompt[{r.n_prompt}] -> "
              f"{r.generated}")
    attn = f"/{out['paged_attn']}" if out["paged_attn"] else ""
    if out["kv_dtype"] != "bf16":
        attn += f"/kv={out['kv_dtype']}"
    if args.prefill_chunk:
        attn += f"/prefill={out['prefill_mode']}({args.prefill_chunk})"
    if out["spec_mode"] == "draft":
        st = out["spec"]
        attn += (f"/spec=K{st['draft_k']}({args.draft_model},"
                 f"accept={st['accept_rate']:.2f},"
                 f"eff={st['eff_tok_per_step']:.2f})")
    elif args.level >= 7:
        attn += "/spec=off"
    print(f"[serve] O{args.level}/{args.policy} "
          f"[{out['layout']}{attn} on {out['device']}]: "
          f"{len(out['finished'])} requests, {out['tokens']} new "
          f"tokens in {out['ticks']} ticks / {out['wall_s']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s)")
    if args.expect_devices and out["devices"] != args.expect_devices:
        raise SystemExit(
            f"placement landed on {out['devices']} device(s), expected "
            f"{args.expect_devices}")


if __name__ == "__main__":
    main()
