#!/usr/bin/env python3
"""Serve qwen3-8b at full width as ``chip_smoke.py``'s phase 5 (b) does
and print the wall time per tick, several times in one process.

    python3 scripts/serve_tick.py --reps 3

8 requests (prompts 16-256, 32 new tokens each, seed 0) at batch 8,
max_seq 1024, T=16, O6 with the paging kernel, prompts fed a token per
tick, random bf16 weights from seed 0.  The tick is host-bound, and a
machine's host speed varies from call to call, so two versions are
compared only in one call, in turns (parent, change, change, parent),
each run from its own checkout.  It reads nothing but its own checkout's
``src/``.  Prints the card and, per repetition, ticks, ms per tick,
tok/s and B1's launches.  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core.optlevel import OptLevel
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.launch.serve import demo_requests, serve_demo
    from repro_torch.models import get_model
    from repro_torch.serving.paged import blocks_for

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = get_config("qwen3-8b")
    params = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    B, max_seq, T, n_req = 8, 1024, 16, 8
    kw = dict(seed=0, prompt_len=(16, 257), max_new=(32, 33))
    reqs = demo_requests(cfg, n_req, **kw)
    pool_blocks = sum(blocks_for(len(p) + n, T) for p, n in reqs)
    for rep in range(args.reps + 1):       # the first builds and warms up
        before = ops.paged_attention.launches
        out = serve_demo(cfg, batch_size=B, max_seq=max_seq,
                         n_requests=n_req, level=OptLevel.O6,
                         paged_attn="kernel", kv_block_size=T,
                         kv_pool_blocks=pool_blocks, params=params, **kw)
        if rep:
            print(f"{ROOT.name} rep {rep}: {out['ticks']} ticks, "
                  f"{out['wall_s'] / out['ticks'] * 1e3:.2f} ms/tick, "
                  f"{out['tok_per_s']:.1f} tok/s, B1 launches "
                  f"{ops.paged_attention.launches - before}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
