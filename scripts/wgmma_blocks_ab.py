#!/usr/bin/env python3
"""Time B6's tensor-core body at other eligible blocks than the O5
rung's, in turns, in one process on one card.

    python3 scripts/wgmma_blocks_ab.py --size 4096

The rung's blocks (``ops.pick_blocks`` at O5: 128 x 128 x 128, two
slots) bring 64 KB into an SM for each 128-deep k-block, 64 FLOP a byte;
wider tiles bring fewer bytes a FLOP (128 x 256 x 64: 85).  Each
blocking runs through ``ops.matmul_tiled`` (the wgmma body, asserted
from its launch counter) on the same bf16 operands, with
``torch.matmul`` in bf16 as the yardstick; prints the card, each
blocking's FLOP a byte of its k-blocks, its median device time
(``chip_smoke.time_ms``: L2 flushed, a spin kernel ahead of each timed
launch) over alternating rounds, and its largest error against the
plain version as a share of max |plain|.  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import card_line, time_ms  # noqa: E402
from repro_torch.kernels.tiled_matmul import ops  # noqa: E402
from repro_torch.kernels.tiled_matmul.ref import \
    matmul_tiled_ref  # noqa: E402

BLOCKS = [(128, 128, 128), (128, 256, 64), (128, 128, 64), (64, 256, 64),
          (128, 192, 64)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    n = args.size
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((n, n), generator=g, device="cuda").to(torch.bfloat16)
    b = torch.randn((n, n), generator=g, device="cuda").to(torch.bfloat16)
    runs = {}
    for bm, bn, bk in BLOCKS:
        if n % bm or n % bn or n % bk or ops.body(
                torch.bfloat16, n, n, n, bm, bn, bk) != "wgmma":
            continue
        runs[(bm, bn, bk)] = (lambda bm=bm, bn=bn, bk=bk: ops.matmul_tiled(
            a, b, bm=bm, bn=bn, bk=bk, parallel_mn=True, double_buffer=True))
    runs["torch.matmul"] = lambda: torch.matmul(a, b)
    times = {k: [] for k in runs}
    order = list(runs)
    for r in range(args.rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(time_ms(runs[k], reps=15))
    print(card_line())
    for k, ts in times.items():
        line = (f"{k}: median {statistics.median(ts):.4f} ms over rounds "
                f"{', '.join(f'{t:.4f}' for t in ts)}")
        if k != "torch.matmul":
            bm, bn, bk = k
            before = ops.matmul_tiled.body_launches["wgmma"]
            got = runs[k]()
            assert ops.matmul_tiled.body_launches["wgmma"] == before + 1
            want = matmul_tiled_ref(a, b, bk=bk)
            err = float((got - want).abs().max() / want.abs().max())
            b_cols = -(-bn // 64) * 64
            intensity = 2 * bm * bn * bk / (2 * (bm * bk + bk * b_cols))
            line += (f"; {intensity:.0f} FLOP a byte a k-block; error "
                     f"{err:.3e} of max |plain|")
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
