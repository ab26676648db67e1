#!/usr/bin/env python3
"""Time kernel B5 built with its blocks taking different shares of a
head's P columns, in turns, in one process on one card (so the variants
share the card, its clocks and its power limit).

    python3 scripts/ssd_p_block_ab.py --p-block 64 32 16

Each variant is the checkout's ``mamba2_ssd.cu`` with ``kPBlock`` (the
P columns a block takes) replaced, written to ``build/`` and built with
the port's nvcc flags.  At mamba2-2.7b's width 64 is one block per (b,
h) (131 KB of shared memory, one block per SM), 32 two blocks (107 KB,
two per SM), each recomputing its tile's C B^T.  Prints each variant's
device time at mamba2-2.7b's training shape (B=4, S=4096, H=80, P=64,
N=128, chunk 256, bf16; L2 flushed, a spin kernel ahead of each timed
launch, ``chip_smoke.time_ms``) in alternating order, and whether the
outputs are bitwise equal (they should be: a column's arithmetic does
not depend on the split).  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import card_line, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mamba2_ssd import kernel  # noqa: E402

P_BLOCK = re.compile(r"constexpr int kPBlock = \d+;")


def variant(p_block: int) -> Path:
    src = kernel.SOURCES[0].read_text()
    if not P_BLOCK.search(src):
        raise SystemExit("kPBlock not found in the kernel source")
    out = _build.BUILD_DIR / f"mamba2_ssd_pb{p_block}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(P_BLOCK.sub(f"constexpr int kPBlock = {p_block};", src))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--p-block", type=int, nargs="+", default=[64, 32])
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    libs = _build.build_all({pb: (variant(pb),) for pb in args.p_block})
    fns = {pb: kernel._bind(ctypes.CDLL(str(path)))
           for pb, path in libs.items()}
    B, S, H, P, N = 4, 4096, 80, 64, 128
    g = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda *s: (torch.randn(s, generator=g, device="cuda") * 0.5).to(
        torch.bfloat16)
    x, Bs, Cs = mk(B, S, H, P), mk(B, S, N), mk(B, S, N)
    dt = torch.nn.functional.softplus(torch.randn(
        (B, S, H), generator=g, device="cuda")).to(torch.bfloat16)
    A = -torch.ones(H, device="cuda", dtype=torch.bfloat16)
    outs = {pb: (torch.empty_like(x),
                 torch.empty((B, H, P, N), device="cuda"))
            for pb in args.p_block}

    def run(pb):
        with mock.patch.object(kernel, "_entry", lambda body: fns[pb]):
            kernel.launch(x, dt, A, Bs, Cs, None, *outs[pb], chunk=256)

    times = {pb: [] for pb in args.p_block}
    order = list(args.p_block)
    for r in range(args.rounds):
        for pb in (order if r % 2 == 0 else order[::-1]):
            times[pb].append(time_ms(lambda: run(pb), reps=10))
    print(card_line())
    for pb, ts in times.items():
        print(f"p_block {pb}: median {statistics.median(ts):.4f} ms over "
              f"rounds {', '.join(f'{t:.4f}' for t in ts)}")
    first = outs[order[0]]
    for pb in order[1:]:
        print(f"p_block {pb} outputs bitwise equal to p_block {order[0]}'s: "
              f"{torch.equal(outs[pb][0], first[0])} (y), "
              f"{torch.equal(outs[pb][1], first[1])} (state)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
