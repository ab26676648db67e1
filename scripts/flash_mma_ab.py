#!/usr/bin/env python3
"""Time kernel B3's bf16 tensor-core body built with other splits of its
head_dim <= 64 instances, in turns, in one process on one card (so the
variants share the card, its clocks and its power limit).

    python3 scripts/flash_mma_ab.py --variant 2,4,2 1,8,2 2,2,4 2,8,1

A variant ``MT,WARPS,BLOCKS`` is the checkout's
``flash_attention_mma.cu`` with the D <= 64 branch of ``m_tiles`` (m16
tiles, i.e. 16 query rows, a warp), ``warps`` (warps a block) and
``min_blocks`` (blocks an SM the launch bounds ask for) replaced,
written to ``build/`` and built with the port's nvcc flags.  The
checkout's own split is 2,4,2: 32 rows a warp, 128 a block, two blocks
an SM; 1,8,2 is 16 rows a warp.  Prints each variant's ptxas registers
and spills at D = 64, its device time at smollm-360m's training shape
(B=8, S=4096, H=15, Hkv=5, D=64, causal, bf16; L2 flushed, a spin kernel
ahead of each timed launch, ``chip_smoke.time_ms``) in alternating
order, its largest error against the plain version as a share of the
row's largest |plain|, and whether the outputs are bitwise equal (they
should be: a row's arithmetic does not depend on the split).  Needs an
NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import card_line, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402

HELPERS = ("m_tiles", "warps", "min_blocks")


def variant(spec: str) -> Path:
    src = kernel.MMA_SOURCES[0].read_text()
    for helper, value in zip(HELPERS, spec.split(",")):
        pat = re.compile(r"(constexpr int " + helper +
                         r"\(\) \{\n  return D <= 64 \? )\d+( : \d+;)")
        if not pat.search(src):
            raise SystemExit(f"{helper} not found in the kernel source")
        src = pat.sub(lambda m: f"{m.group(1)}{int(value)}{m.group(2)}", src)
    out = _build.BUILD_DIR / f"flash_attention_mma_{spec.replace(',', '_')}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", nargs="+", default=["2,4,2", "1,8,2"])
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    libs = _build.build_all({v.replace(",", "_"): (variant(v),)
                             for v in args.variant})
    libs = {v: libs[v.replace(",", "_")] for v in args.variant}
    fns = {}
    for v, path in libs.items():
        log = _build.BUILD_LOGS.get(str(path), "").splitlines()
        for i, line in enumerate(log):
            if "properties" in line and "flash_mma_kernelILi64E" in line:
                print(v, " / ".join(x.strip() for x in log[i + 1:i + 3]))
        fns[v] = kernel.bind(
            ctypes.CDLL(str(path)).flash_attention_mma_forward)
    B, S, H, Hkv, D = 8, 4096, 15, 5, 64
    g = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda").to(
        torch.bfloat16)
    q, k, v = mk(B, S, H, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D)
    outs = {n: torch.empty_like(q) for n in fns}

    def run(n):
        err = fns[n](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     outs[n].data_ptr(), B, S, S, H, Hkv, D, 1,
                     1.0 / D ** 0.5, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{n}: CUDA error {err}")

    times = {n: [] for n in fns}
    order = list(args.variant)
    for r in range(args.rounds):
        for n in (order if r % 2 == 0 else order[::-1]):
            times[n].append(time_ms(lambda: run(n), reps=15))
    want = flash_attention_ref(q, k, v, causal=True).float()
    row = want.abs().amax(dim=-1, keepdim=True)
    print(card_line())
    for n, ts in times.items():
        err = float(((outs[n].float() - want).abs() / row).max())
        print(f"variant {n}: median {statistics.median(ts):.4f} ms over "
              f"rounds {', '.join(f'{t:.4f}' for t in ts)}; worst error "
              f"{err:.3e} of the row's largest |plain|")
    for n in order[1:]:
        print(f"variant {n} outputs bitwise equal to {order[0]}'s: "
              f"{torch.equal(outs[n], outs[order[0]])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
