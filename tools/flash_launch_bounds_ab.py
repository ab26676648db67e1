#!/usr/bin/env python3
"""Time kernel B3 built with different launch bounds, in turns, in one
process on one card (so the versions share the card, its clocks and its
power limit).

    python3 tools/flash_launch_bounds_ab.py --blocks 4 3

Each variant is the checkout's ``flash_attention.cu`` with the minimum
blocks per SM at head_dim 64 replaced, written to ``build/`` and built
with the port's nvcc flags.  Prints each variant's registers and spills
(ptxas), its device times at smollm-360m's training shape (bf16, causal;
L2 flushed, a spin kernel ahead of each timed launch) in alternating
order, and whether the outputs are bitwise equal.  Needs an NVIDIA GPU.
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

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402

BOUNDS = re.compile(r"__launch_bounds__\(kThreads, D == 64 \? \d+ : 2\)")


def variant(blocks: int) -> Path:
    src = kernel.SOURCES[0].read_text()
    if not BOUNDS.search(src):
        raise SystemExit("launch bounds not found in the kernel source")
    out = _build.BUILD_DIR / f"flash_attention_lb{blocks}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(BOUNDS.sub(
        f"__launch_bounds__(kThreads, D == 64 ? {blocks} : 2)", src))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, nargs="+", default=[4, 3])
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    libs = _build.build_all({f"lb{b}": (variant(b),) for b in args.blocks})
    fns = {}
    for name, path in libs.items():
        for line in _build.BUILD_LOGS.get(str(path), "").splitlines():
            if "registers" in line or "spill" in line:
                print(name, line.strip())
        fn = ctypes.CDLL(str(path)).flash_attention_forward
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    B, S, H, Hkv, D = 8, 4096, 15, 5, 64
    q = torch.randn(B, S, H, D, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(B, S, Hkv, D, device="cuda", dtype=torch.bfloat16)
    v = torch.randn(B, S, Hkv, D, device="cuda", dtype=torch.bfloat16)
    outs = {n: torch.empty_like(q) for n in fns}
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")

    def run(n):
        err = fns[n](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     outs[n].data_ptr(), B, S, S, H, Hkv, D, 1, 1,
                     1.0 / D ** 0.5, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{n}: CUDA error {err}")

    def median_ms(n, reps=20):
        for _ in range(3):
            run(n)
        ts = []
        for _ in range(reps):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(10_000_000)
            s.record()
            run(n)
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)

    names = list(fns)
    res = {n: [] for n in names}
    for r in range(args.rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            res[n].append(median_ms(n))
    torch.cuda.synchronize()
    for n in names:
        print(f"{n}: {', '.join(f'{x:.4f}' for x in res[n])} ms "
              f"(median {statistics.median(res[n]):.4f})")
    ref = outs[names[0]]
    print("outputs bitwise equal:", all(torch.equal(ref, outs[n])
                                        for n in names[1:]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
