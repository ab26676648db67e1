#!/usr/bin/env python3
"""Time ways of splitting f32 operands in B6's 3xTF32 body, in turns, in
one process on one card.

    python3 scripts/tf32x3_split_ab.py

The body (``csrc/tiled_matmul_tf32x3.cu``) splits every fragment
element in every warp that reads it, so the split's ALU work sits beside
the MMAs.  Variants of the shipped source, written into the gitignored
``build/ab/`` and built with the port's nvcc flags:

- shipped: big = x rounded to TF32 with two integer ops (cvt.rna's
  value), small = x - big read truncated by the MMA; k-steps unrolled 4;
- cvt small: the same big, small = cvt.rna.tf32(x - big);
- cvt both: big = cvt.rna.tf32(x), small = cvt.rna.tf32(x - big);
- each of the three with the k-steps unrolled by 2.

Each runs at the O3 and O4 rungs' blocks at 4096^3 and O3's at 1024^3
through its own library's C entry point; prints the card, the median
device time (``chip_smoke.time_ms``) over alternating rounds, the
largest error against the plain version as a share of max |plain|, and
``torch.matmul`` in f32 with TF32 off.  Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import card_line, matmul_case, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.tiled_matmul import kernel  # noqa: E402
from repro_torch.kernels.tiled_matmul.ref import \
    matmul_tiled_ref  # noqa: E402

SHIPPED_SPLIT = """  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));"""
SPLITS = {
    "shipped": SHIPPED_SPLIT,
    "cvt small": """  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small)
      : "f"(x - __uint_as_float(big)));""",
    "cvt both": """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small)
      : "f"(x - __uint_as_float(big)));""",
}
SHIPPED_UNROLL = "#pragma unroll 4\n        for (int kk = k0;"
# (size, (bm, bn, bk), stages): O3 and O4 at 4096^3, O3 at 1024^3.
SHAPES = [(4096, (128, 128, 128), 1), (4096, (64, 128, 64), 2),
          (1024, (128, 128, 128), 1)]


def _variants() -> dict:
    """{name: source text} of every variant of the shipped source."""
    src = kernel.TF32X3_SOURCES[0].read_text()
    if SHIPPED_SPLIT not in src or SHIPPED_UNROLL not in src:
        raise RuntimeError("the shipped split or unroll changed; update "
                           "this script")
    out = {}
    for name, split in SPLITS.items():
        for unroll in (4, 2):
            text = src.replace(SHIPPED_SPLIT, split).replace(
                SHIPPED_UNROLL, SHIPPED_UNROLL.replace("4", str(unroll), 1))
            out[f"{name}, unroll {unroll}"] = text
    return out


def _build_all(variants: dict) -> dict:
    """Build every variant at once; {name: bound C entry point}."""
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(variants.items()):
        src = out_dir / f"tf32x3_split_{i}.cu"
        src.write_text(text)
        lib = out_dir / f"tf32x3_split_{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).tiled_matmul_tf32x3_forward
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = _build_all(_variants())
    print(card_line())
    stream = torch.cuda.current_stream().cuda_stream
    for n, (bm, bn, bk), stages in SHAPES:
        a, b = matmul_case(n, n, n, seed=61)
        want = matmul_tiled_ref(a, b, bk=bk)
        c = torch.empty((n, n), device="cuda")
        grid = (n // bm) * (n // bn)
        runs = {name: (lambda fn=fn: fn(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), n, n, n, bm, bn, bk,
            grid, stages, stream)) for name, fn in fns.items()}
        times = {k: [] for k in runs}
        order = list(runs)
        for r in range(args.rounds):
            for k in (order if r % 2 == 0 else order[::-1]):
                times[k].append(time_ms(runs[k], reps=10))
        for k, fn in runs.items():
            c.fill_(float("nan"))
            if fn() != 0:
                raise RuntimeError(f"{k}: launch refused")
            torch.cuda.synchronize()
            rel = float((c - want).abs().max() / want.abs().max())
            print(f"{n}^3 blocks ({bm}, {bn}, {bk}) stages {stages} {k}: "
                  f"median {statistics.median(times[k]):.4f} ms over rounds "
                  f"{', '.join(f'{t:.4f}' for t in times[k])}; error "
                  f"{rel:.3e} of max |plain|")
        print(f"{n}^3 torch.matmul (f32, TF32 off): "
              f"{time_ms(lambda: torch.matmul(a, b), reps=10):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
