#!/usr/bin/env python3
"""Sweep the partition size P of the paged-attention kernel's split
body, in turns, in one process on one card.

    python3 scripts/paged_split_ab.py

P (positions a partition, a multiple of the 64-position chunk) sets how
many blocks a slot's positions are spread over: smaller P gives more
blocks in flight and more partials to combine.  At the main path's
shapes — qwen3-8b decode (B=8, H=32, KV=8, D=128, T=16, lengths
1..2048), its int8 pool, the 64-token chunk from 960 and the verify
window (B=8, Q=5) — each P of ``chip_smoke.SPLIT_PS`` runs
``kernel.launch_split`` directly, beside the CUDA-core body
(``kernel.launch`` / ``launch_prefill``; ``chip_smoke.paged_variants``),
on the same inputs as ``chip_smoke.py`` phases 3, 3b and 3g.  Prints
the card, each variant's median device time (``chip_smoke.time_ms``: L2
flushed, a spin kernel ahead of each timed launch) over alternating
rounds and its largest error against the plain version (bf16 tolerance
of ``chip_smoke.TOL``, checked), and for the routed P and the CUDA-core
body the host time per call of the binding alone (``chip_smoke.host_ms``:
ctypes and the launches, without the wrapper's checks).  Needs an
NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (TOL, card_line, host_ms, paged_case,  # noqa: E402
                        paged_variants, quant_case, time_ms)
from repro_torch.kernels.paged_attention import ops, ref  # noqa: E402


def _cases() -> dict:
    H, KV, D, T = 32, 8, 128, 16
    bf = torch.bfloat16
    r = np.random.default_rng(0)
    lengths = r.integers(1, 2049, 8)
    lengths[0], lengths[-1] = 1, 2048
    decode = paged_case(8, H, KV, D, T, lengths, dtype=bf)
    return {
        "decode": decode,
        "decode int8": quant_case(decode, "int8"),
        "chunk Q=64 from 960": paged_case(1, H, KV, D, T, [960 + 64],
                                          dtype=bf, q_len=64, seed=13,
                                          nb=64),
        "verify Q=5": paged_case(8, H, KV, D, T, lengths + 4, dtype=bf,
                                 q_len=5, seed=20),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(card_line())
    atol, rtol = TOL["bf16"]
    for name, case in _cases().items():
        runs, out = paged_variants(case)
        plain = (ref.paged_attention_ref if case[0].dim() == 3
                 else ref.paged_prefill_attention_ref)
        want = plain(*case).float()
        if case[0].dim() == 3:
            want = want[:, None]
        errs = {}
        for k, fn in runs.items():
            out.fill_(float("nan"))
            fn()
            torch.cuda.synchronize()
            err = (out.float() - want).abs()
            bound = atol + rtol * want.abs().amax(dim=-1, keepdim=True)
            if not (err <= bound).all():
                raise AssertionError(f"{name} {k}: max err "
                                     f"{float(err.max())} over tolerance")
            errs[k] = float(err.max())
        times = {k: [] for k in runs}
        order = list(runs)
        for r in range(args.rounds):
            for k in (order if r % 2 == 0 else order[::-1]):
                times[k].append(time_ms(runs[k], reps=15))
        P = ops.partition_positions(case[1].shape[1], case[0].shape[-1])
        for k, ts in times.items():
            host = ("" if k not in (f"split P={P}", "cuda_core") else
                    f"; the binding's host time per call "
                    f"{host_ms(runs[k]):.4f} ms")
            print(f"{name} {k}: median {statistics.median(ts):.4f} ms over "
                  f"rounds {', '.join(f'{t:.4f}' for t in ts)}; max |err| "
                  f"{errs[k]:.3e}{host}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
