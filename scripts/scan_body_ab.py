#!/usr/bin/env python3
"""Time kernels B5 (Mamba-2 SSD) and B4 (RWKV-6 WKV) body by body, in
turns, in one process on one card (so every variant shares the card, its
clocks and its power limit).

    python3 scripts/scan_body_ab.py
    python3 scripts/scan_body_ab.py --ssd kOutHeads=20 fused --wkv fused

At each kernel's training shape (B5: mamba2-2.7b, B=4, S=4096, H=80, P=64,
N=128, chunk 256; B4: rwkv6-3b, B=4, S=4096, H=40, N=64, chunk 128; bf16,
as the models call them) it times the CUDA-core body (``csrc/
mamba2_ssd.cu``, ``csrc/rwkv6_wkv.cu``), the shipped chunk body
(``csrc/mamba2_ssd_chunk.cu``, ``csrc/rwkv6_wkv_chunk.cu``) and each
variant of it, written to ``build/ab/`` and built with the port's nvcc
flags: a copy of the shipped source with a ``constexpr int`` replaced
(``NAME=VALUE``; several joined with commas), or with a second design of
its later launches appended (``fused``: ``scripts/scan_variants/``, the
scan over the chunks fused into the output pass), or both (by default
B5's ``fused``, and B4's ``fused`` at 4 and at 1 block a head).  Device times are
``chip_smoke.time_ms``'s (median, L2 flushed, a spin kernel ahead of
each timed launch), rounds in alternating order; beside each the largest
|y - plain| over the largest |plain| and the state's, against the plain
version (``ref.py``) on the same inputs, whether y and the state equal
the shipped body's bit for bit, and the same errors in f32 with an
initial state (where bf16 y's rounding does not hide the products'
error), so a variant that breaks the arithmetic shows.  Finally a
``torch.profiler`` reading of the shipped chunk bodies splits their time
over their three launches.  Needs an NVIDIA GPU.
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

from chip_smoke import card_line, ssd_case, time_ms, wkv_case  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mamba2_ssd import kernel as skernel  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ref as sref  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import kernel as wkernel  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ref as wref  # noqa: E402

AB_DIR = _build.REPO_ROOT / "build" / "ab"
FUSED = {"ssd": (ROOT / "scripts" / "scan_variants" / "mamba2_ssd_fused.cu",
                 "mamba2_ssd_fused_forward"),
         "wkv": (ROOT / "scripts" / "scan_variants" / "rwkv6_wkv_fused.cu",
                 "rwkv6_wkv_fused_forward")}


def variant(source: Path, spec: str, kind: str) -> tuple:
    """(path, entry point or None for the shipped one's) of a copy of
    ``source`` changed by ``spec``'s comma-joined items: ``fused``
    appends ``FUSED[kind]``'s source (whose entry point it takes), and
    each ``NAME=VALUE`` replaces a ``constexpr int NAME = ...;``."""
    text, symbol = source.read_text(), None
    items = spec.split(",")
    if "fused" in items:
        items.remove("fused")
        fused, symbol = FUSED[kind]
        text += "\n" + fused.read_text()
    for item in items:
        name, value = item.split("=")
        pat = re.compile(rf"constexpr int {name} = [^;]+;")
        if not pat.search(text):
            raise SystemExit(f"{name} not found in {source.name}")
        text = pat.sub(f"constexpr int {name} = {value};", text)
    tag = re.sub(r"[^A-Za-z0-9]+", "_", spec)
    out = AB_DIR / f"{source.stem}_{tag}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out, symbol


def build(kind: str, source: Path, specs, bind) -> dict:
    """{name: bound entry point} of the shipped chunk body ("chunk") and
    each variant of ``specs``, built all at once."""
    srcs = {"chunk": (source, None)}
    srcs.update({s: variant(source, s, kind) for s in specs})
    libs = _build.build_all({f"ab_{kind}_{i}": (path,)
                             for i, (path, _) in enumerate(srcs.values())})
    return {name: bind(ctypes.CDLL(str(lib)), *filter(None, [symbol]))
            for (name, (_, symbol)), lib in zip(srcs.items(), libs.values())}


def rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def f32_errors(label, names, run_f32, plain) -> None:
    """Each body once on f32 operands with a state: its errors against
    the plain version."""
    wy, ws = plain
    for name in names:
        y, sf = run_f32(name)
        print(f"{label} {name} f32 with s0: max |y - plain| "
              f"{rel(y, wy):.3e} of max |y|, state {rel(sf, ws):.3e}",
              flush=True)


def race(label, launchers: dict, plain, outs: dict, rounds: int) -> dict:
    """Time each ``launchers[name]()`` in alternating order; returns
    {name: (median ms, rounds, y error, state error)}."""
    times = {name: [] for name in launchers}
    order = list(launchers)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(time_ms(launchers[name], reps=10))
    wy, ws = plain
    cy, cs = outs["chunk"]
    res = {}
    for name, ts in times.items():
        y, sf = outs[name]
        res[name] = (statistics.median(ts), ts, rel(y, wy), rel(sf, ws))
        same = torch.equal(y, cy) and torch.equal(sf, cs)
        print(f"{label} {name}: median {res[name][0]:.4f} ms over rounds "
              f"{', '.join(f'{t:.4f}' for t in ts)}; max |y - plain| "
              f"{res[name][2]:.3e} of max |y|, state {res[name][3]:.3e}; "
              f"bitwise the chunk body's: {'yes' if same else 'no'}",
              flush=True)
    return res


def ssd_race(specs, rounds: int) -> None:
    fns = build("ssd", skernel.CHUNK_SOURCES[0], specs, skernel.bind_chunk)
    B, S, H, P, N, Q = 4, 4096, 80, 64, 128, 256
    x, dt, A, Bs, Cs, _ = ssd_case(B, S, H, P, N, dtype=torch.bfloat16,
                                   state=False, seed=80)
    names = ["cuda_core", *fns]
    outs = {n: (torch.empty_like(x), torch.empty((B, H, P, N),
                                                 device="cuda"))
            for n in names}

    def run(name):
        if name == "cuda_core":
            return lambda: skernel.launch(x, dt, A, Bs, Cs, None,
                                          *outs[name], chunk=Q)
        fn = fns[name]

        def go():
            with mock.patch.object(skernel, "_entry", lambda body: fn):
                skernel.launch(x, dt, A, Bs, Cs, None, *outs[name],
                               chunk=Q, body="chunk_tf32x3")
        return go

    plain = sref.ssd_chunked_ref(x, dt, A, Bs, Cs, chunk=Q)
    race("B5", {n: run(n) for n in names}, plain, outs, rounds)
    del x, dt, A, Bs, Cs, outs, plain
    torch.cuda.empty_cache()

    ins = ssd_case(B, S, H, P, N, dtype=torch.float32, state=True, seed=81)

    def run_f32(name):
        y = torch.empty_like(ins[0])
        sf = torch.empty((B, H, P, N), device="cuda")
        if name == "cuda_core":
            skernel.launch(*ins, y, sf, chunk=Q)
        else:
            with mock.patch.object(skernel, "_entry", lambda body: fns[name]):
                skernel.launch(*ins, y, sf, chunk=Q, body="chunk_tf32x3")
        torch.cuda.synchronize()
        return y, sf

    f32_errors("B5", names, run_f32,
               sref.ssd_chunked_ref(*ins[:5], init_state=ins[5], chunk=Q))


def wkv_race(specs, rounds: int) -> None:
    fns = build("wkv", wkernel.CHUNK_SOURCES[0], specs, wkernel.bind_chunk)
    B, S, H, N, Q = 4, 4096, 40, 64, 128
    r, k, v, lw, u, _ = wkv_case(B, S, H, N, dtype=torch.bfloat16,
                                 state=False, seed=60)
    names = ["cuda_core", *fns]
    outs = {n: (torch.empty_like(r), torch.empty((B, H, N, N),
                                                 device="cuda"))
            for n in names}

    def run(name):
        if name == "cuda_core":
            return lambda: wkernel.launch(r, k, v, lw, u, None, *outs[name],
                                          chunk=Q)
        fn = fns[name]

        def go():
            with mock.patch.object(wkernel, "_entry", lambda body: fn):
                wkernel.launch(r, k, v, lw, u, None, *outs[name], chunk=Q,
                               body="chunk_tf32x3")
        return go

    plain = wref.wkv_chunked_ref(r, k, v, lw, u, chunk=Q)
    race("B4", {n: run(n) for n in names}, plain, outs, rounds)
    del r, k, v, lw, u, outs, plain
    torch.cuda.empty_cache()

    ins = wkv_case(B, S, H, N, dtype=torch.float32, state=True, seed=61)

    def run_f32(name):
        y = torch.empty_like(ins[0])
        sf = torch.empty((B, H, N, N), device="cuda")
        if name == "cuda_core":
            wkernel.launch(*ins, y, sf, chunk=Q)
        else:
            with mock.patch.object(wkernel, "_entry", lambda body: fns[name]):
                wkernel.launch(*ins, y, sf, chunk=Q, body="chunk_tf32x3")
        torch.cuda.synchronize()
        return y, sf

    f32_errors("B4", names, run_f32,
               wref.wkv_chunked_ref(*ins[:5], init_state=ins[5], chunk=Q))


def profile_launches() -> None:
    """Device time of each of the shipped chunk bodies' three launches."""
    from torch.profiler import ProfilerActivity, profile

    x, dt, A, Bs, Cs, _ = ssd_case(4, 4096, 80, 64, 128,
                                   dtype=torch.bfloat16, state=False,
                                   seed=80)
    r, k, v, lw, u, _ = wkv_case(4, 4096, 40, 64, dtype=torch.bfloat16,
                                 state=False, seed=60)
    ys, ss = torch.empty_like(x), torch.empty((4, 80, 64, 128),
                                              device="cuda")
    yw, sw = torch.empty_like(r), torch.empty((4, 40, 64, 64),
                                              device="cuda")
    for _ in range(2):
        skernel.launch(x, dt, A, Bs, Cs, None, ys, ss, chunk=256,
                       body="chunk_tf32x3")
        wkernel.launch(r, k, v, lw, u, None, yw, sw, chunk=128,
                       body="chunk_tf32x3")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            skernel.launch(x, dt, A, Bs, Cs, None, ys, ss, chunk=256,
                           body="chunk_tf32x3")
            wkernel.launch(r, k, v, lw, u, None, yw, sw, chunk=128,
                           body="chunk_tf32x3")
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", 0)
              or getattr(ev, "self_cuda_time_total", 0))
        if us and ("ssd_" in ev.key or "wkv_" in ev.key):
            name = re.search(r"(ssd|wkv)_\w+_kernel(<[^>]*>)?", ev.key)
            print(f"launch {name.group(0) if name else ev.key[:60]}: "
                  f"{us / 1e3 / ev.count:.4f} ms a call over {ev.count}",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ssd", nargs="*", default=["fused"],
                    help="variants of mamba2_ssd_chunk.cu: fused and/or "
                         "NAME=VALUE, joined by commas")
    ap.add_argument("--wkv", nargs="*",
                    default=["fused", "fused,kFusedSlices=1"],
                    help="variants of rwkv6_wkv_chunk.cu: fused and/or "
                         "NAME=VALUE, joined by commas")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    ssd_race(args.ssd, args.rounds)
    wkv_race(args.wkv, args.rounds)
    profile_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
