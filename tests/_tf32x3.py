"""The 3xTF32 products of B4's and B5's chunk bodies, emulated in torch,
and the tolerance ``chip_smoke.py`` holds those bodies to, for the CPU
tests of ``test_torch_rwkv6_wkv.py`` and ``test_torch_mamba2_ssd.py``."""

import numpy as np
import torch

# chip_smoke.py's WKV_TOL: y and the f32 state within 2e-5 of their
# largest magnitude (bf16 y also within one bf16 ulp of itself).
WKV_TOL = 2e-5


def tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to 10 mantissa bits, to nearest
    with ties away from zero (the split's big part)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncated(x):
    """The TF32 value an MMA reads from an f32 register (13 low bits
    ignored)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm(a, b, products):
    """a @ b as the chunk bodies' tensor cores take it: ``"tf32x3"`` sums
    small big + big small + big big (an operand exact in TF32, such as a
    widened bf16, has small = 0); ``"tf32"`` one TF32 product;
    ``"bf16"`` one product of bf16 operands; all summed in f32."""
    if products == "tf32x3":
        a_b, b_b = tf32(a), tf32(b)
        a_s, b_s = truncated(a - a_b), truncated(b - b_b)
        return (a_s @ b_b + a_b @ b_s) + a_b @ b_b
    if products == "tf32":
        return tf32(a) @ tf32(b)
    return a.bfloat16().float() @ b.bfloat16().float()


def within_wkv_tol(got_y, got_s, want_y, want_s, kind):
    """(held, (y error, state error) relative to each one's largest
    magnitude): y within WKV_TOL of max |want| (bf16: plus one bf16 ulp
    of each element), the state within WKV_TOL of its max."""
    got_y = got_y.float().numpy()
    es = np.abs(got_s.numpy() - want_s).max() / np.abs(want_s).max()
    ey = np.abs(got_y - want_y)
    ulp = 2.0 ** -7 * np.abs(want_y) if kind == "bf16" else 0.0
    return (ey <= WKV_TOL * np.abs(want_y).max() + ulp).all() and \
        es <= WKV_TOL, (float(ey.max() / np.abs(want_y).max()), float(es))
