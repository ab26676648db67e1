"""Quantized KV block storage: dtypes, scales, and the ladder contract
(port of ``repro/serving/kvquant.py``).

The paged pool (``serving.paged``) can store its KV blocks in a narrow
dtype — the bit-width-reduction refinement of the scratchpad ladder.
Everything dtype-specific lives here so the allocator, both attention
paths (gather and the block-table kernels B1/B2), the prefill/verify
multi-token writers and the tests agree on one definition of

  * the storable dtypes (``KV_DTYPES``) and their torch types,
  * the per-(block x kv-head) absmax scale (``block_scale``),
  * the quantize/dequantize rounding (``quantize`` / ``dequantize``),
  * and the LADDER CONTRACT each dtype buys (``tolerance_contract``):
    bf16 pools stay bit-identical to the contiguous O5 reference; narrow
    pools trade bit-identity for a measured minimum token-prefix
    agreement.

Scale convention: one f32 scale per (pool block row, kv head), computed
as ``absmax / QMAX`` over the block's token and head-dim axes.  Zero
blocks get scale 1, so dequantizing an all-zero block gives exactly 0,
as the zero-initialized bf16 pool does; a never-written row's scale is
0 (the pool's scales start zeroed) and dequantizes to 0 as well.

The pool code gathers and scatters 1-byte pools through
:func:`as_bytes`, a ``uint8`` view of the same bytes, so no step depends
on which indexing ops a torch build implements for ``float8_e4m3fn``.
"""

from __future__ import annotations

import torch

# Storable pool dtypes.  "bf16" is the identity (no scales, bit-exact
# ladder); the narrow pair store 1-byte words with per-block scales.
KV_DTYPES = ("bf16", "int8", "fp8")

# Largest representable magnitude per narrow dtype: int8 is symmetric
# [-127, 127] (-128 is never emitted, so negation round-trips); fp8
# e4m3fn's largest finite value is 448.
_QMAX = {"int8": 127.0, "fp8": 448.0}

_POOL_DTYPE = {
    "bf16": torch.bfloat16,
    "int8": torch.int8,
    "fp8": torch.float8_e4m3fn,
}


def validate_kv_dtype(kv_dtype: str) -> str:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r}; choices: {KV_DTYPES}")
    return kv_dtype


def is_quantized(kv_dtype: str) -> bool:
    return validate_kv_dtype(kv_dtype) != "bf16"


def pool_dtype(kv_dtype: str) -> torch.dtype:
    """The torch dtype pool block leaves are stored in."""
    return _POOL_DTYPE[validate_kv_dtype(kv_dtype)]


def qmax(kv_dtype: str) -> float:
    return _QMAX[kv_dtype]


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A 1-byte pool (or block) as ``uint8`` — a view of the same bytes
    that every device can index, gather and scatter; wider tensors are
    returned as they are."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


def block_scale(x, reduce_axes: tuple, kv_dtype: str):
    """Per-block absmax scale: f32, keepdims over ``reduce_axes`` (the
    block's token axis and head-dim axis), ``absmax / QMAX``; all-zero
    blocks get scale 1 so their dequantized value is exactly 0."""
    absmax = x.float().abs().amax(dim=reduce_axes, keepdim=True)
    m = qmax(kv_dtype)
    return torch.where(absmax > 0, absmax, m) / m


def quantize(x, scale, kv_dtype: str):
    """Round ``x`` (any float dtype) into the narrow dtype under ``scale``
    (broadcastable f32).  Round to nearest, ties to even
    (``torch.round``, like ``jnp.round``); int8 clips to the symmetric
    [-127, 127] range.

    fp8: a cast past e4m3fn's range ends differently by build — torch's
    CPU cast saturates at +-448 (torch 2.13), its CUDA cast gives NaN
    (torch 2.11 on an H100), and the reference's ml_dtypes cast gives NaN
    past about 464.  ``x / scale`` never gets there: the block's absmax
    divides to 448 (to within an f32 rounding), so real blocks quantize
    to the same bytes everywhere."""
    scaled = x.float() / scale
    if kv_dtype == "int8":
        return torch.round(scaled).clamp(-127, 127).to(torch.int8)
    if kv_dtype == "fp8":
        return scaled.to(torch.float8_e4m3fn)
    raise ValueError(f"quantize: kv_dtype {kv_dtype!r} is not narrow")


def dequantize(q, scale, compute_dtype=torch.bfloat16):
    """Widen a narrow block back to the compute dtype.  The f32 multiply
    then single cast to ``compute_dtype`` is THE rounding site both
    attention paths share: the gather path dequantizes the dense view
    with it, and the block-table kernel applies the identical expression
    to each staged block, so the two paged paths see bit-identical KV
    values."""
    return (q.float() * scale).to(compute_dtype)


def scale_bytes_per_block(n_kv_heads: int) -> int:
    """Bytes of scale metadata stored per pool block row per K/V tensor
    (one f32 per kv head)."""
    return n_kv_heads * 4


def tolerance_contract(kv_dtype: str) -> dict:
    """The ladder contract a pool dtype buys, as data the tests and
    :func:`assert_tokens_match` consume:

      * ``exact`` — greedy tokens must be BIT-IDENTICAL to the reference
        (bf16 pools);
      * ``min_agreement`` — for narrow pools, the minimum mean
        per-request matched-prefix fraction against the bf16/O5
        reference.  One flipped token reroutes the rest of its request,
        so the metric is the matched PREFIX, gated well below what
        per-block absmax int8/fp8 reaches on the smoke models but far
        above what a broken scale or rounding site gives (~1/vocab).
    """
    if not is_quantized(kv_dtype):
        return {"kv_dtype": kv_dtype, "exact": True, "min_agreement": 1.0}
    return {"kv_dtype": kv_dtype, "exact": False, "min_agreement": 0.45}


def token_agreement(ref: list, got: list) -> float:
    """Mean per-request matched-prefix fraction between two lists of
    token lists (the tolerance metric of ``tolerance_contract``)."""
    if not ref:
        return 1.0
    total = 0.0
    for r, g in zip(ref, got):
        n = max(len(r), len(g), 1)
        k = 0
        for a, b in zip(r, g):
            if a != b:
                break
            k += 1
        total += k / n
    return total / len(ref)


def assert_tokens_match(ref: list, got: list, contract: dict,
                        label: str = "") -> float:
    """Enforce a ``tolerance_contract`` between two per-request token
    lists and return the measured agreement: exact contracts (bf16)
    demand bit-identity with a first-divergence diagnostic; narrow
    contracts gate :func:`token_agreement` on the contract's floor."""
    if contract["exact"]:
        if ref != got:
            for i, (r, g) in enumerate(zip(ref, got)):
                if r != g:
                    raise AssertionError(
                        f"{label or 'tokens'}: exact contract "
                        f"({contract['kv_dtype']}) violated at request "
                        f"{i}: {r} != {g}")
            raise AssertionError(
                f"{label or 'tokens'}: exact contract "
                f"({contract['kv_dtype']}) violated: "
                f"{len(ref)} vs {len(got)} requests")
        return 1.0
    agreement = token_agreement(ref, got)
    if agreement < contract["min_agreement"]:
        raise AssertionError(
            f"{label or 'tokens'}: agreement {agreement:.3f} below the "
            f"{contract['kv_dtype']} contract floor "
            f"{contract['min_agreement']}")
    return agreement
