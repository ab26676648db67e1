"""The port's ``serving.kvquant`` against the reference's, bit for bit.

Inputs come from seeded numpy generators and go through both packages:
``block_scale``, ``quantize`` (int8 words; fp8 bytes compared through a
``uint8`` view) and ``dequantize`` agree on every bit in bf16 and f32,
including round-half-to-even ties and blocks whose largest element sits
exactly at the absmax; the contract helpers give equal results and raise
alike.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.serving import kvquant as jq
from repro_torch.serving import kvquant as tq

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _block(seed, shape=(5, 4, 3, 16), scale=3.0):
    r = np.random.default_rng(seed)
    x = (r.normal(size=shape) * scale).astype(np.float32)
    x[0] = 0.0                               # an all-zero block row
    return x


def _both(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.tensor(x).to(td)


def _bits(a):
    """Raw bits of a JAX or torch array as a numpy unsigned array."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.int8):
            a = a.view({1: torch.uint8, 2: torch.int16}[a.element_size()])
        return a.numpy().view({1: np.uint8, 2: np.uint16,
                               4: np.uint32}[a.element_size()])
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def test_dtype_tables_match_the_reference():
    assert tq.KV_DTYPES == jq.KV_DTYPES
    for kvd in ("int8", "fp8"):
        assert tq.qmax(kvd) == jq.qmax(kvd)
        assert tq.is_quantized(kvd) and jq.is_quantized(kvd)
        assert tq.pool_dtype(kvd).itemsize == 1
    assert not tq.is_quantized("bf16")
    assert tq.pool_dtype("int8") == torch.int8
    assert tq.pool_dtype("fp8") == torch.float8_e4m3fn
    assert tq.scale_bytes_per_block(8) == jq.scale_bytes_per_block(8) == 32
    for bad in ("int4", "f32"):
        for mod in (tq, jq):
            with pytest.raises(ValueError, match="kv_dtype"):
                mod.validate_kv_dtype(bad)


@pytest.mark.parametrize("kvd", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_scale_quantize_dequantize_bit_identical(kvd, dtype, seed):
    """The (R, T, KV, D) block's scale over (T, D), its narrow words and
    their widening to bf16 and f32, bit for bit."""
    jx, tx = _both(_block(seed), dtype)
    js, ts = jq.block_scale(jx, (1, 3), kvd), tq.block_scale(tx, (1, 3), kvd)
    assert tuple(ts.shape) == js.shape == (5, 1, 3, 1)
    assert np.array_equal(_bits(ts), _bits(js))
    assert float(ts[0].max()) == 1.0             # zero rows: scale 1
    jw, tw = jq.quantize(jx, js, kvd), tq.quantize(tx, ts, kvd)
    assert tw.dtype == tq.pool_dtype(kvd)
    assert np.array_equal(_bits(tw), _bits(jw))
    for cd in DTYPES:
        jd, td = DTYPES[cd]
        assert np.array_equal(_bits(tq.dequantize(tw, ts, td)),
                              _bits(jq.dequantize(jw, js, jd)))


@pytest.mark.parametrize("kvd", ["int8", "fp8"])
def test_block_maximum_at_the_absmax_quantizes_to_qmax(kvd):
    """Each block's largest |x| divides by its own scale to QMAX within an
    f32 rounding and quantizes to +-QMAX in both frameworks — far from
    the magnitudes (> 464) where torch's saturating e4m3fn cast and the
    reference's NaN-producing one part."""
    x = _block(3, scale=50.0)
    jx, tx = _both(x, "float32")
    ts = tq.block_scale(tx, (1, 3), kvd)
    jw = jq.quantize(jx, jq.block_scale(jx, (1, 3), kvd), kvd)
    tw = tq.quantize(tx, ts, kvd)
    assert np.array_equal(_bits(tw), _bits(jw))
    top = tw.float().abs().amax(dim=(1, 3))[1:]
    assert torch.equal(top, torch.full_like(top, tq.qmax(kvd)))
    assert torch.isfinite(tw.float()).all()


def test_int8_ties_round_half_to_even_like_the_reference():
    """Values exactly halfway between two int8 words under a power-of-two
    scale: both frameworks round to the even word."""
    s = np.float32(2.0 ** -3)
    k = np.arange(-126, 126, dtype=np.float32)
    x = ((k + 0.5) * s)[None, :, None, None]
    x = np.concatenate([x, np.full_like(x, 127 * s)], axis=1)
    jx, tx = _both(x, "float32")
    scale = np.full((1, 1, 1, 1), s, np.float32)
    jw = jq.quantize(jx, jnp.asarray(scale), "int8")
    tw = tq.quantize(tx, torch.tensor(scale), "int8")
    assert np.array_equal(_bits(tw), _bits(jw))
    got = tw.numpy().ravel()[:k.size].astype(np.int64)
    assert np.all(got % 2 == 0)


def test_quantize_refuses_bf16():
    with pytest.raises(ValueError, match="not narrow"):
        tq.quantize(torch.ones(2), torch.ones(1), "bf16")


def test_as_bytes_is_a_view_of_one_byte_pools():
    w = tq.quantize(torch.tensor([[1.0, -2.0]]), torch.tensor([[1.0]]),
                    "fp8")
    b = tq.as_bytes(w)
    assert b.dtype == torch.uint8 and b.data_ptr() == w.data_ptr()
    wide = torch.ones(3, dtype=torch.bfloat16)
    assert tq.as_bytes(wide) is wide


_REF = [[1, 2, 3, 4], [5, 6], [7], []]
_GOT = [[1, 2, 9, 4], [5, 6], [8], [3]]


@pytest.mark.parametrize("kvd", ["bf16", "int8", "fp8"])
def test_contract_helpers_match_the_reference(kvd):
    assert tq.tolerance_contract(kvd) == jq.tolerance_contract(kvd)
    assert tq.token_agreement(_REF, _GOT) == jq.token_agreement(_REF, _GOT)
    assert tq.token_agreement([], []) == jq.token_agreement([], []) == 1.0
    c = tq.tolerance_contract(kvd)
    assert tq.assert_tokens_match(_REF, _REF, c) == \
        jq.assert_tokens_match(_REF, _REF, c)
    if kvd != "bf16":
        assert c["min_agreement"] == 0.45
        near = [[1, 2, 3, 4], [5, 6], [7], [3]]
        assert tq.assert_tokens_match(_REF, near, c) == \
            jq.assert_tokens_match(_REF, near, c)


@pytest.mark.parametrize("kvd", ["bf16", "int8"])
@pytest.mark.parametrize("got", [_GOT, _REF[:3]])
def test_contract_violations_raise_alike(kvd, got):
    c = tq.tolerance_contract(kvd)
    bad = got if kvd == "bf16" else [[0], [0], [0], [0]]
    msgs = []
    for mod in (tq, jq):
        with pytest.raises(AssertionError) as exc:
            mod.assert_tokens_match(_REF, bad, c, "lbl")
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and msgs[0].startswith("lbl")
