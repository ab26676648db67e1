"""Narrow (int8, fp8) KV pools in the port, against the JAX reference.

* The plain versions of B1/B2 with ``k_scale``/``v_scale`` against the
  Pallas kernels' quantized branch in interpret mode (f32 within rtol
  1e-5 / atol 1e-6, bf16 within one bf16 ulp), a narrow pool equal bit
  for bit to its pool dequantized with ``kvquant.dequantize``, garbage in
  the NULL block, its scale row and stale tails never leaking, and the
  wrappers' refusals.
* ``paged_decode_attention`` / ``paged_chunk_prefill_attention`` on a
  narrow pool against the reference's in f32: outputs, the re-derived
  scales and the re-quantized words.
* ``BlockPagingPlan``'s geometry, byte counts, gather, scatter and
  scatter_view with scales against the reference plan's.
* The engine at O6 (gather and kernel, chunked prefill) and O7 on int8
  and fp8 pools against the JAX O5 engine's tokens under
  ``kvquant.tolerance_contract``, bit-deterministic from run to run.

Inputs are drawn with numpy and handed to both packages.  Scales travel
as (R, KV) in the port and keepdims (R, 1, KV, 1) in the reference; the
tests convert between the two.
"""

import dataclasses

import ml_dtypes
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.core.optlevel import BestEffortConfig as JaxConfig
from repro.core.optlevel import OptLevel as JaxLevel
from repro.kernels.paged_attention import ops as jops
from repro.models import attention as jattn
from repro.models import get_model as jax_get_model
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import kvquant as jq
from repro.serving.paged import BlockPagingPlan as JaxPlan
from repro_torch.configs import get_smoke
from repro_torch.core.optlevel import BestEffortConfig, OptLevel
from repro_torch.kernels.paged_attention import ops
from repro_torch.models import attention as tattn
from repro_torch.models import get_model
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving import DecodeEngine, Request
from repro_torch.serving import kvquant as tq
from repro_torch.serving.paged import BlockPagingPlan

NARROW = ["int8", "fp8"]
_NP_WORD = {"int8": np.int8, "fp8": ml_dtypes.float8_e4m3fn}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _quantized(r, shape, kvd):
    """Normal data quantized per (row, kv head) block by the reference:
    (words as uint8 bytes, (R, KV) f32 scales)."""
    x = jnp.asarray(r.normal(size=shape).astype(np.float32))
    s = jq.block_scale(x, (1, 3), kvd)
    return (np.asarray(jq.quantize(x, s, kvd)).view(np.uint8),
            np.asarray(s)[:, 0, :, 0].copy())


def _to_jax(words, kvd):
    return jnp.asarray(words.view(_NP_WORD[kvd]))


def _to_torch(words, kvd):
    return torch.from_numpy(words.copy()).view(tq.pool_dtype(kvd))


def _case(B, H, KV, D, T, nb, kvd, *, seed=1, Q=None, extra_rows=2):
    """A narrow pool of shuffled rows covering each slot's prefix, NULL
    table entries past it, per-(row, head) scales (a zero, never-written
    scale row among the unreferenced ones), q (B, H, D) or (B, Q, H, D),
    lengths >= Q; all numpy."""
    r = np.random.default_rng(seed)
    lengths = r.integers(Q or 1, nb * T + 1, B).astype(np.int32)
    R = 1 + B * nb + extra_rows
    (kw, ks), (vw, vs) = (_quantized(r, (R, T, KV, D), kvd)
                          for _ in range(2))
    ks[-1] = vs[-1] = 0.0
    tables = np.zeros((B, nb), np.int32)
    free = list(range(1, R))
    r.shuffle(free)
    for b in range(B):
        for j in range(-(-int(lengths[b]) // T)):
            tables[b, j] = free.pop()
    q = r.normal(size=(B, H, D) if Q is None else (B, Q, H, D))
    return dict(q=q.astype(np.float32), kw=kw, vw=vw, ks=ks, vs=vs,
                tables=tables, lengths=lengths, kvd=kvd)


def _port_call(c, dtype, **over):
    c = dict(c, **over)
    fn = ops.paged_attention if c["q"].ndim == 3 else \
        ops.paged_prefill_attention
    kvd = c["kvd"]
    out = fn(torch.tensor(c["q"]).to(_TORCH[dtype]), _to_torch(c["kw"], kvd),
             _to_torch(c["vw"], kvd), torch.tensor(c["tables"]),
             torch.tensor(c["lengths"]), k_scale=torch.tensor(c["ks"]),
             v_scale=torch.tensor(c["vs"]))
    assert out.dtype == _TORCH[dtype]
    return out.float().numpy()


def _jax_call(c, dtype):
    fn = jops.paged_attention if c["q"].ndim == 3 else \
        jops.paged_prefill_attention
    kvd = c["kvd"]
    out = fn(jnp.asarray(c["q"], _JAX[dtype]), _to_jax(c["kw"], kvd),
             _to_jax(c["vw"], kvd), jnp.asarray(c["tables"]),
             jnp.asarray(c["lengths"]), k_scale=jnp.asarray(c["ks"]),
             v_scale=jnp.asarray(c["vs"]))
    return np.asarray(out.astype(jnp.float32))


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


_DIMS = [(3, 4, 2, 16, 4, 6), (2, 8, 2, 128, 16, 4), (1, 3, 1, 32, 4, 3)]


@pytest.mark.parametrize("kvd", NARROW)
@pytest.mark.parametrize("dims", _DIMS)
@pytest.mark.parametrize("Q", [None, 3])
def test_plain_matches_jax_quantized_kernel_f32(kvd, dims, Q):
    """f32 q: B1 (Q None) and B2 (Q=3) on a narrow pool against the
    Pallas kernels' quantized branch, within reduction-order noise."""
    c = _case(*dims, kvd, Q=Q, seed=2)
    np.testing.assert_allclose(_port_call(c, "float32"),
                               _jax_call(c, "float32"), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kvd", NARROW)
@pytest.mark.parametrize("dims", _DIMS[:2])
@pytest.mark.parametrize("Q", [None, 4])
def test_plain_matches_jax_quantized_kernel_bf16_within_one_ulp(kvd, dims,
                                                                Q):
    """bf16 q: each output within one bf16 ulp of the Pallas kernel's
    (the dequant rounds to bf16 at the same site in both)."""
    c = _case(*dims, kvd, Q=Q, seed=3)
    got, want = _port_call(c, "bfloat16"), _jax_call(c, "bfloat16")
    assert np.all(np.abs(got - want) <= _bf16_ulp(want)), \
        np.abs(got - want).max()


@pytest.mark.parametrize("kvd", NARROW)
@pytest.mark.parametrize("Q", [None, 5])
def test_narrow_pool_equals_its_dequantized_pool_bitwise(kvd, Q):
    """Quantized B1/B2 == B1/B2 on the same pool dequantized to bf16 with
    ``kvquant.dequantize`` and no scales, bit for bit (bf16 q), as the
    reference's test_kernels pins for the Pallas kernel."""
    c = _case(2, 8, 2, 128, 16, 4, kvd, Q=Q, seed=4)
    kw, vw = _to_torch(c["kw"], kvd), _to_torch(c["vw"], kvd)
    ks, vs = torch.tensor(c["ks"]), torch.tensor(c["vs"])
    q = torch.tensor(c["q"]).bfloat16()
    t, lens = torch.tensor(c["tables"]), torch.tensor(c["lengths"])
    fn = ops.paged_attention if Q is None else ops.paged_prefill_attention
    narrow = fn(q, kw, vw, t, lens, k_scale=ks, v_scale=vs)
    wide = fn(q, tq.dequantize(kw, ks[:, None, :, None]),
              tq.dequantize(vw, vs[:, None, :, None]), t, lens)
    assert torch.equal(narrow, wide)


@pytest.mark.parametrize("Q", [None, 3])
def test_null_block_scale_row_and_stale_tails_never_leak(Q):
    """NaN bytes in the NULL block and every unreferenced row, NaN in
    their scale rows, and NaN bytes past each slot's length change no
    output bit (fp8, the narrow dtype that has a NaN)."""
    c = _case(3, 4, 2, 16, 4, 6, "fp8", Q=Q, seed=9)
    clean = _port_call(c, "float32")
    kw, vw, ks, vs = (c[k].copy() for k in ("kw", "vw", "ks", "vs"))
    T = kw.shape[1]
    used = {int(c["tables"][b, j]) for b in range(3)
            for j in range(-(-int(c["lengths"][b]) // T))}
    for row in set(range(kw.shape[0])) - used:
        kw[row] = vw[row] = 0x7F
        ks[row] = vs[row] = np.nan
    for b, L in enumerate(c["lengths"]):
        if L % T:
            kw[c["tables"][b, L // T], L % T:] = 0x7F
            vw[c["tables"][b, L // T], L % T:] = 0x7F
    dirty = _port_call(c, "float32", kw=kw, vw=vw, ks=ks, vs=vs)
    assert np.isfinite(dirty).all()
    assert np.array_equal(clean, dirty)


def test_wrappers_refuse_bad_scales():
    c = _case(2, 4, 2, 16, 4, 4, "int8")
    q = torch.tensor(c["q"])
    kw, vw = _to_torch(c["kw"], "int8"), _to_torch(c["vw"], "int8")
    t, lens = torch.tensor(c["tables"]), torch.tensor(c["lengths"])
    ks, vs = torch.tensor(c["ks"]), torch.tensor(c["vs"])
    bad = {
        "together": dict(k_scale=ks),
        "takes k_scale": {},
        "mismatch": dict(k_scale=ks.T.contiguous(), v_scale=vs),
        "contiguous": dict(k_scale=ks, v_scale=vs.T.contiguous().T),
        "float32": dict(k_scale=ks.double(), v_scale=vs),
    }
    for match, kw_ in bad.items():
        for fn, qq in ((ops.paged_attention, q),
                       (ops.paged_prefill_attention, q[:, None])):
            with pytest.raises(ValueError, match=match):
                fn(qq, kw, vw, t, lens, **kw_)
    wide = torch.zeros(kw.shape)
    with pytest.raises(ValueError, match="no scales"):
        ops.paged_attention(q, wide, wide, t, lens, k_scale=ks, v_scale=vs)
    # 1-byte rows are 16-byte loads only at head_dim a multiple of 16
    c8 = _case(2, 4, 2, 8, 4, 4, "int8")
    with pytest.raises(ValueError, match="16-byte"):
        ops.paged_attention(torch.tensor(c8["q"]),
                            _to_torch(c8["kw"], "int8"),
                            _to_torch(c8["vw"], "int8"),
                            torch.tensor(c8["tables"]),
                            torch.tensor(c8["lengths"]),
                            k_scale=torch.tensor(c8["ks"]),
                            v_scale=torch.tensor(c8["vs"]))


def test_cpu_tensors_take_the_plain_version():
    c = _case(2, 4, 2, 16, 4, 4, "fp8")
    before = (ops.paged_attention.launches,
              ops.paged_prefill_attention.launches)
    _port_call(c, "float32")
    _port_call(_case(2, 4, 2, 16, 4, 4, "fp8", Q=2), "float32")
    assert (ops.paged_attention.launches,
            ops.paged_prefill_attention.launches) == before


# ---------------------------------------------------------------------------
# The attention functions' requant-on-append writers
# ---------------------------------------------------------------------------

_A = dict(n_heads=4, n_kv=2, head_dim=16, qk_norm=True, rope_theta=1e4)


def _attn_case(kvd, *, B=3, T=4, nb=6, d=32, seed=0):
    """Layer params, a narrow pool quantized per block from random data
    (so its scales are real absmax scales), tables and the numpy
    arrays both sides start from."""
    r = np.random.default_rng(seed)
    H, KV, D = _A["n_heads"], _A["n_kv"], _A["head_dim"]
    params = {"wq": r.normal(size=(d, H, D)) * 0.2,
              "wk": r.normal(size=(d, KV, D)) * 0.2,
              "wv": r.normal(size=(d, KV, D)) * 0.2,
              "wo": r.normal(size=(H, D, d)) * 0.2,
              "q_norm": 1 + 0.1 * r.normal(size=(D,)),
              "k_norm": 1 + 0.1 * r.normal(size=(D,))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    R = 1 + B * nb
    pools = [_quantized(r, (R, T, KV, D), kvd) for _ in range(2)]
    tables = np.arange(1, R, dtype=np.int32).reshape(B, nb)
    return params, pools, tables, r


def _run_both(kvd, params, pools, tables, x, fn_j, fn_t, args, kw=None):
    """The reference's function and the port's on the same numpy inputs
    (``args`` after the tables, ``kw`` keywords); returns the outputs and
    the written leaves, NULL row dropped (write garbage on both sides):
    (jax out, jax (k, v, sk, sv)), (port out, port leaves)."""
    kw = kw or {}
    jkvs = tuple(_to_jax(w, kvd) for w, _ in pools) + tuple(
        jnp.asarray(s)[:, None, :, None] for _, s in pools)
    jout, jnew = fn_j({k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(x), jkvs, jnp.asarray(tables),
                      *map(jnp.asarray, args), kv_dtype=kvd,
                      **{k: jnp.asarray(v) for k, v in kw.items()}, **_A)
    tkvs = tuple(_to_torch(w, kvd) for w, _ in pools) + tuple(
        torch.tensor(s) for _, s in pools)
    tout, _ = fn_t({k: torch.tensor(v) for k, v in params.items()},
                   torch.tensor(x), tkvs, torch.tensor(tables),
                   *map(torch.tensor, args), kv_dtype=kvd,
                   **{k: torch.tensor(v) for k, v in kw.items()}, **_A)
    return ((np.asarray(jout), tuple(np.asarray(a)[1:] for a in jnew)),
            (tout.numpy(), tuple(t[1:] for t in tkvs)))


def _hold_writes(kvd, jnew, tkvs, max_flips):
    """New scales within 1e-6 relative; words equal except at most
    ``max_flips`` one-unit rounding flips (projections summed in another
    order could land a value on the other side of a tie; none was seen
    in any case of this file)."""
    flips = 0
    for jw, tw in zip(jnew[:2], tkvs[:2]):
        a = np.asarray(jw).view(np.uint8).astype(np.int64)
        b = tq.as_bytes(tw).numpy().astype(np.int64)
        if kvd == "int8":
            a, b = a.astype(np.uint8).view(np.int8), b.astype(np.uint8).view(
                np.int8)
        diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
        assert diff.max() <= 1, diff.max()
        flips += int((diff > 0).sum())
    for js, ts in zip(jnew[2:], tkvs[2:]):
        np.testing.assert_allclose(ts.numpy(), np.asarray(js)[:, 0, :, 0],
                                   rtol=1e-6, atol=0)
    assert flips <= max_flips, flips
    return flips


@pytest.mark.parametrize("kvd", NARROW)
def test_paged_decode_attention_narrow_matches_jax_f32(kvd):
    """One decode step per slot at positions in the middle, at the start
    and at the end of a block: the output within 1e-5 relative, the
    active blocks re-quantized alike."""
    params, pools, tables, r = _attn_case(kvd)
    x = r.normal(size=(3, 1, 32)).astype(np.float32)
    pos = np.array([5, 8, 23], np.int32)
    (jo, jnew), (to, tkvs) = _run_both(
        kvd, params, pools, tables, x, jattn.paged_decode_attention,
        tattn.paged_decode_attention, (pos,))
    np.testing.assert_allclose(to, jo, rtol=1e-5,
                               atol=1e-5 * np.abs(jo).max())
    _hold_writes(kvd, jnew, tkvs, max_flips=2)


@pytest.mark.parametrize("kvd", NARROW)
@pytest.mark.parametrize("starts,C", [([0, 3, 13], 5), ([2, 7, 20], 4),
                                      ([9, 0, 18], 6)])
def test_paged_chunk_prefill_attention_narrow_matches_jax_f32(kvd, starts,
                                                              C):
    """A C-token window per slot — the last case's third slot ends at the
    table horizon (18 + 6 = nb * T = 24), so its ceil(C / T) + 1 block
    window runs one entry past the table, which goes to the NULL block:
    the window's blocks re-quantized alike, the output within 1e-5
    relative.  (A window clipped AT the horizon is not compared: there
    the reference's last duplicate write wins, the port's writes all
    carry the owning row's K/V, and the block's absmax can differ.)"""
    params, pools, tables, r = _attn_case(kvd)
    T, nb = 4, tables.shape[1]
    x = r.normal(size=(3, C, 32)).astype(np.float32)
    start = np.array(starts, np.int32)
    positions = np.clip(start[:, None] + np.arange(C), 0,
                        nb * T - 1).astype(np.int32)
    lengths = (start + C).astype(np.int32)
    (jo, jnew), (to, tkvs) = _run_both(
        kvd, params, pools, tables, x, jattn.paged_chunk_prefill_attention,
        tattn.paged_chunk_prefill_attention, (positions, lengths),
        dict(start=start))
    np.testing.assert_allclose(to, jo, rtol=1e-5,
                               atol=1e-5 * np.abs(jo).max())
    _hold_writes(kvd, jnew, tkvs, max_flips=4)


# ---------------------------------------------------------------------------
# BlockPagingPlan with scales
# ---------------------------------------------------------------------------

_MODELS = {}


def _models():
    """(jax model, jax params, port model, port params): the qwen3-8b
    smoke config in float32 compute, the same weights on both sides."""
    if not _MODELS:
        jcfg = dataclasses.replace(jax_smoke("qwen3-8b"),
                                   compute_dtype="float32")
        jm = jax_get_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = get_model(dataclasses.replace(get_smoke("qwen3-8b"),
                                           compute_dtype="float32"),
                       device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu",
                             dtype=torch.float32)
        _MODELS["m"] = (jm, jp, tm, tp)
    return _MODELS["m"]


def _plans(kvd, B=3, max_seq=24, T=4, pool_blocks=14):
    jm, _, tm, _ = _models()
    return (JaxPlan(jm, B, max_seq, T, pool_blocks, kv_dtype=kvd),
            BlockPagingPlan(tm, B, max_seq, T, pool_blocks, kv_dtype=kvd))


@pytest.mark.parametrize("kvd", ["bf16"] + NARROW)
def test_plan_geometry_and_bytes_match_the_reference(kvd):
    jp, tp = _plans(kvd)
    assert tp.geometry == jp.geometry
    for attr in ("token_bytes", "compute_token_bytes",
                 "scale_bytes_per_block", "quantized"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    assert tp.gather_bytes_per_tick() == jp.gather_bytes_per_tick()
    for lens in ([1, 5, 9], [24, 24, 1], [4, 8, 12]):
        assert tp.kernel_bytes_per_tick(lens) == \
            jp.kernel_bytes_per_tick(lens)
    if kvd != "bf16":
        # (k, v) x 2 layers x 2 kv heads x 4 B of scales per block row
        assert tp.scale_bytes_per_block == 2 * 2 * 2 * 4
        assert tp.token_bytes * 2 == tp.compute_token_bytes


def _plan_state(kvd, jp, r):
    """The same narrow pool and scales for both plans: the port's
    {name: (L, R, T, KV, dh)} words and {name: (L, R, KV)} scales, the
    reference's trees (keepdims scales)."""
    jpool, _ = jp.init_pool(_models()[0])
    words, scales = {}, {}
    for name, leaf in jpool.items():
        L, R, T, KV, D = leaf.shape
        flat, s = _quantized(r, (L * R, T, KV, D), kvd)
        words[name] = flat.reshape(L, R, T, KV, D)
        scales[name] = s.reshape(L, R, KV)
    jtree = {n: _to_jax(w, kvd) for n, w in words.items()}
    jscale = {n: jnp.asarray(s)[:, :, None, :, None]
              for n, s in scales.items()}
    ttree = {n: _to_torch(w, kvd) for n, w in words.items()}
    tscale = {n: torch.tensor(s) for n, s in scales.items()}
    return jtree, jscale, ttree, tscale


def _tables(B=3, nb=6):
    t = np.zeros((B, nb), np.int32)
    t[0, :4] = [3, 7, 1, 12]
    t[1, :6] = [2, 4, 6, 8, 10, 14]
    t[2, :2] = [5, 9]                        # the rest NULL
    return t


def _same_rows(jtree, jscale, ttree, tscale):
    """Pool words and scales equal bit for bit, NULL row aside."""
    for n in ttree:
        a = np.asarray(jtree[n]).view(np.uint8)[:, 1:]
        b = tq.as_bytes(ttree[n]).numpy()[:, 1:]
        assert np.array_equal(a, b), n
        assert np.array_equal(np.asarray(jscale[n])[:, 1:, 0, :, 0],
                              tscale[n].numpy()[:, 1:]), n


@pytest.mark.parametrize("kvd", NARROW)
def test_plan_gather_scatter_with_scales_match_the_reference(kvd):
    """gather dequantizes to the same bf16 view; scatter re-quantizes the
    one block each slot wrote (positions past the write zeroed) and
    scatter_view every block (positions past ``lengths`` zeroed) into the
    same words and scales."""
    r = np.random.default_rng(11)
    jp, tp = _plans(kvd)
    jtree, jscale, ttree, tscale = _plan_state(kvd, jp, r)
    tables = _tables()
    jd = jp.gather(jtree, jnp.asarray(tables), jscale)
    td = tp.gather(ttree, torch.tensor(tables), tscale)
    for n in td:
        assert td[n].dtype == torch.bfloat16
        assert np.array_equal(
            np.asarray(jd[n].astype(jnp.float32)), td[n].float().numpy())

    new = {n: r.normal(size=td[n].shape).astype(np.float32) for n in td}
    pos = np.array([13, 22, 5], np.int32)
    jtree, jscale = jp.scatter(
        jtree, jnp.asarray(tables),
        {n: jnp.asarray(v, jnp.bfloat16) for n, v in new.items()},
        jnp.asarray(pos), scales=jscale)
    tp.scatter(ttree, torch.tensor(tables),
               {n: torch.tensor(v).bfloat16() for n, v in new.items()},
               torch.tensor(pos), tscale)
    _same_rows(jtree, jscale, ttree, tscale)

    lens = np.array([10, 24, 7], np.int32)
    jtree, jscale = jp.scatter_view(
        jtree, jnp.asarray(tables),
        {n: jnp.asarray(v, jnp.bfloat16) for n, v in new.items()},
        scales=jscale, lengths=jnp.asarray(lens))
    tp.scatter_view(ttree, torch.tensor(tables),
                    {n: torch.tensor(v).bfloat16() for n, v in new.items()},
                    tscale, lengths=torch.tensor(lens))
    _same_rows(jtree, jscale, ttree, tscale)


# ---------------------------------------------------------------------------
# The engine on narrow pools against the JAX O5 engine
# ---------------------------------------------------------------------------

_POOL = dict(kv_block_size=4, kv_pool_blocks=14)


def _random_mix(seed, vocab=256, *, n=8, prompt_hi=10, new_hi=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, int(rng.integers(1, prompt_hi))).tolist(),
             int(rng.integers(1, new_hi))) for _ in range(n)]


def _drive(eng, request_cls, mix, *, eos, late_from, check=False):
    head = mix[:late_from]
    rids = [eng.submit(request_cls(prompt=list(p), max_new_tokens=n,
                                   eos_id=eos.get(k)))
            for k, (p, n) in enumerate(head)]
    for _ in range(2):
        eng.step()
    rids += [eng.submit(request_cls(prompt=list(p), max_new_tokens=n,
                                    eos_id=eos.get(late_from + k)))
             for k, (p, n) in enumerate(mix[late_from:])]
    for _ in range(1000):
        stepped = eng.step()
        if check:
            eng.cache_mgr.check_conservation()
        if not stepped and not eng.queue:
            break
    fin = {r.rid: r.generated for r in eng.finished}
    return [fin[rid] for rid in rids]


_REF = {}


def _reference(seed, policy):
    """The mix of ``tests/test_serving.py``'s quantized fuzz for ``seed``,
    eos planted from a first JAX O5 run, and the JAX O5 tokens."""
    if (seed, policy) not in _REF:
        jm, jp, _, _ = _models()
        mix = _random_mix(seed)

        def o5(eos):
            eng = JaxEngine(jm, jp, batch_size=3, max_seq=32, policy=policy,
                            config=JaxConfig(level=JaxLevel.O5))
            return _drive(eng, JaxRequest, mix, eos=eos, late_from=5)

        first = o5({})
        eos = {k: g[len(g) // 2] for k, g in enumerate(first)
               if k % 2 == 0 and len(g) > 1}
        _REF[(seed, policy)] = (mix, eos, o5(eos))
    return _REF[(seed, policy)]


def _port(mix, eos, policy, level, *, self_draft=False, **cfg):
    _, _, tm, tp = _models()
    kw = dict(draft_model=tm, draft_params=tp) if self_draft else {}
    eng = DecodeEngine(tm, tp, batch_size=3, max_seq=32, policy=policy,
                       config=BestEffortConfig(level=level, **_POOL, **cfg),
                       **kw)
    return eng, _drive(eng, Request, mix, eos=eos, late_from=5, check=True)


_CELLS = {
    "gather": (OptLevel.O6, {}),
    "kernel": (OptLevel.O6, dict(paged_attn="kernel")),
    "chunked-gather": (OptLevel.O6, dict(prefill_chunk=4)),
    "chunked-kernel": (OptLevel.O6, dict(prefill_chunk=4,
                                         paged_attn="kernel")),
    "O7-gather": (OptLevel.O7, dict(draft_k=4)),
    "O7-kernel": (OptLevel.O7, dict(draft_k=4, paged_attn="kernel")),
}


@pytest.mark.parametrize("seed,policy", [(51, "fcfs"), (52, "spf")])
@pytest.mark.parametrize("cell", list(_CELLS))
@pytest.mark.parametrize("kvd", NARROW)
def test_engine_narrow_pool_within_contract_of_jax_o5(kvd, cell, seed,
                                                      policy):
    """Random mixes with mid-flight arrivals and planted eos on an int8 or
    fp8 pool — the gather and kernel steps, chunked prefill (4) on both,
    O7 self-draft K=4 verifying on both — within the dtype's tolerance
    contract of the JAX O5 engine's tokens, every block accounted for
    after every tick, and bit-identical tokens from run to run.  Gather
    and kernel are not held to each other: the gather step attends the
    current token unquantized, the kernel step re-quantized."""
    mix, eos, want = _reference(seed, policy)
    level, cfg = _CELLS[cell]
    eng, got = _port(mix, eos, policy, level, kv_dtype=kvd,
                     self_draft=level == OptLevel.O7, **cfg)
    assert eng.layout.attn_impl == cfg.get("paged_attn", "gather")
    assert eng.cache_mgr.plan.kv_dtype == kvd
    if "chunk" in cell:
        assert eng.prefill_mode == "chunked"
    if level == OptLevel.O7:
        assert eng.spec_mode == "draft" and eng.spec_stats["drafted"] > 0
    tq.assert_tokens_match(want, got, tq.tolerance_contract(kvd),
                           f"{kvd}/{cell} (seed={seed}, {policy})")
    # a diverged token can hit or miss a planted eos, so lengths may part
    assert all(1 <= len(g) <= n for g, (_, n) in zip(got, mix))
    again = _port(mix, eos, policy, level, kv_dtype=kvd,
                  self_draft=level == OptLevel.O7, **cfg)[1]
    assert again == got


def test_engine_narrow_pool_is_a_scale_bundle_half_the_bytes():
    """The manager's cache is the {"pool", "scale"} bundle: 1-byte words
    (L, R, T, KV, dh) and zeroed (L, R, KV) f32 scales; its pool bytes
    are half the bf16 pool's plus the scales."""
    _, _, tm, tp = _models()
    geos = {}
    for kvd in ("bf16", "int8", "fp8"):
        eng = DecodeEngine(tm, tp, batch_size=3, max_seq=32,
                           config=BestEffortConfig(level=OptLevel.O6,
                                                   kv_dtype=kvd, **_POOL))
        geos[kvd] = eng.cache_mgr.geometry
        if kvd == "bf16":
            continue
        cache = eng.cache_mgr.cache
        assert set(cache) == {"pool", "scale"}
        for name in ("k", "v"):
            assert cache["pool"][name].dtype == tq.pool_dtype(kvd)
            assert cache["pool"][name].shape == (2, 15, 4, 2, 16)
            assert cache["scale"][name].shape == (2, 15, 2)
            assert not cache["scale"][name].any()
    for kvd in NARROW:
        assert geos[kvd]["token_bytes"] * 2 == geos["bf16"]["token_bytes"]
        assert geos[kvd]["pool_bytes"] == (
            geos["bf16"]["pool_bytes"] // 2
            + 15 * geos[kvd]["scale_bytes_per_block"])
