"""The port's zamba2-2.7b (family "hybrid": a mamba2 trunk and one shared
attention block) against the JAX package on its smoke config (4 mamba
layers, the shared block after every 2, d_model 64, 4 heads of 16), on
the CPU.

* ``config``: the port's copy of the config equals the reference's.
* ``forward`` and ``lm_loss`` (and its gradients) in f32: the loss
  within 1e-5, the gradients within 1e-4 of their scale (as the mamba2
  tests hold theirs) and the final hidden state within 1e-4 of its scale:
  a one-ulp nudge of the smoke hybrid's weights moves its hidden state
  2.8e-5 of its scale (mamba2's smoke model: 2.2e-6;
  ``scripts/zamba2_conditioning.py``), so 1e-5 is below what two
  summation orders can meet here.
* ``paged_decode_step`` over the mixed pool — the shared attention's K/V
  in blocks through ``tables``, the trunk's state in rows through
  ``rows`` — from a pool built out of a dense cache, on a bf16 pool
  against the reference's dense ``decode_step`` on that cache, and on an
  int8 pool against the reference's paged step on the same words and
  scales: logits within 1e-5 of their scale, each state or KV element
  within 1e-5 of its leaf's scale plus one ulp of its stored dtype (one
  bf16 ulp; one int8 step of its block's scale): XLA's and torch's
  matmuls sum in different orders, which can round a stored element to
  its neighbour.  Rows and blocks no slot references keep their bits.
* A parked slot (mid chunked prefill) keeps every bit of its state row
  and its KV blocks through the batched decode tick, on bf16 and int8
  pools, gather and kernel steps, in a served mix.
* ``scan_prefill``'s ``max_seq`` clip.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.optlevel import BestEffortConfig, OptLevel
from repro_torch.launch import steps
from repro_torch.models import get_model, hybrid, mamba2
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.scan_prefill import scan_prefill
from repro_torch.serving import DecodeEngine, Request
from repro_torch.serving import kvquant
from repro_torch.serving.paged import NULL_BLOCK, NULL_ROW
from repro_torch.tree import leaves

ARCH = "zamba2-2.7b"
TOL = 1e-5
_CACHE = {}


def _setup():
    """(jax model, jax params, port model, port params): identical f32
    weights, f32 compute."""
    if not _CACHE:
        jm = jax_get_model(dataclasses.replace(jax_smoke(ARCH),
                                               compute_dtype="float32"))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = get_model(dataclasses.replace(get_smoke(ARCH),
                                           compute_dtype="float32"),
                       device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _CACHE["m"] = (jm, jp, tm, tp)
    return _CACHE["m"]


def _rel(got, want) -> float:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _close(got, want, what, ulp=None):
    """|got - want| <= TOL * max|want| (+ ``ulp`` elementwise)."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    bound = TOL * np.abs(w).max() + (0 if ulp is None else ulp)
    err = np.abs(g - w)
    assert (err <= bound).all(), (what, float(err.max()), float(
        np.abs(w).max()))


def test_the_port_registers_zamba2_with_the_reference_widths():
    for name in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                 "head_dim", "d_ff", "vocab", "ssm_state", "ssm_head_dim",
                 "ssm_expand", "conv_width", "attn_every", "loss_chunk",
                 "q_chunk", "remat", "compute_dtype", "param_dtype"):
        assert getattr(get_config(ARCH), name) == getattr(
            jax_config(ARCH), name), name
        assert getattr(get_smoke(ARCH), name) == getattr(
            jax_smoke(ARCH), name), name
    full = get_config(ARCH)
    assert (full.n_layers // full.attn_every, full.head_dim) == (9, 80)
    spec = hybrid.cache_spec(full, 8, 256)
    assert {k: s for k, (s, _) in spec.items()} == {
        "conv": (54, 8, 3, 5248), "ssm": (54, 8, 80, 64, 64),
        "k": (9, 8, 256, 32, 80), "v": (9, 8, 256, 32, 80)}


def test_forward_and_lm_loss_match_jax_f32():
    jm, jp, tm, tp = _setup()
    r = np.random.default_rng(0)
    tok = r.integers(0, 256, (2, 32)).astype(np.int32)
    lab = r.integers(0, 256, (2, 32)).astype(np.int32)
    from repro.models import hybrid as jax_hybrid
    jh = jax_hybrid.forward(jm.cfg, jp, jnp.asarray(tok))
    th = hybrid.forward(tm.cfg, mamba2.cast_params(tm.cfg, tp),
                        torch.tensor(tok))
    assert _rel(th, jh) <= 1e-4
    batch = {"tokens": tok, "labels": lab}
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = steps.value_and_grad(
        tm.loss, tp, {k: torch.tensor(v) for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
    jg = dict(leaves(jax.tree.map(np.asarray, jg)))
    tg = dict(leaves(tg))
    assert set(tg) == set(jg) and ("app_proj",) in tg
    for path, g in tg.items():
        assert g.dtype == torch.float32, path
        err = np.abs(g.numpy() - jg[path]).max()
        assert err <= 1e-4 * np.abs(jg[path]).max(), (path, err)


# ---------------------------------------------------------------------------
# The mixed-pool decode step
# ---------------------------------------------------------------------------

B, S, T = 3, 16, 4
NB = S // T
POS = np.array([3, 7, 12], np.int32)        # a block's end, middle, start


def _dense_cache(tm, seed):
    """A random bf16 dense cache, positions past each slot's ``POS``
    zero (the reference's dense step reads none of them)."""
    rng = np.random.default_rng(seed)
    c = {name: torch.tensor(rng.standard_normal(shape).astype(np.float32)
                            * 0.5).to(dt)
         for name, (shape, dt) in tm.cache_spec(B, S).items()}
    for name in hybrid.KV:
        for b in range(B):
            c[name][:, b, POS[b]:] = 0
    return c


def _to_jax(c):
    j = {n: jnp.asarray(v.float().numpy(), jnp.bfloat16) for n, v in
         c.items()}
    return {"mamba": {n: j[n] for n in hybrid.STATE},
            "shared_kv": {n: j[n] for n in hybrid.KV}}


def _layout(seed):
    """Shuffled tables over a pool of 1 + B*NB + 2 block rows (two
    spare), and state rows [2, 4, 1] of 5 (row 3 spare, row 0 NULL)."""
    rng = np.random.default_rng(seed)
    R = 1 + B * NB + 2
    tables = rng.permutation(np.arange(1, R))[:B * NB].reshape(B, NB)
    return tables.astype(np.int32), np.array([2, 4, 1], np.int64), R, 5


def _mixed_pool(dense, tables, rows, R, n_rows, seed):
    """The dense cache laid out in a mixed pool: KV blocks through
    ``tables``, state through ``rows``; every other row and block (the
    NULL ones too) random garbage."""
    g = torch.Generator().manual_seed(seed)
    pool = {}
    for name, leaf in dense.items():
        if name in hybrid.KV:
            A, _, _, KV, D = leaf.shape
            p = torch.randn((A, R, T, KV, D), generator=g).to(leaf.dtype)
            folded = leaf.reshape(A, B * NB, T, KV, D)
            p[:, torch.from_numpy(tables.reshape(-1).astype(np.int64))] = \
                folded
        else:
            shape = list(leaf.shape)
            shape[1] = n_rows
            p = torch.randn(shape, generator=g).to(leaf.dtype)
            p[:, torch.from_numpy(rows)] = leaf
        pool[name] = p
    return pool


def _view(pool, tables, name):
    """The (A, B, S, KV, D) view of KV leaf ``name`` through ``tables``."""
    leaf = pool[name]
    idx = torch.from_numpy(tables.reshape(-1).astype(np.int64))
    g = leaf[:, idx]
    return g.reshape(leaf.shape[0], B, S, *leaf.shape[3:])


def _untouched(before, after, tables, rows):
    """Block rows no table holds and state rows no slot holds keep their
    bits (the NULL block and row take garbage and are not checked)."""
    held_b = set(tables.reshape(-1).tolist()) | {NULL_BLOCK}
    held_r = set(rows.tolist()) | {NULL_ROW}
    for name, leaf in after.items():
        held = held_b if name in hybrid.KV else held_r
        for r in range(leaf.shape[1]):
            if r not in held:
                assert torch.equal(leaf[:, r], before[name][:, r]), (name, r)


def test_paged_decode_step_on_a_bf16_pool_matches_jax_decode_step():
    """From a pool holding a dense cache, the paged step's logits and new
    state and K/V equal the reference's dense ``decode_step`` on the
    cache."""
    jm, jp, tm, tp = _setup()
    dense = _dense_cache(tm, seed=1)
    tables, rows, R, n_rows = _layout(seed=2)
    pool = _mixed_pool(dense, tables, rows, R, n_rows, seed=3)
    before = {k: v.clone() for k, v in pool.items()}
    tok = np.random.default_rng(4).integers(1, 256, (B, 1)).astype(np.int32)
    jl, jc = jm.decode_step(jp, _to_jax(dense), jnp.asarray(tok),
                            jnp.asarray(POS))
    tl, out = tm.paged_decode_step(tp, pool, torch.tensor(tables),
                                   torch.tensor(rows), torch.tensor(tok),
                                   torch.tensor(POS))
    assert out is pool
    _close(tl, jl, "logits")
    want = {**jc["mamba"], **jc["shared_kv"]}
    idx = torch.from_numpy(rows)
    for name in hybrid.STATE:
        got = pool[name][:, idx]
        _close(got, want[name], name, ulp=np.abs(np.asarray(
            want[name], np.float32)) * 2.0 ** -7)
    for name in hybrid.KV:
        got = _view(pool, tables, name)
        _close(got, want[name], name, ulp=np.abs(np.asarray(
            want[name], np.float32)) * 2.0 ** -7)
    _untouched(before, pool, tables, rows)


def test_paged_decode_step_on_an_int8_pool_matches_jax_paged_step():
    """An int8 pool of the same words and (row, kv head) scales on both
    sides: the reference's paged step (its Pallas kernel's quantized
    branch, interpret mode) against the port's (B1q's plain version),
    logits, state and the re-quantized K/V; the state is never
    quantized."""
    jm, jp, tm, tp = _setup()
    dense = _dense_cache(tm, seed=5)
    tables, rows, R, n_rows = _layout(seed=6)
    pool = _mixed_pool(dense, tables, rows, R, n_rows, seed=7)
    scales = {}
    for name in hybrid.KV:
        x = pool[name].float()
        s = kvquant.block_scale(x, (2, 4), "int8")       # (A, R, 1, KV, 1)
        pool[name] = kvquant.quantize(x, s, "int8")
        scales[name] = s[:, :, 0, :, 0].contiguous()
    before = {k: v.clone() for k, v in pool.items()}
    jpool = {"mamba": {n: jnp.asarray(pool[n].float().numpy(), jnp.bfloat16)
                       for n in hybrid.STATE},
             "shared_kv": {n: jnp.asarray(pool[n].numpy()) for n in
                           hybrid.KV}}
    jscales = {"mamba": {n: jnp.zeros(()) for n in hybrid.STATE},
               "shared_kv": {n: jnp.asarray(scales[n].numpy())[:, :, None,
                                                               :, None]
                             for n in hybrid.KV}}
    tok = np.random.default_rng(8).integers(1, 256, (B, 1)).astype(np.int32)
    jl, jpo, jsc = jm.paged_decode_step(
        jp, jpool, jnp.asarray(tables), jnp.asarray(rows.astype(np.int32)),
        jnp.asarray(tok), jnp.asarray(POS), scales=jscales, kv_dtype="int8")
    tl, out, tsc = tm.paged_decode_step(
        tp, pool, torch.tensor(tables), torch.tensor(rows),
        torch.tensor(tok), torch.tensor(POS), scales=scales,
        kv_dtype="int8")
    assert out is pool and tsc is scales
    _close(tl, jl, "logits")
    idx = torch.from_numpy(rows)
    for name in hybrid.STATE:
        assert pool[name].dtype == torch.bfloat16
        want = np.asarray(jpo["mamba"][name], np.float32)[:, rows]
        _close(pool[name][:, idx], want, name, ulp=np.abs(want) * 2.0 ** -7)
    held = torch.from_numpy(tables.reshape(-1).astype(np.int64))
    for name in hybrid.KV:
        assert pool[name].dtype == torch.int8
        js = np.asarray(jsc["shared_kv"][name])[:, :, 0, :, 0]
        _close(scales[name][:, held], js[:, held.numpy()], f"{name} scale")
        deq = lambda w, s: w.float() * s[:, :, None, :, None]
        got = deq(pool[name][:, held], scales[name][:, held])
        want = deq(torch.tensor(np.asarray(jpo["shared_kv"][name]))[:, held],
                   torch.tensor(js)[:, held])
        step = scales[name][:, held][:, :, None, :, None].expand_as(got)
        _close(got, want.numpy(), name, ulp=step.numpy() * (1 + 1e-5))
    _untouched(before, pool, tables, rows)


# ---------------------------------------------------------------------------
# A parked slot on the mixed pool
# ---------------------------------------------------------------------------

_MIX = [([5, 6, 7, 8, 9, 10, 11], 4), ([9, 3], 5),
        ([3, 1, 4, 1, 5, 9, 2, 6, 5], 3), ([2, 2, 2], 4)]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("attn", ["gather", "kernel"])
def test_a_parked_slot_keeps_its_state_row_and_kv_blocks(attn, kv_dtype):
    """O6 with ``prefill_chunk=3`` over a mix whose prompts take several
    chunks: at every batched decode tick, each slot parked mid-prompt
    keeps every bit of its state row and of its KV blocks (their
    words and, on int8, their scales) — its table row is aliased to the
    NULL block for the tick, so its K/V (computed from the NULL row's
    garbage state) lands there — and on the bf16 pool the served tokens
    equal a run without chunking (an int8 pool's chunk re-quantizes
    whole blocks where a token tick re-quantizes one, so the two owe
    ``kvquant.tolerance_contract``, not identity:
    ``tests/test_torch_paged_quant.py``)."""
    _, _, tm, tp = _setup()

    def engine(chunk):
        return DecodeEngine(tm, tp, batch_size=3, max_seq=24,
                            config=BestEffortConfig(
                                level=OptLevel.O6, kv_block_size=4,
                                paged_attn=attn, kv_dtype=kv_dtype,
                                prefill_chunk=chunk))

    eng = engine(3)
    mgr = eng.cache_mgr
    step_fn, extras_fn = eng._step_fn, mgr.step_extras
    seen = {"parked": None, "ticks": 0}

    def extras(parked=None):
        seen["parked"] = list(parked or [])
        return extras_fn(parked=parked)

    def snapshot(i):
        pool = mgr.cache if kv_dtype == "bf16" else mgr.cache["pool"]
        out = {n: pool[n][:, int(mgr.state.rows[i])].clone()
               for n in hybrid.STATE}
        blocks = torch.from_numpy(mgr.tables[i].astype(np.int64))
        blocks = blocks[blocks != NULL_BLOCK]
        out.update({n: pool[n][:, blocks].clone() for n in hybrid.KV})
        if kv_dtype != "bf16":
            out.update({f"{n} scale": mgr.cache["scale"][n][:, blocks]
                        .clone() for n in hybrid.KV})
        return out

    def step(params, cache, *rest):
        parked = seen["parked"]
        snaps = {i: snapshot(i) for i in parked}
        out = step_fn(params, cache, *rest)
        for i in parked:
            after = snapshot(i)
            for n, v in snaps[i].items():
                assert torch.equal(after[n], v), (i, n)
        seen["ticks"] += bool(parked)
        return out

    mgr.step_extras, eng._step_fn = extras, step
    rids = [eng.submit(Request(prompt=list(p), max_new_tokens=n))
            for p, n in _MIX]
    eng.generate()
    assert eng.prefill_mode == "chunked" and seen["ticks"] >= 3
    if kv_dtype != "bf16":
        return
    got = {r.rid: r.generated for r in eng.finished}
    plain = engine(0)
    want_rids = [plain.submit(Request(prompt=list(p), max_new_tokens=n))
                 for p, n in _MIX]
    want = {r.rid: r.generated for r in plain.generate()}
    assert [got[r] for r in rids] == [want[r] for r in want_rids]


def test_step_extras_alias_a_parked_slots_table_only_on_a_mixed_pool():
    _, _, tm, tp = _setup()
    eng = DecodeEngine(tm, tp, batch_size=3, max_seq=16,
                       config=BestEffortConfig(level=OptLevel.O6,
                                               kv_block_size=4))
    mgr = eng.cache_mgr
    for i in range(3):
        mgr.admit_slot(i, Request(prompt=[1] * 5, max_new_tokens=3))
    tables, rows = mgr.step_extras(parked=[2])
    assert (tables[2] == NULL_BLOCK).all() and rows[2] == NULL_ROW
    assert torch.equal(tables[:2], torch.from_numpy(mgr.tables[:2]))
    assert tables is not mgr.step_extras()[0]        # not the cached upload
    assert mgr.step_extras()[0] is mgr.step_extras()[0]


# ---------------------------------------------------------------------------
# scan_prefill's max_seq clip
# ---------------------------------------------------------------------------

def test_scan_prefill_clips_positions_to_max_seq():
    """A padded final chunk past the KV leaf: the body sees the positions
    clipped to ``max_seq - 1`` (and unclipped without ``max_seq``, as
    every pure-state family calls it); the hybrid's chunk running past
    its 8-position cache equals its one-token steps bit for bit and its
    frozen KV positions keep their bits."""
    seen = []

    def body(c, tok, pos):
        seen.append(pos.tolist())
        return torch.zeros((2, 4)), {"x": c["x"]}

    cache = {"x": torch.zeros(2, 3)}
    start, last = torch.tensor([5, 0]), torch.tensor([1, 3])
    for max_seq, want in ((8, [[5, 0], [6, 1], [7, 2], [7, 3]]),
                          (None, [[5, 0], [6, 1], [7, 2], [8, 3]])):
        seen.clear()
        scan_prefill(body, cache, torch.zeros(2, 4, dtype=torch.long),
                     start, last, logits_width=4, batch_axes={"x": 0},
                     max_seq=max_seq)
        assert seen == want, (max_seq, seen)

    _, _, tm, tp = _setup()
    rng = np.random.default_rng(9)
    c0 = {name: torch.tensor(rng.standard_normal(shape).astype(np.float32)
                             ).to(dt)
          for name, (shape, dt) in tm.cache_spec(2, 8).items()}
    tok = torch.tensor(rng.integers(1, 256, (2, 4)))
    cache = {k: v.clone() for k, v in c0.items()}
    sel, _ = tm.prefill_step(tp, cache, tok, start, last)
    steps_ = {k: v.clone() for k, v in c0.items()}
    for j in range(2):                  # slot 0's real rows: positions 5, 6
        lg, _ = tm.decode_step(tp, steps_, tok[:, j:j + 1], start + j)
    assert torch.equal(sel[0], lg[0])
    for name in tm.cache_spec(2, 8):
        assert torch.equal(cache[name][:, 0], steps_[name][:, 0]), name
    for name in hybrid.KV:              # slot 0's frozen position 7
        assert torch.equal(cache[name][:, 0, 7], c0[name][:, 0, 7])
