"""The port's recurrent serving path — rwkv6-3b (family "ssm"),
mamba2-2.7b (family "mamba") and zamba2-2.7b (family "hybrid": a mamba2
trunk with a shared attention block, served from a mixed pool of KV
blocks and state rows) — against the JAX package, on the smoke configs
(rwkv6: 2 layers, d_model 64, head_dim 16; mamba2: 4 layers, d_model 64,
P 32, N 16; zamba2: 4 mamba layers, the shared block after every 2,
4 heads of 16), everything on the CPU.

Weights come from the reference's ``init(cfg, PRNGKey(0))`` through
``models/bridge.py``; caches, tokens and activations from seeded numpy
generators.  The cache dtype is bf16, as the reference's default, so in
f32 compute the token shifts (rwkv6) and the conv/ssm state (mamba2) are
rounded to bf16 every step on both sides.

Tolerances.  In f32 compute the decode step, the block-level decode
updates and the chunked prefill step are held to the reference within
1e-5 of the largest magnitude of each output (logits, block output,
f32 state).  A state leaf stored in bf16 is held within 1e-5 of its
scale plus one bf16 ulp of the element: both sides compute it in f32 and
round it once, and XLA's and torch's dot products sum in different
orders (a few f32 ulps), which can round an element to the neighbouring
bf16 value.  Within the port, the chunked prefill is held BIT FOR BIT to
one-token decode steps, and a parked or frozen row to its old bits.  The
engine's greedy tokens in f32 equal the JAX O5 contiguous engine's (the
reference's O6 is not the oracle: ROADMAP C1); in bf16 the port's rungs
equal the port's O5 (ROADMAP C5).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.core.optlevel import BestEffortConfig as JaxConfig
from repro.core.optlevel import OptLevel as JaxLevel
from repro.models import get_model as jax_get_model
from repro.models import mamba2 as jax_mamba2
from repro.models import rwkv6 as jax_rwkv6
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving.paged import StatePool as JaxStatePool
from repro_torch.configs import get_smoke
from repro_torch.core.optlevel import BestEffortConfig, OptLevel
from repro_torch.launch.serve import serve_demo
from repro_torch.models import get_model, hybrid, mamba2, rwkv6, rwkv_lm
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.scan_prefill import batch_axes_of, scan_prefill
from repro_torch.models.transformer import layer_params
from repro_torch.serving import DecodeEngine, Request
from repro_torch.serving.paged import NULL_BLOCK, NULL_ROW, StatePool

ARCHS = ["rwkv6-3b", "mamba2-2.7b", "zamba2-2.7b"]
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TOL = 1e-5

_MODELS = {}
_REF = {}


def _models(arch: str, dtype: str = "float32"):
    """(jax model, jax params, port model, port params in ``dtype``):
    identical weights, ``dtype`` compute."""
    key = (arch, dtype)
    if key not in _MODELS:
        jm = jax_get_model(dataclasses.replace(jax_smoke(arch),
                                               compute_dtype=dtype))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = get_model(dataclasses.replace(get_smoke(arch),
                                           compute_dtype=dtype),
                       device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu",
                             dtype=TDT[dtype])
        _MODELS[key] = (jm, jp, tm, tp)
    return _MODELS[key]


def _rand_cache(tm, B: int, seed: int) -> dict:
    """A random (non-zero) decode cache of the port's layout."""
    rng = np.random.default_rng(seed)
    return {name: torch.tensor(
                rng.standard_normal(shape).astype(np.float32) * 0.5).to(dt)
            for name, (shape, dt) in tm.cache_spec(B, 16).items()}


def _to_jax(cache: dict) -> dict:
    """The port's flat cache as the reference's tree: the hybrid's nests
    its trunk state and shared KV (``{"mamba": {conv, ssm},
    "shared_kv": {k, v}}``)."""
    out = {name: jnp.asarray(leaf.float().numpy(), JDT[leaf.dtype])
           for name, leaf in cache.items()}
    if "k" in out and "ssm" in out:
        return {"mamba": {n: out[n] for n in hybrid.STATE},
                "shared_kv": {n: out[n] for n in hybrid.KV}}
    return out


def _flat(tree: dict) -> dict:
    """The reference's cache tree, flat by leaf name (the port's)."""
    out = {}
    for name, leaf in tree.items():
        out.update(_flat(leaf) if isinstance(leaf, dict) else {name: leaf})
    return out


def _clone(cache: dict) -> dict:
    return {name: leaf.clone() for name, leaf in cache.items()}


def _close(got, want, what: str) -> None:
    """|got - want| <= TOL * max|want| (+ one bf16 ulp of ``want`` for a
    leaf stored in bf16)."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    bound = TOL * np.abs(w).max()
    if got.dtype == torch.bfloat16:      # one ulp: at most 2^-7 relative
        bound = bound + np.abs(w) * 2.0 ** -7
    err = np.abs(g - w)
    assert (err <= bound).all(), (what, err.max(), np.abs(w).max())


def _tokens(B: int, C: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, 256, (B, C)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# The model steps against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    """Three decode steps from a random cache: logits and every cache
    leaf after each step."""
    jm, jp, tm, tp = _models(arch)
    tc = _rand_cache(tm, 3, seed=1)
    jc = _to_jax(tc)
    for t in range(3):
        tok = _tokens(3, 1, seed=10 + t)
        pos = np.full((3,), t, np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, tc, torch.tensor(tok), torch.tensor(pos))
        assert tl.dtype == torch.float32 and tl.shape == (3, 256)
        _close(tl, jl, f"{arch} logits, step {t}")
        assert _flat(jc).keys() == tc.keys()
        for name in tc:
            assert tc[name].dtype == tm.cache_spec(3, 16)[name][1]
            _close(tc[name], _flat(jc)[name], f"{arch} {name}, step {t}")


def test_rwkv6_time_mix_decode_matches_jax():
    """``time_mix_apply(decode=True)`` — the single-step WKV update from
    a random f32 state and token shift — against the reference's."""
    _, jp, _, tp = _models("rwkv6-3b")
    rng = np.random.default_rng(3)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"]["tm"])
    tlp = layer_params(tp, 0)["tm"]
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    state = rng.standard_normal((3, 4, 16, 16)).astype(np.float32)
    prev = rng.standard_normal((3, 64)).astype(np.float32)
    jo, (js, jlast) = jax_rwkv6.time_mix_apply(
        jlp, jnp.asarray(x), head_dim=16, state=jnp.asarray(state),
        x_prev=jnp.asarray(prev), decode=True)
    to, (ts, tlast) = rwkv6.time_mix_apply(
        tlp, torch.tensor(x), head_dim=16, state=torch.tensor(state),
        x_prev=torch.tensor(prev), decode=True)
    _close(to, jo, "out")
    _close(ts, js, "wkv state")
    _close(tlast, jlast, "token shift")
    assert ts.dtype == torch.float32


def test_mamba2_decode_matches_jax():
    """``mamba2_decode`` from a random bf16 conv window and ssm state:
    the block output and the new state (rounded to bf16 on both
    sides)."""
    _, jp, tm, tp = _models("mamba2-2.7b")
    rng = np.random.default_rng(4)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    tlp = layer_params(tp, 0)
    kw = dict(expand=2, head_dim=32, state=16, conv_width=4)
    st = {name: torch.tensor(rng.standard_normal(shape).astype(np.float32)
                             ).to(dt)
          for name, (shape, dt) in mamba2.mamba2_state_spec(3, 64,
                                                            **kw).items()}
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    jo, jst = jax_mamba2.mamba2_decode(jlp, jnp.asarray(x), _to_jax(st),
                                       **kw)
    to, tst = mamba2.mamba2_decode(tlp, torch.tensor(x), st, **kw)
    _close(to, jo, "out")
    for name in st:
        assert tst[name].dtype == torch.bfloat16
        _close(tst[name], jst[name], name)
    zero = mamba2.mamba2_init_state(2, 64, device="cpu", **kw)
    assert all(not leaf.any() for leaf in zero.values())
    assert {k: tuple(v.shape) for k, v in zero.items()} == {
        "conv": (2, 3, 160), "ssm": (2, 4, 32, 16)}


# A ragged chunk: slots ending their prompt at rows 3 (the whole chunk),
# 1 and 0, from different starts.
_START = np.array([0, 5, 9], np.int32)
_LAST = np.array([3, 1, 0], np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_jax_and_freezes_rows_past_last(arch):
    """The chunked prefill step against the reference's (logits at each
    slot's ``last`` row and the whole cache), and each slot's state
    bitwise equal to the state after ``last + 1`` one-token decode steps
    of the port: the rows past ``last`` stay frozen.

    The hybrid is held to the reference one step at a time: the port's
    one-token step ``j`` (which its chunk equals bit for bit) against
    the reference's decode step from the same cache, and the reference's
    chunk at the slot whose chunk is one row.  Across steps the two
    would compound their summation-order noise through an
    ill-conditioned stack (``scripts/zamba2_conditioning.py``): with
    this chunk, two steps of the JAX and the port's arithmetic part by
    more than 1e-5 of the logits' scale."""
    jm, jp, tm, tp = _models(arch)
    c0 = _rand_cache(tm, 3, seed=5)
    tok = _tokens(3, 4, seed=6)
    jl, jc = jm.prefill_step(jp, _to_jax(c0), jnp.asarray(tok),
                             jnp.asarray(_START), jnp.asarray(_LAST))
    tc = _clone(c0)
    tl, out = tm.prefill_step(tp, tc, torch.tensor(tok),
                              torch.tensor(_START), torch.tensor(_LAST))
    assert out is tc
    synced = arch == "zamba2-2.7b"
    if synced:              # the slot whose chunk is one row long
        _close(tl[_LAST == 0], np.asarray(jl)[_LAST == 0],
               f"{arch} prefill logits, row 0")
    else:
        _close(tl, jl, f"{arch} prefill logits")
        for name in tc:
            _close(tc[name], _flat(jc)[name], f"{arch} prefill {name}")

    steps = _clone(c0)
    per_step = []
    for j in range(4):
        if synced:
            jlj, jcj = jm.decode_step(jp, _to_jax(steps),
                                      jnp.asarray(tok[:, j:j + 1]),
                                      jnp.asarray(_START + j))
        logits, _ = tm.decode_step(tp, steps, torch.tensor(tok[:, j:j + 1]),
                                   torch.tensor(_START + j))
        if synced:
            _close(logits, jlj, f"{arch} step {j} logits")
            for name in steps:
                _close(steps[name], _flat(jcj)[name], f"{arch} step {j} "
                       f"{name}")
        per_step.append((logits, _clone(steps)))
    bax = batch_axes_of(tm.cache_axes())
    for b, last in enumerate(_LAST):
        logits, want = per_step[last]
        assert torch.equal(tl[b], logits[b]), (arch, b)
        for name in tc:
            assert torch.equal(tc[name].select(bax[name], b),
                               want[name].select(bax[name], b)), (name, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_scan_prefill_bitwise_equals_one_token_steps(arch):
    """``scan_prefill`` over C = 5 positions with every slot live is bit
    for bit five decode steps; a slot whose ``last`` is -1 is untouched
    and a slot frozen from row 2 keeps row 2's state (the hybrid's KV
    leaves, appended in place, keep their bits past row 2 too)."""
    _, _, tm, tp = _models(arch)
    c0 = _rand_cache(tm, 3, seed=7)
    tok = _tokens(3, 5, seed=8)
    start = torch.zeros(3, dtype=torch.int32)
    steps = _clone(c0)
    seen = []
    for j in range(5):
        logits, _ = tm.decode_step(tp, steps, torch.tensor(tok[:, j:j + 1]),
                                   start + j)
        seen.append((logits, _clone(steps)))
    last = torch.tensor([4, 2, -1])
    cache = _clone(c0)
    cfg = tm.cfg
    kw = {}
    if cfg.family == "hybrid":
        step = hybrid.scan_body(cfg, tp)
        kw = dict(max_seq=16, in_place=hybrid.KV)
    else:
        mod = {"ssm": rwkv_lm, "mamba": mamba2}[cfg.family]

        def step(c, t, pos):
            new = {name: torch.empty_like(leaf) for name, leaf in c.items()}
            return mod._decode(cfg, tp, c, t, new), new

    sel, out = scan_prefill(step, cache, torch.tensor(tok), start, last,
                            logits_width=256,
                            batch_axes=batch_axes_of(tm.cache_axes()), **kw)
    assert out is cache
    bax = batch_axes_of(tm.cache_axes())
    for b, (j, want) in enumerate([(4, seen[4][1]), (2, seen[2][1]),
                                   (None, c0)]):
        for name in cache:
            assert torch.equal(cache[name].select(bax[name], b),
                               want[name].select(bax[name], b)), (name, b)
        if j is not None:
            assert torch.equal(sel[b], seen[j][0][b])
    assert not sel[2].any()          # no real token: no logits taken


# ---------------------------------------------------------------------------
# The state-row pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_state_pool_matches_jax_under_random_traffic(seed):
    """Random admit / release / compaction traffic through the port's
    ``StatePool`` and the reference's: the same row map and free list
    after every operation, rows conserved throughout."""
    rng = np.random.default_rng(seed)
    B = 5
    tp_, jp_ = StatePool(B), JaxStatePool(B)
    for _ in range(200):
        op = rng.integers(0, 3)
        i = int(rng.integers(0, B))
        if op == 0 and tp_.rows[i] == NULL_ROW and tp_.can_admit():
            tp_.admit_slot(i)
            jp_.admit_slot(i)
        elif op == 1:
            tp_.release_slot(i)
            jp_.release_slot(i)
        elif op == 2:
            moves = tp_.compaction_moves()
            assert moves == jp_.compaction_moves()
            tp_.apply_moves(moves)
            jp_.apply_moves(moves)
        tp_.check_conservation()
        jp_.check_conservation()
        assert tp_.rows.tolist() == jp_.rows.tolist()
        assert tp_._free == jp_._free
        assert (tp_.free_rows, tp_.used_rows) == (jp_.free_rows,
                                                  jp_.used_rows)


def test_state_pool_raises_on_misuse():
    p = StatePool(2)
    p.admit_slot(0)
    with pytest.raises(RuntimeError, match="holding row"):
        p.admit_slot(0)
    p.admit_slot(1)
    assert not p.can_admit()
    p.release_slot(0)
    p.release_slot(0)                   # an empty slot: a no-op
    p.rows[0] = 2                       # forge a double hold
    with pytest.raises(AssertionError):
        p.check_conservation()


def _paged_engine(arch, attn="gather", dtype="float32", B=3, **kw):
    _, _, tm, tp = _models(arch, dtype)
    return DecodeEngine(tm, tp, batch_size=B, max_seq=16, config=(
        BestEffortConfig(level=OptLevel.O6, kv_block_size=4,
                         paged_attn=attn, **kw)))


@pytest.mark.parametrize("attn", ["gather", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_parked_row_is_bitwise_unchanged_by_a_tick(arch, attn):
    """A decode tick with slot 1 parked: slot 1's state row keeps its
    bits, slots 0 and 2 advance, the spare rows are untouched and only
    the NULL row takes the parked slot's garbage.  On the hybrid's mixed
    pool the parked slot's KV block keeps its bits too (its table row is
    aliased to the NULL block for the tick), slots 0 and 2 append into
    theirs and the spare blocks are untouched."""
    eng = _paged_engine(arch, attn, B=4)
    mgr = eng.cache_mgr
    assert eng.layout.state_impl == "rows" and mgr.state_plan is not None
    for i in range(3):
        mgr.admit_slot(i, Request(prompt=[1], max_new_tokens=1))
    gen = torch.Generator().manual_seed(0)
    for leaf in mgr.cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    before = _clone(mgr.cache)
    rows = [int(r) for r in mgr.state.rows]
    assert rows == [1, 2, 3, NULL_ROW]
    extras = mgr.step_extras(parked=[1])
    assert extras[-1].tolist() == [1, NULL_ROW, 3, NULL_ROW]
    if mgr.has_blocks:
        assert (extras[0][1] == NULL_BLOCK).all()
        assert torch.equal(extras[0][[0, 2]],
                           torch.from_numpy(mgr.tables[[0, 2]]))
    eng._step_fn(eng.params, mgr.cache, *extras,
                 torch.tensor([[5], [6], [7], [0]]),
                 torch.tensor([0, 0, 0, 0]), [0] * 4)
    blocks = {int(mgr.tables[i, 0]) for i in (0, 2)} | {NULL_BLOCK}
    for name, leaf in mgr.cache.items():
        same = [torch.equal(leaf[:, r], before[name][:, r])
                for r in range(leaf.shape[1])]
        if name in mgr.state_plan.leaf_specs:
            assert same == [False, False, True, False, True], (name, same)
        else:
            assert same == [r not in blocks for r in range(len(same))], (
                name, same)
    # Unparked, the cached uploads of the row map and tables serve the
    # tick.
    assert mgr.step_extras()[-1] is mgr.step_extras()[-1]
    assert mgr.step_extras()[-1].tolist() == [1, 2, 3, NULL_ROW]
    assert mgr.step_extras()[0] is mgr.step_extras()[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_reused_row_starts_from_zero_state(arch):
    """Admission zeroes the row a slot is given (``reset_slots``): a
    released row that held a tenant's state comes back zeroed, and the
    other rows keep their bits."""
    eng = _paged_engine(arch, B=2)
    mgr = eng.cache_mgr
    req = Request(prompt=[1], max_new_tokens=1)
    mgr.admit_slot(0, req)
    mgr.admit_slot(1, req)
    for leaf in mgr.cache.values():
        leaf.fill_(3.0)
    mgr.release_slot(0)
    mgr.admit_slot(0, req)
    r0, r1 = int(mgr.state.rows[0]), int(mgr.state.rows[1])
    mgr.reset_slots([0], [0, 1])
    for name, leaf in mgr.cache.items():
        if name in mgr.state_plan.leaf_specs:
            assert not leaf[:, r0].any()
            assert (leaf[:, r1] == 3.0).all()
        else:                           # KV blocks are masked, not zeroed
            assert (leaf == 3.0).all()
    mgr.check_conservation()


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_recurrent_state_zeroed_on_slot_reuse(arch):
    """The port's counterpart of the reference test: the third request
    reuses a slot, so a leaked tenant's state would corrupt it — O6 (both
    steps) decodes the JAX O5 engine's tokens."""
    mix = [([5, 6, 7], 4), ([9, 9], 5), ([3, 1, 4], 3)]
    want = _jax_o5(arch, mix, B=2, max_seq=24)
    for attn in ("gather", "kernel"):
        _, _, tm, tp = _models(arch)
        eng = DecodeEngine(tm, tp, batch_size=2, max_seq=24,
                           config=BestEffortConfig(level=OptLevel.O6,
                                                   kv_block_size=8,
                                                   paged_attn=attn))
        assert _drive(eng, Request, mix) == want, attn


@pytest.mark.parametrize("arch", ARCHS)
def test_state_pool_geometry_insert_and_compact(arch):
    """The manager's geometry counts the state rows (and, for the
    hybrid's mixed pool, the KV blocks beside them; a pure-state family
    has none); ``insert_slot`` copies a batch-1 state into the slot's row
    (and its KV through the slot's table); ``compact`` packs the held
    rows (and blocks) into the lowest ids and moves their bits."""
    eng = _paged_engine(arch, B=3)
    mgr = eng.cache_mgr
    _, _, tm, _ = _models(arch)
    state, kv = mgr.state_plan.leaf_specs, mgr.plan.leaf_specs
    assert mgr.has_blocks == bool(kv) == (arch == "zamba2-2.7b")
    assert mgr.blocks_needed(Request(prompt=[1] * 9, max_new_tokens=5)) == (
        4 if kv else 0)
    g = mgr.geometry
    spec = tm.cache_spec(3, 16)
    row_bytes = sum(int(np.prod(spec[name][0])) // 3 * spec[name][1].itemsize
                    for name in state)
    assert (g["state_rows"], g["state_row_bytes"]) == (4, row_bytes)
    assert g["state_bytes"] == 4 * row_bytes
    blocks = g["pool_rows"] * g["block_size"] * g["token_bytes"]
    assert g["pool_bytes"] == g["state_bytes"] + blocks
    assert (blocks > 0) == bool(kv)
    req = Request(prompt=[1] * 3, max_new_tokens=5)    # two blocks of 4
    for i in range(3):
        mgr.admit_slot(i, req)
    one = _rand_cache(tm, 1, seed=9)
    mgr.insert_slot(2, one)

    def held_kv(i, name):
        """Slot ``i``'s held blocks of KV leaf ``name``, as positions."""
        leaf = mgr.cache[name]
        rows = torch.from_numpy(mgr.tables[i, :2].astype(np.int64))
        return leaf[:, rows].reshape(leaf.shape[0], 8, *leaf.shape[3:])

    for name, leaf in mgr.cache.items():
        if name in state:
            assert torch.equal(leaf[:, 3], one[name][:, 0])
        else:
            assert torch.equal(held_kv(2, name), one[name][:, 0, :8])
    mgr.release_slot(0)
    assert mgr.state.compaction_moves() == {2: 1, 3: 2}
    mgr.compact()
    assert mgr.state.rows.tolist() == [NULL_ROW, 1, 2]
    mgr.check_conservation()
    if kv:
        assert mgr.tables[2, :2].tolist() == [3, 4]
    for name, leaf in mgr.cache.items():
        if name in state:
            assert torch.equal(leaf[:, 2], one[name][:, 0])
        else:
            assert torch.equal(held_kv(2, name), one[name][:, 0, :8])
    with pytest.raises(ValueError, match="leaves"):
        mgr.insert_slot(1, {"x": torch.zeros(1)})


# ---------------------------------------------------------------------------
# The engine: tokens against the JAX O5 engine
# ---------------------------------------------------------------------------

_WORKLOAD = [([5, 6, 7], 4), ([9], 6), ([3, 1, 4, 1], 3), ([2, 2], 5),
             ([8, 8, 8, 8, 8], 2), ([4, 2], 4)]

RUNGS = {
    "O0": dict(level=OptLevel.O0),
    "O1": dict(level=OptLevel.O1),
    "O2": dict(level=OptLevel.O2),
    "O4": dict(level=OptLevel.O4),
    "O5": dict(level=OptLevel.O5),
    "O6-gather": dict(level=OptLevel.O6, kv_block_size=4),
    "O6-kernel": dict(level=OptLevel.O6, kv_block_size=4,
                      paged_attn="kernel"),
    "O7": dict(level=OptLevel.O7, kv_block_size=4, paged_attn="kernel",
               draft_model="smollm-360m"),
}


def _random_mix(seed, *, n=8, prompt_hi=10, new_hi=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 256, int(rng.integers(1, prompt_hi))).tolist(),
             int(rng.integers(1, new_hi))) for _ in range(n)]


def _drive(eng, request_cls, mix, *, eos=None, late_from=None,
           each_tick=None):
    """Decode ``mix`` (``late_from`` submits the tail after two ticks;
    ``eos`` maps request index -> eos_id); returns generated tokens in
    submission order."""
    eos = eos or {}
    head = mix if late_from is None else mix[:late_from]
    rids = [eng.submit(request_cls(prompt=list(p), max_new_tokens=n,
                                   eos_id=eos.get(k)))
            for k, (p, n) in enumerate(head)]
    if late_from is not None:
        for _ in range(2):
            eng.step()
        rids += [eng.submit(request_cls(prompt=list(p), max_new_tokens=n,
                                        eos_id=eos.get(late_from + k)))
                 for k, (p, n) in enumerate(mix[late_from:])]
    for _ in range(1000):
        stepped = eng.step()
        if each_tick is not None:
            each_tick(eng)
        if not stepped and not eng.queue:
            break
    fin = {r.rid: r.generated for r in eng.finished}
    return [fin[rid] for rid in rids]


def _jax_o5(arch, mix, *, B=3, max_seq=32, **kw):
    jm, jp, _, _ = _models(arch)
    eng = JaxEngine(jm, jp, batch_size=B, max_seq=max_seq,
                    config=JaxConfig(level=JaxLevel.O5))
    return _drive(eng, JaxRequest, mix, **kw)


def _mixes(arch):
    """The two mixes and their JAX O5 float32 tokens: the ladder
    workload, and a random mix with eos planted from a first reference
    run and its tail arriving mid-flight."""
    if arch not in _REF:
        ref = {"ladder": (_WORKLOAD, {}, None, _jax_o5(arch, _WORKLOAD))}
        mix = _random_mix(1)
        first = _jax_o5(arch, mix)
        eos = {k: g[len(g) // 2] for k, g in enumerate(first)
               if k % 2 == 0 and len(g) > 1}
        assert eos, "no eos planted"
        ref["fuzz"] = (mix, eos, 5, _jax_o5(arch, mix, eos=eos,
                                             late_from=5))
        _REF[arch] = ref
    return _REF[arch]


def _port(arch, mix, rung=None, *, dtype="float32", B=3, max_seq=32,
          cfg=None, **kw):
    _, _, tm, tp = _models(arch, dtype)
    eng = DecodeEngine(tm, tp, batch_size=B, max_seq=max_seq,
                       config=cfg or BestEffortConfig(**RUNGS[rung]))
    if eng.layout.name == "paged":
        kw.setdefault("each_tick",
                      lambda e: e.cache_mgr.check_conservation())
    return _drive(eng, Request, mix, **kw), eng


@pytest.mark.parametrize("rung", list(RUNGS))
@pytest.mark.parametrize("arch", ARCHS)
def test_f32_greedy_tokens_identical_to_jax_o5(arch, rung):
    for name, (mix, eos, late, want) in _mixes(arch).items():
        got, eng = _port(arch, mix, rung, eos=eos, late_from=late)
        assert got == want, f"{arch} {rung} on {name}: {got} != {want}"
        assert eng.prefill_mode == "token"
        if eng.layout.name == "paged":
            assert eng.layout.state_impl == "rows"
            assert eng.layout.attn_impl == RUNGS[rung].get("paged_attn",
                                                           "gather")
            assert eng.cache_mgr.state.free_rows == 3
    assert [len(g) for g in _mixes(arch)["ladder"][3]] == \
        [n for _, n in _WORKLOAD]


@pytest.mark.parametrize("attn", ["gather", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_o6_chunked_prefill_identical_to_jax_o5(arch, attn):
    """O6 with ``prefill_chunk=3``: chunks run the decode body on the
    slot's state row while the batched tick parks the slot on the NULL
    row; the JAX O5 engine's tokens on both mixes."""
    for name, (mix, eos, late, want) in _mixes(arch).items():
        cfg = BestEffortConfig(level=OptLevel.O6, kv_block_size=4,
                               paged_attn=attn, prefill_chunk=3)
        got, eng = _port(arch, mix, cfg=cfg, eos=eos, late_from=late)
        assert eng.prefill_mode == "chunked"
        assert eng.layout.prefill_impl == "gather"
        assert eng.degrade_reason is None
        assert got == want, f"{arch} O6/{attn} chunk 3 on {name}"


@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_prefill_chunk_degrade_is_recorded(arch):
    """The contiguous layout cannot park a carried state mid-prompt:
    ``prefill_chunk`` degrades to token-by-token prefill with the
    reference's ``degrade_reason``, and the tokens stay JAX O5's."""
    mix, eos, late, want = _mixes(arch)["fuzz"]
    cfg = BestEffortConfig(level=OptLevel.O5, prefill_chunk=3)
    got, eng = _port(arch, mix, cfg=cfg, eos=eos, late_from=late)
    assert eng.prefill_mode == "token"
    assert "carries recurrent state" in eng.degrade_reason
    assert "NULL-row parking" in eng.degrade_reason
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_o7_degrades_to_plain_decode_and_records_why(arch):
    _, _, tm, _ = _models(arch)
    assert tm.carries_state and tm.verify_step is None
    assert tm.paged_verify_step is None and tm.paged_prefill_step is None
    mix, eos, late, want = _mixes(arch)["ladder"]
    got, eng = _port(arch, mix, "O7")
    assert eng.spec_mode == "off" and eng.spec_stats["draft_k"] == 0
    assert "no verify step" in eng.spec_off_reason
    assert got == want


@pytest.mark.parametrize("rung", ["O5", "O6-gather", "O6-kernel", "O1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_insert_generate_equals_run(arch, rung):
    """``prefill`` (token by token on a batch-1 cache) -> ``insert`` (a
    state row, or the slot's cache slice) -> ``generate`` gives each
    request the tokens of submitting it."""
    mix, _, _, want = _mixes(arch)["ladder"]
    _, _, tm, tp = _models(arch)
    eng = DecodeEngine(tm, tp, batch_size=3, max_seq=32,
                       config=BestEffortConfig(**RUNGS[rung]))
    got = {}
    for k, (p, n) in enumerate(mix[:3]):
        res = eng.prefill(p, max_new_tokens=n)
        assert res.length == len(p) and res.first_token == want[k][0]
        eng.insert(res)
        got[res.request.rid] = k
    rids = {eng.submit(Request(prompt=list(p), max_new_tokens=n)): k
            for k, (p, n) in enumerate(mix[3:], start=3)}
    got.update(rids)
    fin = eng.generate()
    assert {got[r.rid]: r.generated for r in fin} == dict(enumerate(want))


@pytest.mark.parametrize("rung", ["O0", "O1", "O2", "O4", "O6-gather",
                                  "O6-kernel", "O6-chunk", "O7"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_rungs_identical_to_port_o5(arch, rung):
    mix, eos, late, _ = _mixes(arch)["fuzz"]
    want, _ = _port(arch, mix, "O5", dtype="bfloat16", eos=eos,
                    late_from=late)
    cfg = (BestEffortConfig(level=OptLevel.O6, kv_block_size=4,
                            paged_attn="kernel", prefill_chunk=3)
           if rung == "O6-chunk" else None)
    got, _ = _port(arch, mix, None if cfg else rung, dtype="bfloat16",
                   cfg=cfg, eos=eos, late_from=late)
    assert got == want, (arch, rung)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_demo_serves_the_family_on_the_cpu(arch):
    out = serve_demo(get_smoke(arch), batch_size=3, max_seq=32,
                     n_requests=4, level=OptLevel.O6, paged_attn="kernel",
                     kv_block_size=4, prefill_chunk=4, device="cpu")
    assert len(out["finished"]) == 4 and out["ticks"] > 0
    assert out["prefill_mode"] == "chunked" and out["spec_mode"] == "off"
    assert out["degrade_reason"] is None and out["spec_off_reason"] is None
    g = out["pool"]
    assert g["state_rows"] == 4 and g["state_bytes"] > 0
    blocks = g["pool_rows"] * g["block_size"] * g["token_bytes"]
    assert g["pool_bytes"] == g["state_bytes"] + blocks
    assert (blocks > 0) == (arch == "zamba2-2.7b")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_the_cpu(arch, capsys):
    """``launch.serve --arch <family> --smoke --device cpu`` at the
    contiguous level with a prefill chunk (token mode, recorded) and at
    O6 chunked."""
    from repro_torch.launch.serve import main

    main(["--arch", arch, "--smoke", "--device", "cpu", "--level", "5",
          "--prefill-chunk", "4", "--requests", "3"])
    main(["--arch", arch, "--smoke", "--device", "cpu", "--level", "6",
          "--paged-attn", "kernel", "--prefill-chunk", "4", "--requests",
          "3"])
    out = capsys.readouterr().out
    assert "[contiguous/prefill=token(4) on cpu]: 3 requests" in out
    assert "[paged/kernel/prefill=chunked(4) on cpu]: 3 requests" in out
