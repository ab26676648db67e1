"""The port's serving API beside the tick loop, against the JAX O5 engine:
prefill -> insert -> generate, the insert contract, insert on narrow
pools, the O0 cache rebuild, the paged pool's defrag ``compact`` and the
allocators' ``grow_slot`` / ``rebuild`` arithmetic.

In float32 the port's tokens equal the JAX O5 contiguous engine's (never
JAX O6: ROADMAP C1); a narrow pool is held to
``kvquant.tolerance_contract``.  Everything runs on the CPU, where the
O6 kernel rung takes the kernels' plain versions.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.core.optlevel import BestEffortConfig as JaxConfig
from repro.core.optlevel import OptLevel as JaxLevel
from repro.models import get_model as jax_get_model
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_smoke
from repro_torch.core.optlevel import BestEffortConfig, OptLevel
from repro_torch.models import get_model
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving import DecodeEngine, PrefillResult, Request, kvquant
from repro_torch.serving.paged import (BlockAllocator, PagedAllocator,
                                       blocks_for)
from repro_torch.serving.scheduler import Scheduler

_WORKLOAD = [([5, 6, 7], 4), ([9], 6), ([3, 1, 4, 1], 3), ([2, 2], 5),
             ([8, 8, 8, 8, 8], 2), ([4, 2], 4)]

CELLS = {
    "O5c": dict(level=OptLevel.O5, prefill_chunk=4),
    "O6c": dict(level=OptLevel.O6, prefill_chunk=4, kv_block_size=4),
    "O6kc": dict(level=OptLevel.O6, prefill_chunk=4, kv_block_size=4,
                 paged_attn="kernel"),
    "O0": dict(level=OptLevel.O0),
}

_MODELS = {}


def _models():
    """(jax model, jax params, port model, port params): the smoke
    qwen3-8b in float32, the same weights."""
    if not _MODELS:
        jcfg = dataclasses.replace(jax_smoke("qwen3-8b"),
                                   compute_dtype="float32")
        jm = jax_get_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = get_model(dataclasses.replace(get_smoke("qwen3-8b"),
                                           compute_dtype="float32"),
                       device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS["f32"] = (jm, jp, tm, tp)
    return _MODELS["f32"]


def _engine(B=3, max_seq=32, **cfg):
    _, _, tm, tp = _models()
    return DecodeEngine(tm, tp, batch_size=B, max_seq=max_seq,
                        config=BestEffortConfig(**cfg))


def _drain(eng, mix, request_cls=Request, each_tick=None):
    """Submit ``mix`` and tick to the end; tokens in submission order."""
    rids = [eng.submit(request_cls(prompt=list(p), max_new_tokens=n))
            for p, n in mix]
    for _ in range(1000):
        stepped = eng.step()
        if each_tick is not None:
            each_tick(eng)
        if not stepped and not eng.queue:
            break
    fin = {r.rid: r.generated for r in eng.finished}
    return [fin[rid] for rid in rids]


def _jax_o5(mix, *, B=3, max_seq=32):
    jm, jp, _, _ = _models()
    eng = JaxEngine(jm, jp, batch_size=B, max_seq=max_seq,
                    config=JaxConfig(level=JaxLevel.O5))
    return _drain(eng, mix, JaxRequest)


# ---------------------------------------------------------------------------
# prefill -> insert -> generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", list(CELLS))
def test_prefill_insert_generate_matches_prestaged(cell):
    """Prompts prefilled on a standalone batch-1 cache, inserted into
    the engine's slots (scattered through block tables on the paged
    layout), then drained: the tokens of submitting the same requests to
    the same engine, and the JAX O5 engine's; ``first_token`` is each
    request's first emission."""
    mix = _WORKLOAD[:3]
    want = _jax_o5(mix)
    assert _drain(_engine(**CELLS[cell]), mix) == want
    eng = _engine(**CELLS[cell])
    results = [eng.prefill(p, max_new_tokens=n) for p, n in mix]
    assert all(isinstance(r, PrefillResult) for r in results)
    assert [r.length for r in results] == [len(p) for p, _ in mix]
    assert sorted(eng.insert(r) for r in results) == [0, 1, 2]
    if eng.layout.name == "paged":
        eng.cache_mgr.check_conservation()
    fin = {r.rid: r.generated for r in eng.generate()}
    assert [fin[r.request.rid] for r in results] == want
    assert [r.first_token for r in results] == [g[0] for g in want]


def test_prefill_state_is_zero_past_the_prompt():
    """A padded final chunk writes its pad rows past the prompt; prefill
    hands back a state that is zero there (what a narrow pool's insert
    quantizes), and the same first token whatever the engine's chunk."""
    prompt = [3, 1, 4, 1, 5, 9, 2]
    firsts = set()
    for chunk in (3, 4, 7, 16):
        eng = _engine(level=OptLevel.O5, prefill_chunk=chunk)
        res = eng.prefill(prompt, max_new_tokens=4)
        for leaf in res.kv_state.values():           # (L, 1, S, KV, dh)
            assert leaf.shape[1] == 1
            assert leaf[:, :, :len(prompt)].abs().sum() > 0
            assert not leaf[:, :, len(prompt):].any()
        firsts.add(res.first_token)
    assert len(firsts) == 1


def test_prefill_insert_mid_flight_and_validation():
    """Insert while another request decodes, plus the error contract:
    prefill validates like submit, inserting with no free slot raises,
    and a paged pool too full for the reservation raises until
    retirements free blocks."""
    eng = _engine(B=2, level=OptLevel.O5, prefill_chunk=4)
    r0 = eng.submit(Request(prompt=[5, 6, 7], max_new_tokens=6))
    for _ in range(3):
        eng.step()
    res = eng.prefill([9, 9], max_new_tokens=4)
    eng.insert(res)
    fin = {r.rid: r.generated for r in eng.generate()}
    assert [fin[r0], fin[res.request.rid]] == \
        _jax_o5([([5, 6, 7], 6), ([9, 9], 4)])

    with pytest.raises(ValueError, match="empty prompt"):
        eng.prefill([], max_new_tokens=2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.prefill([1, 2], max_new_tokens=0)
    with pytest.raises(ValueError, match="max_seq"):
        eng.prefill([1] * 30, max_new_tokens=6)

    eng.submit(Request(prompt=[1, 2], max_new_tokens=8))
    eng.submit(Request(prompt=[3, 4], max_new_tokens=8))
    eng.step()
    spare = eng.prefill([7, 7], max_new_tokens=2)
    with pytest.raises(ValueError, match="no free slot"):
        eng.insert(spare)
    eng.generate()
    eng.insert(spare)                      # slot freed: insert succeeds
    fin2 = {r.rid: r.generated for r in eng.generate()}
    assert len(fin2[spare.request.rid]) == 2

    engp = _engine(B=3, max_seq=16, level=OptLevel.O6, kv_block_size=4,
                   kv_pool_blocks=5)
    engp.submit(Request(prompt=[1] * 8, max_new_tokens=4))   # 3 blocks
    engp.step()
    big = engp.prefill([2] * 8, max_new_tokens=4)            # 3 more
    with pytest.raises(ValueError, match="insufficient free KV blocks"):
        engp.insert(big)
    engp.cache_mgr.check_conservation()
    engp.generate()
    engp.insert(big)                       # blocks freed: fits now
    fin3 = {r.rid: r.generated for r in engp.generate()}
    assert len(fin3[big.request.rid]) == 4
    assert engp.cache_mgr.free_blocks == 5


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_insert_on_narrow_pool_within_contract(kv_dtype):
    """Insert on an int8 / fp8 pool: each folded block gets a fresh
    absmax scale (``x / scale`` within the dtype's range, C11), the
    installed blocks dequantize to the prefilled state within one
    quantization step, and the drained tokens meet the tolerance
    contract against the JAX O5 engine."""
    mix = _WORKLOAD[:3]
    eng = _engine(level=OptLevel.O6, kv_block_size=4, paged_attn="kernel",
                  prefill_chunk=4, kv_dtype=kv_dtype)
    mgr = eng.cache_mgr
    results = [eng.prefill(p, max_new_tokens=n) for p, n in mix]
    slots = [eng.insert(r) for r in results]
    for res, i in zip(results, slots):
        P = res.length
        row = torch.from_numpy(mgr.tables[i, :blocks_for(P, 4)]).long()
        for name, dense in res.kv_state.items():
            pool = mgr.cache["pool"][name].index_select(1, row)
            scale = mgr.cache["scale"][name].index_select(1, row)
            deq = kvquant.dequantize(pool, scale[:, :, None, :, None],
                                     torch.float32)
            want = dense[:, 0, :row.numel() * 4].reshape(deq.shape)
            step = scale[:, :, None, :, None] * (
                1.0 if kv_dtype == "int8" else 32.0)
            assert ((deq - want).abs() <= step).all()
            assert (want.abs() / scale[:, :, None, :, None]
                    <= kvquant.qmax(kv_dtype) * (1 + 1e-6)).all()
            assert torch.isfinite(deq).all()
    fin = {r.rid: r.generated for r in eng.generate()}
    got = [fin[r.request.rid] for r in results]
    kvquant.assert_tokens_match(_jax_o5(mix), got,
                                kvquant.tolerance_contract(kv_dtype),
                                f"insert on {kv_dtype}")
    mgr.check_conservation()


def test_o0_rebuilds_the_cache_and_keeps_live_slots():
    """O0 allocates a fresh cache at each admission and copies the live
    slots' slices across; O1 zeroes the admitted slot in place."""
    e0 = _engine(B=2, level=OptLevel.O0)
    e0.submit(Request(prompt=[5, 6, 7], max_new_tokens=6))
    e0.step()
    e0.step()
    before = {k: v.clone() for k, v in e0.cache.items()}
    first = e0.cache
    e0.submit(Request(prompt=[9], max_new_tokens=2))
    e0.step()
    assert e0.cache is not first
    for k, v in e0.cache.items():
        assert torch.equal(v[:, 0, :2], before[k][:, 0, :2])
    e1 = _engine(B=2, level=OptLevel.O1)
    cache = e1.cache
    e1.submit(Request(prompt=[5, 6, 7], max_new_tokens=2))
    e1.step()
    assert e1.cache is cache


def test_capacity_tokens():
    assert _engine(B=3, max_seq=32, level=OptLevel.O5).cache_mgr \
        .capacity_tokens == 96
    mgr = _engine(B=3, max_seq=32, level=OptLevel.O6, kv_block_size=4,
                  kv_pool_blocks=10).cache_mgr
    assert mgr.capacity_tokens == 40


# ---------------------------------------------------------------------------
# compact: copy-on-admit defrag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", [
    dict(level=OptLevel.O6, kv_block_size=4),
    dict(level=OptLevel.O6, kv_block_size=4, paged_attn="kernel"),
], ids=["O6-gather", "O6-kernel"])
def test_compact_mid_flight_preserves_tokens(cell):
    """Compacting after every tick (churn fragments the pool as requests
    retire) moves live blocks to the lowest ids without disturbing any
    generation: the JAX O5 tokens, every block accounted for, the held
    blocks a packed prefix after each compaction."""
    rng = np.random.default_rng(7)
    mix = [(rng.integers(1, 256, int(rng.integers(1, 10))).tolist(),
            int(rng.integers(1, 8))) for _ in range(6)]
    moved = []

    def tick(e):
        mgr = e.cache_mgr
        before = mgr.tables.copy()
        mgr.compact()
        mgr.check_conservation()
        held = sorted({b for row, n in zip(mgr.tables, mgr._held)
                       for b in row[:n].tolist()})
        assert held == list(range(1, len(held) + 1))
        moved.append(int((before != mgr.tables).sum()))

    assert _drain(_engine(**cell), mix, each_tick=tick) == _jax_o5(mix)
    assert sum(moved) > 0, "no compaction moved a block"


def test_compact_moves_scale_rows_of_a_narrow_pool():
    """On an int8 pool the scale rows ride along with their blocks: the
    tokens equal the same engine's without compaction, bit for bit."""
    rng = np.random.default_rng(7)
    mix = [(rng.integers(1, 256, int(rng.integers(1, 10))).tolist(),
            int(rng.integers(1, 8))) for _ in range(6)]
    cell = dict(level=OptLevel.O6, kv_block_size=4, paged_attn="kernel",
                kv_dtype="int8")
    moved = []

    def tick(e):
        before = e.cache_mgr.tables.copy()
        e.cache_mgr.compact()
        moved.append(int((before != e.cache_mgr.tables).sum()))

    assert _drain(_engine(**cell), mix, each_tick=tick) == \
        _drain(_engine(**cell), mix)
    assert sum(moved) > 0


# ---------------------------------------------------------------------------
# The allocators: rebuild, grow_slot
# ---------------------------------------------------------------------------

def test_block_allocator_lifo_and_rebuild():
    """Fresh blocks come lowest id first, released ones LIFO; ``rebuild``
    (what ``compact`` leaves behind) holds ``1..n`` and frees the rest."""
    a = BlockAllocator(6)
    assert a.allocate(4) == [1, 2, 3, 4]
    a.release([1, 3])
    assert a.allocate(1) == [3]            # LIFO
    with pytest.raises(RuntimeError, match="double/invalid"):
        a.release([2, 2])
    a.rebuild(2)
    assert a.free_blocks == 4 and a.allocate(4) == [3, 4, 5, 6]
    with pytest.raises(RuntimeError, match="exhausted"):
        a.allocate(1)


def test_admit_slot_reserves_through_grow_slot():
    """Admission reserves prompt + budget (clipped to max_seq) through
    ``grow_slot``; release returns every block; a holding slot cannot
    be admitted again."""
    pa = PagedAllocator(3, 32, block_size=4, pool_blocks=10)
    assert pa.capacity_tokens == 40
    pa.admit_slot(1, Request(prompt=[1] * 5, max_new_tokens=3))   # 8 tok
    assert pa._held == [0, 2, 0] and pa.free_blocks == 8
    assert pa.tables[1, :2].tolist() == [1, 2]
    with pytest.raises(RuntimeError, match="holding blocks"):
        pa.admit_slot(1, Request(prompt=[1], max_new_tokens=1))
    pa.admit_slot(0, Request(prompt=[1] * 30, max_new_tokens=9))  # clip 32
    assert pa._held[0] == 8 and pa.free_blocks == 0
    pa.check_conservation()
    pa.release_slot(0)
    pa.release_slot(1)
    assert pa.free_blocks == 10 and not any(pa._held)
    pa.check_conservation()


def test_prefill_without_a_prefill_step_raises_naming_a11():
    """A family with no prefill step (none the port serves yet) raises
    rather than prefilling some other way."""
    _, _, tm, tp = _models()
    eng = DecodeEngine(dataclasses.replace(tm, prefill_step=None), tp,
                       batch_size=2, max_seq=16,
                       config=BestEffortConfig(level=OptLevel.O5))
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        eng.prefill([1, 2], max_new_tokens=2)


def test_grow_slot_never_double_counts_shared_block():
    """Growing by TOTALS: a chunk ending mid-block shares its active
    block with the next chunk, so consecutive grows allocate
    ``blocks_for(total) - held`` — never per-chunk ceil sums."""
    pa = PagedAllocator(1, 32, block_size=4, pool_blocks=8)
    assert pa.grow_slot(0, 6) == 2         # covers tokens 0..5
    assert pa.grow_slot(0, 7) == 0         # same final block: no alloc
    assert pa.grow_slot(0, 9) == 1         # one more block
    assert pa._held[0] == 3 and pa.free_blocks == 5
    assert pa.grow_slot(0, 9) == 0         # idempotent
    assert pa.grow_slot(0, 100) == 5       # clips to max_seq (32 tokens)
    assert pa._held[0] == 8
    pa.check_conservation()


def test_grow_slot_invalidates_the_cached_device_tables():
    mgr = _engine(B=2, max_seq=32, level=OptLevel.O6,
                  kv_block_size=4).cache_mgr
    (t0,) = mgr.step_extras()
    assert mgr.grow_slot(0, 5) == 2
    (t1,) = mgr.step_extras()
    assert t1 is not t0 and t1[0, :2].tolist() == mgr.tables[0, :2].tolist()
    assert mgr.grow_slot(0, 6) == 0
    assert mgr.step_extras()[0] is t1


def _check_invariants(sched, pa):
    active = [s.req for s in sched.slots if s.active]
    assert len({id(r) for r in active}) == len(active)
    assert not any(r.done for r in active)
    pa.check_conservation()
    for i, s in enumerate(sched.slots):
        if not s.active:
            assert pa._held[i] == 0, f"retired slot {i} still holds blocks"
        else:
            assert pa._held[i] == pa.blocks_needed(s.req)


def test_grow_slot_queue_then_admit_neither_leaks_nor_deadlocks():
    """Queue-then-admit under a constrained pool: a reservation the gate
    defers admits after retirements free blocks, and a full drain
    returns every block (admission grows by totals through
    ``grow_slot``)."""
    pa = PagedAllocator(2, 16, block_size=4, pool_blocks=5)
    sched = Scheduler(2, 16, policy="fcfs")
    sched.admission_gate = pa.can_admit
    sched.on_admit = pa.admit_slot
    sched.on_retire = pa.release_slot
    sched.submit(Request(prompt=[1] * 10, max_new_tokens=2))  # 3 blocks
    sched.submit(Request(prompt=[2] * 10, max_new_tokens=2))  # must queue
    assert sched.admit() == [0] and sched.admit() == []
    C = 4
    for _ in range(20):
        pf = sched.prefill_queue()
        if pf:
            i = pf[0]
            s = sched.slots[i]
            n = min(C, s.req.n_prompt - s.pos)
            if s.pos + n == s.req.n_prompt:
                sched.advance_chunk(i, n - 1)
                sched.advance(i, 3)
            else:
                sched.advance_chunk(i, n)
        else:
            for i in sched.active_indices:
                sched.advance(i, 3)
        _check_invariants(sched, pa)
        sched.admit()
        if not sched.has_work():
            break
    assert not sched.has_work(), "constrained pool deadlocked"
    assert len(sched.finished) == 2
    assert pa.free_blocks == 5, "blocks leaked"
