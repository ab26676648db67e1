"""The port's DecodeEngine on its rungs (O0, O1, O2, O4, O5, O6-gather,
O6-kernel, O7) and with chunked prefill, against the JAX O5 engine.

In float32 compute the port's greedy tokens are identical to the JAX O5
contiguous engine's (the reference's O6 and O7 are not the oracle:
ROADMAP C1) on ``tests/test_serving.py``-style mixes — mid-flight
arrivals, planted eos, a block pool small enough to queue.  In bf16 the
port's rungs give identical tokens among themselves.  Everything runs on
the CPU, where the O6 kernel rung takes the kernels' plain versions.
O7 is paged, as in the reference (its ladder includes O6), so its two
cells are the gather (dense) verify step and the kernel (B2) one.  O0
and O1 run the un-pipelined loop (a batch-1 model call per request per
tick, O0 rebuilding the cache at each admission).
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
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.optlevel import BestEffortConfig, OptLevel
from repro_torch.kernels.paged_attention import ops
from repro_torch.launch.serve import serve_demo
from repro_torch.models import get_model
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving import (DecodeEngine, Request, SamplerConfig,
                                 TickBudgetExceeded)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_WORKLOAD = [([5, 6, 7], 4), ([9], 6), ([3, 1, 4, 1], 3), ([2, 2], 5),
             ([8, 8, 8, 8, 8], 2), ([4, 2], 4)]

RUNGS = {
    "O0": dict(level=OptLevel.O0),
    "O1": dict(level=OptLevel.O1),
    "O2": dict(level=OptLevel.O2),
    "O4": dict(level=OptLevel.O4),
    "O5": dict(level=OptLevel.O5),
    "O6-gather": dict(level=OptLevel.O6, kv_block_size=4,
                      kv_pool_blocks=14),
    "O6-kernel": dict(level=OptLevel.O6, kv_block_size=4,
                      kv_pool_blocks=14, paged_attn="kernel"),
}

_MODELS = {}
_REF = {}


def _models(dtype: str):
    """(jax model, jax params, port model, port params), same weights."""
    if dtype not in _MODELS:
        jcfg = dataclasses.replace(jax_smoke("qwen3-8b"),
                                   compute_dtype=dtype)
        jm = jax_get_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = get_model(dataclasses.replace(get_smoke("qwen3-8b"),
                                           compute_dtype=dtype),
                       device="cpu")
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu",
                             dtype=DTYPES[dtype])
        _MODELS[dtype] = (jm, jp, tm, tp)
    return _MODELS[dtype]


def _random_mix(seed, vocab=256, *, n=8, prompt_hi=10, new_hi=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, int(rng.integers(1, prompt_hi))).tolist(),
             int(rng.integers(1, new_hi))) for _ in range(n)]


def _drive(eng, request_cls, mix, *, eos=None, late_from=None,
           each_tick=None):
    """Decode ``mix`` (``late_from`` submits the tail after two ticks;
    ``eos`` maps request index -> eos_id); returns generated tokens in
    submission order.  ``each_tick(eng)`` runs after every tick."""
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


def _jax_o5(mix, *, B=3, max_seq=32, **kw):
    jm, jp, _, _ = _models("float32")
    eng = JaxEngine(jm, jp, batch_size=B, max_seq=max_seq,
                    config=JaxConfig(level=JaxLevel.O5))
    return _drive(eng, JaxRequest, mix, **kw)


def _port(mix, rung, *, dtype="float32", B=3, max_seq=32, policy="fcfs",
          sampler=None, **kw):
    _, _, tm, tp = _models(dtype)
    eng = DecodeEngine(tm, tp, batch_size=B, max_seq=max_seq, policy=policy,
                       config=BestEffortConfig(**RUNGS[rung]),
                       sampler=sampler)
    if eng.layout.name == "paged":
        kw.setdefault("each_tick",
                      lambda e: e.cache_mgr.check_conservation())
    return _drive(eng, Request, mix, **kw)


def _mixes():
    """The two reference mixes and their JAX O5 float32 tokens: the
    ladder workload, and a random mix with eos planted from a first
    reference run and its tail arriving mid-flight."""
    if not _REF:
        _REF["ladder"] = (_WORKLOAD, {}, None, _jax_o5(_WORKLOAD))
        mix = _random_mix(1)
        first = _jax_o5(mix)
        eos = {k: g[len(g) // 2] for k, g in enumerate(first)
               if k % 2 == 0 and len(g) > 1}
        _REF["fuzz"] = (mix, eos, 5, _jax_o5(mix, eos=eos, late_from=5))
    return _REF


@pytest.mark.parametrize("rung", list(RUNGS))
def test_f32_greedy_tokens_identical_to_jax_o5(rung):
    for name, (mix, eos, late, want) in _mixes().items():
        got = _port(mix, rung, eos=eos, late_from=late)
        assert got == want, f"{rung} on {name}: {got} != {want}"
    assert [len(g) for g in _mixes()["ladder"][3]] == \
        [n for _, n in _WORKLOAD]


@pytest.mark.parametrize("rung", ["O0", "O1", "O2", "O4", "O6-gather",
                                  "O6-kernel"])
def test_bf16_rungs_identical_to_port_o5(rung):
    mix, eos, late, _ = _mixes()["fuzz"]
    want = _port(mix, "O5", dtype="bfloat16", eos=eos, late_from=late)
    got = _port(mix, rung, dtype="bfloat16", eos=eos, late_from=late)
    assert got == want, rung


@pytest.mark.parametrize("rung", ["O6-gather", "O6-kernel"])
def test_constrained_pool_queues_and_drains(rung):
    """A pool of two reservations with three slots queues (never
    rejects) the overflow, keeps every block accounted for after every
    tick, and finishes everything with the JAX O5 tokens."""
    mix = [([1, 2, 3, 4, 5, 6], 4)] * 4          # 10-token reservations
    _, _, tm, tp = _models("float32")
    eng = DecodeEngine(tm, tp, batch_size=3, max_seq=16,
                       config=BestEffortConfig(**dict(
                           RUNGS[rung], kv_pool_blocks=6)))
    seen = []

    def tick(e):
        e.cache_mgr.check_conservation()
        seen.append((len(e.queue), sum(s.active for s in e.slots)))

    got = _drive(eng, Request, mix, each_tick=tick)
    assert got == _jax_o5(mix, max_seq=16)
    assert any(q > 0 and a < 3 for q, a in seen), "pool never gated"
    assert eng.cache_mgr.free_blocks == 6
    plan = eng.cache_mgr.plan
    tok = 2 * 2 * 2 * 16 * 2          # (k, v) x L x KV x dh x bf16
    assert plan.geometry["token_bytes"] == tok
    assert plan.geometry["pool_bytes"] == 7 * 4 * tok
    assert plan.kernel_bytes_per_tick([1, 5]) == (3 * 4 + 2) * tok


@pytest.mark.parametrize("kind,kw", [("temperature", dict(temperature=1.3)),
                                     ("top_k", dict(top_k=5))])
@pytest.mark.parametrize("rung", ["O0", "O1", "O5", "O6-kernel"])
def test_stochastic_samplers_deterministic_per_seed(kind, kw, rung):
    mix = _random_mix(7, n=5)

    def run(seed):
        return _port(mix, rung, sampler=SamplerConfig(kind=kind, seed=seed,
                                                      **kw))

    a, b = run(3), run(3)
    assert a == b
    assert [len(g) for g in a] == [n for _, n in mix]
    assert run(4) != a


def test_placement_and_attn_impl_recorded():
    _, _, tm, tp = _models("float32")
    eng = DecodeEngine(tm, tp, batch_size=2, max_seq=16,
                       config=BestEffortConfig(**RUNGS["O6-kernel"]))
    assert eng.layout.attn_impl == "kernel"
    assert (eng.placement.requested_pe, eng.placement.n_devices) == (8, 1)
    eng2 = DecodeEngine(tm, tp, batch_size=2, max_seq=16,
                        config=BestEffortConfig(level=OptLevel.O2))
    assert eng2.layout.attn_impl is None
    assert eng2.placement.requested_pe == 1


def test_run_raises_on_tick_budget():
    _, _, tm, tp = _models("float32")
    eng = DecodeEngine(tm, tp, batch_size=2, max_seq=32,
                       config=BestEffortConfig(**RUNGS["O6-gather"]))
    for p, n in _WORKLOAD:
        eng.submit(Request(prompt=list(p), max_new_tokens=n))
    with pytest.raises(TickBudgetExceeded) as exc:
        eng.run(max_ticks=3)
    assert exc.value.survivors and all(r.truncated
                                       for r in exc.value.survivors)


def test_serve_demo_on_cpu_takes_the_plain_kernel():
    before = ops.paged_attention.launches
    out = serve_demo(get_smoke("qwen3-8b"), batch_size=3, max_seq=32,
                     n_requests=4, level=OptLevel.O6, paged_attn="kernel",
                     kv_block_size=4, device="cpu")
    assert ops.paged_attention.launches == before
    assert len(out["finished"]) == 4 and out["ticks"] > 0
    assert out["paged_attn"] == "kernel" and out["device"] == "cpu"
    assert out["pool"]["block_size"] == 4
    assert (out["prefill_mode"], out["spec_mode"]) == ("token", "off")
    before2 = ops.paged_prefill_attention.launches
    spec = serve_demo(get_smoke("qwen3-8b"), batch_size=3, max_seq=32,
                      n_requests=4, level=OptLevel.O7, paged_attn="kernel",
                      kv_block_size=4, draft_model="smollm-360m",
                      device="cpu")
    assert ops.paged_prefill_attention.launches == before2
    assert spec["spec_mode"] == "draft" and spec["spec"]["drafted"] > 0
    by_rid = lambda res: sorted((r.rid, r.generated)  # noqa: E731
                                for r in res["finished"])
    assert by_rid(spec) == by_rid(out)


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [2, 4, 16])
@pytest.mark.parametrize("rung", ["O2", "O5", "O6-gather", "O6-kernel"])
def test_chunked_prefill_f32_tokens_identical_to_jax_o5(rung, chunk):
    """Chunked prefill on the serial tick (O2), the overlapped tick (O5),
    and the paged gather and kernel (B2) steps: the JAX O5 engine's
    tokens on both reference mixes, every block accounted for after
    every tick."""
    for name, (mix, eos, late, want) in _mixes().items():
        _, _, tm, tp = _models("float32")
        eng = DecodeEngine(tm, tp, batch_size=3, max_seq=32,
                           config=BestEffortConfig(**RUNGS[rung],
                                                   prefill_chunk=chunk))
        assert eng.prefill_mode == "chunked"
        kw = {}
        if eng.layout.name == "paged":
            kw["each_tick"] = lambda e: e.cache_mgr.check_conservation()
        got = _drive(eng, Request, mix, eos=eos, late_from=late, **kw)
        assert got == want, f"{rung}/chunk {chunk} on {name}"


def test_chunked_prefill_cuts_ticks_to_first_token():
    """A 13-token prompt reaches its first token after ceil(13 / 4) = 4
    chunk ticks (the final chunk samples it) instead of 13 prestaged
    ticks and the O5 tick that finalizes the last one."""
    _, _, tm, tp = _models("float32")
    firsts = {}
    for chunk in (0, 4):
        eng = DecodeEngine(tm, tp, batch_size=2, max_seq=32,
                           config=BestEffortConfig(level=OptLevel.O5,
                                                   prefill_chunk=chunk))
        eng.submit(Request(prompt=list(range(1, 14)), max_new_tokens=3))
        ticks = 0
        while not eng.slots[0].active or not eng.slots[0].req.generated:
            eng.step()
            ticks += 1
        firsts[chunk] = ticks
    assert firsts == {0: 13 + 1, 4: 4}


# ---------------------------------------------------------------------------
# O7 speculative decoding
# ---------------------------------------------------------------------------

_DRAFTER = {}

SPEC = {
    "gather": dict(level=OptLevel.O7, kv_block_size=4, kv_pool_blocks=14),
    "kernel": dict(level=OptLevel.O7, kv_block_size=4, kv_pool_blocks=14,
                   paged_attn="kernel"),
}


def _drafter():
    """The smollm-360m smoke drafter (random weights from the
    reference's init, float32): acceptance near zero, which is what
    stresses rejection and rollback."""
    if not _DRAFTER:
        jcfg = dataclasses.replace(jax_smoke("smollm-360m"),
                                   compute_dtype="float32")
        jp = jax_get_model(jcfg).init(jax.random.PRNGKey(1))
        api = get_model(dataclasses.replace(get_smoke("smollm-360m"),
                                            compute_dtype="float32"),
                        device="cpu")
        _DRAFTER["zoo"] = (api, params_from_jax(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _DRAFTER["zoo"]


def _spec_engine(cell, *, draft="zoo", B=3, max_seq=32, **cfg_kw):
    _, _, tm, tp = _models("float32")
    api, dparams = (tm, tp) if draft == "self" else _drafter()
    return DecodeEngine(tm, tp, batch_size=B, max_seq=max_seq,
                        config=BestEffortConfig(**dict(SPEC[cell],
                                                       **cfg_kw)),
                        draft_model=api, draft_params=dparams)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("cell", list(SPEC))
def test_spec_f32_tokens_identical_to_jax_o5(cell, k):
    """O7 with the smollm-360m smoke drafter: the JAX O5 engine's tokens
    on both reference mixes (eos planted inside windows, late arrivals,
    a queueing pool), blocks conserved after every tick."""
    for name, (mix, eos, late, want) in _mixes().items():
        eng = _spec_engine(cell, draft_k=k)
        assert eng.spec_mode == "draft"
        got = _drive(eng, Request, mix, eos=eos, late_from=late,
                     each_tick=lambda e: e.cache_mgr.check_conservation())
        assert got == want, f"O7/{cell} K={k} on {name}"
        assert eng.spec_stats["drafted"] > 0


@pytest.mark.parametrize("cell", list(SPEC))
def test_spec_self_draft_accepts_every_draft(cell):
    """The target drafting for itself proposes its own argmax, so every
    draft is accepted: accept_rate is exactly 1.0 and a window emits
    more than one token (never reject a matching draft)."""
    eng = _spec_engine(cell, draft="self", B=2)
    mix, _, _, _ = _mixes()["ladder"]
    got = _drive(eng, Request, mix[:4])
    st = eng.spec_stats
    assert st["spec_mode"] == "draft" and st["draft_k"] == 4
    assert st["drafted"] > 0 and st["accept_rate"] == 1.0
    assert st["eff_tok_per_step"] > 1.0
    assert got == _mixes()["ladder"][3][:4]


def test_spec_counters_coherent_and_blocks_conserved():
    """Under the rejecting zoo drafter and a small pool: counters stay
    coherent after every tick (accepted <= drafted, one emitted token
    at least per window), blocks are conserved after every tick, and
    the windowed counters bracket disjoint intervals."""
    eng = _spec_engine("kernel", draft_k=4)
    windows = []

    def tick(e):
        e.cache_mgr.check_conservation()
        st = e.spec_stats
        assert st["accepted"] <= st["drafted"] == 4 * e.spec_windows
        assert st["emitted"] >= e.spec_windows
        windows.append(e.spec_stats_window())

    _drive(eng, Request, _random_mix(41), each_tick=tick)
    st = eng.spec_stats
    assert 0.0 <= st["accept_rate"] <= 1.0 and eng.spec_windows >= 1
    assert sum(w["drafted"] for w in windows) == st["drafted"]
    assert eng.cache_mgr.free_blocks == 14


@pytest.mark.parametrize("why", ["no drafter", "draft_k=0", "stochastic"])
def test_spec_degrades_are_recorded(why):
    """No drafter, K=0 or a stochastic sampler leave O7 decoding plainly
    — recorded in ``spec_mode``, never a failure — with the plain
    tokens."""
    _, _, tm, tp = _models("float32")
    api, dparams = _drafter()
    kw = dict(draft_model=api, draft_params=dparams)
    cfg = dict(SPEC["kernel"])
    sampler = None
    if why == "no drafter":
        kw = {}
    elif why == "draft_k=0":
        cfg["draft_k"] = 0
    else:
        sampler = SamplerConfig(kind="temperature", temperature=1.3)
    eng = DecodeEngine(tm, tp, batch_size=2, max_seq=24,
                       config=BestEffortConfig(**cfg), sampler=sampler, **kw)
    assert eng.spec_mode == "off" and eng.spec_stats["draft_k"] == 0
    eng.submit(Request(prompt=[5, 6, 7], max_new_tokens=4))
    got = eng.run()[0].generated
    assert len(got) == 4
    if sampler is None:
        assert got == _jax_o5([([5, 6, 7], 4)], B=2, max_seq=24)[0]


def test_spec_boundary_slots_near_max_seq():
    """Slots within K of ``max_seq`` take a plain decode dispatch for
    their last ticks (a window there would clip onto itself): tokens
    stay the JAX O5 engine's up to the max_seq retirement."""
    mix = [([3, 1, 4, 1, 5, 9], 9), ([2, 7], 13), ([8] * 9, 6)]
    want = _jax_o5(mix, max_seq=16)
    eng = _spec_engine("kernel", draft="self", max_seq=16, kv_pool_blocks=0)
    dispatches = []
    step = eng._dispatch

    def spy(*a, **k):
        dispatches.append(1)
        return step(*a, **k)

    eng._dispatch = spy
    assert _drive(eng, Request, mix) == want
    assert dispatches, "no slot took the boundary decode dispatch"


def test_spec_drafter_must_share_the_vocab():
    """A vocab-incompatible drafter is an operator error, not a degrade:
    the engine raises for the full-scale smollm-360m beside the smoke
    target (49,152 against 256 tokens)."""
    _, _, tm, tp = _models("float32")
    full = get_model(get_config("smollm-360m"), device="cpu")
    with pytest.raises(ValueError, match="not token-compatible"):
        DecodeEngine(tm, tp, batch_size=2, max_seq=16,
                     config=BestEffortConfig(level=OptLevel.O7),
                     draft_model=full, draft_params={})
