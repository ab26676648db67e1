"""The port's async front end (``repro_torch/launch/server.py``) against
the reference's: ``make_trace`` returns the reference's trace for the
same arguments, ``latency_metrics`` the reference's row for the same
finished records; and the server's tokens equal the synchronous
``submit()``/``run()`` path's — streaming in order, staggered arrivals,
degenerate and oversized requests, ``stop``, and ``serve_trace`` on the
contiguous, paged (O6) and int8-pool engines (the last within the
tolerance contract).  The engines run the smoke qwen3-8b on the CPU."""

import asyncio

import numpy as np
import pytest
import torch

from repro.launch import server as jserver
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_smoke
from repro_torch.core.optlevel import BestEffortConfig, OptLevel
from repro_torch.launch.server import (AsyncServer, TokenEvent,
                                       latency_metrics, make_trace,
                                       replay_trace, serve_trace)
from repro_torch.models import get_model
from repro_torch.serving import DecodeEngine, Request
from repro_torch.serving.kvquant import assert_tokens_match, tolerance_contract

_MODEL = {}


def _engine(B=3, max_seq=32, **cfg):
    if not _MODEL:
        cfg_m = get_smoke("qwen3-8b")
        model = get_model(cfg_m, device="cpu")
        _MODEL["m"] = (cfg_m, model,
                       model.init(torch.Generator().manual_seed(0)))
    cfg_m, model, params = _MODEL["m"]
    return DecodeEngine(model, params, batch_size=B, max_seq=max_seq,
                        config=BestEffortConfig(**cfg) if cfg else None)


def _sync_tokens(jobs, **kw):
    """Reference completions through the synchronous submit()/run()."""
    eng = _engine(**kw)
    for prompt, n in jobs:
        eng.submit(Request(prompt=list(prompt), max_new_tokens=n))
    return {tuple(r.prompt): r.generated for r in eng.run()}


def _match(want, got, label, contract=tolerance_contract("bf16")):
    assert set(want) == set(got), label
    keys = sorted(want)
    assert_tokens_match([want[k] for k in keys], [got[k] for k in keys],
                        contract, label)


# ---------------------------------------------------------------------------
# Traces and metrics against the reference's.
# ---------------------------------------------------------------------------

def _items(trace):
    return [(t.at_s, t.prompt, t.max_new_tokens, t.eos_id, t.deadline_s)
            for t in trace]


@pytest.mark.parametrize("kw", [
    dict(n_requests=20, rate=10.0, seed=3),
    dict(n_requests=33, rate=2.5, seed=1, pattern="bursty"),
    dict(n_requests=12, rate=40.0, seed=5, pattern="bursty", burst=3,
         burst_idle_factor=9.0, vocab=151936, prompt_len=(16, 257),
         max_new=(16, 33)),
    dict(n_requests=5, rate=10.0, deadline_slack_s=2.5),
], ids=["poisson", "bursty", "bursty-wide", "deadline"])
def test_make_trace_is_the_references(kw):
    mine = make_trace(**kw)
    assert _items(mine) == _items(jserver.make_trace(**kw))
    assert all(b.at_s >= a.at_s > 0 for a, b in zip(mine, mine[1:]))
    if "deadline_slack_s" in kw:
        assert all(t.deadline_s == 2.5 for t in mine)


def test_make_trace_rejects_bad_inputs():
    with pytest.raises(ValueError, match="pattern"):
        make_trace(n_requests=4, rate=1.0, pattern="carrier-pigeon")
    with pytest.raises(ValueError, match="rate"):
        make_trace(n_requests=4, rate=0.0)


def _recs(cls):
    rows = [  # arrival, first, finish, n_gen, truncated, deadline
        (0.0, 0.1, 0.5, 5, False, None),        # good
        (0.0, 0.9, 1.0, 2, False, None),        # TTFT miss
        (0.0, 0.1, 9.0, 5, False, None),        # TPOT miss
        (0.0, 0.1, 0.2, 5, True, None),         # truncated
        (0.2, 0.3, 0.4, 3, False, 1.0),         # deadline met
        (0.1, 0.2, 5.0, 3, False, 1.0),         # deadline missed
        (0.3, 0.35, 0.35, 1, False, None),      # one token: no TPOT
    ]
    out = []
    for arrival, first, finish, n, trunc, deadline in rows:
        r = cls(prompt=[1], max_new_tokens=n, deadline_s=deadline)
        r.generated = list(range(n))
        r.arrival_s, r.first_token_s, r.finish_s = arrival, first, finish
        r.truncated, r.done = trunc, True
        out.append(r)
    return out


@pytest.mark.parametrize("slo", [dict(), dict(ttft_slo_s=0.5,
                                              tpot_slo_s=0.2),
                                 dict(ttft_slo_s=60.0, tpot_slo_s=60.0)])
def test_latency_metrics_are_the_references(slo):
    mine = latency_metrics(_recs(Request), makespan_s=2.0, **slo)
    assert mine == jserver.latency_metrics(_recs(JaxRequest),
                                           makespan_s=2.0, **slo)
    assert latency_metrics([], makespan_s=1.0) == \
        jserver.latency_metrics([], makespan_s=1.0)


# ---------------------------------------------------------------------------
# AsyncServer against the synchronous path.
# ---------------------------------------------------------------------------

def test_async_server_tokens_identical_to_sync():
    jobs = [([5, 6, 7], 6), ([9, 3], 4), ([2, 2, 2, 2], 5), ([11], 3),
            ([4, 8], 7)]
    want = _sync_tokens(jobs)

    async def _run():
        async with AsyncServer(_engine()) as server:
            handles = [server.submit(p, max_new_tokens=n) for p, n in jobs]
            done = await asyncio.gather(*(h.done for h in handles))
        return {tuple(r.prompt): r.generated for r in done}

    _match(want, asyncio.run(_run()), "async vs sync")


def test_async_server_streams_every_token_in_order():
    async def _run():
        events = []
        async with AsyncServer(_engine(B=2)) as server:
            h1 = server.submit([5, 6, 7], max_new_tokens=5,
                               on_token=events.append)
            h2 = server.submit([9, 3], max_new_tokens=4)
            streamed = [ev async for ev in h2.tokens()]
            r1, r2 = await h1.done, await h2.done
        return h1, events, streamed, r1, r2

    h1, events, streamed, r1, r2 = asyncio.run(_run())
    assert all(isinstance(ev, TokenEvent) for ev in events)
    assert [ev.token for ev in events] == r1.generated
    assert [ev.index for ev in events] == list(range(len(r1.generated)))
    assert all(ev.rid == h1.rid for ev in events)
    assert [ev.token for ev in streamed] == r2.generated
    assert len(r1.generated) == 5 and len(r2.generated) == 4


def test_async_server_concurrent_staggered_submits():
    """Arrivals landing while the engine ticks still finish with the
    sync path's tokens for the same admission order."""
    jobs = [([5, 6, 7], 4), ([9, 3], 3), ([1, 2, 3, 4], 5), ([7], 3)]
    want = _sync_tokens(jobs, B=2)

    async def _run():
        async with AsyncServer(_engine(B=2)) as server:
            handles = []
            for p, n in jobs:
                handles.append(server.submit(p, max_new_tokens=n))
                for _ in range(3):
                    await asyncio.sleep(0)
            done = await asyncio.gather(*(h.done for h in handles))
        return {tuple(r.prompt): r.generated for r in done}

    _match(want, asyncio.run(_run()), "staggered async vs sync")


def test_async_server_degenerate_request_resolves_immediately():
    async def _run():
        async with AsyncServer(_engine()) as server:
            h = server.submit([1, 2], max_new_tokens=0)
            req = await h.done
            evs = [ev async for ev in h.tokens()]
        return req, evs

    req, evs = asyncio.run(_run())
    assert req.done and req.generated == [] and evs == []


def test_async_server_rejects_oversized_like_sync():
    async def _run():
        async with AsyncServer(_engine(max_seq=16)) as server:
            with pytest.raises(ValueError, match="max_seq"):
                server.submit([1] * 10, max_new_tokens=10)
            await server.submit([1, 2], max_new_tokens=2).done

    asyncio.run(_run())


def test_async_server_stop_fails_outstanding_futures():
    async def _run():
        server = await AsyncServer(_engine(), max_ticks=1).start()
        h = server.submit([5, 6, 7], max_new_tokens=8)
        with pytest.raises(RuntimeError, match="tick budget"):
            await h.done
        await server.stop()
        with pytest.raises(RuntimeError, match="not running"):
            server.submit([1], max_new_tokens=1)
        return h.request

    assert asyncio.run(_run()).truncated


def test_serve_trace_end_to_end_metrics():
    eng = _engine(B=2)
    trace = make_trace(n_requests=6, rate=50.0, seed=0, vocab=256,
                       prompt_len=(2, 6), max_new=(2, 5))
    out = serve_trace(eng, trace, time_scale=0.0)       # fire at once
    assert len(out["finished"]) == 6 and out["ticks"] > 0
    m = latency_metrics(out["finished"], makespan_s=out["makespan_s"],
                        ttft_slo_s=60.0, tpot_slo_s=60.0)
    assert m["requests"] == 6 and m["good_requests"] == 6
    assert m["tok_per_s"] > 0
    assert m["ttft_p50_s"] >= 0 and m["tpot_p50_s"] >= 0
    r = out["finished"][0]
    assert r.arrival_s <= r.first_token_s <= r.finish_s


def test_replay_trace_waits_for_arrival_times():
    """Open loop: each arrival waits for its time stamp, not for
    completions, so a trace spanning ~0.3 s takes at least that long."""
    trace = make_trace(n_requests=3, rate=10.0, seed=4, vocab=256,
                       prompt_len=(2, 4), max_new=(2, 3))

    async def _run():
        async with AsyncServer(_engine()) as server:
            return await replay_trace(server, trace, time_scale=0.2)

    out = asyncio.run(_run())
    assert len(out) == 3
    assert out[-1].arrival_s - out[0].arrival_s >= \
        0.2 * (trace[-1].at_s - trace[0].at_s) - 1e-3


@pytest.mark.parametrize("cell", [
    dict(level=OptLevel.O6, kv_block_size=4),
    dict(level=OptLevel.O6, kv_block_size=4, paged_attn="kernel",
         prefill_chunk=3),
], ids=["O6-gather", "O6-kernel-chunked"])
def test_serve_trace_paged_engine_identical_to_sync(cell):
    trace = make_trace(n_requests=5, rate=100.0, seed=2, vocab=64,
                       prompt_len=(2, 6), max_new=(2, 5))
    jobs = [(t.prompt, t.max_new_tokens) for t in trace]
    want = _sync_tokens(jobs, **cell)
    out = serve_trace(_engine(**cell), trace, time_scale=0.0)
    got = {tuple(r.prompt): r.generated for r in out["finished"]}
    _match(want, got, "trace paged vs sync")
    assert want == _sync_tokens(jobs, level=OptLevel.O5)


def test_serve_trace_quantized_engine_within_contract():
    """The int8 pool's replayed trace is held to the narrow tolerance
    contract against the bf16 sync reference, not bit-identity."""
    trace = make_trace(n_requests=5, rate=100.0, seed=2, vocab=64,
                       prompt_len=(2, 6), max_new=(2, 5))
    jobs = [(t.prompt, t.max_new_tokens) for t in trace]
    want = _sync_tokens(jobs, level=OptLevel.O6, kv_block_size=4)
    out = serve_trace(_engine(level=OptLevel.O6, kv_block_size=4,
                              kv_dtype="int8"), trace, time_scale=0.0)
    got = {tuple(r.prompt): r.generated for r in out["finished"]}
    _match(want, got, "trace int8 vs sync bf16",
           contract=tolerance_contract("int8"))
    assert np.isfinite(latency_metrics(
        out["finished"], makespan_s=out["makespan_s"])["tok_per_s"])
