"""One measurement API for the port's tuning surfaces (port copy of
``repro/autotune/measurement.py``).

The paper's refinement loop is *measure -> diagnose -> transform*; this
module owns the "measure" leg: the ``Measurement`` record the closed-loop
tuner (``autotune.tuner``) speaks and the repo-wide roofline-term
arithmetic, here against the card's spec (``core.hw.H100_SXM``).

Two backends implement the measure protocol:

  * :class:`KernelModelBackend` — the paper's analytic FPGA cost model
    (``core.costmodel``) for MachSuite kernels.  Instant and exact: the
    reference's records, number for number.
  * :class:`ServingBackend` — the serving engine itself: measured wall
    clock of a fixed workload at each rung O0..O7, with the
    paged-attention, prefill-chunk, draft-K and pool-dtype races, and an
    open-loop traffic objective (``launch.server``).

The reference's third, ``CostTwinBackend`` (the lowered-HLO cost twin of
an LM config), is still to port (ROADMAP A19, A20).

A backend exposes::

    initial_state()            -> opaque state (OptLevel)
    applied(state)             -> set[Step] already applied
    candidate_steps(state)     -> steps that could be applied next
    apply(state, step)         -> new state with ``step`` applied
    measure(state)             -> Measurement
    describe(state)            -> short human label ("O3")
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import costmodel
from repro_torch.core.hw import FPGA_2012, H100_SXM, GpuSpec
from repro_torch.core.optlevel import LADDER, OptLevel, Step


@dataclasses.dataclass
class Measurement:
    """One (target, configuration) performance measurement.

    ``total_s`` is the modeled wall time of the candidate — the objective the
    tuner minimizes.  The three roofline terms (plus the offload term for the
    comm-bound filter) are what the guideline diagnoses on.
    """

    target: str                  # "gemm"
    label: str                   # "O2"
    compute_s: float
    memory_s: float
    collective_s: float = 0.0
    offload_s: float = 0.0       # host<->device payload time (PCIe analog)
    baseline_s: float = 0.0      # CPU baseline for the comm-bound filter
    total_s: float = 0.0
    breakdown: dict = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["step_time_s"] = self.step_time_s
        return d


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_device: float,
    *,
    chips: int = 1,
    model_flops: float = 0.0,
    fused_bytes_per_device: float = None,
    spec: GpuSpec = H100_SXM,
) -> dict:
    """The repo-wide three-term roofline arithmetic, in one place.

    Per-device work over per-device peak: FLOPs over the bf16 peak, bytes
    over the device-memory rate, collective bytes over one link's rate
    each way.  Returns the ``*_s`` terms plus the derived diagnosis
    fields every harness reports (dominant term, step-time bound,
    roofline fraction); when ``fused_bytes_per_device`` is given, the
    fusion-adjusted view is included as ``*_fused`` fields.
    """
    rec = {
        "compute_s": flops_per_device / spec.peak_bf16_flops,
        "memory_s": bytes_per_device / spec.hbm_bw,
        "collective_s": collective_bytes_per_device / spec.link_bw,
    }
    terms = {k[:-2]: rec[k] for k in ("compute_s", "memory_s", "collective_s")}
    rec["dominant"] = max(terms, key=terms.get)
    rec["step_time_s"] = max(terms.values())
    useful_s = model_flops / (chips * spec.peak_bf16_flops)
    rec["roofline_fraction"] = (
        useful_s / rec["step_time_s"] if rec["step_time_s"] else 0.0)
    total_flops = flops_per_device * chips
    rec["useful_flops_fraction"] = (
        model_flops / total_flops if total_flops else 0.0)
    if fused_bytes_per_device is not None:
        rec["memory_fused_s"] = fused_bytes_per_device / spec.hbm_bw
        fterms = dict(terms, memory=rec["memory_fused_s"])
        rec["dominant_fused"] = max(fterms, key=fterms.get)
        rec["step_time_fused_s"] = max(fterms.values())
        rec["roofline_fraction_fused"] = (
            useful_s / rec["step_time_fused_s"]
            if rec["step_time_fused_s"] else 0.0)
    return rec


# ---------------------------------------------------------------------------
# Cumulative-ladder state machine, shared by every backend whose steps are
# the paper's O0..O5 levels rather than independent knobs.
# ---------------------------------------------------------------------------


class CumulativeLadderState:
    """State is an :class:`OptLevel`.  The ladder is cumulative, so
    "applying" a step means moving to the lowest level that includes it
    (exactly what the paper's iterations do: Iter #3 lands at O5 having
    passed O4).

    ``top_level`` bounds the walk to the steps that exist on this
    surface: the paper's platforms stop at O5.  ``step_universe`` is the
    matching step set, handed to the guideline so it neither recommends a
    rung the surface lacks nor stops before one it has.
    """

    top_level: OptLevel = OptLevel.O5

    @property
    def step_universe(self) -> tuple:
        return LADDER[: int(self.top_level)]

    def initial_state(self) -> OptLevel:
        return OptLevel.O0

    def applied(self, state: OptLevel):
        return set(state.steps)

    def candidate_steps(self, state: OptLevel):
        # The ladder is cumulative, so the only *minimal* move is the next
        # level: offering later steps as candidates would bundle every
        # intervening step into one jump (O0 + scratchpad-reorg == O5) and
        # the frontier would trivially pick the whole ladder in one round.
        if state >= self.top_level:
            return []
        return [LADDER[int(state)]]

    def apply(self, state: OptLevel, step: Step) -> OptLevel:
        return OptLevel(max(int(state), LADDER.index(step) + 1))

    def describe(self, state: OptLevel) -> str:
        return f"O{int(state)}"


# ---------------------------------------------------------------------------
# Backend: analytic cost model (MachSuite kernels, the paper's platform).
# ---------------------------------------------------------------------------


class KernelModelBackend(CumulativeLadderState):
    """Measure MachSuite kernels on the paper's analytic FPGA model.

    Instant, framework-free, exact reproduction of the paper's platform —
    including its resource feedback (Table 6): a level whose requested
    (cache, PE, word-width) configuration over-subscribes the BRAM fabric
    is not a dead end; ``costmodel.fit_resources`` shrinks the knobs,
    re-measures the feasible candidates, and the walk continues at the
    fastest one.  The fit is recorded in ``Measurement.meta['resource']``.
    """

    def __init__(self, profile: costmodel.KernelProfile, *, hw=None,
                 cache_bytes: float = 64 * 1024, pe: int = 128):
        self.profile = profile
        self.hw = hw or FPGA_2012
        self.cache_bytes = cache_bytes
        self.pe = pe

    @property
    def name(self) -> str:
        return self.profile.name

    def measure(self, state: OptLevel) -> Measurement:
        fit = costmodel.fit_resources(
            self.profile, state, self.hw,
            cache_bytes=self.cache_bytes, pe=self.pe)
        t = costmodel.kernel_time(
            self.profile, state, self.hw,
            cache_bytes=fit["cache_bytes"], pe=fit["pe"],
            word_bits=fit["word_bits"])
        return Measurement(
            target=self.profile.name,
            label=self.describe(state),
            compute_s=t["compute_s"],
            memory_s=t["dram_s"],
            offload_s=t["pcie_s"],
            baseline_s=self.profile.cpu_time_s,
            total_s=t["system_s"],
            breakdown=dict(t),
            meta={"backend": "kernel_model", "level": int(state),
                  "resource": fit},
        )


# ---------------------------------------------------------------------------
# Backend: the serving engine itself (measured tokens/sec, not a model).
# ---------------------------------------------------------------------------


def _generator(device, seed: int):
    """A torch generator on ``device`` seeded with ``seed``: random weights
    are drawn on the device they serve from."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def serving_smoke_config(arch: str, vocab: int = 0):
    """The smoke config, optionally with a production-sized vocabulary.

    ``vocab=0`` keeps the reduced smoke vocab — short ticks, so the
    host-side mechanics the upper ladder rungs change (overlap, packed
    resets) are a measurable fraction of a tick.  Passing e.g. 32768
    restores a serving-realistic lm head, which stresses the naive
    per-request path's full-logits round trips instead (layers stay
    smoke-sized either way).
    """
    from repro_torch.configs import get_smoke

    cfg = get_smoke(arch)
    if vocab and vocab > cfg.vocab:
        cfg = dataclasses.replace(cfg, vocab=vocab)
    return cfg


def serving_workload(vocab: int, *, max_seq: int, n_requests: int,
                     max_new: int, seed: int = 0) -> list:
    """The fixed mixed-length workload every serving measurement decodes:
    ``[(prompt, max_new_tokens), ...]``, deterministic from ``seed``.
    The reference's workload, draw for draw."""
    import numpy as np

    if max_new < 1 or max_seq < 2:
        raise ValueError(
            f"serving workload needs max_new >= 1 and max_seq >= 2 "
            f"(got max_new={max_new}, max_seq={max_seq})")
    max_new = min(max_new, max_seq - 1)
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n_requests):
        plen = int(rng.integers(1, max(2, max_seq // 4)))
        new = int(rng.integers(min(2, max_new), max_new + 1))
        # keep every request admissible: prompt + budget within max_seq
        plen = max(1, min(plen, max_seq - new))
        reqs.append((rng.integers(1, vocab, plen).tolist(), new))
    return reqs


def run_serving_workload(engine, workload: list):
    """Submit ``workload`` to ``engine``, drain it, and return
    ``(wall_s, tokens, generated, ticks)`` for that run only (the engine
    may be reused across runs)."""
    import time

    from repro_torch.serving import Request

    done_before = len(engine.finished)
    steps_before = engine.n_steps
    rids = [engine.submit(Request(prompt=list(p), max_new_tokens=n))
            for p, n in workload]
    t0 = time.perf_counter()
    engine.run()
    wall = time.perf_counter() - t0
    by_rid = {r.rid: r.generated for r in engine.finished[done_before:]}
    gen = [by_rid[rid] for rid in rids]
    return wall, sum(len(g) for g in gen), gen, engine.n_steps - steps_before


def serving_latency_probe(engine, vocab: int, *, prompt_len: int = 24,
                          max_new: int = 8, seed: int = 123):
    """One latency probe through the REAL prefill path: submit a single
    request to an idle, warm engine and step it to completion, timing

      * TTFT — wall seconds from submit until the host OBSERVES the
        first generated token (chunked prefill pays
        ceil(prompt_len/chunk) ticks here; the legacy path pays
        prompt_len), and
      * ITL — mean wall seconds between subsequent tokens.

    Returns ``(ttft_s, itl_s, tokens)``.  This is a single unloaded
    probe, NOT wall-clock under load: callers take the best of several
    probes so process drift cancels."""
    import time

    from repro_torch.serving import Request

    import numpy as np

    rng = np.random.default_rng(seed)
    prompt = rng.integers(1, vocab, prompt_len).tolist()
    req = Request(prompt=prompt, max_new_tokens=max_new)
    engine.submit(req)
    t0 = time.perf_counter()
    ticks = 0
    while not req.generated and ticks < 100_000:
        engine.step()
        ticks += 1
    ttft = time.perf_counter() - t0
    while not req.done and ticks < 200_000:
        engine.step()
        ticks += 1
    total = time.perf_counter() - t0
    itl = (total - ttft) / max(1, len(req.generated) - 1)
    return ttft, itl, len(req.generated)


class ServingBackend(CumulativeLadderState):
    """Measure ``repro_torch.serving.DecodeEngine`` at each ladder level.

    Unlike the analytic backend this one runs the *real* hot path on
    ``device`` (default CUDA; ``"cpu"`` runs the kernels' plain
    versions): a fixed continuous-batching workload (mixed
    prompt/generation lengths, deterministic from ``seed``) is decoded to
    completion on the smoke config and the objective is measured
    wall-clock seconds (tokens/sec in ``meta``).  One engine is built per
    level, warmed up once so first-call costs (the kernels' build and
    load) never pollute the timing, then the workload is re-run
    ``repeats`` times and the best run wins (best-of-K absorbs scheduler
    jitter; the workload itself is identical run to run).  The engine's
    tick reads its tokens back to the host, so a drain's wall clock ends
    after the device finished.

    ``meta['generated']`` records every request's token ids so the ladder
    walk can assert bit-identical generations across levels under greedy
    sampling — the serving analog of MachSuite's O0..O5 output-equivalence
    matrix.  This surface's ladder extends past the paper's five to the
    paged-scratchpad and speculative rungs (``top_level = O7``);
    ``meta['kv_capacity']`` records each level's persistent decode-cache
    token capacity so the walk shows the paged rung's actual win
    (capacity at equal memory, not raw tok/s), and ``meta['layout']`` /
    ``meta['devices']`` record each rung's (cache layout, device count)
    cell — the port serves on one device, so O3's ``pe`` is recorded and
    clipped (``engine.placement``) and ``devices`` reads 1.

    At the paged rung the attention implementation is itself a measured
    knob (``paged_attn="auto"``, the default): the walk builds BOTH the
    gather step (dense view re-materialized per tick) and the gather-free
    block-table kernel step, interleaves the timed repeats so process
    drift cancels, and keeps the winner — falling back to gather on a
    tie/loss (within 1%).  ``meta['paged_attn']`` records the chosen
    implementation and ``meta['paged_attn_walls']`` both measured floors,
    AutoDSE-style: the rung is kept because it measured faster, not
    assumed so.

    The pool's stored dtype is a measured knob too (``kv_dtype="auto"``):
    the paged rung races its chosen bf16 engine against an int8 twin at
    EQUAL POOL MEMORY (the narrow blocks' saved bytes buy more blocks)
    and keeps narrow only when goodput/tok-s wins beyond the noise
    floor.  Narrow pools are held to the dtype's TOLERANCE contract
    (``serving.kvquant.tolerance_contract``) against the incumbent's
    tokens — never to bit-identity — plus strict determinism across
    repeats; ``meta['kv_dtype']`` records the shipped dtype and
    ``meta['kv_dtype_walls']`` both measured floors.

    The speculative rung (``top_level = O7``) follows the same rule with
    the window size as the knob: ``draft_k="auto"`` races K in {0,2,4,8}
    on interleaved repeats (K=0 is the incumbent O6-equivalent engine —
    speculation off) and keeps a K only when it WINS beyond the 1% noise
    floor.  Greedy rejection makes every K bit-identical, so the race is
    pure wall-clock; ``meta['draft_k_walls']`` records every measured
    floor keyed by the K that actually RAN, and ``meta['accept_rate']``
    / ``meta['eff_tok_per_step']`` the chosen engine's acceptance
    telemetry.

    TRAFFIC MODE (``traffic_rate > 0``): after the closed-loop races pick
    the level's engine, the walk replays a fixed open-loop arrival trace
    (``launch.server``) at the target rate and the OBJECTIVE
    becomes inverse goodput-under-SLO — requests meeting both the TTFT
    and per-token SLOs, per second — instead of best-of-K wall clock.
    AutoDSE's lesson is that closed-loop tuning only transfers when the
    measured objective matches the deployment objective; for a server
    that objective is goodput at the offered rate, not drain time of a
    fixed batch.  The knob races above still run closed-loop (they pick
    the engine; bit-identity is asserted there), and
    ``meta['traffic']`` records the full latency/goodput row.
    """

    top_level = OptLevel.O7

    def __init__(self, arch: str = "qwen3-8b", *, batch_size: int = 4,
                 max_seq: int = 48, n_requests: int = 12, max_new: int = 8,
                 repeats: int = 3, policy: str = "fcfs", pe: int = 8,
                 vocab: int = 0, seed: int = 0, kv_block_size: int = 16,
                 kv_pool_blocks: int = 0, paged_attn: str = "auto",
                 prefill_chunk="auto", draft_model: str = "smollm-360m",
                 draft_k="auto", kv_dtype: str = "auto",
                 traffic_rate: float = 0.0,
                 traffic_pattern: str = "poisson",
                 ttft_slo_s: float = 0.5, tpot_slo_s: float = 0.1,
                 device=None):
        from repro_torch.serving.kvquant import KV_DTYPES
        if paged_attn not in ("auto", "gather", "kernel"):
            raise ValueError(f"paged_attn must be auto|gather|kernel "
                             f"(got {paged_attn!r})")
        if kv_dtype != "auto" and kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be auto|{'|'.join(KV_DTYPES)} "
                             f"(got {kv_dtype!r})")
        if traffic_pattern not in ("poisson", "bursty"):
            raise ValueError(f"traffic_pattern must be poisson|bursty "
                             f"(got {traffic_pattern!r})")
        if prefill_chunk != "auto" and (not isinstance(prefill_chunk, int)
                                        or prefill_chunk < 0):
            raise ValueError(f"prefill_chunk must be 'auto' or an int >= 0 "
                             f"(got {prefill_chunk!r})")
        if draft_k != "auto" and (not isinstance(draft_k, int)
                                  or draft_k < 0):
            raise ValueError(f"draft_k must be 'auto' or an int >= 0 "
                             f"(got {draft_k!r})")
        self.prefill_chunk = prefill_chunk
        self.draft_model = draft_model
        self.draft_k = draft_k
        self.arch = arch
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.n_requests = n_requests
        self.max_new = max_new
        self.repeats = repeats
        self.policy = policy
        self.pe = pe
        self.vocab = vocab
        self.seed = seed
        self.kv_block_size = kv_block_size
        self.kv_pool_blocks = kv_pool_blocks
        self.paged_attn = paged_attn
        self.kv_dtype = kv_dtype
        self.traffic_rate = float(traffic_rate)
        self.traffic_pattern = traffic_pattern
        self.ttft_slo_s = float(ttft_slo_s)
        self.tpot_slo_s = float(tpot_slo_s)
        self.device = device
        self._model = None
        self._params = None
        self._draft = None          # (ModelAPI, params) once built

    @property
    def name(self) -> str:
        return f"serve/{self.arch}"

    def _ensure_model(self):
        if self._model is None:
            from repro_torch.models import get_model

            cfg = serving_smoke_config(self.arch, self.vocab)
            self._model = get_model(cfg, device=self.device)
            self._params = self._model.init(
                _generator(self._model.device, self.seed))
            self._vocab = cfg.vocab
        return self._model, self._params

    def _workload(self):
        self._ensure_model()
        return serving_workload(self._vocab, max_seq=self.max_seq,
                                n_requests=self.n_requests,
                                max_new=self.max_new, seed=self.seed)

    def _ensure_drafter(self):
        """Build the drafter (api, params) ONCE and share it across every
        engine in the draft_k race — drafter weights are not a knob, and
        re-initializing per K would race different random drafters.  The
        drafter gets the same smoke config (and ``vocab`` override) as
        the target: this surface's token space is synthetic, so the two
        share it by construction — ``compatible_drafter`` still
        validates the pairing."""
        if self._draft is None:
            from repro_torch.models import get_model
            from repro_torch.models.model_zoo import compatible_drafter

            model, _ = self._ensure_model()
            dcfg = serving_smoke_config(self.draft_model, self.vocab)
            dcfg = compatible_drafter(model.cfg, dcfg)
            api = get_model(dcfg, device=model.device)
            self._draft = (api, api.init(_generator(api.device,
                                                    self.seed + 1)))
        return self._draft

    def _build_engine(self, state: OptLevel, paged_attn: str,
                      prefill_chunk: int = 0, draft_k: int = 0,
                      kv_dtype: str = "bf16", pool_blocks=None):
        from repro_torch.core.optlevel import BestEffortConfig
        from repro_torch.serving import DecodeEngine

        model, params = self._ensure_model()
        draft_api = draft_params = None
        if draft_k > 0:
            draft_api, draft_params = self._ensure_drafter()
        return DecodeEngine(
            model, params, batch_size=self.batch_size, max_seq=self.max_seq,
            config=BestEffortConfig(level=state, pe=self.pe,
                                    kv_block_size=self.kv_block_size,
                                    kv_pool_blocks=(
                                        self.kv_pool_blocks
                                        if pool_blocks is None
                                        else pool_blocks),
                                    paged_attn=paged_attn,
                                    prefill_chunk=prefill_chunk,
                                    draft_model=self.draft_model,
                                    draft_k=draft_k,
                                    kv_dtype=kv_dtype),
            policy=self.policy, draft_model=draft_api,
            draft_params=draft_params)

    def _traffic_measure(self, engine) -> dict:
        """Open-loop replay of a fixed deterministic trace at the target
        arrival rate on the (warm, drained) chosen engine; best goodput
        over ``repeats`` replays — wall-clock is noisy on a shared
        container, so the floor absorbs the jitter the same way the
        closed-loop best-of-K does."""
        from repro_torch.launch.server import (latency_metrics, make_trace,
                                               serve_trace)

        trace = make_trace(
            n_requests=max(self.n_requests, 8), rate=self.traffic_rate,
            seed=self.seed, pattern=self.traffic_pattern,
            vocab=self._vocab,
            prompt_len=(2, max(3, min(10, self.max_seq // 4))),
            max_new=(2, max(3, self.max_new)))
        best = None
        for _ in range(max(1, self.repeats)):
            res = serve_trace(engine, trace)
            m = latency_metrics(res["finished"],
                                makespan_s=res["makespan_s"],
                                ttft_slo_s=self.ttft_slo_s,
                                tpot_slo_s=self.tpot_slo_s)
            m["rate_rps"] = self.traffic_rate
            m["pattern"] = self.traffic_pattern
            if best is None or m["goodput_rps"] > best["goodput_rps"]:
                best = m
        return best

    def measure(self, state: OptLevel) -> Measurement:
        model, _ = self._ensure_model()
        workload = self._workload()

        # The paged rung's attention implementation is a measured knob:
        # "auto" races gather vs the gather-free kernel and keeps the
        # winner; gather wins ties.
        paged = state.has(Step.PAGED_SCRATCHPAD)
        if not paged:
            variants = ("gather",)            # ignored by the layout
        elif self.paged_attn == "auto" and model.paged_decode_step is not None:
            variants = ("gather", "kernel")
        else:
            variants = (self.paged_attn if self.paged_attn != "auto"
                        else "gather",)
        pinned = 0 if self.prefill_chunk == "auto" else int(self.prefill_chunk)
        engines = {v: self._build_engine(state, v, pinned) for v in variants}

        # warmup: first calls (the kernels' build and load) land here
        generated = tokens = ticks = None
        for v in variants:
            _, tok, gen, tk = run_serving_workload(engines[v], workload)
            if generated is None:
                generated, tokens, ticks = gen, tok, tk
            else:
                assert gen == generated, (
                    f"paged_attn={v} changed greedy tokens")
        best = dict.fromkeys(variants)
        for _ in range(max(1, self.repeats)):
            for v in variants:                # interleaved: drift cancels
                wall, _, gen, _ = run_serving_workload(engines[v], workload)
                assert gen == generated, \
                    "serving workload must be deterministic"
                if best[v] is None or wall < best[v]:
                    best[v] = wall

        chosen = variants[0]
        if len(variants) > 1:
            # The kernel displaces gather only by WINNING beyond the 1%
            # noise floor; a tie or loss keeps the incumbent (the
            # best-effort keep-only-when-it-wins rule).
            if (engines["kernel"].layout.attn_impl == "kernel"
                    and best["kernel"] < 0.99 * best["gather"]):
                chosen = "kernel"
        engine = engines[chosen]
        best_wall = best[chosen]

        # Chunked prefill is itself a measured knob ("auto", paged rungs
        # only): race the chosen engine against a chunked twin of the
        # same (level, attn) cell, interleaving the timed repeats, and
        # keep the chunk only when it WINS beyond the 1% noise floor —
        # the same best-effort rule as the paged_attn race.
        chunk = pinned
        chunk_walls = None
        if (self.prefill_chunk == "auto" and state >= OptLevel.O6
                and model.prefill_step is not None):
            race_chunk = 16
            chunked = self._build_engine(state, chosen, race_chunk)
            if chunked.prefill_mode == "chunked":
                _, _, gen, _ = run_serving_workload(chunked, workload)
                assert gen == generated, \
                    "chunked prefill changed greedy tokens"
                best_c = None
                for _ in range(max(1, self.repeats)):
                    wall, _, gen, _ = run_serving_workload(chunked, workload)
                    assert gen == generated, \
                        "serving workload must be deterministic"
                    if best_c is None or wall < best_c:
                        best_c = wall
                    wall, _, _, _ = run_serving_workload(engine, workload)
                    if wall < best_wall:
                        best_wall = wall
                chunk_walls = {0: best_wall, race_chunk: best_c}
                # the extra interleaved repeats refine the incumbent's
                # floor — keep the recorded attn-race wall in sync
                best[chosen] = best_wall
                if best_c < 0.99 * best_wall:
                    engine, best_wall, chunk = chunked, best_c, race_chunk

        # The speculative rung's window size is a measured knob too
        # (``draft_k="auto"``, O7 only): race K in {0, 2, 4, 8} on
        # interleaved repeats.  K=0 is the incumbent engine chosen
        # above (speculation off — exactly the O6 hot path); a window
        # displaces it only by WINNING beyond the 1% noise floor.
        # Greedy rejection keeps every K bit-identical, so the race is
        # pure wall-clock — asserted, not assumed.
        draft_k_walls = None
        if (state.has(Step.SPECULATIVE) and self.draft_k != 0
                and model.verify_step is not None):
            ks = (2, 4, 8) if self.draft_k == "auto" else (self.draft_k,)
            spec_engines = {}
            for k in ks:
                e = self._build_engine(state, chosen, chunk, draft_k=k)
                if e.spec_mode != "draft":
                    # this (layout x placement x model) cell cannot
                    # speculate — degrade to the incumbent, no race
                    spec_engines = {}
                    break
                spec_engines[k] = e
            if spec_engines:
                for k, e in spec_engines.items():   # warmup
                    _, _, gen, _ = run_serving_workload(e, workload)
                    assert gen == generated, \
                        f"draft_k={k} changed greedy tokens"
                best_k = dict.fromkeys(spec_engines)
                for _ in range(max(1, self.repeats)):
                    for k, e in spec_engines.items():   # interleaved
                        wall, _, gen, _ = run_serving_workload(e, workload)
                        assert gen == generated, \
                            "serving workload must be deterministic"
                        if best_k[k] is None or wall < best_k[k]:
                            best_k[k] = wall
                    wall, _, _, _ = run_serving_workload(engine, workload)
                    if wall < best_wall:
                        best_wall = wall
                # keyed by the K each engine actually RAN at (0 = the
                # incumbent; spec engines were verified to be drafting)
                draft_k_walls = {0: best_wall}
                draft_k_walls.update(
                    {e.spec_stats["draft_k"]: best_k[k]
                     for k, e in spec_engines.items()})
                win = min(spec_engines, key=lambda k: best_k[k])
                if best_k[win] < 0.99 * best_wall:
                    engine, best_wall = spec_engines[win], best_k[win]

        # The pool's STORED dtype is the last measured knob (paged rungs
        # only): ``kv_dtype="auto"`` races the chosen bf16 engine against
        # a narrow (int8) twin holding the SAME pool memory — the bytes
        # the narrow blocks save are spent on MORE blocks, so the race
        # compares what deployment compares (capacity-for-precision at
        # equal HBM).  The narrow twin is NOT token-asserted against the
        # incumbent — quantized rungs carry a tolerance contract, not the
        # bit-identity contract — it must instead meet the contract's
        # agreement floor against the incumbent's tokens AND be
        # deterministic across repeats.  "auto" keeps narrow only when it
        # WINS beyond the 1% noise floor (goodput in traffic mode, drain
        # wall otherwise); a pinned narrow dtype ships narrow regardless
        # but still records both measured floors.
        kv_dtype_walls = None
        kv_agreement = None
        # The race only runs when the cache pages KV blocks (the port's
        # serving families all do).
        has_blocks = paged and engine.cache_mgr.plan.token_bytes > 0
        if paged and has_blocks and self.kv_dtype != "bf16":
            from repro_torch.serving import kvquant
            from repro_torch.serving.paged import BlockPagingPlan

            narrow = "int8" if self.kv_dtype == "auto" else self.kv_dtype
            inc_mgr = engine.cache_mgr
            T = inc_mgr.block_size
            wide_plan = inc_mgr.plan
            nplan = BlockPagingPlan(model, self.batch_size, self.max_seq,
                                    T, inc_mgr.pool_blocks,
                                    kv_dtype=narrow)
            wide_bb = T * wide_plan.token_bytes \
                + wide_plan.scale_bytes_per_block
            narrow_bb = T * nplan.token_bytes + nplan.scale_bytes_per_block
            q_blocks = max(inc_mgr.pool_blocks,
                           inc_mgr.pool_blocks * wide_bb // narrow_bb)
            qk = 0
            if state.has(Step.SPECULATIVE):
                st = engine.spec_stats
                if st["spec_mode"] == "draft":
                    qk = st["draft_k"]
            qeng = self._build_engine(state, chosen, chunk, draft_k=qk,
                                      kv_dtype=narrow,
                                      pool_blocks=q_blocks)
            _, _, qgen, _ = run_serving_workload(qeng, workload)  # warmup
            tc = kvquant.tolerance_contract(narrow)
            kv_agreement = kvquant.token_agreement(generated, qgen)
            assert kv_agreement >= tc["min_agreement"], (
                f"kv_dtype={narrow} token agreement {kv_agreement:.3f} "
                f"below the {tc['min_agreement']} tolerance contract")
            best_q = None
            for _ in range(max(1, self.repeats)):
                wall, _, g, _ = run_serving_workload(qeng, workload)
                assert g == qgen, \
                    "narrow-pool serving workload must be deterministic"
                if best_q is None or wall < best_q:
                    best_q = wall
                wall, _, _, _ = run_serving_workload(engine, workload)
                if wall < best_wall:
                    best_wall = wall
            kv_dtype_walls = {"bf16": best_wall, narrow: best_q}
            if self.traffic_rate > 0:
                tm_b = self._traffic_measure(engine)
                tm_q = self._traffic_measure(qeng)
                win_q = (tm_q["goodput_rps"]
                         > 1.01 * tm_b["goodput_rps"])
            else:
                win_q = best_q < 0.99 * best_wall
            if self.kv_dtype != "auto" or win_q:
                engine, best_wall, generated = qeng, best_q, qgen

        # Unloaded single-request latency (TTFT / inter-token) through
        # the real prefill path, best-of-repeats on the warm engine.
        ttft = itl = None
        probe_len = max(1, min(24, self.max_seq - self.max_new))
        for _ in range(max(1, self.repeats)):
            t, il, _ = serving_latency_probe(
                engine, self._vocab, prompt_len=probe_len,
                max_new=self.max_new, seed=self.seed + 17)
            ttft = t if ttft is None else min(ttft, t)
            itl = il if itl is None else min(itl, il)

        tok_per_s = tokens / best_wall if best_wall > 0 else 0.0
        # Persistent decode-cache capacity in token positions: contiguous
        # rungs reserve B x max_seq; the paged rung holds pool_blocks x T.
        kv_capacity = engine.cache_mgr.capacity_tokens
        meta = {
            "backend": "serving",
            "level": int(state),
            "tok_per_s": tok_per_s,
            "tokens": tokens,
            "ticks": ticks,
            "batch_size": self.batch_size,
            "requests": self.n_requests,
            "policy": self.policy,
            "kv_capacity": kv_capacity,
            "layout": engine.layout.name,
            "devices": engine.placement.n_devices,
            "paged_attn": getattr(engine.layout, "attn_impl", None),
            "state_impl": getattr(engine.layout, "state_impl", "none"),
            "degrade_reason": getattr(engine, "degrade_reason", None),
            "kv_dtype": getattr(engine.layout, "kv_dtype", "bf16"),
            "prefill_chunk": chunk,
            "prefill_mode": engine.prefill_mode,
            "ttft_s": ttft,
            "itl_s": itl,
            "generated": [[int(t) for t in g] for g in generated],
        }
        if state.has(Step.SPECULATIVE):
            st = engine.spec_stats
            meta["spec_mode"] = st["spec_mode"]
            meta["draft_k"] = st["draft_k"]
            meta["draft_model"] = (self.draft_model
                                   if st["spec_mode"] == "draft" else None)
            meta["accept_rate"] = st["accept_rate"]
            meta["eff_tok_per_step"] = st["eff_tok_per_step"]
        if draft_k_walls is not None:
            meta["draft_k_walls"] = draft_k_walls
        if kv_dtype_walls is not None:
            # keyed by stored dtype; both floors recorded whether or not
            # the narrow pool was kept (AutoDSE-style: the decision is
            # auditable from the walls, not just the winner)
            meta["kv_dtype_walls"] = kv_dtype_walls
            meta["kv_agreement"] = kv_agreement
        if chunk_walls is not None:
            meta["prefill_chunk_walls"] = chunk_walls
        if paged:
            # keyed by the implementation that actually RAN
            meta["paged_attn_walls"] = {
                engines[v].layout.attn_impl: best[v] for v in variants}

        # Traffic mode: the tuner's objective flips from drain wall to
        # inverse goodput at the target arrival rate (lower total_s ==
        # more SLO-meeting requests per second); the closed-loop wall
        # stays in compute_s / breakdown for reference.
        objective = best_wall
        if self.traffic_rate > 0:
            traffic = self._traffic_measure(engine)
            meta["traffic"] = traffic
            objective = 1.0 / max(traffic["goodput_rps"], 1e-9)
        return Measurement(
            target=self.name,
            label=self.describe(state),
            compute_s=best_wall,
            memory_s=0.0,
            total_s=objective,
            breakdown={"wall_s": best_wall, "tok_per_s": tok_per_s},
            meta=meta,
        )
