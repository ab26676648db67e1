"""Unified model API: family dispatch, drafter pairing and input specs
(port of ``repro/models/model_zoo.py``).

``get_model(cfg, device=None)`` returns a ``ModelAPI`` whose functions
close over the arch config and the device (``None`` = CUDA).  Five
families are ported, each with the training loss and the serving hooks.
The dense family has decode, chunked prefill and speculative verify,
each dense and paged.  The ssm (rwkv6), mamba (mamba2) and hybrid
(zamba2) families carry recurrent state: decode, its paged form and
chunked prefill, but no paged prefill and no verify step, as in the
reference (O7 on them decodes plainly).  The paged decode step takes
what the paged manager's ``step_extras()`` emits: (rows,) for rwkv6 and
mamba2, (tables, rows) for the hybrid, whose shared attention reads the
block pool (kernel B1) while its trunk's state lives in state rows.  The
enc-dec family (audio: whisper) carries no state — its self K/V is
rewrite-safe and its cross K/V read-only — so its contiguous rungs chunk
prompts like the dense family's; its paged step takes (tables, rows)
like the hybrid's (self K/V in blocks, cross K/V in state rows), and it
has chunked prefill but no paged prefill and no verify step, as in the
reference.  ``input_specs``/``make_batch`` give a training cell's batch
(with its ``frames`` for the audio family).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import (encdec, hybrid, mamba2, rwkv_lm,
                                scan_prefill, transformer)


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    device: torch.device
    # (generator, dtype=None) -> params on ``device``, in the compute
    # dtype unless ``dtype`` is given (training: float32 masters).
    init: Callable
    defs: Callable            # () -> PDef tree
    loss: Callable            # (params, batch) -> scalar (autograd)
    decode_step: Callable     # (params, cache, tokens, positions) -> (logits, cache)
    cache_spec: Callable      # (batch, max_seq) -> {name: (shape, dtype)}
    init_cache: Callable      # (batch, max_seq) -> cache on ``device``
    cache_axes: Callable      # () -> logical-axes tree matching cache_spec
    # True for families whose decode cache is a CARRY (the rwkv wkv
    # state and token shifts, the mamba conv/ssm state) rather than a
    # position-addressed KV log.  The contiguous layout cannot park a
    # carried-state slot mid-prompt (a pad feed would fold into the
    # carry), so it refuses chunked prefill for these families; the
    # paged layout parks them on the NULL state row instead.
    carries_state: bool = False
    # (params, pool, *extras, tokens, positions) -> (logits, pool): the
    # serving O6 kernel path.  ``extras`` is what the paged manager's
    # ``step_extras()`` emits: (tables,) for the dense family, (rows,)
    # for the recurrent ones, (tables, rows) for the hybrid and enc-dec.
    paged_decode_step: Callable = None
    # Chunked prefill (params, cache, tokens (B, C), start (B,), last
    # (B,)) -> (logits, cache): C prompt tokens per call, logits at each
    # slot's ``last`` row.
    prefill_step: Callable = None
    # Same straight off the paged pool through kernel B2:
    # (params, pool, tables, tokens, start, last) -> (logits, pool).
    paged_prefill_step: Callable = None
    # Speculative verify (params, cache, tokens (B, C), start (B,)) ->
    # (logits (B, C, vocab_padded), cache): one forward over the pending
    # token + C-1 drafts per slot, logits at every row.
    verify_step: Callable = None
    # Same off the paged pool: (params, pool, tables, tokens, start) ->
    # (logits (B, C, vocab_padded), pool).
    paged_verify_step: Callable = None


def get_model(cfg: ArchConfig, device=None) -> ModelAPI:
    if cfg.family in _RECURRENT:
        return _recurrent_model(cfg, resolve_device(device),
                                _RECURRENT[cfg.family])
    if cfg.family == "audio":
        return _encdec_model(cfg, resolve_device(device))
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} (n_experts {cfg.n_experts}) is not "
            f"ported yet; repro_torch runs the dense, ssm, mamba, hybrid "
            f"and audio families (ROADMAP A11-A12)")
    dev = resolve_device(device)
    mod = transformer
    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=lambda generator, dtype=None: mod.init(cfg, generator, dev,
                                                    dtype),
        defs=lambda: mod.model_defs(cfg),
        loss=lambda params, batch: mod.lm_loss(cfg, params, batch),
        decode_step=lambda params, cache, tokens, positions:
            mod.decode_step(cfg, params, cache, tokens, positions),
        cache_spec=lambda batch, max_seq: mod.cache_spec(cfg, batch, max_seq),
        init_cache=lambda batch, max_seq:
            mod.init_cache(cfg, batch, max_seq, device=dev),
        cache_axes=lambda: mod.cache_axes(cfg),
        paged_decode_step=lambda params, pool, tables, tokens, positions,
        scales=None, kv_dtype="bf16": mod.paged_decode_step(
            cfg, params, pool, tables, tokens, positions, scales=scales,
            kv_dtype=kv_dtype),
        prefill_step=lambda params, cache, tokens, start, last:
            mod.prefill_step(cfg, params, cache, tokens, start, last),
        paged_prefill_step=lambda params, pool, tables, tokens, start, last,
        scales=None, kv_dtype="bf16": mod.paged_prefill_step(
            cfg, params, pool, tables, tokens, start, last, scales=scales,
            kv_dtype=kv_dtype),
        verify_step=lambda params, cache, tokens, start:
            mod.verify_step(cfg, params, cache, tokens, start),
        paged_verify_step=lambda params, pool, tables, tokens, start,
        scales=None, kv_dtype="bf16": mod.paged_verify_step(
            cfg, params, pool, tables, tokens, start, scales=scales,
            kv_dtype=kv_dtype),
    )


# The families whose decode cache carries state: family -> module.
_RECURRENT = {"ssm": rwkv_lm, "mamba": mamba2, "hybrid": hybrid}


def _recurrent_model(cfg: ArchConfig, dev: torch.device, mod) -> ModelAPI:
    """rwkv6, mamba2, zamba2: decode, its paged form and chunked prefill
    by running the decode body over the chunk.  The paged step of rwkv6
    and mamba2 runs the decode step on their state rows (``extras`` =
    (rows,)); the hybrid's own takes (tables, rows): its shared
    attention's K/V in blocks (kernel B1 / B1q on the card), its trunk's
    state in rows.  No paged prefill and no verify step, as in the
    reference: a carried state cannot roll rejected drafts back by
    truncating a length, so the engine's O7 decodes plainly
    (``spec_mode`` "off")."""
    batch_axes = scan_prefill.batch_axes_of(mod.cache_axes(cfg))
    if hasattr(mod, "paged_decode_step"):
        paged_step = (lambda params, pool, *rest, scales=None,
                      kv_dtype="bf16": mod.paged_decode_step(
                          cfg, params, pool, *rest, scales=scales,
                          kv_dtype=kv_dtype))
    else:
        # Recurrent state is never quantized: ``scales``/``kv_dtype``
        # only match the dense family's signature.
        paged_step = (lambda params, pool, rows, tokens, positions,
                      scales=None, kv_dtype="bf16":
                      scan_prefill.row_decode_step(
                          lambda cache, tok, pos: mod.decode_step(
                              cfg, params, cache, tok, pos),
                          pool, rows, tokens, positions,
                          batch_axes=batch_axes))
    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=lambda generator, dtype=None: mod.init(cfg, generator, dev,
                                                    dtype),
        defs=lambda: mod.model_defs(cfg),
        loss=lambda params, batch: mod.lm_loss(cfg, params, batch),
        decode_step=lambda params, cache, tokens, positions:
            mod.decode_step(cfg, params, cache, tokens, positions),
        cache_spec=lambda batch, max_seq: mod.cache_spec(cfg, batch, max_seq),
        init_cache=lambda batch, max_seq:
            mod.init_cache(cfg, batch, max_seq, device=dev),
        cache_axes=lambda: mod.cache_axes(cfg),
        carries_state=True,
        paged_decode_step=paged_step,
        prefill_step=lambda params, cache, tokens, start, last:
            mod.prefill_step(cfg, params, cache, tokens, start, last),
    )


def _encdec_model(cfg: ArchConfig, dev: torch.device) -> ModelAPI:
    """whisper: decode over the self K/V and the read-only cross K/V, its
    mixed-pool paged form (``extras`` = (tables, rows): kernel B1 / B1q
    on the self K/V, the cross K/V gathered from state rows) and chunked
    prefill by running the decode body over the chunk.  Not carried
    state (``carries_state`` False), no paged prefill and no verify
    step, as in the reference: O7 decodes plainly (``spec_mode``
    "off")."""
    mod = encdec
    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=lambda generator, dtype=None: mod.init(cfg, generator, dev,
                                                    dtype),
        defs=lambda: mod.model_defs(cfg),
        loss=lambda params, batch: mod.lm_loss(cfg, params, batch),
        decode_step=lambda params, cache, tokens, positions:
            mod.decode_step(cfg, params, cache, tokens, positions),
        cache_spec=lambda batch, max_seq: mod.cache_spec(cfg, batch, max_seq),
        init_cache=lambda batch, max_seq:
            mod.init_cache(cfg, batch, max_seq, device=dev),
        cache_axes=lambda: mod.cache_axes(cfg),
        paged_decode_step=lambda params, pool, tables, rows, tokens,
        positions, scales=None, kv_dtype="bf16": mod.paged_decode_step(
            cfg, params, pool, tables, rows, tokens, positions,
            scales=scales, kv_dtype=kv_dtype),
        prefill_step=lambda params, cache, tokens, start, last:
            mod.prefill_step(cfg, params, cache, tokens, start, last),
    )


# ---------------------------------------------------------------------------
# Drafter pairing (speculative decoding)
# ---------------------------------------------------------------------------

# Known (target -> drafter) pairings: the small zoo arch that proposes
# tokens for the big one.  A pairing is a candidate only: it still has to
# pass ``compatible_drafter``'s vocab check at the scale it runs (the
# smoke configs share a 256-token vocab; the full qwen3 and smollm
# tokenizers differ, which the check rejects).
DRAFTER_PAIRS = {
    "qwen3-8b": "smollm-360m",
    "mistral-large-123b": "smollm-360m",
    "nemotron-4-340b": "smollm-360m",
}


def compatible_drafter(target, draft=None) -> ArchConfig:
    """Resolve and validate the (drafter, target) pair for speculation.

    ``target`` is an ArchConfig (or registry name); ``draft`` a registry
    name / ArchConfig, defaulting to the ``DRAFTER_PAIRS`` entry.  A
    string drafter resolves at the SAME scale as the target (smoke vs
    full).  Verify compares the drafter's proposed token ids with the
    target's argmax, so the two must share one token space: mismatched
    vocabs raise ValueError naming both sizes."""
    if isinstance(target, str):
        target = get_config(target)
    if draft is None:
        try:
            draft = DRAFTER_PAIRS[target.name]
        except KeyError:
            raise ValueError(
                f"no known drafter pairing for target {target.name!r}; "
                f"pass draft_model explicitly (pairs: {sorted(DRAFTER_PAIRS)})"
            ) from None
    if isinstance(draft, str):
        try:
            full = get_config(target.name)
        except KeyError:
            full = target
        draft = get_smoke(draft) if target != full else get_config(draft)
    if draft.vocab != target.vocab:
        raise ValueError(
            f"drafter {draft.name!r} (vocab {draft.vocab}) is not "
            f"token-compatible with target {target.name!r} (vocab "
            f"{target.vocab}): speculative verify compares token ids "
            f"across the two models, so they must share one tokenizer/"
            f"vocab")
    return draft


# ---------------------------------------------------------------------------
# Input specs (smoke/test batches)
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Train/prefill batch specs for one cell: {name: (shape, dtype)};
    the audio family's adds its ``frames`` (B, S, d_model) in the compute
    dtype."""
    if cfg.family == "vlm":
        raise NotImplementedError(
            f"family {cfg.family!r} batches (patches) are not ported yet "
            f"(ROADMAP A11)")
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": ((B, S), torch.int32),
             "labels": ((B, S), torch.int32)}
    if cfg.family == "audio":
        specs = {"frames": ((B, S, cfg.d_model),
                            transformer.compute_dtype(cfg)), **specs}
    return specs


def make_batch(cfg: ArchConfig, shape: ShapeConfig, generator, *,
               device=None) -> dict:
    """A synthetic batch matching ``input_specs``: token ids drawn
    uniformly from the vocab, frames from a normal of std 0.02 (the
    reference's synthetic scale), all with ``generator`` (which must
    live on ``device``; ``None`` = CUDA)."""
    dev = resolve_device(device)
    out = {}
    for name, (shp, dt) in input_specs(cfg, shape).items():
        if dt.is_floating_point:
            out[name] = (torch.randn(shp, generator=generator, device=dev)
                         * 0.02).to(dt)
        else:
            out[name] = torch.randint(0, cfg.vocab, shp, generator=generator,
                                      device=dev, dtype=dt)
    return out
