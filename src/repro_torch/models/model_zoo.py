"""Unified model API: family dispatch (port of ``repro/models/model_zoo.py``).

``get_model(cfg, device=None)`` returns a ``ModelAPI`` whose functions
close over the arch config and the device (``None`` = CUDA).  Only the
dense family is served in this slice; the chunked-prefill and
speculative-verify hooks are ``None`` (ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    device: torch.device
    init: Callable            # (generator) -> params on ``device``
    defs: Callable            # () -> PDef tree
    decode_step: Callable     # (params, cache, tokens, positions) -> (logits, cache)
    cache_spec: Callable      # (batch, max_seq) -> {name: (shape, dtype)}
    init_cache: Callable      # (batch, max_seq) -> cache on ``device``
    cache_axes: Callable      # () -> logical-axes tree matching cache_spec
    # (params, pool, tables, tokens, positions) -> (logits, pool): the
    # serving O6 kernel path.
    paged_decode_step: Callable = None
    # Not in this slice (chunked prefill / O7 verify, ROADMAP A8).
    prefill_step: Callable = None
    paged_prefill_step: Callable = None
    verify_step: Callable = None
    paged_verify_step: Callable = None


def get_model(cfg: ArchConfig, device=None) -> ModelAPI:
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} (n_experts {cfg.n_experts}) is not "
            f"ported yet; repro_torch serves the dense family (ROADMAP "
            f"A11-A12)")
    dev = resolve_device(device)
    mod = transformer
    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=lambda generator: mod.init(cfg, generator, dev),
        defs=lambda: mod.model_defs(cfg),
        decode_step=lambda params, cache, tokens, positions:
            mod.decode_step(cfg, params, cache, tokens, positions),
        cache_spec=lambda batch, max_seq: mod.cache_spec(cfg, batch, max_seq),
        init_cache=lambda batch, max_seq:
            mod.init_cache(cfg, batch, max_seq, device=dev),
        cache_axes=lambda: mod.cache_axes(cfg),
        paged_decode_step=lambda params, pool, tables, tokens, positions,
        kv_dtype="bf16": mod.paged_decode_step(
            cfg, params, pool, tables, tokens, positions, kv_dtype=kv_dtype),
    )
