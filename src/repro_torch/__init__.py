"""PyTorch + CUDA port of ``repro`` (the JAX/Pallas reference package).

Same subpackage and module names as ``src/repro/``, so every port file
maps one-to-one to its reference file.  This package imports ``torch``
and numpy only — never ``jax`` and nothing of ``repro``: what it needs
from a framework-free reference module (configs, the optimization
ladder, the scheduler) it keeps as its own copy.

Slice 1 (the main path): the dense ``qwen3-8b`` family served by
``serving.engine.DecodeEngine`` at rungs O2, O4, O5 (contiguous cache)
and O6 (paged KV pool, ``paged_attn="gather"|"kernel"``), with the
paged-decode attention kernel written in CUDA for sm_90a
(``kernels/paged_attention/csrc/paged_attention.cu``).  Everything else
raises ``NotImplementedError`` naming its ROADMAP item.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``repro_torch.device``).
"""
