"""PyTorch + CUDA port of ``repro`` (the JAX/Pallas reference package).

Same subpackage and module names as ``src/repro/``, so every port file
maps one-to-one to its reference file.  This package imports ``torch``
and numpy only — never ``jax`` and nothing of ``repro``: what it needs
from a framework-free reference module (configs, the optimization
ladder, the scheduler) it keeps as its own copy.

What it serves: the dense ``qwen3-8b`` family through
``serving.engine.DecodeEngine`` at rungs O0..O5 (contiguous cache), O6
(paged KV pool, ``paged_attn="gather"|"kernel"``) and O7 (speculative
decoding with a drafter), with prompts fed a token per tick or in chunks
(``prefill_chunk``); the attention-free ``rwkv6-3b`` and
``mamba2-2.7b`` at the same rungs, their carried state in a pool of
state rows at O6; and the hybrid ``zamba2-2.7b`` (a mamba2 trunk with one
shared attention block), its trunk's state in state rows and its shared
attention's K/V in blocks at O6 (O7 decodes the three plainly: they have
no verify step, as in the reference).  The paged attention kernels —
one query per slot (decode) and a window of queries per slot (chunked
prefill, verify) — are written in CUDA for sm_90a
(``kernels/paged_attention/csrc/paged_attention.cu``).  It trains the same
family on one card (``launch.train``: f32 masters, bf16 compute, remat,
AdamW, the synthetic stream, async checkpoints, the resilient loop),
with the forward's causal attention in a CUDA flash-attention kernel
(``kernels/flash_attention/csrc/flash_attention.cu``); rwkv6 and mamba2
train too, with their scans in CUDA (``kernels/rwkv6_wkv``,
``kernels/mamba2_ssd``).  The paper layer runs the paper's O0..O5 ladder:
the blocked matmul of its Fig. 4 as CUDA kernels B6/B7
(``kernels/tiled_matmul``), all eight MachSuite kernels at every
level (``machsuite``), and the analytic cost model with its closed-loop
autotuner (``core.costmodel``, ``core.guideline``, ``autotune``;
``python -m repro_torch.autotune --kernel gemm``).  Everything else
raises ``NotImplementedError`` naming its ROADMAP item.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``repro_torch.device``).
"""
