"""Architecture and shape configs (port copy of the fields it reads).

The fields of ``repro/configs/base.py::ArchConfig`` that the serving
and training paths of the dense, rwkv6, mamba2 and hybrid (zamba2)
families read, with the same names and defaults, and
``ShapeConfig``/``SHAPES``.
The reference's sharding and scan knobs (``constrain`` axes,
``unroll_layers``) have no counterpart: the port runs on one device and
loops over layers in Python.  Families and features outside the port
(MoE, enc-dec, relu2 MLPs) are rejected by the model code, not
silently ignored.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | ssm (rwkv6) | mamba (mamba2) |
                                 # hybrid (zamba2); each serves, and
                                 # each but hybrid trains on the card
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 => d_model // n_heads
    n_experts: int = 0           # MoE is not in this slice
    qk_norm: bool = False
    mlp_kind: str = "swiglu"
    rope_theta: float = 10_000.0
    # Mamba-2 (family "mamba")
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # Hybrid (family "hybrid"): the shared attention block runs after
    # every ``attn_every`` mamba layers.
    attn_every: int = 0
    # RWKV (family "ssm")
    rwkv_head_dim: int = 64
    # Numerics / memory.  Serving stores params in ``compute_dtype`` (the
    # reference keeps f32 and casts per use: the same bits, half the
    # memory); training keeps ``param_dtype`` masters and casts them once
    # per loss evaluation.
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = ""       # "" => legacy `remat` flag; full|dots|none
    cast_params_once: bool = False  # the port's loss always casts once
    scores_dtype: str = "float32"   # attention logits dtype
    loss_chunk: int = 2048       # chunked cross-entropy (memory cap)
    q_chunk: int = 1024          # query rows per attention backward chunk
    microbatch: int = 0          # >1: grad-accumulation microbatches

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)


# ---------------------------------------------------------------------------
# Input shapes (LM shapes: seq_len x global_batch), as in the reference.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
