"""zamba2-2.7b [hybrid]: 54 Mamba2 layers d_model=2560 + shared attention
block (32H MHA, d_ff=10240) applied every 6 layers; ssm_state=64;
vocab=32000. [arXiv:2411.15242; hf]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32_000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, conv_width=4,
    attn_every=6,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        FULL, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, ssm_state=16, ssm_head_dim=32, attn_every=2,
        q_chunk=32, loss_chunk=32, remat=False)
