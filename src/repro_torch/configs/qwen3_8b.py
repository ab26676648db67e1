"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936, qk-norm. [hf:Qwen/Qwen3-8B; hf]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab=151_936, head_dim=128, qk_norm=True,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        FULL, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, q_chunk=32, loss_chunk=32, remat=False)
