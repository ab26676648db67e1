"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152 (llama-arch small). [hf:HuggingFaceTB/SmolLM-360M; hf]

The speculative drafter paired with qwen3-8b (``model_zoo.DRAFTER_PAIRS``).
Its smoke config has head_dim 20 and no qk-norm, so it runs on the dense
path (its drafter cache is contiguous)."""
import dataclasses

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49_152,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        FULL, n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, head_dim=20,
        d_ff=128, vocab=256, q_chunk=32, loss_chunk=32, remat=False)
