"""Config registry of the port: only the archs it runs — qwen3-8b,
smollm-360m (its speculative drafter, and the training CLI's default),
rwkv6-3b and mamba2-2.7b (trained), zamba2-2.7b and whisper-base
(served)."""

from repro_torch.configs import (mamba2_2p7b, qwen3_8b, rwkv6_3b,
                                 smollm_360m, whisper_base, zamba2_2p7b)
from repro_torch.configs.base import (ArchConfig, SHAPES,  # noqa: F401
                                      ShapeConfig)

_MODULES = {
    "qwen3-8b": qwen3_8b,
    "smollm-360m": smollm_360m,
    "rwkv6-3b": rwkv6_3b,
    "mamba2-2.7b": mamba2_2p7b,
    "zamba2-2.7b": zamba2_2p7b,
    "whisper-base": whisper_base,
}

ARCH_NAMES = tuple(_MODULES)


def _module(name: str):
    try:
        return _MODULES[name]
    except KeyError:
        raise KeyError(
            f"arch {name!r} is not ported yet (repro_torch runs "
            f"{ARCH_NAMES}; see ROADMAP queue A)") from None


def get_config(name: str) -> ArchConfig:
    return _module(name).FULL


def get_smoke(name: str) -> ArchConfig:
    return _module(name).smoke()
