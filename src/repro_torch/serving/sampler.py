"""Token samplers for the decode engine (port of ``repro/serving/sampler.py``).

``make_sampler(cfg)`` returns ``sample(logits[B, V], seeds) -> tokens[B]``
running on the logits' device, so at O2+ only the (B,) sampled ids
leave the device.  Greedy takes the first maximal index
(``torch.argmax`` documents first-max semantics), bit-identical to the
reference's greedy.  Stochastic kinds (temperature / top-k) draw each
row from a ``torch.Generator`` seeded with the host-side per-(request,
emission) seed, so they are reproducible per request regardless of
batch composition — but they cannot reproduce JAX's random bits.
"""

from __future__ import annotations

import dataclasses

import torch

KINDS = ("greedy", "temperature", "top_k")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    kind: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0               # 0 => full vocab
    seed: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown sampler {self.kind!r}; "
                             f"choices: {KINDS}")

    @property
    def stochastic(self) -> bool:
        return self.kind != "greedy"

    def request_seed(self, rid: int, n_emitted: int) -> int:
        """Stable per-(request, emission) seed, independent of slot/batch."""
        h = (self.seed * 1_000_003 + rid * 7_919 + n_emitted) & 0x7FFFFFFF
        return h


def make_sampler(cfg: SamplerConfig):
    """Returns ``sample(logits[B, V], seeds) -> tokens[B]`` (int64 on the
    logits' device); ``seeds`` is a host sequence of ints (ignored by
    greedy)."""

    if cfg.kind == "greedy":
        def sample(logits, seeds):
            del seeds
            return torch.argmax(logits, dim=-1)
        return sample

    temp = max(cfg.temperature, 1e-6)
    top_k = cfg.top_k

    def sample(logits, seeds):
        scaled = logits.float() / temp
        if top_k and top_k > 0:
            kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
            scaled = torch.where(scaled < kth, float("-inf"), scaled)
        probs = torch.softmax(scaled, dim=-1)
        out = []
        for row, seed in zip(probs, seeds):
            g = torch.Generator(device=logits.device)
            g.manual_seed(int(seed))
            out.append(torch.multinomial(row, 1, generator=g))
        return torch.cat(out)

    return sample
