"""Serving: prefill + decode steps and a simple batched engine.

``make_prefill``/``make_serve_step`` give the prefill and the one-token
decode step of a configuration; ``ServeEngine`` drives them: static
batch, greedy sampling, one shared length.  PyTorch runs eagerly, so
there is no counterpart of the reference's ``jax.jit`` here (nor CUDA
graphs yet).  Greedy ``argmax`` takes the first maximum, as
``jnp.argmax`` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import registry
from ..models.common import ModelConfig


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


def make_prefill(cfg: ModelConfig):
    mod = registry.model_module(cfg)

    def prefill(params, tokens, cache, **kw):
        return mod.prefill(cfg, params, tokens, cache, **kw)

    return prefill


def make_serve_step(cfg: ModelConfig):
    """One-token decode for the whole batch: (next tokens, cache)."""
    mod = registry.model_module(cfg)

    def serve_step(params, tokens, cache, index, **kw):
        logits, cache = mod.decode_step(cfg, params, tokens, cache, index,
                                        **kw)
        return _greedy(logits), cache

    return serve_step


@dataclasses.dataclass
class ServeEngine:
    """Greedy batched decoding over a fixed slot batch, on the device of
    the parameters."""

    cfg: ModelConfig
    params: torch.nn.Module
    max_len: int

    def __post_init__(self):
        self._mod = registry.model_module(self.cfg)
        self._prefill = make_prefill(self.cfg)
        self.device = next(self.params.parameters()).device

    def _run(self, prompts, num_tokens, enc_out, forced):
        b, plen = prompts.shape
        if plen + num_tokens - 1 > self.max_len:
            raise ValueError(f"{plen} + {num_tokens} tokens overrun the "
                             f"{self.max_len}-row cache")
        kw = {"enc_out": enc_out} if self.cfg.family == "encdec" else {}
        toks = torch.as_tensor(np.asarray(prompts, np.int32),
                               device=self.device)
        cache = registry.init_cache(self.cfg, b, self.max_len,
                                    device=self.device)
        logits, cache = self._prefill(self.params, toks, cache, **kw)
        out, steps = [_greedy(logits)], [logits]
        for i in range(num_tokens - 1):
            tok = out[-1] if forced is None else forced[:, i:i + 1]
            logits, cache = self._mod.decode_step(
                self.cfg, self.params, tok, cache, plen + i, **kw)
            out.append(_greedy(logits))
            steps.append(logits)
        return torch.cat(out, 1), steps

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, num_tokens: int, enc_out=None,
                 return_logits: bool = False):
        """prompts: (B, P) int32 → (B, num_tokens) generated ids.  With
        ``return_logits``, also the fp32 logits of every call: the
        prefill's (B, P, vocab), then each decode step's (B, 1, vocab)."""
        toks, steps = self._run(prompts, num_tokens, enc_out, None)
        toks = toks.cpu().numpy()
        return (toks, steps) if return_logits else toks

    @torch.inference_mode()
    def teacher_forced_logits(self, prompts: np.ndarray, tokens: np.ndarray,
                              enc_out=None) -> list[torch.Tensor]:
        """The logits :meth:`generate` returns, had it emitted ``tokens``
        (B, T): each decode step is fed ``tokens[:, i]`` instead of its own
        argmax, so two runs can be compared step by step after their greedy
        choices part."""
        forced = torch.as_tensor(np.asarray(tokens, np.int32),
                                 device=self.device)
        return self._run(prompts, forced.shape[1], enc_out, forced)[1]
