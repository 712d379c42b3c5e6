"""LLM prompt expansion (port of ``apex_studio_tpu/prompt_extension.py``).

Expands terse user prompts into detailed descriptions with the Qwen-class
chat LM that ZImage ships for conditioning. Generation is KV-cached: one
prefill over the prompt fills fixed-size per-layer caches, then each new
token is one single-token decode step (models/text_encoders/qwen3.py
``prefill`` / ``decode_step``), whose attention runs the flash kernel on the
card. Sampling stays on the host in numpy (temperature, top-p, a
``default_rng(seed)`` stream), as in the JAX package, so a seed gives the
same tokens there and here. Models without ``decode_step`` fall back to the
padded-recompute loop.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.utils.progress import safe_emit_progress

logger = logging.getLogger("apex.prompt_extension")

SYSTEM_PROMPT = (
    "You rewrite short user prompts for a text-to-video generator. Expand the "
    "prompt into one vivid, concrete paragraph: name the subject and action, "
    "the setting, lighting, camera framing and movement, and overall style. "
    "Keep every detail the user asked for, add no text overlays, and answer "
    "with the rewritten prompt only."
)


class PromptExtender:
    def __init__(self, model, tokenizer, eos_token_id: Optional[int] = None):
        self.model = model
        self.tokenizer = tokenizer
        self.eos_token_id = eos_token_id

    def _chat(self, prompt: str) -> str:
        return (
            f"<|im_start|>system\n{SYSTEM_PROMPT}<|im_end|>\n"
            f"<|im_start|>user\n{prompt}<|im_end|>\n<|im_start|>assistant\n"
        )

    def _logits(self, hidden: torch.Tensor) -> np.ndarray:
        """Tied-embedding logits of ``hidden`` [D] as f32 numpy."""
        emb = self.model.embed_tokens
        return torch.matmul(hidden, emb.t().to(hidden.dtype)).float().cpu().numpy()

    @torch.inference_mode()
    def generate(
        self,
        prompt: str,
        max_new_tokens: int = 192,
        temperature: float = 0.7,
        top_p: float = 0.9,
        seed: int = 0,
        progress_callback: Optional[Callable] = None,
        use_cache: bool = True,
    ) -> str:
        text = self._chat(prompt)
        ids = list(self.tokenizer.encode(text, add_special_tokens=False).ids)
        buf_len = len(ids) + max_new_tokens
        device = self.model.embed_tokens.device
        buf = torch.zeros((1, buf_len), dtype=torch.long, device=device)
        buf[0, : len(ids)] = torch.tensor(ids, dtype=torch.long)
        mask = torch.zeros((1, buf_len), dtype=torch.int32, device=device)
        mask[0, : len(ids)] = 1

        rng = np.random.default_rng(seed)
        pos = len(ids)
        new_tokens: list[int] = []

        def sample(logits: np.ndarray) -> int:
            if temperature <= 0:
                return int(np.argmax(logits))
            logits = logits / temperature
            probs = np.exp(logits - logits.max())
            probs /= probs.sum()
            order = np.argsort(probs)[::-1]
            csum = np.cumsum(probs[order])
            cutoff = int(np.searchsorted(csum, top_p)) + 1
            keep = order[:cutoff]
            p = probs[keep] / probs[keep].sum()
            return int(rng.choice(keep, p=p))

        if use_cache and hasattr(self.model, "decode_step"):
            hidden, caches = self.model.prefill(buf[:, :pos], mask[:, :pos], cache_len=buf_len)
            logits = self._logits(hidden[0, pos - 1])
            for step in range(max_new_tokens):
                token = sample(logits)
                if self.eos_token_id is not None and token == self.eos_token_id:
                    break
                new_tokens.append(token)
                hidden, caches = self.model.decode_step(
                    torch.tensor([[token]], dtype=torch.long, device=device), pos, caches)
                logits = self._logits(hidden[0, 0])
                pos += 1
                safe_emit_progress(progress_callback, (step + 1) / max_new_tokens, "extending prompt")
        else:  # padded-recompute fallback for LMs without decode_step
            for step in range(max_new_tokens):
                hidden = self.model(buf, attention_mask=mask, normalize_last=True)
                token = sample(self._logits(hidden[0, pos - 1]))
                if self.eos_token_id is not None and token == self.eos_token_id:
                    break
                new_tokens.append(token)
                buf[0, pos] = token
                mask[0, pos] = 1
                pos += 1
                safe_emit_progress(progress_callback, (step + 1) / max_new_tokens, "extending prompt")

        out = self.tokenizer.decode(new_tokens)
        # Strip any trailing chat-control artifacts.
        for stop in ("<|im_end|>", "<|endoftext|>"):
            if stop in out:
                out = out.split(stop)[0]
        return out.strip() or prompt
