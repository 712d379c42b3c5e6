"""Generic text encoder wrapper (port of ``apex_studio_tpu/text_encoder.py``).

Instantiates a registered encoder family from a manifest component spec, owns
the tokenizer (HuggingFace ``tokenizers`` files, or one injected through
``spec["tokenizer"]``), and runs the forward. ``encode`` results are cached
on disk per canonicalized inputs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

class TextEncoder:
    def __init__(self, engine, spec: Dict[str, Any]):
        self.engine = engine
        self.spec = spec
        self.base = spec.get("base") or ""
        self.model = None
        self._tokenizer = None

    # -- lazy pieces -----------------------------------------------------------

    def _ensure_model(self):
        if self.model is None:
            from apex_studio_tpu_torch.models.registry import text_encoder_registry

            self.model = self.engine._instantiate_family(text_encoder_registry, self.spec,
                                                         self._converter_family())
        return self.model

    def release(self) -> None:
        """Free the encoder weights. The spec and tokenizer survive, so the
        next uncached encode rebuilds lazily."""
        self.model = None

    def _converter_family(self) -> str:
        if "Qwen2" in self.base:  # Qwen2 and Qwen2.5-VL share one text path and key map
            return "qwen2"
        if "T5" in self.base:
            return "t5"
        if "CLIP" in self.base:
            return "clip"
        return self.base.lower()

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            self._tokenizer = self._load_tokenizer()
        return self._tokenizer

    def _load_tokenizer(self):
        if self.spec.get("tokenizer") is not None:  # injected (tests, smoke runs)
            return self.spec["tokenizer"]
        from tokenizers import Tokenizer

        name = self.spec.get("tokenizer_name") or ""
        sub = (self.spec.get("tokenizer_kwargs") or {}).get("subfolder", "")
        local = None
        if name:
            rel = Path(name) / sub if sub else Path(name)
            local = self.engine._resolve_path(str(rel / "tokenizer.json"))
        if not local:
            raise FileNotFoundError(
                f"tokenizer.json not found for {name!r} (subfolder {sub!r}) under "
                f"{self.engine.components_root}")
        return Tokenizer.from_file(str(local))

    # -- encode ------------------------------------------------------------------

    def apply_chat_template(self, prompt: str) -> str:
        """No ported family wraps prompts here: HunyuanVideo 1.5 builds its
        Qwen2.5-VL chat text itself (engine/hunyuanvideo15.py), and Qwen3's
        template comes with Qwen3."""
        return prompt

    def tokenize(self, prompts: Sequence[str], max_length: int,
                 pad_to_max: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        tok = self.tokenizer
        ids_batch: List[List[int]] = []
        for p in prompts:
            enc = tok.encode(p, add_special_tokens=False)
            ids_batch.append(list(enc.ids)[:max_length])
        width = max_length if pad_to_max else max(len(i) for i in ids_batch)
        ids_arr = np.zeros((len(prompts), width), np.int32)
        mask = np.zeros((len(prompts), width), np.int32)
        for i, ids in enumerate(ids_batch):
            ids_arr[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        return ids_arr, mask

    def encode(
        self,
        prompts: Sequence[str],
        max_sequence_length: int = 512,
        use_chat_template: bool = True,
        output: str = "pre_norm",
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (hidden_states [B, L, D], mask [B, L]) on the engine's device.
        Results are disk-cached per canonicalized inputs."""
        from apex_studio_tpu_torch.utils.disk_cache import EmbeddingCache

        device = self.engine.device
        cache = EmbeddingCache(self._converter_family() or "te")
        cache_key = {
            "prompts": list(prompts),
            "max_len": max_sequence_length,
            "chat": use_chat_template,
            "output": output,
            "base": self.base,
            "weights": str((self.spec.get("model_path") or ""))[:256],
            "config": self.spec.get("config") or self.spec.get("config_path") or "",
        }
        cached = cache.load(cache_key)
        if cached is not None:
            hidden_np, mask_np = cached
            return torch.from_numpy(hidden_np).to(device), torch.from_numpy(mask_np).to(device)

        model = self._ensure_model()
        texts = [self.apply_chat_template(p) if use_chat_template else p for p in prompts]
        ids, mask = self.tokenize(texts, max_sequence_length)
        ids_t = torch.from_numpy(ids).long().to(device)
        mask_t = torch.from_numpy(mask).to(device)
        with torch.inference_mode():
            hidden = model(ids_t, attention_mask=mask_t)
        cache.store(cache_key, hidden.float().cpu().numpy(), mask)
        return hidden, mask_t
