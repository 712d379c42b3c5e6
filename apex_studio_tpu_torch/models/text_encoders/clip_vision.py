"""CLIP vision tower (ViT-H/14 class), port of
``apex_studio_tpu/models/text_encoders/clip_vision.py``.

Wan 2.1 i2v conditions its image cross-attention on the penultimate hidden
states of this encoder: 257 tokens × 1280 at 224 px. The layers are the
port's CLIP text layers (``clip.py``). Each layer gets no mask, which the
shared ``CLIPAttention`` turns into a **causal** mask on the plain route
(``backend="xla"``): that is what the JAX encoder computes (its
``CLIPLayer(x, None)``), a fault of the reference that the port mirrors
(ROADMAP Queue 3). The plain route is JAX's own routing for this attention,
not a fallback; its head dim, 80, is not one the flash kernel takes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from apex_studio_tpu_torch.models.layers import LayerNorm, Linear
from apex_studio_tpu_torch.models.registry import text_encoder_registry
from apex_studio_tpu_torch.models.text_encoders.clip import CLIPLayer, CLIPTextConfig

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass
class CLIPVisionConfig:
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"  # ViT-H uses the exact GELU

    @classmethod
    def from_dict(cls, cfg: dict) -> "CLIPVisionConfig":
        if "vision_config" in cfg:
            cfg = cfg["vision_config"]
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in known})

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@text_encoder_registry.register("CLIPVisionModel", aliases=("CLIPVisionModelWithProjection", "clip_vision"))
class CLIPVisionEncoder(nn.Module):
    config_class = CLIPVisionConfig

    def __init__(self, cfg: CLIPVisionConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.hidden_size
        # the stride = patch conv as a Linear over flattened [C, ph, pw] patches
        self.patch_embedding = Linear(3 * cfg.patch_size ** 2, d, use_bias=False, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(d, dtype=dtype))
        self.position_embedding = nn.Parameter(torch.empty(cfg.num_patches + 1, d, dtype=dtype))
        self.pre_layrnorm = LayerNorm(d, eps=cfg.layer_norm_eps)
        layer_cfg = CLIPTextConfig(hidden_size=d, intermediate_size=cfg.intermediate_size,
                                   num_hidden_layers=cfg.num_hidden_layers,
                                   num_attention_heads=cfg.num_attention_heads,
                                   layer_norm_eps=cfg.layer_norm_eps, hidden_act=cfg.hidden_act)
        self.layers = nn.ModuleList([CLIPLayer(layer_cfg, dtype=dtype) for _ in range(cfg.num_hidden_layers)])
        self.post_layernorm = LayerNorm(d, eps=cfg.layer_norm_eps)

    def _patchify(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] → [B, n_patches, 3·p²] in the conv weight's (C, ph, pw) order."""
        p = self.cfg.patch_size
        b, c, h, w = pixel_values.shape
        x = pixel_values.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
        return x.reshape(b, (h // p) * (w // p), c * p * p)

    def forward(self, pixel_values: torch.Tensor, penultimate: bool = True) -> torch.Tensor:
        """CLIP-normalised ``[B, 3, 224, 224]`` → hidden states ``[B, 257, D]``:
        the penultimate layer's output by default (Wan's conditioning)."""
        b = pixel_values.shape[0]
        patches = self.patch_embedding(self._patchify(pixel_values.to(self.dtype)))
        cls = self.class_embedding.to(self.dtype).expand(b, 1, self.cfg.hidden_size)
        x = torch.cat([cls, patches], dim=1) + self.position_embedding.to(self.dtype)
        x = self.pre_layrnorm(x)
        for layer in self.layers[:len(self.layers) - (1 if penultimate else 0)]:
            x = layer(x, None)  # None: causal, as the JAX encoder attends (module docstring)
        if not penultimate:
            x = self.post_layernorm(x)
        return x


def preprocess_clip_image(image: np.ndarray, size: int = 224) -> np.ndarray:
    """HWC uint8 RGB → ``[1, 3, size, size]`` CLIP-normalised float32 (OpenCV
    bicubic resize, as in JAX)."""
    import cv2

    resized = cv2.resize(image, (size, size), interpolation=cv2.INTER_CUBIC)
    arr = resized.astype(np.float32) / 255.0
    arr = (arr - np.asarray(CLIP_MEAN)) / np.asarray(CLIP_STD)
    return arr.transpose(2, 0, 1)[None].astype(np.float32)
