"""SigLIP vision tower (so400m/14-384: 1152 wide, 27 layers, 16 heads of 72),
port of ``apex_studio_tpu/models/text_encoders/siglip.py``.

HunyuanVideo 1.5 i2v conditions the DiT's image stream on SigLIP's
post-layernormed last hidden state (729 tokens × 1152). No class token,
learned position embeddings over the patches, a biased patch projection (the
strided conv as a Linear over [C, ph, pw] patches; the remainder rows and
columns a strided conv drops are cropped), gelu-tanh MLPs in CLIP layers.

The layers call CLIP's attention with no mask, which the JAX module runs as a
causal attention through XLA; the port does the same through its plain route.
Head dim 72 is not one the flash kernel takes, and its dispatch raises for it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from apex_studio_tpu_torch.models.layers import LayerNorm, Linear
from apex_studio_tpu_torch.models.registry import text_encoder_registry
from apex_studio_tpu_torch.models.text_encoders.clip import CLIPLayer, CLIPTextConfig

SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


@dataclasses.dataclass
class SiglipVisionConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu_pytorch_tanh"
    use_head: bool = False  # the MAP pooling head is not ported

    @classmethod
    def from_dict(cls, cfg: dict) -> "SiglipVisionConfig":
        if "vision_config" in cfg:
            cfg = cfg["vision_config"]
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in known})

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@text_encoder_registry.register(
    "SiglipVisionModel", aliases=("SiglipVisionModelWithProjection", "siglip", "Siglip2VisionModel"))
class SiglipVisionEncoder(nn.Module):
    config_class = SiglipVisionConfig

    def __init__(self, cfg: SiglipVisionConfig, *, dtype=torch.bfloat16):
        super().__init__()
        if cfg.use_head:
            raise NotImplementedError("the SigLIP MAP pooling head is not ported")
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.hidden_size
        self.patch_embedding = Linear(3 * cfg.patch_size**2, d, dtype=dtype)
        self.position_embedding = nn.Parameter(torch.empty(cfg.num_patches, d, dtype=dtype))
        text_like = CLIPTextConfig(
            hidden_size=d, intermediate_size=cfg.intermediate_size,
            num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
            layer_norm_eps=cfg.layer_norm_eps, hidden_act="gelu_tanh")
        self.layers = nn.ModuleList([CLIPLayer(text_like, dtype=dtype) for _ in range(cfg.num_hidden_layers)])
        self.post_layernorm = LayerNorm(d, eps=cfg.layer_norm_eps)

    def _patchify(self, pixel_values: torch.Tensor) -> torch.Tensor:
        p = self.cfg.patch_size
        b, c, h, w = pixel_values.shape
        h, w = (h // p) * p, (w // p) * p
        x = pixel_values[:, :, :h, :w].reshape(b, c, h // p, p, w // p, p)
        return x.permute(0, 2, 4, 1, 3, 5).reshape(b, (h // p) * (w // p), c * p * p)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [B,3,384,384] normalized to ±1 → [B, 729, 1152]."""
        x = self.patch_embedding(self._patchify(pixel_values.to(self.dtype)))
        x = x + self.position_embedding.to(self.dtype)
        for layer in self.layers:
            x = layer(x, None)
        return self.post_layernorm(x)


def preprocess_siglip_image(image: np.ndarray, size: int = 384) -> np.ndarray:
    """HWC uint8 RGB → [1,3,size,size] ±1-normalized float32
    (SiglipImageProcessor: bicubic resize through OpenCV, as the JAX package)."""
    import cv2

    resized = cv2.resize(image, (size, size), interpolation=cv2.INTER_CUBIC)
    arr = resized.astype(np.float32) / 255.0
    arr = (arr - np.asarray(SIGLIP_MEAN, np.float32)) / np.asarray(SIGLIP_STD, np.float32)
    return arr.transpose(2, 0, 1)[None].astype(np.float32)
