"""HunyuanImage 2.1 DiT, port of
``apex_studio_tpu/models/transformers/hunyuanimage.py``.

HunyuanVideo's dual- and single-stream blocks (the port's) on 2D latents:
20 dual + 40 single blocks at dim 3584 (28 heads of 128), Qwen2.5-VL tokens
refined by HunyuanVideo 1.5's token refiner, an optional byT5 glyph branch
(``context_embedder_2``: LayerNorm and three Linears with exact GELU),
2-axis RoPE (64, 64) θ 256 on the image tokens, an optional distilled
guidance embedding and the meanflow ``timestep_r`` (the time and time-r
embeddings averaged). The text is packed ``[byT5, mllm]`` with one combined
key-padding mask, built once a forward as a ``[B, 1, 1, S]`` bias over
``[img | txt]`` and sent with every joint launch (the flash kernel on the
card), as the JAX module carries it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import LayerNorm, Linear
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.models.transformers.hunyuanvideo import HunyuanVideoDualBlock, HunyuanVideoSingleBlock
from apex_studio_tpu_torch.models.transformers.hunyuanvideo15 import TokenRefiner
from apex_studio_tpu_torch.ops.attention import _prep_bias
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import precompute_axial_freqs


@dataclasses.dataclass
class HunyuanImageConfig:
    in_channels: int = 64
    out_channels: int = 64
    num_attention_heads: int = 28
    attention_head_dim: int = 128
    num_layers: int = 20
    num_single_layers: int = 40
    num_refiner_layers: int = 2
    mlp_ratio: float = 4.0
    patch_size: Tuple[int, int] = (1, 1)
    guidance_embeds: bool = False
    text_embed_dim: int = 3584
    text_embed_2_dim: Optional[int] = None
    rope_theta: float = 256.0
    rope_axes_dim: Tuple[int, ...] = (64, 64)
    use_meanflow: bool = False

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def from_dict(cls, cfg: dict) -> "HunyuanImageConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        for key in ("patch_size", "rope_axes_dim"):
            if key in kw and isinstance(kw[key], (list, tuple)):
                kw[key] = tuple(kw[key])
        if isinstance(kw.get("patch_size"), int):
            kw["patch_size"] = (kw["patch_size"], kw["patch_size"])
        return cls(**kw)


@transformer_registry.register("hunyuanimage.base", aliases=("hunyuanimage", "HunyuanImageTransformer2DModel"))
class HunyuanImageTransformer2DModel(nn.Module):
    config_class = HunyuanImageConfig

    def __init__(self, cfg: HunyuanImageConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        ph, pw = cfg.patch_size
        self.x_embedder = Linear(cfg.in_channels * ph * pw, d, dtype=dtype)
        # the refiner reads dim / mlp ratio / heads / text width / refiner layers
        self.context_embedder = TokenRefiner(cfg, dtype=dtype)
        if cfg.text_embed_2_dim is not None:
            self.byt5_norm = LayerNorm(cfg.text_embed_2_dim, eps=1e-5)
            self.byt5_linear_1 = Linear(cfg.text_embed_2_dim, 2048, dtype=dtype)
            self.byt5_linear_2 = Linear(2048, 2048, dtype=dtype)
            self.byt5_linear_3 = Linear(2048, d, dtype=dtype)
        else:
            self.byt5_norm = None
        self.time_linear_1 = Linear(256, d, dtype=dtype)
        self.time_linear_2 = Linear(d, d, dtype=dtype)
        if cfg.use_meanflow:
            self.time_r_linear_1 = Linear(256, d, dtype=dtype)
            self.time_r_linear_2 = Linear(d, d, dtype=dtype)
        else:
            self.time_r_linear_1 = self.time_r_linear_2 = None
        if cfg.guidance_embeds:
            self.guidance_linear_1 = Linear(256, d, dtype=dtype)
            self.guidance_linear_2 = Linear(d, d, dtype=dtype)
        else:
            self.guidance_linear_1 = self.guidance_linear_2 = None
        self.transformer_blocks = nn.ModuleList(
            [HunyuanVideoDualBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.single_transformer_blocks = nn.ModuleList(
            [HunyuanVideoSingleBlock(cfg, dtype=dtype) for _ in range(cfg.num_single_layers)])
        self.norm_out_linear = Linear(d, 2 * d, dtype=dtype)
        self.proj_out = Linear(d, ph * pw * cfg.out_channels, dtype=dtype)
        self._rope = {}  # (h, w, device) → the last tables built

    def rope_tables(self, h_tok: int, w_tok: int, device=None):
        """cos/sin [1, h·w, 1, D/2] in f32 from numpy ids (float64 path); the
        tables of the last grid are kept."""
        key = (h_tok, w_tok, str(device))
        if key not in self._rope:
            ids = np.stack(np.meshgrid(np.arange(h_tok), np.arange(w_tok), indexing="ij"), axis=-1).reshape(1, -1, 2)
            cos, sin = precompute_axial_freqs(ids, self.cfg.rope_axes_dim, self.cfg.rope_theta)
            self._rope = {key: tuple(torch.from_numpy(a)[:, :, None, :].to(device) for a in (cos, sin))}
        return self._rope[key]

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        ph, pw = self.cfg.patch_size
        x = x.reshape(b, c, h // ph, ph, w // pw, pw).permute(0, 2, 4, 1, 3, 5)
        return x.reshape(b, (h // ph) * (w // pw), c * ph * pw)

    def unpatchify(self, tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
        ph, pw = self.cfg.patch_size
        b, c = tokens.shape[0], self.cfg.out_channels
        x = tokens.reshape(b, h // ph, w // pw, c, ph, pw).permute(0, 3, 1, 4, 2, 5)
        return x.reshape(b, c, h, w)

    def _mlp2(self, l1, l2, vec):
        return l2(F.silu(l1(vec.to(self.dtype))))

    def forward(
        self,
        x: torch.Tensor,                 # [B, C, H, W] latents
        t: torch.Tensor,                 # [B] timestep (0..1000)
        text: torch.Tensor,              # [B, Lt, text_embed_dim] mllm features
        text_mask: Optional[torch.Tensor] = None,    # [B, Lt] 1 = real
        text_2: Optional[torch.Tensor] = None,       # [B, L2, byt5_dim] glyphs
        text_2_mask: Optional[torch.Tensor] = None,  # [B, L2]
        guidance: Optional[torch.Tensor] = None,     # [B] distilled guidance × 1000
        t_r: Optional[torch.Tensor] = None,          # [B] meanflow end timestep
    ) -> torch.Tensor:
        cfg = self.cfg
        b, _, hh, ww = x.shape

        temb = self._mlp2(self.time_linear_1, self.time_linear_2, timestep_embedding(t.float(), 256))
        if self.time_r_linear_1 is not None and t_r is not None:
            temb = (temb + self._mlp2(self.time_r_linear_1, self.time_r_linear_2,
                                      timestep_embedding(t_r.float(), 256))) / 2.0
        if self.guidance_linear_1 is not None and guidance is not None:
            temb = temb + self._mlp2(self.guidance_linear_1, self.guidance_linear_2,
                                     timestep_embedding(guidance.float(), 256))

        img = self.x_embedder(self.patchify(x).to(self.dtype))
        txt = self.context_embedder(text.to(self.dtype), t, text_mask)
        if self.byt5_norm is not None and text_2 is not None:
            y = self.byt5_norm(text_2.to(self.dtype))
            y = self.byt5_linear_2(F.gelu(self.byt5_linear_1(y)))
            y = self.byt5_linear_3(F.gelu(y))
            txt = torch.cat([y, txt], dim=1)
            if text_mask is not None:
                t2m = text_2_mask if text_2_mask is not None else torch.ones(y.shape[:2], device=y.device)
                text_mask = torch.cat([t2m.to(text_mask.dtype), text_mask], dim=1)

        rope_cos, rope_sin = self.rope_tables(hh // cfg.patch_size[0], ww // cfg.patch_size[1], device=img.device)
        n_img = img.shape[1]
        bias = None
        if text_mask is not None:
            bias = _prep_bias(None, torch.cat([torch.ones(b, n_img, dtype=torch.bool, device=img.device),
                                               text_mask.bool()], dim=1))
        for blk in self.transformer_blocks:
            img, txt = blk(img, txt, temb, None, 0, rope_cos, rope_sin, bias)
        xseq = torch.cat([img, txt], dim=1)
        del img, txt
        for blk in self.single_transformer_blocks:
            xseq = blk(xseq, n_img, temb, None, 0, rope_cos, rope_sin, bias)
        img = xseq[:, :n_img]

        scale, shift = self.norm_out_linear(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        img = layer_norm(img, eps=1e-6) * (1 + scale) + shift
        return self.unpatchify(self.proj_out(img), hh, ww)
