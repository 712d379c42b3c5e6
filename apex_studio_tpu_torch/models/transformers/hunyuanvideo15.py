"""HunyuanVideo 1.5 DiT (54 dual-stream blocks, 2048 wide), port of
``apex_studio_tpu/models/transformers/hunyuanvideo15.py``.

Same graph, attribute names and dtype flow as the JAX module:

- ``x_embedder``: the (1,1,1) patch Conv3d as a Linear over 65-channel
  latents (32 noise + 32 cond + 1 mask);
- ``context_embedder``: a 2-block token refiner over the Qwen2.5-VL features,
  gated by the timestep and the masked-mean pooled text; its attention takes
  the text mask as a ``[B, Lt]`` key-padding bias (the flash kernel on the
  card);
- the byT5 glyph branch and the SigLIP image branch, each offset by a learned
  cond-type embedding, packed [image, byT5, mllm] with padding zeroed but
  attended;
- dual-stream blocks: adaLN per stream, joint attention over [img, ctx]
  (unmasked, the flash kernel on the card) with per-head RMS qk-norm and
  3-axis interleaved RoPE (θ = 256, axes 16/56/56) on the image tokens only;
- AdaLayerNormContinuous and a Linear to 32 channels, unpatchified
  channel-slowest.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import GELUMLP, LayerNorm, Linear, RMSNorm
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import apply_rope, precompute_axial_freqs


@dataclasses.dataclass
class HYV15Config:
    in_channels: int = 65
    out_channels: int = 32
    num_attention_heads: int = 16
    attention_head_dim: int = 128
    num_layers: int = 54
    num_refiner_layers: int = 2
    mlp_ratio: float = 4.0
    patch_size: int = 1
    patch_size_t: int = 1
    text_embed_dim: int = 3584
    text_embed_2_dim: int = 1472
    image_embed_dim: int = 1152
    rope_theta: float = 256.0
    rope_axes_dim: Tuple[int, ...] = (16, 56, 56)
    guidance_embeds: bool = False

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def from_dict(cls, cfg: dict) -> "HYV15Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "rope_axes_dim" in kw:
            kw["rope_axes_dim"] = tuple(kw["rope_axes_dim"])
        return cls(**kw)


class RefinerBlock(nn.Module):
    """Token-refiner block: masked self-attention and a SiLU FFN, each gated
    by the adaLN output of the refiner's timestep embedding."""

    def __init__(self, cfg: HYV15Config, *, dtype):
        super().__init__()
        d = cfg.dim
        self.norm1 = LayerNorm(d, eps=1e-6)
        self.to_q = Linear(d, d, dtype=dtype)
        self.to_k = Linear(d, d, dtype=dtype)
        self.to_v = Linear(d, d, dtype=dtype)
        self.to_out = Linear(d, d, dtype=dtype)
        self.norm2 = LayerNorm(d, eps=1e-6)
        self.ff_in = Linear(d, int(d * cfg.mlp_ratio), dtype=dtype)
        self.ff_out = Linear(int(d * cfg.mlp_ratio), d, dtype=dtype)
        self.ada_linear = Linear(d, 2 * d, dtype=dtype)
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.attention_head_dim

    def forward(self, x, temb, mask):
        b, s, _ = x.shape
        y = self.norm1(x)
        shape = (b, s, self.heads, self.head_dim)
        q, k, v = self.to_q(y).reshape(shape), self.to_k(y).reshape(shape), self.to_v(y).reshape(shape)
        attn = self.to_out(attention_op(q, k, v, mask=mask).reshape(b, s, -1))
        gate_msa, gate_mlp = self.ada_linear(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        x = x + attn * gate_msa
        return x + self.ff_out(F.silu(self.ff_in(self.norm2(x)))) * gate_mlp


class TokenRefiner(nn.Module):
    def __init__(self, cfg: HYV15Config, *, dtype):
        super().__init__()
        d = cfg.dim
        self.timestep_linear_1 = Linear(256, d, dtype=dtype)
        self.timestep_linear_2 = Linear(d, d, dtype=dtype)
        self.text_linear_1 = Linear(cfg.text_embed_dim, d, dtype=dtype)
        self.text_linear_2 = Linear(d, d, dtype=dtype)
        self.proj_in = Linear(cfg.text_embed_dim, d, dtype=dtype)
        self.refiner_blocks = nn.ModuleList(
            [RefinerBlock(cfg, dtype=dtype) for _ in range(cfg.num_refiner_layers)])

    def forward(self, text, timestep, mask):
        if mask is None:
            pooled = text.mean(dim=1)
        else:
            m = mask.float()[..., None]
            pooled = ((text.float() * m).sum(1) / m.sum(1).clamp_min(1e-6)).to(text.dtype)
        t_freq = timestep_embedding(timestep.float(), 256, flip_sin_to_cos=True)
        temb = self.timestep_linear_2(F.silu(self.timestep_linear_1(t_freq.to(text.dtype))))
        temb = temb + self.text_linear_2(F.silu(self.text_linear_1(pooled)))
        x = self.proj_in(text)
        attn_mask = None if mask is None else mask.bool()
        for blk in self.refiner_blocks:
            x = blk(x, temb, attn_mask)
        return x


class HYV15Block(nn.Module):
    def __init__(self, cfg: HYV15Config, *, dtype):
        super().__init__()
        d = cfg.dim
        self.norm1_linear = Linear(d, 6 * d, dtype=dtype)
        self.norm1_context_linear = Linear(d, 6 * d, dtype=dtype)
        for name in ("to_q", "to_k", "to_v", "to_out", "add_q_proj", "add_k_proj", "add_v_proj",
                     "to_add_out"):
            setattr(self, name, Linear(d, d, dtype=dtype))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(self, name, RMSNorm(cfg.attention_head_dim, eps=1e-6))
        self.ff = GELUMLP(d, int(d * cfg.mlp_ratio), approximate=True, dtype=dtype)
        self.ff_context = GELUMLP(d, int(d * cfg.mlp_ratio), approximate=True, dtype=dtype)
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.attention_head_dim

    @staticmethod
    def _ada6(linear, temb):
        return linear(F.silu(temb))[:, None, :].chunk(6, dim=-1)

    def forward(self, img, txt, temb, rope_cos, rope_sin):
        b, n_img, _ = img.shape
        n_txt = txt.shape[1]
        sh, sc, g, sh2, sc2, g2 = self._ada6(self.norm1_linear, temb)
        csh, csc, cg, csh2, csc2, cg2 = self._ada6(self.norm1_context_linear, temb)

        img_n = layer_norm(img, eps=1e-6) * (1 + sc) + sh
        txt_n = layer_norm(txt, eps=1e-6) * (1 + csc) + csh

        def heads(x, proj):
            return proj(x).reshape(b, x.shape[1], self.heads, self.head_dim)

        q_i = apply_rope(self.norm_q(heads(img_n, self.to_q)), rope_cos, rope_sin)
        k_i = apply_rope(self.norm_k(heads(img_n, self.to_k)), rope_cos, rope_sin)
        v_i = heads(img_n, self.to_v)
        q_t = self.norm_added_q(heads(txt_n, self.add_q_proj))
        k_t = self.norm_added_k(heads(txt_n, self.add_k_proj))
        v_t = heads(txt_n, self.add_v_proj)

        q = torch.cat([q_i, q_t], dim=1)
        k = torch.cat([k_i, k_t], dim=1)
        v = torch.cat([v_i, v_t], dim=1)
        out = attention_op(q, k, v).reshape(b, n_img + n_txt, -1)
        img = img + self.to_out(out[:, :n_img]) * g
        txt = txt + self.to_add_out(out[:, n_img:]) * cg

        img = img + self.ff(layer_norm(img, eps=1e-6) * (1 + sc2) + sh2) * g2
        txt = txt + self.ff_context(layer_norm(txt, eps=1e-6) * (1 + csc2) + csh2) * cg2
        return img, txt


@transformer_registry.register("hunyuanvideo15.base", aliases=("hunyuanvideo15",))
class HunyuanVideo15Transformer3DModel(nn.Module):
    config_class = HYV15Config

    def __init__(self, cfg: HYV15Config, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        patch_dim = cfg.in_channels * cfg.patch_size_t * cfg.patch_size**2
        self.x_embedder = Linear(patch_dim, d, dtype=dtype)
        self.context_embedder = TokenRefiner(cfg, dtype=dtype)
        self.byt5_norm = LayerNorm(cfg.text_embed_2_dim, eps=1e-5)
        self.byt5_linear_1 = Linear(cfg.text_embed_2_dim, 2048, dtype=dtype)
        self.byt5_linear_2 = Linear(2048, 2048, dtype=dtype)
        self.byt5_linear_3 = Linear(2048, d, dtype=dtype)
        self.img_norm_in = LayerNorm(cfg.image_embed_dim, eps=1e-5)
        self.img_linear_1 = Linear(cfg.image_embed_dim, cfg.image_embed_dim, dtype=dtype)
        self.img_linear_2 = Linear(cfg.image_embed_dim, d, dtype=dtype)
        self.img_norm_out = LayerNorm(d, eps=1e-5)
        self.time_linear_1 = Linear(256, d, dtype=dtype)
        self.time_linear_2 = Linear(d, d, dtype=dtype)
        self.cond_type_embed = nn.Parameter(torch.empty(3, d, dtype=dtype))
        self.transformer_blocks = nn.ModuleList([HYV15Block(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.norm_out_linear = Linear(d, 2 * d, dtype=dtype)
        self.proj_out = Linear(d, cfg.patch_size_t * cfg.patch_size**2 * cfg.out_channels, dtype=dtype)
        self._rope = {}  # (t, h, w, device) → the last tables built

    def rope_tables(self, t_tok: int, h_tok: int, w_tok: int, device=None):
        """cos/sin [1, t·h·w, 1, D/2] in f32, from numpy ids on the float64
        path as the JAX module builds them; the tables of the last grid are
        kept."""
        key = (t_tok, h_tok, w_tok, str(device))
        if key not in self._rope:
            ids = np.stack(np.meshgrid(np.arange(t_tok), np.arange(h_tok), np.arange(w_tok),
                                       indexing="ij"), axis=-1).reshape(1, -1, 3)
            cos, sin = precompute_axial_freqs(ids, self.cfg.rope_axes_dim, self.cfg.rope_theta)
            self._rope = {key: tuple(torch.from_numpy(a)[:, :, None, :].to(device) for a in (cos, sin))}
        return self._rope[key]

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """[B,C,T,H,W] → [B, N, C·pt·p·p], conv-ordered features [C, pt, ph, pw]."""
        pt, p = self.cfg.patch_size_t, self.cfg.patch_size
        b, c, t, h, w = x.shape
        if pt == 1 and p == 1:
            return x.reshape(b, c, t * h * w).transpose(1, 2)
        x = x.reshape(b, c, t // pt, pt, h // p, p, w // p, p)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
        return x.reshape(b, (t // pt) * (h // p) * (w // p), c * pt * p * p)

    def unpatchify(self, tokens: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
        """proj_out features are channel-SLOWEST [C, pt, ph, pw] (the opposite
        of Wan's channel-fastest order)."""
        pt, p = self.cfg.patch_size_t, self.cfg.patch_size
        b = tokens.shape[0]
        c = self.cfg.out_channels
        if pt == 1 and p == 1:
            return tokens.transpose(1, 2).reshape(b, c, t, h, w)
        x = tokens.reshape(b, t // pt, h // p, w // p, c, pt, p, p)
        x = x.permute(0, 4, 1, 5, 2, 6, 3, 7)
        return x.reshape(b, c, t, h, w)

    def forward(
        self,
        x: torch.Tensor,                    # [B, 65, T, H, W] packed latents
        t: torch.Tensor,                    # [B] timestep (0..1000)
        text: torch.Tensor,                 # [B, Lt, 3584] Qwen2.5-VL features
        text_mask: Optional[torch.Tensor] = None,    # [B, Lt]
        text_2: Optional[torch.Tensor] = None,       # [B, Lb, 1472] byT5 glyph
        text_2_mask: Optional[torch.Tensor] = None,
        image_embeds: Optional[torch.Tensor] = None,  # [B, Li, 1152] SigLIP
        image_stream_zeroed: bool = False,  # t2v: the zeroed vision stream
    ) -> torch.Tensor:
        cfg = self.cfg
        b, c, tt, hh, ww = x.shape

        t_freq = timestep_embedding(t.float(), 256, flip_sin_to_cos=True)
        temb = self.time_linear_2(F.silu(self.time_linear_1(t_freq.to(self.dtype))))

        img = self.x_embedder(self.patchify(x).to(self.dtype))
        rope_cos, rope_sin = self.rope_tables(tt // cfg.patch_size_t, hh // cfg.patch_size,
                                              ww // cfg.patch_size, device=img.device)

        ctype = self.cond_type_embed.to(self.dtype)
        txt = self.context_embedder(text.to(self.dtype), t, text_mask) + ctype[0]
        streams = [txt]
        if text_2 is not None:
            y = self.byt5_norm(text_2.to(self.dtype))
            y = self.byt5_linear_2(F.gelu(self.byt5_linear_1(y)))
            y = self.byt5_linear_3(F.gelu(y)) + ctype[1]
            if text_2_mask is not None:
                y = y * text_2_mask.to(y.dtype)[..., None]
            streams.insert(0, y)  # byT5 ahead of the mllm stream
        if image_embeds is not None:
            if image_stream_zeroed:
                # t2v keeps the vision slots as the bare cond-type-2 embedding
                z = ctype[2].expand(b, image_embeds.shape[1], cfg.dim)
            else:
                z = self.img_linear_1(self.img_norm_in(image_embeds.to(self.dtype)))
                z = self.img_norm_out(self.img_linear_2(F.gelu(z))) + ctype[2]
            streams.insert(0, z)  # image first

        # Static packing [image, byT5, mllm]: padding stays zeroed and attended
        # (no joint mask, so the joint attention is the unmasked kernel).
        if text_mask is not None:
            streams[-1] = streams[-1] * text_mask.to(self.dtype)[..., None]
        ctx = torch.cat(streams, dim=1)

        for blk in self.transformer_blocks:
            img, ctx = blk(img, ctx, temb, rope_cos, rope_sin)

        # AdaLayerNormContinuous: scale first, then shift.
        scale, shift = self.norm_out_linear(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        img = layer_norm(img, eps=1e-6) * (1 + scale) + shift
        return self.unpatchify(self.proj_out(img), tt, hh, ww)
