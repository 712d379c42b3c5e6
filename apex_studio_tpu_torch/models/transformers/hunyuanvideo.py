"""HunyuanVideo (the original, 13B) DiT, port of
``apex_studio_tpu/models/transformers/hunyuanvideo.py``.

Same graph, attribute names and dtype flow as the JAX module:

- 20 dual-stream and 40 single-stream blocks at dim 3072 (24 heads of 128);
  llava-llama-3 features refined by the HunyuanVideo 1.5 ``TokenRefiner``
  (its config read duck-typed: dim, mlp ratio, heads, text width, refiner
  layers); the timestep, CLIP-L pooled text and the distilled guidance
  (``guidance × 1000``) each through a two-Linear MLP into one embedding;
- the sequence is ``[img, txt]``, image first; 3-axis interleaved RoPE
  (16, 56, 56), θ = 256, on the image tokens only; per-head RMS q/k norm;
- the one attention mask is the text key padding: a ``[B, S]`` additive
  bias over ``[img | txt]`` (image keys always kept), built once a forward
  and sent with every joint launch (the flash kernel on the card);
- ``image_condition_type``: ``latent_concat`` reads 2C+1 input channels
  with plain blocks; ``token_replace`` modulates the first latent frame's
  image tokens with a t = 0 embedding (``temb_tr``, ``_select_mod``);
- AdaLayerNormContinuous (scale first, then shift) and a Linear to
  ``pt·p·p·C`` features, unpatchified channel-slowest.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import GELUMLP, Linear, RMSNorm
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.models.transformers.hunyuanvideo15 import TokenRefiner
from apex_studio_tpu_torch.ops.attention import _prep_bias
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import apply_rope, precompute_axial_freqs


@dataclasses.dataclass
class HunyuanVideoConfig:
    in_channels: int = 16
    out_channels: int = 16
    num_attention_heads: int = 24
    attention_head_dim: int = 128
    num_layers: int = 20
    num_single_layers: int = 40
    num_refiner_layers: int = 2
    mlp_ratio: float = 4.0
    patch_size: int = 2
    patch_size_t: int = 1
    guidance_embeds: bool = True
    text_embed_dim: int = 4096
    pooled_projection_dim: int = 768
    rope_theta: float = 256.0
    rope_axes_dim: Tuple[int, ...] = (16, 56, 56)
    image_condition_type: Optional[str] = None  # None | latent_concat | token_replace

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def from_dict(cls, cfg: dict) -> "HunyuanVideoConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "rope_axes_dim" in kw:
            kw["rope_axes_dim"] = tuple(kw["rope_axes_dim"])
        return cls(**kw)


def _select_mod(mods, mods_tr, n_first: int, n_total: int):
    """token_replace: the first ``n_first`` image tokens take the t = 0
    modulation, the rest the request's."""
    if mods_tr is None:
        return mods
    sel = (torch.arange(n_total, device=mods[0].device) < n_first)[None, :, None]
    return tuple(torch.where(sel, tr, m) for m, tr in zip(mods, mods_tr))


class HunyuanVideoDualBlock(nn.Module):
    def __init__(self, cfg: HunyuanVideoConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.norm1_linear = Linear(d, 6 * d, dtype=dtype)
        self.norm1_context_linear = Linear(d, 6 * d, dtype=dtype)
        for name in ("to_q", "to_k", "to_v", "to_out", "add_q_proj", "add_k_proj", "add_v_proj",
                     "to_add_out"):
            setattr(self, name, Linear(d, d, dtype=dtype))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(self, name, RMSNorm(cfg.attention_head_dim, eps=1e-6))
        hidden = int(d * cfg.mlp_ratio)
        self.ff = GELUMLP(d, hidden, approximate=True, dtype=dtype)
        self.ff_context = GELUMLP(d, hidden, approximate=True, dtype=dtype)
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.attention_head_dim

    @staticmethod
    def _ada6(linear, temb):
        return linear(F.silu(temb))[:, None, :].chunk(6, dim=-1)

    def forward(self, img, txt, temb, temb_tr, n_first, rope_cos, rope_sin, bias):
        b, n_img, _ = img.shape
        n_txt = txt.shape[1]
        mods = self._ada6(self.norm1_linear, temb)
        if temb_tr is not None:
            mods = _select_mod(mods, self._ada6(self.norm1_linear, temb_tr), n_first, n_img)
        sh, sc, g, sh2, sc2, g2 = mods
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
        out = attention_op(q, k, v, bias=bias).reshape(b, n_img + n_txt, -1)
        img = img + self.to_out(out[:, :n_img]) * g
        txt = txt + self.to_add_out(out[:, n_img:]) * cg

        img = img + self.ff(layer_norm(img, eps=1e-6) * (1 + sc2) + sh2) * g2
        txt = txt + self.ff_context(layer_norm(txt, eps=1e-6) * (1 + csc2) + csh2) * cg2
        return img, txt


class HunyuanVideoSingleBlock(nn.Module):
    """Parallel attention + MLP over the fused ``[img, txt]`` sequence, RoPE
    on the image part only."""

    def __init__(self, cfg: HunyuanVideoConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.norm_linear = Linear(d, 3 * d, dtype=dtype)
        self.to_q = Linear(d, d, dtype=dtype)
        self.to_k = Linear(d, d, dtype=dtype)
        self.to_v = Linear(d, d, dtype=dtype)
        self.norm_q = RMSNorm(cfg.attention_head_dim, eps=1e-6)
        self.norm_k = RMSNorm(cfg.attention_head_dim, eps=1e-6)
        hidden = int(d * cfg.mlp_ratio)
        self.proj_mlp = Linear(d, hidden, dtype=dtype)
        self.proj_out = Linear(d + hidden, d, dtype=dtype)
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.attention_head_dim

    def forward(self, x, n_img, temb, temb_tr, n_first, rope_cos, rope_sin, bias):
        b, s, _ = x.shape
        mods = self.norm_linear(F.silu(temb))[:, None, :].chunk(3, dim=-1)
        if temb_tr is not None:
            mods_tr = self.norm_linear(F.silu(temb_tr))[:, None, :].chunk(3, dim=-1)
            mods = _select_mod(mods, mods_tr, n_first, s)
        shift, scale, gate = mods
        xn = layer_norm(x, eps=1e-6) * (1 + scale) + shift

        def heads(proj):
            return proj(xn).reshape(b, s, self.heads, self.head_dim)

        q = self.norm_q(heads(self.to_q))
        k = self.norm_k(heads(self.to_k))
        v = heads(self.to_v)
        q = torch.cat([apply_rope(q[:, :n_img], rope_cos, rope_sin), q[:, n_img:]], dim=1)
        k = torch.cat([apply_rope(k[:, :n_img], rope_cos, rope_sin), k[:, n_img:]], dim=1)
        attn = attention_op(q, k, v, bias=bias).reshape(b, s, -1)
        mlp = F.gelu(self.proj_mlp(xn), approximate="tanh")
        return x + gate * self.proj_out(torch.cat([attn, mlp], dim=-1))


@transformer_registry.register("hunyuanvideo.base", aliases=("hunyuanvideo", "HunyuanVideoTransformer3DModel"))
class HunyuanVideoTransformer3DModel(nn.Module):
    config_class = HunyuanVideoConfig

    def __init__(self, cfg: HunyuanVideoConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        patch_dim = cfg.in_channels * cfg.patch_size_t * cfg.patch_size**2
        self.x_embedder = Linear(patch_dim, d, dtype=dtype)
        self.context_embedder = TokenRefiner(cfg, dtype=dtype)
        self.time_linear_1 = Linear(256, d, dtype=dtype)
        self.time_linear_2 = Linear(d, d, dtype=dtype)
        self.text_linear_1 = Linear(cfg.pooled_projection_dim, d, dtype=dtype)
        self.text_linear_2 = Linear(d, d, dtype=dtype)
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
        self.proj_out = Linear(d, cfg.patch_size_t * cfg.patch_size**2 * cfg.out_channels, dtype=dtype)
        self._rope = {}  # (t, h, w, device) → the last tables built

    def rope_tables(self, t_tok: int, h_tok: int, w_tok: int, device=None):
        """cos/sin [1, t·h·w, 1, D/2] in f32 from numpy ids (float64 path);
        the tables of the last grid are kept."""
        key = (t_tok, h_tok, w_tok, str(device))
        if key not in self._rope:
            cos, sin = self.rope_for_indices(np.arange(t_tok), h_tok, w_tok)
            self._rope = {key: tuple(torch.from_numpy(a)[None, :, None, :].to(device) for a in (cos, sin))}
        return self._rope[key]

    def rope_for_indices(self, frame_indices, h_tok: int, w_tok: int):
        """numpy cos/sin [T·H·W, D/2] for explicit (maybe non-contiguous)
        frame indices."""
        ids = np.stack(np.meshgrid(np.asarray(frame_indices), np.arange(h_tok), np.arange(w_tok),
                                   indexing="ij"), axis=-1).reshape(1, -1, 3)
        cos, sin = precompute_axial_freqs(ids, self.cfg.rope_axes_dim, self.cfg.rope_theta)
        return cos[0], sin[0]

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """[B,C,T,H,W] → [B, (T/pt)(H/p)(W/p), C·pt·p·p]."""
        return _patch(x, self.cfg.patch_size_t, self.cfg.patch_size)

    def unpatchify(self, tokens: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
        pt, p = self.cfg.patch_size_t, self.cfg.patch_size
        b, c = tokens.shape[0], self.cfg.out_channels
        x = tokens.reshape(b, t // pt, h // p, w // p, c, pt, p, p)
        return x.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(b, c, t, h, w)

    def embed_conditions(self, t, pooled, guidance, token_replace: bool):
        """(temb, temb_tr): the timestep (+ pooled text, + guidance) embedding,
        and for token_replace the same at t = 0."""

        def mlp(first, second, freq):
            return second(F.silu(first(freq.to(self.dtype))))

        t_freq = timestep_embedding(t.float(), 256, flip_sin_to_cos=True)
        temb = mlp(self.time_linear_1, self.time_linear_2, t_freq)
        text = None if pooled is None else mlp(self.text_linear_1, self.text_linear_2, pooled)
        if text is not None:
            temb = temb + text
        temb_tr = None
        if token_replace:
            temb_tr = mlp(self.time_linear_1, self.time_linear_2,
                          timestep_embedding(torch.zeros_like(t, dtype=torch.float32), 256,
                                             flip_sin_to_cos=True))
            if text is not None:
                temb_tr = temb_tr + text
        if self.guidance_linear_1 is not None and guidance is not None:
            g = mlp(self.guidance_linear_1, self.guidance_linear_2,
                    timestep_embedding(guidance.float(), 256, flip_sin_to_cos=True))
            temb = temb + g
            if temb_tr is not None:
                temb_tr = temb_tr + g
        return temb, temb_tr

    def run_blocks(self, img, txt, text_mask, temb, temb_tr, n_first, rope_cos, rope_sin):
        """The dual then the single blocks over ``[img, txt]``; the text
        key padding is one ``[B, 1, 1, S]`` bias for every launch. Returns
        the image tokens after AdaLayerNormContinuous."""
        b, n_img = img.shape[:2]
        bias = None
        if text_mask is not None:
            keep = torch.cat([torch.ones(b, n_img, dtype=torch.bool, device=img.device),
                              text_mask.bool()], dim=1)
            bias = _prep_bias(None, keep)
        for blk in self.transformer_blocks:
            img, txt = blk(img, txt, temb, temb_tr, n_first, rope_cos, rope_sin, bias)
        xseq = torch.cat([img, txt], dim=1)
        del img, txt
        for blk in self.single_transformer_blocks:
            xseq = blk(xseq, n_img, temb, temb_tr, n_first, rope_cos, rope_sin, bias)
        img = xseq[:, :n_img]
        scale, shift = self.norm_out_linear(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        return layer_norm(img, eps=1e-6) * (1 + scale) + shift

    def forward(
        self,
        x: torch.Tensor,                          # [B, C, T, H, W] latents
        t: torch.Tensor,                          # [B] timestep (0..1000)
        text: torch.Tensor,                       # [B, Lt, 4096] llama features
        text_mask: Optional[torch.Tensor] = None,  # [B, Lt] 1 = real
        pooled: Optional[torch.Tensor] = None,     # [B, 768] CLIP-L pooled
        guidance: Optional[torch.Tensor] = None,   # [B] distilled guidance × 1000
    ) -> torch.Tensor:
        cfg = self.cfg
        _, _, tt, hh, ww = x.shape
        n_first = (hh // cfg.patch_size) * (ww // cfg.patch_size)  # first-frame tokens
        temb, temb_tr = self.embed_conditions(t, pooled, guidance, cfg.image_condition_type == "token_replace")
        img = self.x_embedder(self.patchify(x).to(self.dtype))
        txt = self.context_embedder(text.to(self.dtype), t, text_mask)
        rope_cos, rope_sin = self.rope_tables(tt // cfg.patch_size_t, hh // cfg.patch_size,
                                              ww // cfg.patch_size, device=img.device)
        img = self.run_blocks(img, txt, text_mask, temb, temb_tr, n_first, rope_cos, rope_sin)
        return self.unpatchify(self.proj_out(img), tt, hh, ww)


def _patch(x: torch.Tensor, pt: int, p: int) -> torch.Tensor:
    """[B,C,T,H,W] → [B, (T/pt)(H/p)(W/p), C·pt·p·p], features [C, pt, p, p]."""
    b, c, t, h, w = x.shape
    x = x.reshape(b, c, t // pt, pt, h // p, p, w // p, p).permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (t // pt) * (h // p) * (w // p), c * pt * p * p)
