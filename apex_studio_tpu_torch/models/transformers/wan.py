"""Wan 2.1 / 2.2 video DiT, port of ``apex_studio_tpu/models/transformers/wan.py``:
the base ``WanTransformer3DModel`` (also SkyReels V2's DiT, ``skyreels.base``)
and its block-causal (Self-Forcing), VACE, Fun / Phantom, ReCamMaster and
HoloCine variants.

- blocks: an f32 layer norm without affine, modulated by a learned
  ``scale_shift_table`` plus the per-sample time projection [B, 6, dim], or
  with per-frame timesteps ``t`` [B, T_lat] (SkyReels' diffusion forcing)
  each frame's projection over its h·w tokens, [B, N, 6, dim];
  self-attention with 3-D RoPE (t/h/w = d−4⌊d/6⌋ / 2⌊d/6⌋ / 2⌊d/6⌋ rotary
  dims, θ = 10000); cross-attention over the UMT5 features after the affine
  ``norm2`` (plus CLIP image features through ``add_k/v_proj`` when
  ``added_kv_proj_dim`` is set); a tanh-GELU FFN
- the q/k RMS norm runs **across heads**, over the whole inner dim
- both attentions are unmasked flash-kernel launches: 40 heads, self at
  Sq = Sk = S, cross at Sq = S over the 512 text keys (zeroed padding, no bias)
- ``patch_embedding`` is the stride = patch Conv3d as a Linear over flattened
  [C, pt, ph, pw] patches; ``proj_out`` features are [pt, ph, pw, C], channel
  fastest, as published checkpoints lay them out
- RoPE tables are built from integer (t, h, w) ids in float64 numpy, cast to
  f32, and kept per grid
- SkyReels (``inject_sample_info``): a 2-row fps embedding (row 0 for 16 fps,
  1 otherwise) whose 6·dim projection is added to every frame's ``temb6``
- causal: a preallocated ``[L, B, S_max, H, D]`` K/V cache written in place
  at ``cache_pos`` (JAX writes a copy with ``dynamic_update_slice`` and
  donates it; the contents are the same); each block's queries attend over
  all ``S_max`` keys with a ``[B, S_max]`` validity mask, as JAX launches it
- VACE: a stack of control blocks over the 96-channel conditioning video
  whose per-block hints are added into the main stream at ``vace_layers``
- Fun / Phantom: subject-reference latents appended in time (RoPE over
  T + T_ref frames) and sliced off before the output projection
- ReCamMaster: the target and source clips concatenated in time; each
  block's 12 → dim ``cam_encoder`` embeds the per-latent-frame relative
  camera poses, each pose repeated over consecutive frames of the joint clip
  (JAX's ``jnp.repeat``) and over the h·w grid, and adds them to the tokens
- HoloCine: a learned ``shot_embedding`` row added to each token by its shot
  id, and a per-query cross-attention bias ``ctx_bias`` [B, 1, S, L] that
  routes each token to its shot's caption span; that bias goes to the plain
  route (the kernel takes a key-only bias), in query-row chunks of
  ``BIAS_ROWS`` so its f32 scores stay small
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import GELUMLP, Linear, RMSNorm
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import apply_rope, precompute_axial_freqs

# query rows a chunk of a per-query-biased attention: 40 heads x 4096 rows x
# 512 text keys of f32 scores are 0.34 GB
BIAS_ROWS = 4096


@dataclasses.dataclass
class WanConfig:
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_attention_heads: int = 40
    attention_head_dim: int = 128
    in_channels: int = 16
    out_channels: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    ffn_dim: int = 13824
    num_layers: int = 40
    cross_attn_norm: bool = True
    eps: float = 1e-6
    inject_sample_info: bool = False        # SkyReels' fps embedding
    image_dim: Optional[int] = None         # 1280 for Wan 2.1 i2v (CLIP features)
    added_kv_proj_dim: Optional[int] = None  # set for the i2v cross-attn image K/V
    rope_max_seq_len: int = 1024
    pos_embed_seq_len: Optional[int] = None
    # VACE (the control branch's block indices and input channels)
    vace_layers: Tuple[int, ...] = ()
    vace_in_channels: int = 96

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def rope_axes_dims(self) -> Tuple[int, int, int]:
        d = self.attention_head_dim
        h = w = 2 * (d // 6)
        return (d - 2 * h, h, w)

    @classmethod
    def from_dict(cls, cfg: dict) -> "WanConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        for key in ("patch_size", "vace_layers"):
            if key in kw:
                kw[key] = tuple(kw[key])
        return cls(**kw)


def _patchify(x: torch.Tensor, patch_size) -> torch.Tensor:
    pt, ph, pw = patch_size
    b, c, t, h, w = x.shape
    x = x.reshape(b, c, t // pt, pt, h // ph, ph, w // pw, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (t // pt) * (h // ph) * (w // pw), c * pt * ph * pw)


class WanAttention(nn.Module):
    """Self- or cross-attention with across-heads RMS qk-norm."""

    def __init__(self, cfg: WanConfig, cross: bool, *, dtype):
        super().__init__()
        d = cfg.dim
        self.to_q = Linear(d, d, dtype=dtype)
        self.to_k = Linear(d, d, dtype=dtype)
        self.to_v = Linear(d, d, dtype=dtype)
        self.to_out = Linear(d, d, dtype=dtype)
        self.norm_q = RMSNorm(d, eps=cfg.eps)
        self.norm_k = RMSNorm(d, eps=cfg.eps)
        if cross and cfg.added_kv_proj_dim is not None:
            self.add_k_proj = Linear(cfg.added_kv_proj_dim, d, dtype=dtype)
            self.add_v_proj = Linear(cfg.added_kv_proj_dim, d, dtype=dtype)
            self.norm_added_k = RMSNorm(d, eps=cfg.eps)
        else:
            self.add_k_proj = self.add_v_proj = self.norm_added_k = None
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.attention_head_dim

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        return x.reshape(b, s, self.heads, self.head_dim)

    def forward(self, x, context=None, rope_cos=None, rope_sin=None, context_image=None, ctx_bias=None):
        ctx = x if context is None else context
        q = self._heads(self.norm_q(self.to_q(x)))
        k = self._heads(self.norm_k(self.to_k(ctx)))
        v = self._heads(self.to_v(ctx))
        if rope_cos is not None:
            q = apply_rope(q, rope_cos, rope_sin)
            k = apply_rope(k, rope_cos, rope_sin)
        out = attention_op(q, k, v) if ctx_bias is None else biased_attention(q, k, v, ctx_bias)
        if context_image is not None and self.add_k_proj is not None:
            k_img = self._heads(self.norm_added_k(self.add_k_proj(context_image)))
            v_img = self._heads(self.add_v_proj(context_image))
            out = out + attention_op(q, k_img, v_img)
        b, s = q.shape[:2]
        return self.to_out(out.reshape(b, s, -1))


def biased_attention(q, k, v, bias):
    """Attention under a per-query additive bias [B, 1, S, Sk], which takes
    the plain route (the kernel takes a key-only bias), in chunks of
    ``BIAS_ROWS`` query rows: each row's softmax is whole in its chunk."""
    return torch.cat([attention_op(q[:, i:i + BIAS_ROWS], k, v, bias=bias[:, :, i:i + BIAS_ROWS])
                      for i in range(0, q.shape[1], BIAS_ROWS)], dim=1)


class WanTransformerBlock(nn.Module):
    def __init__(self, cfg: WanConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.attn1 = WanAttention(cfg, cross=False, dtype=dtype)
        self.attn2 = WanAttention(cfg, cross=True, dtype=dtype)
        if cfg.cross_attn_norm:
            self.norm2_weight = nn.Parameter(torch.ones(d, dtype=torch.float32))
            self.norm2_bias = nn.Parameter(torch.zeros(d, dtype=torch.float32))
        else:
            self.norm2_weight = self.norm2_bias = None
        self.ffn = GELUMLP(d, cfg.ffn_dim, approximate=True, dtype=dtype)
        self.scale_shift_table = nn.Parameter(torch.empty(1, 6, d, dtype=torch.float32))
        self.eps = cfg.eps

    def forward(self, x, context, temb6, rope_cos, rope_sin, context_image=None, ctx_bias=None):
        # temb6 [B, 6, dim] f32, or [B, N, 6, dim] a token (diffusion forcing);
        # the sum with the table is cast to the activations' dtype
        if temb6.ndim == 4:
            mods = (self.scale_shift_table[:, :, None] + temb6.transpose(1, 2)).to(x.dtype)
            shift_msa, scale_msa, gate_msa = mods[:, 0], mods[:, 1], mods[:, 2]
            c_shift, c_scale, c_gate = mods[:, 3], mods[:, 4], mods[:, 5]
        else:
            mods = (self.scale_shift_table + temb6).to(x.dtype)
            shift_msa, scale_msa, gate_msa = mods[:, 0:1], mods[:, 1:2], mods[:, 2:3]
            c_shift, c_scale, c_gate = mods[:, 3:4], mods[:, 4:5], mods[:, 5:6]

        norm_x = layer_norm(x, eps=self.eps) * (1 + scale_msa) + shift_msa
        x = x + self.attn1(norm_x, rope_cos=rope_cos, rope_sin=rope_sin) * gate_msa

        norm_x = (layer_norm(x, self.norm2_weight, self.norm2_bias, self.eps)
                  if self.norm2_weight is not None else x)
        x = x + self.attn2(norm_x, context=context, context_image=context_image, ctx_bias=ctx_bias)

        norm_x = layer_norm(x, eps=self.eps) * (1 + c_scale) + c_shift
        return x + self.ffn(norm_x) * c_gate


@transformer_registry.register("wan.base", aliases=("wan",))
class WanTransformer3DModel(nn.Module):
    config_class = WanConfig

    def __init__(self, cfg: WanConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        patch_dim = cfg.in_channels * int(np.prod(cfg.patch_size))
        self.patch_embedding = Linear(patch_dim, d, dtype=dtype)
        self.time_embedder_linear_1 = Linear(cfg.freq_dim, d, dtype=dtype)
        self.time_embedder_linear_2 = Linear(d, d, dtype=dtype)
        self.time_proj = Linear(d, 6 * d, dtype=dtype)
        self.text_embedder_linear_1 = Linear(cfg.text_dim, d, dtype=dtype)
        self.text_embedder_linear_2 = Linear(d, d, dtype=dtype)
        if cfg.inject_sample_info:
            self.fps_embedding = nn.Parameter(torch.empty(2, d, dtype=torch.float32))
            self.fps_projection_1 = Linear(d, d, dtype=dtype)
            self.fps_projection_2 = Linear(d, 6 * d, dtype=dtype)
        if cfg.image_dim is not None:
            self.img_norm1 = nn.Parameter(torch.ones(cfg.image_dim, dtype=torch.float32))
            self.img_norm1_bias = nn.Parameter(torch.zeros(cfg.image_dim, dtype=torch.float32))
            self.img_ff1 = Linear(cfg.image_dim, cfg.image_dim, dtype=dtype)
            self.img_ff2 = Linear(cfg.image_dim, d, dtype=dtype)
            self.img_norm2 = nn.Parameter(torch.ones(d, dtype=torch.float32))
            self.img_norm2_bias = nn.Parameter(torch.zeros(d, dtype=torch.float32))
        else:
            self.img_ff1 = None
        self.blocks = nn.ModuleList([WanTransformerBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.proj_out = Linear(d, cfg.out_channels * int(np.prod(cfg.patch_size)), dtype=dtype)
        self.scale_shift_table = nn.Parameter(torch.empty(1, 2, d, dtype=torch.float32))
        self._tables: Dict[tuple, tuple] = {}

    # -- geometry --------------------------------------------------------------------

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, T, H, W] → [B, N, C·pt·ph·pw], token order (t, h, w), features
        [C, pt, ph, pw] as Conv3d(kernel = stride = patch) reads them."""
        return _patchify(x, self.cfg.patch_size)

    def unpatchify(self, tokens: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
        """``proj_out`` features [pt, ph, pw, C], channel fastest, → [B, C, T, H, W]."""
        pt, ph, pw = self.cfg.patch_size
        c = self.cfg.out_channels
        b = tokens.shape[0]
        x = tokens.reshape(b, t // pt, h // ph, w // pw, pt, ph, pw, c)
        x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
        return x.reshape(b, c, t, h, w)

    def rope_tables(self, t_tok: int, h_tok: int, w_tok: int, device=None):
        """(cos, sin), each [1, N, 1, head_dim/2] f32, for a t × h × w token grid."""
        key = (t_tok, h_tok, w_tok, str(device))
        if key not in self._tables:
            ids = np.stack(
                np.meshgrid(np.arange(t_tok), np.arange(h_tok), np.arange(w_tok), indexing="ij"),
                axis=-1,
            ).reshape(1, -1, 3)
            cos, sin = precompute_axial_freqs(ids, self.cfg.rope_axes_dims, theta=10000.0)
            self._tables[key] = tuple(torch.from_numpy(a[:, :, None, :]).to(device) for a in (cos, sin))
        return self._tables[key]

    # -- forward ---------------------------------------------------------------------

    def _prepare_cond(self, x, t, context, context_image, fps_index=None):
        """(tokens, temb, temb6, ctx, ctx_img, rope_cos, rope_sin). With
        per-frame timesteps ``t`` [B, T_lat], ``temb`` is [B, N, dim] and
        ``temb6`` [B, N, 6, dim]: each frame's over its h·w tokens."""
        cfg = self.cfg
        b, _, tt, hh, ww = x.shape
        pt, ph, pw = cfg.patch_size
        per_frame = t.ndim == 2  # diffusion forcing (SkyReels df)
        t_freq = timestep_embedding(t.reshape(-1).float(), cfg.freq_dim, flip_sin_to_cos=True)
        temb = self.time_embedder_linear_2(F.silu(self.time_embedder_linear_1(t_freq.to(self.dtype))))
        temb6 = self.time_proj(F.silu(temb)).float().reshape(-1, 6, cfg.dim)
        if cfg.inject_sample_info and fps_index is not None:
            fps_emb = self.fps_embedding[fps_index].to(self.dtype)
            fps6 = self.fps_projection_2(F.silu(self.fps_projection_1(fps_emb))).float().reshape(b, 6, cfg.dim)
            temb6 = temb6 + (fps6.repeat_interleave(temb6.shape[0] // b, dim=0) if per_frame else fps6)
        if per_frame:
            f_lat, hw = t.shape[1], (hh // ph) * (ww // pw)
            if f_lat != tt // pt:
                raise ValueError(f"{f_lat} per-frame timesteps for {tt // pt} latent frames")
            temb = temb.reshape(b, f_lat, 1, cfg.dim).expand(b, f_lat, hw, cfg.dim).reshape(b, -1, cfg.dim)
            temb6 = temb6.reshape(b, f_lat, 1, 6, cfg.dim).expand(b, f_lat, hw, 6, cfg.dim).reshape(
                b, -1, 6, cfg.dim)

        ctx = self.text_embedder_linear_2(
            F.gelu(self.text_embedder_linear_1(context.to(self.dtype)), approximate="tanh"))
        ctx_img = None
        if context_image is not None and self.img_ff1 is not None:
            y = layer_norm(context_image.to(self.dtype), self.img_norm1, self.img_norm1_bias)
            y = self.img_ff2(F.gelu(self.img_ff1(y)))
            ctx_img = layer_norm(y, self.img_norm2, self.img_norm2_bias)

        tokens = self.patch_embedding(self.patchify(x).to(self.dtype))
        rope_cos, rope_sin = self.rope_tables(tt // pt, hh // ph, ww // pw, device=tokens.device)
        return tokens, temb, temb6, ctx, ctx_img, rope_cos, rope_sin

    def _finalize(self, tokens, temb, tt, hh, ww):
        # the final modulated norm; the table's order is (shift, scale); a
        # per-token temb [B, N, dim] under per-frame timesteps
        if temb.ndim == 3:
            table = self.scale_shift_table[:, :, None] + temb.float()[:, None]   # [B, 2, N, dim]
            shift, scale = table[:, 0].to(tokens.dtype), table[:, 1].to(tokens.dtype)
        else:
            table = self.scale_shift_table + temb.float()[:, None, :]
            shift, scale = table[:, 0:1].to(tokens.dtype), table[:, 1:2].to(tokens.dtype)
        tokens = layer_norm(tokens, eps=self.cfg.eps) * (1 + scale) + shift
        return self.unpatchify(self.proj_out(tokens), tt, hh, ww)

    def forward(
        self,
        x: torch.Tensor,                # [B, C, T, H, W] latents
        t: torch.Tensor,                # [B] or [B, T_lat] timesteps (0..1000)
        context: torch.Tensor,          # [B, L, text_dim] UMT5 features
        context_image: Optional[torch.Tensor] = None,  # [B, Li, image_dim] CLIP
        fps_index: Optional[torch.Tensor] = None,      # [B] int 0 | 1 (SkyReels)
        ctx_bias: Optional[torch.Tensor] = None,       # [B, 1, S, L] cross-attention bias (HoloCine)
        shot_ids: Optional[torch.Tensor] = None,       # [B, S] each token's shot (HoloCine)
    ) -> torch.Tensor:
        _, _, tt, hh, ww = x.shape
        tokens, temb, temb6, ctx, ctx_img, rope_cos, rope_sin = self._prepare_cond(x, t, context, context_image,
                                                                                  fps_index)
        if shot_ids is not None and getattr(self, "shot_embedding", None) is not None:
            tokens = tokens + self.shot_embedding[shot_ids].to(tokens.dtype)
        for blk in self.blocks:
            tokens = blk(tokens, ctx, temb6, rope_cos, rope_sin, context_image=ctx_img, ctx_bias=ctx_bias)
        return self._finalize(tokens, temb, tt, hh, ww)


# SkyReels V2 is this architecture with inject_sample_info and per-frame
# (diffusion-forcing) timesteps (reference transformer/skyreels/base/model.py:362).
transformer_registry.add("skyreels.base", WanTransformer3DModel,
                         aliases=("skyreels", "SkyReelsTransformer3DModel"))


# -- causal / autoregressive variant ---------------------------------------------------


@transformer_registry.register("wan.causal", aliases=("wan_causal", "WanCausalTransformer3DModel"))
class WanCausalTransformer3DModel(WanTransformer3DModel):
    """Block-causal Wan DiT for autoregressive long video (Self-Forcing /
    CausVid class): each block of latent frames attends to a K/V cache of the
    blocks committed before it plus itself, optionally within a local window
    of recent tokens plus sink tokens.

    The cache is a preallocated ``[L, B, S_max, H, D]`` tensor pair that
    ``forward_causal`` writes in place at ``cache_pos``; the attention reads
    every ``S_max`` row and masks the rows past ``cache_pos + n_new`` (and
    outside the window), so one call shape serves every block position.
    Cross-attention K/V are recomputed each call, as in JAX."""

    def init_cache(self, batch: int, max_tokens: int, device=None):
        shape = (len(self.blocks), batch, max_tokens, self.cfg.num_attention_heads, self.cfg.attention_head_dim)
        device = device if device is not None else self.patch_embedding.weight.device
        return (torch.zeros(shape, dtype=self.dtype, device=device),
                torch.zeros(shape, dtype=self.dtype, device=device))

    @staticmethod
    def causal_mask(batch: int, s_max: int, cache_pos: int, n_new: int, local_tokens: int = -1,
                    sink_tokens: int = 0, device=None) -> torch.Tensor:
        """``[B, S_max]`` bool: the keys a block at ``cache_pos`` of ``n_new``
        tokens attends to (JAX's ``valid`` at ``wan.py`` ``forward_causal``)."""
        pos = torch.arange(s_max, device=device)
        end = cache_pos + n_new
        valid = pos < end
        if local_tokens > 0:
            window = valid & (pos >= end - local_tokens)
            if sink_tokens > 0:
                window = window | (valid & (pos < sink_tokens))
            valid = window
        return valid[None].expand(batch, s_max)

    def forward_causal(
        self,
        x: torch.Tensor,               # [B, C, T_blk, H, W] the block's latents
        t: torch.Tensor,               # [B, T_blk] per-frame timesteps (0..1000)
        context: torch.Tensor,         # [B, L, text_dim]
        k_cache: torch.Tensor,         # [L, B, S_max, H, D], written in place
        v_cache: torch.Tensor,
        cache_pos: int,                # tokens committed before this block
        rope_cos: torch.Tensor,        # tables for this block's absolute positions
        rope_sin: torch.Tensor,
        local_tokens: int = -1,        # attend to at most this many recent tokens
        sink_tokens: int = 0,          # plus always the first ``sink_tokens``
    ):
        """→ (flow [B, C, T_blk, H, W], (k_cache, v_cache)) with this block's
        K/V written at ``cache_pos``."""
        cfg = self.cfg
        b, _, tt, hh, ww = x.shape
        _, ph, pw = cfg.patch_size
        t_freq = timestep_embedding(t.reshape(-1).float(), cfg.freq_dim, flip_sin_to_cos=True)
        temb = self.time_embedder_linear_2(F.silu(self.time_embedder_linear_1(t_freq.to(self.dtype))))
        temb6 = self.time_proj(F.silu(temb)).float().reshape(-1, 6, cfg.dim)
        f_lat, hw = t.shape[1], (hh // ph) * (ww // pw)
        # each frame's conditioning over its h·w tokens: [B, N, dim], [B, N, 6, dim]
        temb = temb.reshape(b, f_lat, 1, cfg.dim).expand(b, f_lat, hw, cfg.dim).reshape(b, -1, cfg.dim)
        temb6 = temb6.reshape(b, f_lat, 1, 6, cfg.dim).expand(b, f_lat, hw, 6, cfg.dim).reshape(b, -1, 6, cfg.dim)
        ctx = self.text_embedder_linear_2(
            F.gelu(self.text_embedder_linear_1(context.to(self.dtype)), approximate="tanh"))
        tokens = self.patch_embedding(self.patchify(x).to(self.dtype))

        n_new, s_max = tokens.shape[1], k_cache.shape[2]
        mask = self.causal_mask(b, s_max, int(cache_pos), n_new, local_tokens, sink_tokens, tokens.device)
        rows = slice(int(cache_pos), int(cache_pos) + n_new)
        temb6_t = temb6.transpose(1, 2)  # [B, 6, N, dim]
        for i, blk in enumerate(self.blocks):
            mods = (blk.scale_shift_table[:, :, None] + temb6_t).to(tokens.dtype)
            shift_msa, scale_msa, gate_msa = mods[:, 0], mods[:, 1], mods[:, 2]
            c_shift, c_scale, c_gate = mods[:, 3], mods[:, 4], mods[:, 5]

            norm_x = layer_norm(tokens, eps=blk.eps) * (1 + scale_msa) + shift_msa
            attn = blk.attn1
            q = apply_rope(attn._heads(attn.norm_q(attn.to_q(norm_x))), rope_cos, rope_sin)
            k_new = apply_rope(attn._heads(attn.norm_k(attn.to_k(norm_x))), rope_cos, rope_sin)
            v_new = attn._heads(attn.to_v(norm_x))
            k_cache[i, :, rows] = k_new.to(k_cache.dtype)
            v_cache[i, :, rows] = v_new.to(v_cache.dtype)
            out = attention_op(q, k_cache[i], v_cache[i], mask=mask).reshape(b, n_new, -1)
            tokens = tokens + attn.to_out(out) * gate_msa

            norm_x = (layer_norm(tokens, blk.norm2_weight, blk.norm2_bias, blk.eps)
                      if blk.norm2_weight is not None else tokens)
            tokens = tokens + blk.attn2(norm_x, context=ctx)
            norm_x = layer_norm(tokens, eps=blk.eps) * (1 + c_scale) + c_shift
            tokens = tokens + blk.ffn(norm_x) * c_gate

        table = self.scale_shift_table[:, :, None] + temb.float()[:, None]
        shift, scale = table[:, 0].to(tokens.dtype), table[:, 1].to(tokens.dtype)
        tokens = layer_norm(tokens, eps=cfg.eps) * (1 + scale) + shift
        return self.unpatchify(self.proj_out(tokens), tt, hh, ww), (k_cache, v_cache)

    def causal_rope_tables(self, start_frame: int, n_frames: int, h_tok: int, w_tok: int, device=None):
        """RoPE tables for a block starting at absolute latent frame ``start_frame``."""
        key = ("causal", start_frame, n_frames, h_tok, w_tok, str(device))
        if key not in self._tables:
            ids = np.stack(np.meshgrid(np.arange(start_frame, start_frame + n_frames), np.arange(h_tok),
                                       np.arange(w_tok), indexing="ij"), axis=-1).reshape(1, -1, 3)
            cos, sin = precompute_axial_freqs(ids, self.cfg.rope_axes_dims, theta=10000.0)
            self._tables[key] = tuple(torch.from_numpy(a[:, :, None, :]).to(device) for a in (cos, sin))
        return self._tables[key]


# -- VACE variant -----------------------------------------------------------------------


class WanVACEBlock(WanTransformerBlock):
    """A Wan block on the control stream: an input projection on the first
    block (adding the video tokens) and a per-block output projection that
    makes the hint."""

    def __init__(self, cfg: WanConfig, first: bool, *, dtype):
        super().__init__(cfg, dtype=dtype)
        self.proj_in = Linear(cfg.dim, cfg.dim, dtype=dtype) if first else None
        self.proj_out = Linear(cfg.dim, cfg.dim, dtype=dtype)

    def run_control(self, hidden, context, control, temb6, rope_cos, rope_sin):
        if self.proj_in is not None:
            control = self.proj_in(control) + hidden
        control = super().forward(control, context, temb6, rope_cos, rope_sin)
        return self.proj_out(control), control


@transformer_registry.register("wan.vace", aliases=("wan_vace", "WanVACETransformer3DModel"))
class WanVACETransformer3DModel(WanTransformer3DModel):
    """Wan with the VACE control branch: the 96-channel conditioning video
    (inactive / reactive latents and the space-to-depth mask) runs through
    the control blocks, whose hints are added into the main stream after the
    blocks named by ``vace_layers`` (every ``num_layers // 8``-th by default)."""

    def __init__(self, cfg: WanConfig, *, dtype=torch.bfloat16):
        if not cfg.vace_layers:
            cfg = dataclasses.replace(cfg, vace_layers=tuple(range(0, cfg.num_layers, max(1, cfg.num_layers // 8))))
        super().__init__(cfg, dtype=dtype)
        self.vace_patch_embedding = Linear(cfg.vace_in_channels * int(np.prod(cfg.patch_size)), cfg.dim, dtype=dtype)
        self.vace_blocks = nn.ModuleList([WanVACEBlock(cfg, first=(i == 0), dtype=dtype)
                                          for i in range(len(cfg.vace_layers))])

    def patchify_control(self, control: torch.Tensor) -> torch.Tensor:
        return _patchify(control, self.cfg.patch_size)

    def forward(self, x, t, context, control=None, control_scale=None, context_image=None):
        _, _, tt, hh, ww = x.shape
        tokens, temb, temb6, ctx, ctx_img, rope_cos, rope_sin = self._prepare_cond(x, t, context, context_image)
        hint_by_layer = {}
        if control is not None:
            ctl = self.vace_patch_embedding(self.patchify_control(control).to(self.dtype))
            if ctl.shape[1] < tokens.shape[1]:  # zero-padded to the main sequence
                ctl = F.pad(ctl, (0, 0, 0, tokens.shape[1] - ctl.shape[1]))
            if control_scale is None:
                control_scale = torch.ones(len(self.vace_blocks), dtype=torch.float32, device=tokens.device)
            hints = []
            for vb in self.vace_blocks:
                hint, ctl = vb.run_control(tokens, ctx, ctl, temb6, rope_cos, rope_sin)
                hints.append(hint)
            hint_by_layer = {layer: j for j, layer in enumerate(self.cfg.vace_layers)}
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens, ctx, temb6, rope_cos, rope_sin, context_image=ctx_img)
            if i in hint_by_layer:
                j = hint_by_layer[i]
                tokens = tokens + hints[j] * control_scale[j].to(tokens.dtype)
        return self._finalize(tokens, temb, tt, hh, ww)


# -- Fun / Phantom variant --------------------------------------------------------------


@transformer_registry.register(
    "wan.fun", aliases=("wan_fun", "wan.phantom", "WanFunTransformer3DModel", "Wan2_2FunTransformerModel"))
class WanFunTransformer3DModel(WanTransformer3DModel):
    """Wan with subject-reference tokens (the fun / fun_control / phantom
    engines): the references' latents, zero-padded to the input's channels,
    are appended in time, patch-embedded with the shared embedding (RoPE over
    T + T_ref frames) and sliced off before the output projection."""

    def forward(self, x, t, context, subject_ref=None, context_image=None):
        if subject_ref is None:
            return super().forward(x, t, context, context_image)
        b, c, tt, hh, ww = x.shape
        if subject_ref.shape[1] < c:
            subject_ref = F.pad(subject_ref, (0, 0, 0, 0, 0, 0, 0, c - subject_ref.shape[1]))
        xr = torch.cat([x, subject_ref.to(x.dtype)], dim=2)
        tokens, temb, temb6, ctx, ctx_img, rope_cos, rope_sin = self._prepare_cond(xr, t, context, context_image)
        for blk in self.blocks:
            tokens = blk(tokens, ctx, temb6, rope_cos, rope_sin, context_image=ctx_img)
        pt, ph, pw = self.cfg.patch_size
        tokens = tokens[:, :(tt // pt) * (hh // ph) * (ww // pw)]
        return self._finalize(tokens, temb, tt, hh, ww)


# -- ReCamMaster variant ----------------------------------------------------------------


class WanRecamBlock(WanTransformerBlock):
    """A Wan block with a camera-pose encoder (12 → dim) whose embedding is
    added to the tokens before the block."""

    def __init__(self, cfg: WanConfig, *, dtype):
        super().__init__(cfg, dtype=dtype)
        self.cam_encoder = Linear(12, cfg.dim, dtype=dtype)

    def forward(self, x, context, temb6, rope_cos, rope_sin, context_image=None, cam_tokens=None):
        if cam_tokens is not None:
            x = x + cam_tokens.to(x.dtype)
        return super().forward(x, context, temb6, rope_cos, rope_sin, context_image=context_image)


@transformer_registry.register("wan.recam", aliases=("wan_recam", "WanRecamTransformer3DModel"))
class WanRecamTransformer3DModel(WanTransformer3DModel):
    """ReCamMaster: the target clip and the source clip concatenated in time;
    per-block camera encodings of the relative 3×4 extrinsics (12 values a
    latent frame), each repeated over ``T / F_cam`` consecutive latent frames
    and over the spatial grid, added before every block."""

    def __init__(self, cfg: WanConfig, *, dtype=torch.bfloat16):
        super().__init__(cfg, dtype=dtype)
        self.blocks = nn.ModuleList([WanRecamBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])

    def forward(self, x, t, context, cam_emb=None, context_image=None, fps_index=None):
        _, _, tt, hh, ww = x.shape
        pt, ph, pw = self.cfg.patch_size
        tokens, temb, temb6, ctx, ctx_img, rope_cos, rope_sin = self._prepare_cond(x, t, context, context_image,
                                                                                  fps_index)
        hw = (hh // ph) * (ww // pw)
        for blk in self.blocks:
            cam_tokens = None
            if cam_emb is not None:
                ce = blk.cam_encoder(cam_emb.to(self.dtype))
                ce = ce.repeat_interleave((tt // pt) // ce.shape[1], dim=1)  # target + source halves
                cam_tokens = ce.repeat_interleave(hw, dim=1)
            tokens = blk(tokens, ctx, temb6, rope_cos, rope_sin, context_image=ctx_img, cam_tokens=cam_tokens)
        return self._finalize(tokens, temb, tt, hh, ww)


# -- HoloCine joint multi-shot variant -------------------------------------------------


@transformer_registry.register("wan.holocine", aliases=("holocine",))
class WanHolocineTransformer3DModel(WanTransformer3DModel):
    """HoloCine's multi-shot DiT: the base architecture plus a learned
    per-shot token embedding (20 rows) added after the patch embedding by
    ``shot_ids``; the per-query cross-attention bias that routes each token
    to its shot's caption span is built by the engine (``ctx_bias``)."""

    def __init__(self, cfg: WanConfig, *, dtype=torch.bfloat16):
        super().__init__(cfg, dtype=dtype)
        n_shots = int(getattr(cfg, "max_shots", 0) or 20)
        self.shot_embedding = nn.Parameter(torch.empty(n_shots, cfg.dim, dtype=torch.float32))
