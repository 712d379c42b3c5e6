"""FLUX.2 DiT, port of ``apex_studio_tpu/models/transformers/flux2.py``.

8 dual-stream + 48 single-stream blocks at dim 6144 (48 heads of 128),
conditioned on 15360-wide stacked Mistral states, every Linear without bias.
What sets it apart from Flux 1, as in the JAX module:

- modulation is **shared across blocks**: computed once a forward from temb
  (``double_stream_modulation_img`` / ``_txt``, two sets of shift, scale and
  gate each; ``single_stream_modulation``, one set);
- the FFN is a fused SwiGLU (``linear_in`` to twice the inner width) with
  ``mlp_ratio`` 3;
- a single block has one fused in-projection ``to_qkv_mlp_proj`` and one
  fused ``to_out`` over [attention ‖ SwiGLU(mlp)];
- 4-axis RoPE (32, 32, 32, 32) at θ 2000 over (T, H, W, L) ids: text tokens
  (0, 0, 0, l), image tokens (0, h, w, 0), the k-th reference image's tokens
  (10·(k+1), h, w, 0); the tables are built on the host in float64 and used
  in f32, as the JAX module builds them;
- the sequence is [txt ‖ img ‖ references], one unmasked joint attention
  launch a block; the reference tokens are dropped before ``proj_out``.

The control variant runs a chain of dual blocks over the packed
[control ‖ inverted mask ‖ inpaint] context and adds each block's
``after_proj`` hint into the main double stream at ``control_layers``.
``sharding_rules`` is not ported (it belongs to the multi-GPU queue).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear, RMSNorm
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import apply_rope, precompute_axial_freqs

Mods = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class Flux2Config:
    patch_size: int = 1
    in_channels: int = 128
    out_channels: Optional[int] = None
    num_layers: int = 8
    num_single_layers: int = 48
    attention_head_dim: int = 128
    num_attention_heads: int = 48
    joint_attention_dim: int = 15360
    timestep_guidance_channels: int = 256
    mlp_ratio: float = 3.0
    axes_dims_rope: Tuple[int, ...] = (32, 32, 32, 32)
    rope_theta: float = 2000.0
    guidance_embeds: bool = True

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def from_dict(cls, cfg: dict) -> "Flux2Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        for key in ("axes_dims_rope", "control_layers"):
            if key in kw:
                kw[key] = tuple(kw[key])
        return cls(**kw)


class Flux2FeedForward(nn.Module):
    """linear_out(silu(x1) * x2) where (x1, x2) = split(linear_in(x))."""

    def __init__(self, dim: int, inner: int, *, dtype):
        super().__init__()
        self.linear_in = Linear(dim, 2 * inner, use_bias=False, dtype=dtype)
        self.linear_out = Linear(inner, dim, use_bias=False, dtype=dtype)

    def forward(self, x):
        x1, x2 = self.linear_in(x).chunk(2, dim=-1)
        return self.linear_out(F.silu(x1) * x2)


class Flux2DualBlock(nn.Module):
    def __init__(self, cfg: Flux2Config, *, dtype):
        super().__init__()
        d = cfg.dim
        for name in ("to_q", "to_k", "to_v", "to_out", "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out"):
            setattr(self, name, Linear(d, d, use_bias=False, dtype=dtype))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(self, name, RMSNorm(cfg.attention_head_dim, eps=1e-6))
        inner = int(d * cfg.mlp_ratio)
        self.ff = Flux2FeedForward(d, inner, dtype=dtype)
        self.ff_context = Flux2FeedForward(d, inner, dtype=dtype)
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.attention_head_dim

    def forward(self, img, txt, mods_img: Tuple[Mods, Mods], mods_txt: Tuple[Mods, Mods], rope_cos, rope_sin):
        b, n_img, _ = img.shape
        n_txt = txt.shape[1]
        (sh, sc, g), (sh2, sc2, g2) = mods_img
        (csh, csc, cg), (csh2, csc2, cg2) = mods_txt

        img_n = layer_norm(img, eps=1e-6) * (1 + sc) + sh
        txt_n = layer_norm(txt, eps=1e-6) * (1 + csc) + csh

        def heads(x, proj):
            return proj(x).reshape(b, x.shape[1], self.heads, self.head_dim)

        q = torch.cat([self.norm_added_q(heads(txt_n, self.add_q_proj)), self.norm_q(heads(img_n, self.to_q))], 1)
        k = torch.cat([self.norm_added_k(heads(txt_n, self.add_k_proj)), self.norm_k(heads(img_n, self.to_k))], 1)
        v = torch.cat([heads(txt_n, self.add_v_proj), heads(img_n, self.to_v)], dim=1)
        q, k = apply_rope(q, rope_cos, rope_sin), apply_rope(k, rope_cos, rope_sin)
        out = attention_op(q, k, v).reshape(b, n_txt + n_img, -1)
        txt = txt + self.to_add_out(out[:, :n_txt]) * cg
        img = img + self.to_out(out[:, n_txt:]) * g

        img = img + self.ff(layer_norm(img, eps=1e-6) * (1 + sc2) + sh2) * g2
        txt = txt + self.ff_context(layer_norm(txt, eps=1e-6) * (1 + csc2) + csh2) * cg2
        return img, txt


class Flux2SingleBlock(nn.Module):
    """Parallel attention + MLP block: one fused qkv+mlp in-projection and
    one fused out-projection over [attention ‖ SwiGLU(mlp)]."""

    def __init__(self, cfg: Flux2Config, *, dtype):
        super().__init__()
        d = cfg.dim
        self.mlp_hidden = int(d * cfg.mlp_ratio)
        self.to_qkv_mlp_proj = Linear(d, 3 * d + 2 * self.mlp_hidden, use_bias=False, dtype=dtype)
        self.to_out = Linear(d + self.mlp_hidden, d, use_bias=False, dtype=dtype)
        self.norm_q = RMSNorm(cfg.attention_head_dim, eps=1e-6)
        self.norm_k = RMSNorm(cfg.attention_head_dim, eps=1e-6)
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.attention_head_dim

    def forward(self, x, mods: Mods, rope_cos, rope_sin):
        b, s, d = x.shape
        shift, scale, gate = mods
        proj = self.to_qkv_mlp_proj(layer_norm(x, eps=1e-6) * (1 + scale) + shift)
        shape = (b, s, self.heads, self.head_dim)
        q = apply_rope(self.norm_q(proj[..., :d].reshape(shape)), rope_cos, rope_sin)
        k = apply_rope(self.norm_k(proj[..., d:2 * d].reshape(shape)), rope_cos, rope_sin)
        v = proj[..., 2 * d:3 * d].reshape(shape)
        attn = attention_op(q, k, v).reshape(b, s, -1)
        m1, m2 = proj[..., 3 * d:].chunk(2, dim=-1)
        return x + gate * self.to_out(torch.cat([attn, F.silu(m1) * m2], dim=-1))


@transformer_registry.register("flux2.base", aliases=("flux2", "Flux2Transformer2DModel"))
class Flux2Transformer2DModel(nn.Module):
    config_class = Flux2Config

    def __init__(self, cfg: Flux2Config, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        ch = cfg.timestep_guidance_channels
        lin = lambda i, o: Linear(i, o, use_bias=False, dtype=dtype)  # noqa: E731
        self.timestep_linear_1 = lin(ch, d)
        self.timestep_linear_2 = lin(d, d)
        if cfg.guidance_embeds:
            self.guidance_linear_1 = lin(ch, d)
            self.guidance_linear_2 = lin(d, d)
        else:
            self.guidance_linear_1 = self.guidance_linear_2 = None
        # shared (per forward, not per block) modulation projections
        self.double_stream_modulation_img = lin(d, 6 * d)
        self.double_stream_modulation_txt = lin(d, 6 * d)
        self.single_stream_modulation = lin(d, 3 * d)
        self.x_embedder = lin(cfg.in_channels, d)
        self.context_embedder = lin(cfg.joint_attention_dim, d)
        self.transformer_blocks = nn.ModuleList([Flux2DualBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.single_transformer_blocks = nn.ModuleList(
            [Flux2SingleBlock(cfg, dtype=dtype) for _ in range(cfg.num_single_layers)])
        self.norm_out_linear = lin(d, 2 * d)
        self.proj_out = lin(d, cfg.patch_size ** 2 * (cfg.out_channels or cfg.in_channels))

    # -- geometry -----------------------------------------------------------------

    def rope_tables(self, n_txt: int, grid_hw: Tuple[int, int],
                    cond_grids: Sequence[Tuple[int, int]] = (), device=None):
        """cos/sin [1, S, 1, D/2] in f32 over (T, H, W, L) ids: text (0, 0, 0,
        l), latents (0, h, w, 0), the k-th reference image (10·(k+1), h, w, 0);
        computed in float64 on the host."""
        ids = [np.stack([np.zeros(n_txt), np.zeros(n_txt), np.zeros(n_txt), np.arange(n_txt)], axis=-1)]
        for t, (h, w) in [(0.0, grid_hw)] + [(10.0 * (k + 1), g) for k, g in enumerate(cond_grids)]:
            hh, ww = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            ids.append(np.stack([np.full(h * w, t), hh.reshape(-1), ww.reshape(-1), np.zeros(h * w)], axis=-1))
        cos, sin = precompute_axial_freqs(np.concatenate(ids, axis=0)[None], self.cfg.axes_dims_rope,
                                          self.cfg.rope_theta)
        return (torch.from_numpy(cos)[:, :, None, :].to(device), torch.from_numpy(sin)[:, :, None, :].to(device))

    @staticmethod
    def pack_latents(x: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] → [B, (H/2)(W/2), 4C] (2×2 pixel-shuffle packing)."""
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // 2, 2, w // 2, 2)
        return x.permute(0, 2, 4, 1, 3, 5).reshape(b, (h // 2) * (w // 2), c * 4)

    @staticmethod
    def unpack_latents(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, d = tokens.shape
        x = tokens.reshape(b, h // 2, w // 2, d // 4, 2, 2)
        return x.permute(0, 3, 1, 4, 2, 5).reshape(b, d // 4, h, w)

    # -- forward -------------------------------------------------------------------

    def _mods(self, linear, temb, sets: int):
        parts = linear(F.silu(temb))[:, None, :].chunk(3 * sets, dim=-1)
        return tuple(tuple(parts[3 * i: 3 * (i + 1)]) for i in range(sets))

    def _prepare(self, hidden_states, encoder_hidden_states, timestep, guidance, grid_hw, cond_tokens,
                 cond_grids, rope):
        """temb, the three shared modulations, the embedded streams and the
        RoPE tables."""
        cfg = self.cfg
        n_img, n_txt = hidden_states.shape[1], encoder_hidden_states.shape[1]
        if grid_hw is None:
            side = int(round(float(np.sqrt(n_img))))
            grid_hw = (side, side)
        ch = cfg.timestep_guidance_channels
        t_freq = timestep_embedding(timestep.float() * 1000.0, ch, flip_sin_to_cos=True)
        temb = self.timestep_linear_2(F.silu(self.timestep_linear_1(t_freq.to(self.dtype))))
        if self.guidance_linear_1 is not None and guidance is not None:
            g_freq = timestep_embedding(guidance.float() * 1000.0, ch, flip_sin_to_cos=True)
            temb = temb + self.guidance_linear_2(F.silu(self.guidance_linear_1(g_freq.to(self.dtype))))
        mods = (self._mods(self.double_stream_modulation_img, temb, 2),
                self._mods(self.double_stream_modulation_txt, temb, 2),
                self._mods(self.single_stream_modulation, temb, 1)[0])
        if cond_tokens is not None:
            hidden_states = torch.cat([hidden_states, cond_tokens.to(hidden_states.dtype)], dim=1)
        img = self.x_embedder(hidden_states.to(self.dtype))
        txt = self.context_embedder(encoder_hidden_states.to(self.dtype))
        rope = rope if rope is not None else self.rope_tables(n_txt, grid_hw, cond_grids, device=img.device)
        return temb, mods, img, txt, rope

    def _finish(self, img, txt, temb, mods_single, rope, n_img: int):
        """The single-stream blocks over [txt ‖ img], then the output head on
        the noise tokens (the reference tokens dropped)."""
        n_txt = txt.shape[1]
        x = torch.cat([txt, img], dim=1)
        for blk in self.single_transformer_blocks:
            x = blk(x, mods_single, *rope)
        img = x[:, n_txt: n_txt + n_img]
        scale, shift = self.norm_out_linear(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        return self.proj_out(layer_norm(img, eps=1e-6) * (1 + scale) + shift)

    def forward(
        self,
        hidden_states: torch.Tensor,          # [B, N_img, in_channels] packed
        encoder_hidden_states: torch.Tensor,  # [B, L, 15360] stacked Mistral states
        timestep: torch.Tensor,               # [B] in [0, 1]
        guidance: Optional[torch.Tensor] = None,  # [B]
        grid_hw: Optional[Tuple[int, int]] = None,
        cond_tokens: Optional[torch.Tensor] = None,  # edit references [B, N_cond, C]
        cond_grids: Sequence[Tuple[int, int]] = (),
        rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        temb, (mods_img, mods_txt, mods_single), img, txt, rope = self._prepare(
            hidden_states, encoder_hidden_states, timestep, guidance, grid_hw, cond_tokens, cond_grids, rope)
        for blk in self.transformer_blocks:
            img, txt = blk(img, txt, mods_img, mods_txt, *rope)
        return self._finish(img, txt, temb, mods_single, rope, hidden_states.shape[1])


# -- control (VACE-style hint chain) -------------------------------------------------------


@dataclasses.dataclass
class Flux2ControlConfig(Flux2Config):
    """A chain of dual blocks over the packed [control latents ‖ inverted
    mask ‖ inpaint latents] context, each emitting a hint added into the main
    double stream at ``control_layers``."""

    control_layers: Tuple[int, ...] = (0, 2, 4, 6)
    control_in_dim: int = 260


class Flux2ControlChainBlock(Flux2DualBlock):
    """A dual block with a ``before_proj`` (the first block only) and an
    ``after_proj`` hint head, both with bias. The JAX module zero-inits their
    kernels; here every weight comes from a checkpoint, a carry or synthetic
    values."""

    def __init__(self, cfg: Flux2Config, first: bool, *, dtype):
        super().__init__(cfg, dtype=dtype)
        d = cfg.dim
        self.before_proj = Linear(d, d, dtype=dtype) if first else None
        self.after_proj = Linear(d, d, dtype=dtype)


@transformer_registry.register("flux2.control", aliases=("Flux2ControlTransformer2DModel",))
class Flux2ControlTransformer2DModel(Flux2Transformer2DModel):
    config_class = Flux2ControlConfig

    def __init__(self, cfg: Optional[Flux2ControlConfig] = None, *, dtype=torch.bfloat16):
        cfg = cfg or Flux2ControlConfig()
        super().__init__(cfg, dtype=dtype)
        self.control_img_in = Linear(cfg.control_in_dim, cfg.dim, dtype=dtype)
        self.control_transformer_blocks = nn.ModuleList(
            [Flux2ControlChainBlock(cfg, first=j == 0, dtype=dtype) for j in range(len(cfg.control_layers))])

    def forward(
        self,
        hidden_states: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        timestep: torch.Tensor,
        guidance: Optional[torch.Tensor] = None,
        grid_hw: Optional[Tuple[int, int]] = None,
        cond_tokens: Optional[torch.Tensor] = None,
        cond_grids: Sequence[Tuple[int, int]] = (),
        control_context: Optional[torch.Tensor] = None,
        control_context_scale: float = 1.0,
        rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        temb, (mods_img, mods_txt, mods_single), img, txt, rope = self._prepare(
            hidden_states, encoder_hidden_states, timestep, guidance, grid_hw, cond_tokens, cond_grids, rope)
        # the control stream runs its own dual blocks, threading the same text
        # stream forward; each block's after_proj is the hint of one main layer
        hints = []
        if control_context is not None:
            c, ctx_txt = self.control_img_in(control_context.to(self.dtype)), txt
            for blk in self.control_transformer_blocks:
                if blk.before_proj is not None:
                    c = blk.before_proj(c) + img
                c, ctx_txt = blk(c, ctx_txt, mods_img, mods_txt, *rope)
                hints.append(blk.after_proj(c))
        mapping = {layer: j for j, layer in enumerate(self.cfg.control_layers)}
        for i, blk in enumerate(self.transformer_blocks):
            img, txt = blk(img, txt, mods_img, mods_txt, *rope)
            if hints and i in mapping:
                img = img + hints[mapping[i]] * control_context_scale
        return self._finish(img, txt, temb, mods_single, rope, hidden_states.shape[1])
