"""QwenImage MMDiT (60 dual-stream blocks, 3072 wide) and its ControlNet
branch, port of ``apex_studio_tpu/models/transformers/qwenimage.py``.

- packed 2×2 latents (64-wide tokens); the text is Qwen2.5-VL's final
  hidden states, RMS-normed over 3584 and projected
- joint attention over ``[txt ‖ img]``, one unmasked launch a block (the
  engine's zero rows that pad the text bucket stay attended); per-head RMS
  q/k norms (eps 1e-6) before interleaved RoPE, each stream its own
- RoPE ids (scale_rope convention): image tokens (frame, y − h//2, x − w//2);
  each ``extra_segments`` grid (an edit's condition image) is a later frame
  with its own centred ids; text tokens ``max_vid + i`` on all three axes.
  The tables are computed from f32 positions, as the JAX module computes
  them from a ``jnp`` array, and kept per shape
- per-stream modulation ``silu(temb)`` → 6·d split as shift, scale, gate,
  shift, scale, gate; a parameter-free layer norm (eps 1e-6) times
  ``1 + scale`` plus shift; gates without tanh; tanh-GELU MLPs
- the timestep is ``timestep_embedding(t·1000, 256, flip_sin_to_cos)`` → MLP
- ControlNet: ``img_in`` plus ``controlnet_x_embedder`` of the packed
  control latents, N blocks, each output through ``controlnet_blocks[i]``
  times ``conditioning_scale``; the main DiT adds sample ``bi // ceil(L/N)``
  after block ``bi``
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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


@dataclasses.dataclass
class QwenImageConfig:
    patch_size: int = 2
    in_channels: int = 64
    out_channels: int = 16
    num_layers: int = 60
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 3584
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    rope_theta: float = 10000.0
    guidance_embeds: bool = False

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def from_dict(cls, cfg: dict):
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "axes_dims_rope" in kw:
            kw["axes_dims_rope"] = tuple(kw["axes_dims_rope"])
        return cls(**kw)


def _modulate(x, scale, shift):
    return layer_norm(x, eps=1e-6) * (1 + scale) + shift


class QwenImageBlock(nn.Module):
    def __init__(self, cfg: QwenImageConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.img_mod = Linear(d, 6 * d, dtype=dtype)
        self.txt_mod = Linear(d, 6 * d, dtype=dtype)
        for name in ("to_q", "to_k", "to_v", "to_out", "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out"):
            setattr(self, name, Linear(d, d, dtype=dtype))
        for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(self, name, RMSNorm(cfg.attention_head_dim, eps=1e-6))
        self.img_mlp = GELUMLP(d, 4 * d, approximate=True, dtype=dtype)
        self.txt_mlp = GELUMLP(d, 4 * d, approximate=True, dtype=dtype)
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.attention_head_dim

    def forward(self, img, txt, temb, img_cos, img_sin, txt_cos, txt_sin):
        b, n_txt = img.shape[0], txt.shape[1]
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = self.img_mod(F.silu(temb))[:, None, :].chunk(6, dim=-1)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = self.txt_mod(F.silu(temb))[:, None, :].chunk(6, dim=-1)
        img_n = _modulate(img, i_sc1, i_sh1)
        txt_n = _modulate(txt, t_sc1, t_sh1)

        def heads(x, proj):
            return proj(x).reshape(b, x.shape[1], self.heads, self.head_dim)

        q = torch.cat([apply_rope(self.norm_added_q(heads(txt_n, self.add_q_proj)), txt_cos, txt_sin),
                       apply_rope(self.norm_q(heads(img_n, self.to_q)), img_cos, img_sin)], dim=1)
        k = torch.cat([apply_rope(self.norm_added_k(heads(txt_n, self.add_k_proj)), txt_cos, txt_sin),
                       apply_rope(self.norm_k(heads(img_n, self.to_k)), img_cos, img_sin)], dim=1)
        v = torch.cat([heads(txt_n, self.add_v_proj), heads(img_n, self.to_v)], dim=1)
        out = attention_op(q, k, v).reshape(b, q.shape[1], -1)
        txt = txt + self.to_add_out(out[:, :n_txt]) * t_g1
        img = img + self.to_out(out[:, n_txt:]) * i_g1
        img = img + self.img_mlp(_modulate(img, i_sc2, i_sh2)) * i_g2
        txt = txt + self.txt_mlp(_modulate(txt, t_sc2, t_sh2)) * t_g2
        return img, txt


def pack_latents(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] → [B, (H/2)·(W/2), 4C], feature order (c, dy, dx)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The inverse of :func:`pack_latents` for an H × W latent."""
    b, _, d = tokens.shape
    c = d // 4
    x = tokens.reshape(b, h // 2, w // 2, c, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h, w)


class _QwenImageStem(nn.Module):
    """What the DiT and its ControlNet share: the input projections, the
    timestep MLP, the blocks and the RoPE tables."""

    def __init__(self, cfg: QwenImageConfig, *, dtype):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        self.img_in = Linear(cfg.in_channels, d, dtype=dtype)
        self.txt_norm = RMSNorm(cfg.joint_attention_dim, eps=1e-6)
        self.txt_in = Linear(cfg.joint_attention_dim, d, dtype=dtype)
        self.timestep_linear_1 = Linear(256, d, dtype=dtype)
        self.timestep_linear_2 = Linear(d, d, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([QwenImageBlock(cfg, dtype=dtype)
                                                 for _ in range(cfg.num_layers)])
        self._tables: Dict[tuple, tuple] = {}

    def rope_tables(self, h_tok: int, w_tok: int, n_txt: int,
                    extra_segments: Sequence[Tuple[int, int]] = (), device=None):
        """(img_cos, img_sin, txt_cos, txt_sin), each [1, S, 1, head_dim/2]."""
        key = (h_tok, w_tok, n_txt, tuple(map(tuple, extra_segments)), str(device))
        if key not in self._tables:
            segs = [(h_tok, w_tok)] + [tuple(s) for s in extra_segments]
            parts = []
            for frame, (ht, wt) in enumerate(segs):
                ids = np.zeros((ht, wt, 3), np.int64)
                ids[..., 0] = frame
                ids[..., 1] = (np.arange(ht) - ht // 2)[:, None]
                ids[..., 2] = (np.arange(wt) - wt // 2)[None, :]
                parts.append(ids.reshape(-1, 3))
            max_vid = max(max(ht // 2, wt // 2) for ht, wt in segs)
            txt_ids = np.stack([max_vid + np.arange(n_txt)] * 3, axis=-1)
            tables = []
            for ids in (np.concatenate(parts, axis=0), txt_ids):
                cos, sin = precompute_axial_freqs(torch.from_numpy(ids)[None], self.cfg.axes_dims_rope,
                                                  self.cfg.rope_theta)
                tables += [cos[:, :, None, :].to(device), sin[:, :, None, :].to(device)]
            self._tables[key] = tuple(tables)
        return self._tables[key]

    def _embed(self, timestep, encoder_hidden_states):
        t_freq = timestep_embedding(timestep.float() * 1000.0, 256, flip_sin_to_cos=True)
        temb = self.timestep_linear_2(F.silu(self.timestep_linear_1(t_freq.to(self.dtype))))
        txt = self.txt_in(self.txt_norm(encoder_hidden_states.to(self.dtype)))
        return temb, txt

    @staticmethod
    def _grid(n_img: int, grid_hw):
        if grid_hw is None:
            side = int(round(float(np.sqrt(n_img))))
            grid_hw = (side, side)
        return grid_hw


@transformer_registry.register("qwenimage.base", aliases=("qwenimage",))
class QwenImageTransformer2DModel(_QwenImageStem):
    config_class = QwenImageConfig

    def __init__(self, cfg: QwenImageConfig, *, dtype=torch.bfloat16):
        super().__init__(cfg, dtype=dtype)
        d = cfg.dim
        self.norm_out_linear = Linear(d, 2 * d, dtype=dtype)
        self.proj_out = Linear(d, cfg.patch_size ** 2 * cfg.out_channels, dtype=dtype)

    pack_latents = staticmethod(pack_latents)
    unpack_latents = staticmethod(unpack_latents)

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor,
                timestep: torch.Tensor, grid_hw: Optional[Tuple[int, int]] = None,
                extra_segments: Sequence[Tuple[int, int]] = (),
                controlnet_block_samples: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """hidden_states [B, N_img, 64] (noise tokens, then each condition
        grid's); encoder_hidden_states [B, N_txt, 3584]; timestep [B] in [0, 1]."""
        n_txt = encoder_hidden_states.shape[1]
        h_tok, w_tok = self._grid(hidden_states.shape[1], grid_hw)
        temb, txt = self._embed(timestep, encoder_hidden_states)
        img = self.img_in(hidden_states.to(self.dtype))
        tables = self.rope_tables(h_tok, w_tok, n_txt, extra_segments, device=img.device)
        interval = None
        if controlnet_block_samples is not None:
            n = len(self.transformer_blocks)
            interval = -(-n // len(controlnet_block_samples))
        for bi, blk in enumerate(self.transformer_blocks):
            img, txt = blk(img, txt, temb, *tables)
            if interval is not None:
                img = img + controlnet_block_samples[bi // interval].to(img.dtype)
        scale, shift = self.norm_out_linear(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        return self.proj_out(_modulate(img, scale, shift))


@dataclasses.dataclass
class QwenImageControlNetConfig(QwenImageConfig):
    num_layers: int = 5
    extra_condition_channels: int = 0


@transformer_registry.register("qwenimage.controlnet", aliases=("QwenImageControlNetModel",))
class QwenImageControlNetModel(_QwenImageStem):
    config_class = QwenImageControlNetConfig

    def __init__(self, cfg: Optional[QwenImageControlNetConfig] = None, *, dtype=torch.bfloat16):
        cfg = cfg or QwenImageControlNetConfig()
        super().__init__(cfg, dtype=dtype)
        d = cfg.dim
        self.controlnet_x_embedder = Linear(cfg.in_channels + cfg.extra_condition_channels, d, dtype=dtype)
        self.controlnet_blocks = nn.ModuleList([Linear(d, d, dtype=dtype) for _ in range(cfg.num_layers)])

    def forward(self, hidden_states, controlnet_cond, encoder_hidden_states, timestep,
                grid_hw=None, conditioning_scale: float = 1.0) -> List[torch.Tensor]:
        """Per-block residuals, f32 (the output times an f32 scale, as the
        JAX engine's traced scale promotes them); the DiT casts them back."""
        n_txt = encoder_hidden_states.shape[1]
        h_tok, w_tok = self._grid(hidden_states.shape[1], grid_hw)
        temb, txt = self._embed(timestep, encoder_hidden_states)
        img = (self.img_in(hidden_states.to(self.dtype))
               + self.controlnet_x_embedder(controlnet_cond.to(self.dtype)))
        tables = self.rope_tables(h_tok, w_tok, n_txt, device=img.device)
        scale = float(np.float32(conditioning_scale))
        samples = []
        for blk, out_lin in zip(self.transformer_blocks, self.controlnet_blocks):
            img, txt = blk(img, txt, temb, *tables)
            samples.append(out_lin(img).float() * scale)
        return samples
