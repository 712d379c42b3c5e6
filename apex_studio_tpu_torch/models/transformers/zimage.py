"""Z-Image DiT, port of ``apex_studio_tpu/models/transformers/zimage.py``.

A single-stream DiT with sandwich norms, adaLN modulation and SwiGLU FFNs, in
the JAX module's parameterization and names:

- Static padded sequences: the engine packs caption tokens into a 32-multiple
  bucket and the model pads image tokens to a multiple of 32 with the learned
  ``x_pad_token``. Caption bucket slots take ``cap_pad_token`` but stay
  attended: no mask reaches attention, so every attention of the model runs
  the flash kernel unmasked.
- Position ids: image tokens carry (cap_len + 1, row, col), the padding 0,
  caption tokens (1..cap_len, 0, 0) continued over the bucket padding; the
  RoPE tables (interleaved pairs, axes (32, 48, 48), θ 256) are numpy
  constants per shape, as in the JAX module.
- The engine feeds ``t = (1000 − σt)/1000`` and negates the output.

``ZImageControlTransformer2DModel`` adds the ControlNet-in-one-model branch:
control tokens run their own refiner and layer chain over [control ‖ caption],
and their ``after_proj`` hints are added into the host stream at
``control_refiner_layers_places`` and ``control_layers_places`` times
``control_context_scale``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear, RMSNorm, SwiGLU, TimestepEmbedder
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import apply_rope, precompute_axial_freqs

ADALN_DIM = 256
SEQ_MULTI_OF = 32


@dataclasses.dataclass
class ZImageConfig:
    dim: int = 3840
    n_layers: int = 30
    n_refiner_layers: int = 2
    n_heads: int = 30
    n_kv_heads: int = 30
    in_channels: int = 16
    cap_feat_dim: int = 2560
    norm_eps: float = 1e-5
    qk_norm: bool = True
    patch_size: int = 2
    f_patch_size: int = 1
    rope_theta: float = 256.0
    t_scale: float = 1000.0
    axes_dims: Tuple[int, ...] = (32, 48, 48)
    axes_lens: Tuple[int, ...] = (1024, 512, 512)

    _TUPLES = ("axes_dims", "axes_lens")

    @classmethod
    def from_dict(cls, cfg: dict):
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        # the published config stores list-valued patch sizes
        if "all_patch_size" in cfg:
            kw["patch_size"] = int(cfg["all_patch_size"][0])
        if "all_f_patch_size" in cfg:
            kw["f_patch_size"] = int(cfg["all_f_patch_size"][0])
        for key in cls._TUPLES:
            if kw.get(key) is not None:
                kw[key] = tuple(kw[key])
        return cls(**kw)


class ZImageAttention(nn.Module):
    """Self-attention with per-head RMS qk-norm and interleaved RoPE."""

    def __init__(self, cfg: ZImageConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        self.heads = cfg.n_heads
        self.head_dim = d // cfg.n_heads
        self.to_q = Linear(d, d, use_bias=False, dtype=dtype)
        self.to_k = Linear(d, d, use_bias=False, dtype=dtype)
        self.to_v = Linear(d, d, use_bias=False, dtype=dtype)
        self.to_out = Linear(d, d, use_bias=False, dtype=dtype)
        if cfg.qk_norm:
            self.norm_q = RMSNorm(self.head_dim, eps=1e-5)
            self.norm_k = RMSNorm(self.head_dim, eps=1e-5)
        else:
            self.norm_q = self.norm_k = None

    def forward(self, x, rope_cos, rope_sin):
        b, s, _ = x.shape
        q = self.to_q(x).reshape(b, s, self.heads, self.head_dim)
        k = self.to_k(x).reshape(b, s, self.heads, self.head_dim)
        v = self.to_v(x).reshape(b, s, self.heads, self.head_dim)
        if self.norm_q is not None:
            q, k = self.norm_q(q), self.norm_k(k)
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
        return self.to_out(attention_op(q, k, v).reshape(b, s, -1))


class ZImageBlock(nn.Module):
    """Sandwich-norm block: x += gate·norm2(attn(norm1(x)·scale)), then the
    same around the FFN. adaLN splits into scale_msa, gate_msa, scale_mlp,
    gate_mlp; gates pass through tanh and scales through 1 +."""

    def __init__(self, cfg: ZImageConfig, *, modulation: bool, dtype):
        super().__init__()
        d = cfg.dim
        self.modulation = modulation
        self.attention = ZImageAttention(cfg, dtype=dtype)
        self.feed_forward = SwiGLU(d, int(d / 3 * 8), dtype=dtype)
        self.attention_norm1 = RMSNorm(d, eps=cfg.norm_eps)
        self.attention_norm2 = RMSNorm(d, eps=cfg.norm_eps)
        self.ffn_norm1 = RMSNorm(d, eps=cfg.norm_eps)
        self.ffn_norm2 = RMSNorm(d, eps=cfg.norm_eps)
        if modulation:
            self.adaLN_modulation = Linear(min(d, ADALN_DIM), 4 * d, use_bias=True, dtype=dtype)

    def forward(self, x, rope_cos, rope_sin, adaln=None):
        if self.modulation:
            mod = self.adaLN_modulation(adaln)[:, None, :]  # (B, 1, 4d)
            scale_msa, gate_msa, scale_mlp, gate_mlp = mod.chunk(4, dim=-1)
            gate_msa, gate_mlp = torch.tanh(gate_msa), torch.tanh(gate_mlp)
            scale_msa, scale_mlp = 1.0 + scale_msa, 1.0 + scale_mlp
            attn_out = self.attention(self.attention_norm1(x) * scale_msa, rope_cos, rope_sin)
            x = x + gate_msa * self.attention_norm2(attn_out)
            return x + gate_mlp * self.ffn_norm2(self.feed_forward(self.ffn_norm1(x) * scale_mlp))
        x = x + self.attention_norm2(self.attention(self.attention_norm1(x), rope_cos, rope_sin))
        return x + self.ffn_norm2(self.feed_forward(self.ffn_norm1(x)))


class ZImageFinalLayer(nn.Module):
    def __init__(self, dim: int, out_channels: int, *, dtype):
        super().__init__()
        self.linear = Linear(dim, out_channels, use_bias=True, dtype=dtype)
        self.adaLN_modulation = Linear(min(dim, ADALN_DIM), dim, use_bias=True, dtype=dtype)

    def forward(self, x, c):
        scale = 1.0 + self.adaLN_modulation(F.silu(c))[:, None, :]
        return self.linear(layer_norm(x, eps=1e-6) * scale.to(x.dtype))


@transformer_registry.register("zimage.base", aliases=("zimage",))
class ZImageTransformer2DModel(nn.Module):
    config_class = ZImageConfig

    def __init__(self, cfg: ZImageConfig, *, dtype=torch.bfloat16):
        super().__init__()
        if cfg.dim // cfg.n_heads != sum(cfg.axes_dims):
            raise ValueError(f"head dim {cfg.dim // cfg.n_heads} != sum(axes_dims) {sum(cfg.axes_dims)}")
        self.cfg = cfg
        self.dtype = dtype
        patch_dim = cfg.f_patch_size * cfg.patch_size ** 2 * cfg.in_channels
        self.x_embedder = Linear(patch_dim, cfg.dim, use_bias=True, dtype=dtype)
        self.final_layer = ZImageFinalLayer(cfg.dim, patch_dim, dtype=dtype)
        self.t_embedder = TimestepEmbedder(min(cfg.dim, ADALN_DIM), mid_size=1024, freq_size=256,
                                           max_period=10000.0, flip_sin_to_cos=True, dtype=dtype)
        self.cap_embedder_norm = RMSNorm(cfg.cap_feat_dim, eps=cfg.norm_eps)
        self.cap_embedder_linear = Linear(cfg.cap_feat_dim, cfg.dim, use_bias=True, dtype=dtype)
        self.noise_refiner = nn.ModuleList([ZImageBlock(cfg, modulation=True, dtype=dtype)
                                            for _ in range(cfg.n_refiner_layers)])
        self.context_refiner = nn.ModuleList([ZImageBlock(cfg, modulation=False, dtype=dtype)
                                              for _ in range(cfg.n_refiner_layers)])
        self.layers = nn.ModuleList([ZImageBlock(cfg, modulation=True, dtype=dtype)
                                     for _ in range(cfg.n_layers)])
        self.x_pad_token = nn.Parameter(torch.zeros(1, cfg.dim, dtype=dtype))
        self.cap_pad_token = nn.Parameter(torch.zeros(1, cfg.dim, dtype=dtype))
        self._tables: Dict[tuple, tuple] = {}

    # -- geometry ------------------------------------------------------------------

    def _pos_tables(self, h_tok: int, w_tok: int, n_pad: int, cap_len: int, device):
        """RoPE cos/sin for the image tokens, the caption tokens and the
        unified [x, cap] sequence, each [1, S, 1, head_dim/2], kept per shape."""
        key = (h_tok, w_tok, n_pad, cap_len, str(device))
        if key not in self._tables:
            # x tokens: axis0 = cap_len + 1 (constant), axes 1/2 = (row, col)
            grid = np.stack(np.meshgrid(np.array([cap_len + 1]), np.arange(h_tok), np.arange(w_tok),
                                        indexing="ij"), axis=-1).reshape(-1, 3)
            x_ids = np.concatenate([grid, np.zeros((n_pad - grid.shape[0], 3), np.int64)], axis=0)
            # caption tokens: axis0 = 1..cap_len over the whole bucket
            cap_ids = np.stack([1 + np.arange(cap_len), np.zeros(cap_len), np.zeros(cap_len)], axis=-1)
            cos, sin = precompute_axial_freqs(np.concatenate([x_ids, cap_ids], axis=0),
                                              self.cfg.axes_dims, self.cfg.rope_theta)
            cos = torch.from_numpy(cos)[None, :, None, :].to(device)
            sin = torch.from_numpy(sin)[None, :, None, :].to(device)
            n_x = x_ids.shape[0]
            self._tables[key] = (cos[:, :n_x], sin[:, :n_x], cos[:, n_x:], sin[:, n_x:], cos, sin)
        return self._tables[key]

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, F, H, W] → [B, N, pF·pH·pW·C] (token order: f, h, w)."""
        p, pf = self.cfg.patch_size, self.cfg.f_patch_size
        b, c, f, h, w = x.shape
        x = x.reshape(b, c, f // pf, pf, h // p, p, w // p, p)
        x = x.permute(0, 2, 4, 6, 3, 5, 7, 1)  # (b, f/pf, h/p, w/p, pf, p, p, c)
        return x.reshape(b, (f // pf) * (h // p) * (w // p), pf * p * p * c)

    def unpatchify(self, tokens: torch.Tensor, f: int, h: int, w: int) -> torch.Tensor:
        p, pf = self.cfg.patch_size, self.cfg.f_patch_size
        c = self.cfg.in_channels
        b = tokens.shape[0]
        n = (f // pf) * (h // p) * (w // p)
        x = tokens[:, :n].reshape(b, f // pf, h // p, w // p, pf, p, p, c)
        x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)  # (b, c, f/pf, pf, h/p, p, w/p, p)
        return x.reshape(b, c, f, h, w)

    # -- forward -------------------------------------------------------------------

    def _embed(self, x, t, cap_feats, cap_mask):
        """The timestep vector, the image tokens and their padding, the caption
        tokens after the context refiner, and the position tables."""
        cfg = self.cfg
        b, _, f, h, w = x.shape
        lc = cap_feats.shape[1]
        if lc % SEQ_MULTI_OF:
            raise ValueError(f"caption bucket {lc} is not a multiple of {SEQ_MULTI_OF}")
        adaln = self.t_embedder(t.float() * cfg.t_scale)
        tokens = self.x_embedder(self.patchify(x).to(self.dtype))
        n_pad = (-tokens.shape[1]) % SEQ_MULTI_OF
        pad = self.x_pad_token.to(self.dtype).expand(b, n_pad, cfg.dim)
        tables = self._pos_tables(h // cfg.patch_size, w // cfg.patch_size, tokens.shape[1] + n_pad, lc, x.device)
        cap = self.cap_embedder_linear(self.cap_embedder_norm(cap_feats.to(self.dtype)))
        # cap_mask marks the real caption tokens; the bucket's padding slots take
        # the learned pad token and stay attended
        if cap_mask is not None:
            cap = torch.where(cap_mask[..., None].bool(), cap, self.cap_pad_token.to(self.dtype))
        c_cos, c_sin = tables[2], tables[3]
        for blk in self.context_refiner:
            cap = blk(cap, c_cos, c_sin)
        return adaln, tokens, pad, cap, tables

    def forward(self, x: torch.Tensor, t: torch.Tensor, cap_feats: torch.Tensor,
                cap_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, C, F, H, W] latents; t [B] in [0, 1] (already (1000 − t)/1000);
        cap_feats [B, Lc, cap_feat_dim], Lc a multiple of 32; cap_mask [B, Lc]."""
        _, _, f, h, w = x.shape
        adaln, tokens, pad, cap, tables = self._embed(x, t, cap_feats, cap_mask)
        x_cos, x_sin, _, _, u_cos, u_sin = tables
        tokens = torch.cat([tokens, pad], dim=1)
        for blk in self.noise_refiner:
            tokens = blk(tokens, x_cos, x_sin, adaln)
        n_tot = tokens.shape[1]
        unified = torch.cat([tokens, cap], dim=1)
        for blk in self.layers:
            unified = blk(unified, u_cos, u_sin, adaln)
        return self.unpatchify(self.final_layer(unified[:, :n_tot], adaln), f, h, w)


# ------------------------------------------------------------------------------
# Control variant (ControlNet-in-one-model)
# ------------------------------------------------------------------------------


@dataclasses.dataclass
class ZImageControlConfig(ZImageConfig):
    control_layers_places: Tuple[int, ...] = tuple(range(0, 30, 2))
    control_refiner_layers_places: Tuple[int, ...] = (0, 1)
    control_in_dim: int = 33
    add_control_noise_refiner: bool = True

    _TUPLES = ("axes_dims", "axes_lens", "control_layers_places", "control_refiner_layers_places")


class ZImageControlBlock(ZImageBlock):
    """Control-branch block: block 0 starts from the host stream plus the
    projected control stream (``before_proj``); every block emits an
    ``after_proj`` hint."""

    def __init__(self, cfg, first: bool, *, dtype):
        super().__init__(cfg, modulation=True, dtype=dtype)
        self.before_proj = Linear(cfg.dim, cfg.dim, use_bias=True, dtype=dtype) if first else None
        self.after_proj = Linear(cfg.dim, cfg.dim, use_bias=True, dtype=dtype)


@transformer_registry.register("zimage.control", aliases=("ZImageControlTransformer2DModel",))
class ZImageControlTransformer2DModel(ZImageTransformer2DModel):
    config_class = ZImageControlConfig

    def __init__(self, cfg: Optional[ZImageControlConfig] = None, *, dtype=torch.bfloat16):
        cfg = cfg or ZImageControlConfig()
        super().__init__(cfg, dtype=dtype)
        patch_dim = cfg.f_patch_size * cfg.patch_size ** 2 * cfg.control_in_dim
        self.control_x_embedder = Linear(patch_dim, cfg.dim, use_bias=True, dtype=dtype)
        self.control_layers = nn.ModuleList([ZImageControlBlock(cfg, first=(i == 0), dtype=dtype)
                                             for i in range(len(cfg.control_layers_places))])
        self.control_noise_refiner = (
            nn.ModuleList([ZImageControlBlock(cfg, first=(i == 0), dtype=dtype)
                           for i in range(cfg.n_refiner_layers)])
            if cfg.add_control_noise_refiner else None)

    def forward(self, x, t, cap_feats, cap_mask=None, control_context=None,
                control_context_scale: float = 1.0):
        if control_context is None:
            return super().forward(x, t, cap_feats, cap_mask)
        cfg = self.cfg
        _, _, f, h, w = x.shape
        adaln, tokens, pad, cap, tables = self._embed(x, t, cap_feats, cap_mask)
        x_cos, x_sin, _, _, u_cos, u_sin = tables
        ctokens = self.control_x_embedder(self.patchify(control_context).to(self.dtype))
        tokens = torch.cat([tokens, pad], dim=1)
        ctokens = torch.cat([ctokens, pad], dim=1)
        n_tot = tokens.shape[1]
        scale = torch.tensor(float(control_context_scale), dtype=torch.float32).to(self.dtype)

        # refiner stage with control hints
        if self.control_noise_refiner is not None:
            cr, refiner_hints = ctokens, []
            for blk in self.control_noise_refiner:
                if blk.before_proj is not None:
                    cr = blk.before_proj(cr) + tokens
                cr = blk(cr, x_cos, x_sin, adaln)
                refiner_hints.append(blk.after_proj(cr))
            ctokens = cr
            places = {p: i for i, p in enumerate(cfg.control_refiner_layers_places)}
            for i, blk in enumerate(self.noise_refiner):
                tokens = blk(tokens, x_cos, x_sin, adaln)
                if i in places:
                    tokens = tokens + refiner_hints[places[i]] * scale
        else:
            for blk in self.noise_refiner:
                tokens = blk(tokens, x_cos, x_sin, adaln)

        unified = torch.cat([tokens, cap], dim=1)
        # control layer chain over [control ‖ cap]
        cu, hints = torch.cat([ctokens, cap], dim=1), []
        for blk in self.control_layers:
            if blk.before_proj is not None:
                cu = blk.before_proj(cu) + unified
            cu = blk(cu, u_cos, u_sin, adaln)
            hints.append(blk.after_proj(cu))
        places = {p: i for i, p in enumerate(cfg.control_layers_places)}
        for i, blk in enumerate(self.layers):
            unified = blk(unified, u_cos, u_sin, adaln)
            if i in places:
                unified = unified + hints[places[i]] * scale
        return self.unpatchify(self.final_layer(unified[:, :n_tot], adaln), f, h, w)
