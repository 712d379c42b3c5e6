"""Wan 2.2 Animate DiT (character animation and replacement), port of
``apex_studio_tpu/models/transformers/wan_animate.py``: the Wan i2v backbone
(CLIP reference-image keys in the cross-attention) plus

- a StyleGAN-style motion encoder: equalized-lr convs (weights scaled by
  1/√fan_in as they run) with a fused leaky ReLU (slope 0.2, ×√2) and
  blur-pooled residual downsampling, 512² face crops → a ``motion_dim`` code
  re-expanded through the QR-orthonormalised synthesis basis; f32, run in
  chunks of ``FACE_CHUNK`` frames (each frame is independent);
- a causal face encoder (the ``CausalConv1d`` of ``wan_s2v.py``, stride 4
  over time): ``4·T − 3`` face frames → T latent frames of ``heads + 1``
  tokens (the last a learned padding token), shifted right by one zero frame
  for the reference slot;
- face-adapter cross-attention after every ``inject_face_latents_blocks``-th
  block: the video tokens of each latent frame attend to that frame's 5 face
  tokens, one flash launch with the latent frames as the batch (Sk = 5);
- pose latents patch-embedded and added to every frame's tokens but the
  reference slot's.

Published layouts: the motion encoder's conv weights are ``[O, I, k, k]`` and
its ``motion_network`` weights ``[out, in]``, as the published file holds
them; the JAX module keeps HWIO and ``[in, out]`` (``from_jax.py`` carries
them, ``jax_weight_hwio`` / ``jax_weight_in_out``). ``proj_out`` features are
[C, pt, ph, pw], channel slowest, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear, RMSNorm
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.models.transformers.wan import WanConfig, WanTransformerBlock, _patchify
from apex_studio_tpu_torch.models.transformers.wan_s2v import CausalConv1d
from apex_studio_tpu_torch.ops.attention import attention as attention_op
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import precompute_axial_freqs

_MOTION_CHANNELS = {512: 64, 256: 128, 128: 256, 64: 512, 32: 512, 16: 512, 8: 512, 4: 512}
_BLUR = (np.outer([1.0, 3.0, 3.0, 1.0], [1.0, 3.0, 3.0, 1.0]) / 64.0).astype(np.float32)
# face frames a motion-encoder pass: 16 frames of 64 x 512 x 512 f32 are 1 GB an activation
FACE_CHUNK = 16


@dataclasses.dataclass
class WanAnimateConfig:
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_attention_heads: int = 40
    attention_head_dim: int = 128
    in_channels: int = 36
    out_channels: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    ffn_dim: int = 13824
    num_layers: int = 40
    cross_attn_norm: bool = True
    eps: float = 1e-6
    image_dim: Optional[int] = 1280
    added_kv_proj_dim: Optional[int] = None
    motion_encoder_size: int = 512
    motion_style_dim: int = 512
    motion_dim: int = 20
    motion_encoder_dim: int = 512
    face_encoder_hidden_dim: int = 1024
    face_encoder_num_heads: int = 4
    inject_face_latents_blocks: int = 5

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def rope_axes_dims(self) -> Tuple[int, int, int]:
        d = self.attention_head_dim
        h = w = 2 * (d // 6)
        return (d - 2 * h, h, w)

    @classmethod
    def from_dict(cls, cfg: dict) -> "WanAnimateConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        if "patch_size" in kw:
            kw["patch_size"] = tuple(kw["patch_size"])
        return cls(**kw)


def _fused_leaky(x: torch.Tensor, bias: Optional[torch.Tensor], slope: float = 0.2) -> torch.Tensor:
    """StyleGAN's fused leaky ReLU over channels (dim 1): (x + b), slope 0.2, ×√2."""
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.ndim - 2))
    return torch.where(x >= 0, x, x * slope) * math.sqrt(2.0)


class MotionConv(nn.Module):
    """Equalized-lr conv (NCHW, weight [O, I, k, k]) with an optional blur
    pre-filter ([1, 3, 3, 1]², depthwise) and the fused leaky ReLU."""

    jax_weight_hwio = True

    def __init__(self, cin, cout, kernel, stride=1, padding=0, use_bias=True, blur=False, use_activation=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, dtype=torch.float32))
        self.scale = 1.0 / math.sqrt(cin * kernel * kernel)
        self.stride, self.padding, self.use_activation, self.cin = stride, padding, use_activation, cin
        if use_activation:
            self.act_bias = nn.Parameter(torch.zeros(cout, dtype=torch.float32))
            self.bias = None
        else:
            self.act_bias = None
            self.bias = nn.Parameter(torch.zeros(cout, dtype=torch.float32)) if use_bias else None
        self.blur = blur
        if blur:
            p = (4 - stride) + (kernel - 1)
            self.blur_pad = ((p + 1) // 2, p // 2)

    def forward(self, x):
        if self.blur:
            lo, hi = self.blur_pad
            bk = torch.from_numpy(_BLUR).to(x.device)[None, None].expand(self.cin, 1, 4, 4)
            x = F.conv2d(F.pad(x, (lo, hi, lo, hi)), bk, groups=self.cin)
        y = F.conv2d(x, self.weight * self.scale, stride=self.stride, padding=self.padding)
        if self.use_activation:
            return _fused_leaky(y, self.act_bias)
        if self.bias is not None:
            y = y + self.bias[None, :, None, None]
        return y


class MotionLinear(nn.Module):
    """Equalized-lr linear, weight [out, in]."""

    jax_weight_in_out = True

    def __init__(self, din, dout, use_activation=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dout, din, dtype=torch.float32))
        self.scale = 1.0 / math.sqrt(din)
        self.use_activation = use_activation
        self.bias = nn.Parameter(torch.zeros(dout, dtype=torch.float32))

    def forward(self, x):
        y = x @ (self.weight * self.scale).T
        if self.use_activation:
            return _fused_leaky(y, self.bias)
        return y + self.bias


class MotionResBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = MotionConv(cin, cin, 3, padding=1)
        self.conv2 = MotionConv(cin, cout, 3, stride=2, blur=True)
        self.conv_skip = MotionConv(cin, cout, 1, stride=2, blur=True, use_bias=False, use_activation=False)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.conv_skip(x)) / math.sqrt(2.0)


class WanAnimateMotionEncoder(nn.Module):
    def __init__(self, cfg: WanAnimateConfig):
        super().__init__()
        size = cfg.motion_encoder_size
        self.conv_in = MotionConv(3, _MOTION_CHANNELS[size], 1)
        blocks, cin = [], _MOTION_CHANNELS[size]
        for i in range(int(math.log2(size)), 2, -1):
            cout = _MOTION_CHANNELS[2 ** (i - 1)]
            blocks.append(MotionResBlock(cin, cout))
            cin = cout
        self.res_blocks = nn.ModuleList(blocks)
        self.conv_out = MotionConv(cin, cfg.motion_style_dim, 4, use_bias=False, use_activation=False)
        self.motion_network = nn.ModuleList([MotionLinear(cfg.motion_style_dim, cfg.motion_style_dim)
                                             for _ in range(4)] + [MotionLinear(cfg.motion_style_dim, cfg.motion_dim)])
        self.motion_synthesis_weight = nn.Parameter(
            torch.empty(cfg.motion_encoder_dim, cfg.motion_dim, dtype=torch.float32))

    def forward(self, faces: torch.Tensor) -> torch.Tensor:
        """[F, 3, S, S] f32 → [F, motion_encoder_dim]."""
        x = self.conv_in(faces)
        for blk in self.res_blocks:
            x = blk(x)
        feat = self.conv_out(x).reshape(x.shape[0], -1)
        for lin in self.motion_network:
            feat = lin(feat)
        # the synthesis basis' orthonormal columns, from LAPACK on the host on every device
        q, _ = torch.linalg.qr(self.motion_synthesis_weight.detach().float().cpu() + 1e-8)
        q = q.to(feat.device)
        return (feat.float()[:, :, None] * q.T[None]).sum(dim=1)


class WanAnimateFaceEncoder(nn.Module):
    """Causal stride-4 conv stack over time → [B, F/4, heads + 1, dim]."""

    def __init__(self, cfg: WanAnimateConfig):
        super().__init__()
        d_in, hid = cfg.motion_encoder_dim, cfg.face_encoder_hidden_dim
        self.num_heads = cfg.face_encoder_num_heads
        self.conv1_local = CausalConv1d(d_in, hid * self.num_heads, 3)
        self.conv2 = CausalConv1d(hid, hid, 3, stride=2)
        self.conv3 = CausalConv1d(hid, hid, 3, stride=2)
        self.out_proj = Linear(hid, cfg.dim, dtype=torch.float32)
        self.padding_tokens = nn.Parameter(torch.zeros(1, 1, 1, cfg.dim, dtype=torch.float32))

    def forward(self, motion_vec: torch.Tensor) -> torch.Tensor:
        b = motion_vec.shape[0]
        x = self.conv1_local(motion_vec)
        x = x.reshape(b, x.shape[1], self.num_heads, -1).transpose(1, 2).reshape(b * self.num_heads, x.shape[1], -1)
        x = F.silu(layer_norm(x, eps=1e-6))
        x = F.silu(layer_norm(self.conv2(x), eps=1e-6))
        x = F.silu(layer_norm(self.conv3(x), eps=1e-6))
        x = self.out_proj(x)
        f = x.shape[1]
        x = x.reshape(b, self.num_heads, f, -1).transpose(1, 2)
        return torch.cat([x, self.padding_tokens.expand(b, f, 1, x.shape[-1])], dim=2)


class FaceAdapterCrossAttention(nn.Module):
    """Each latent frame's video tokens attend to that frame's face tokens:
    the frames as the batch of one launch."""

    def __init__(self, cfg: WanAnimateConfig, *, dtype):
        super().__init__()
        d = cfg.dim
        for name in ("to_q", "to_k", "to_v", "to_out"):
            setattr(self, name, Linear(d, d, dtype=dtype))
        self.norm_q = RMSNorm(cfg.attention_head_dim, eps=cfg.eps)
        self.norm_k = RMSNorm(cfg.attention_head_dim, eps=cfg.eps)
        self.heads, self.head_dim, self.eps = cfg.num_attention_heads, cfg.attention_head_dim, cfg.eps

    def forward(self, x, face_tokens):
        # x [B, S, C]; face_tokens [B, T, N, C]; T divides S
        b, s, c = x.shape
        t, n = face_tokens.shape[1], face_tokens.shape[2]
        h, d = self.heads, self.head_dim
        xq = layer_norm(x, eps=self.eps)
        fk = layer_norm(face_tokens, eps=self.eps).to(x.dtype)
        q = self.norm_q(self.to_q(xq).reshape(b, s, h, d)).reshape(b * t, s // t, h, d)
        k = self.norm_k(self.to_k(fk).reshape(b, t, n, h, d)).reshape(b * t, n, h, d)
        v = self.to_v(fk).reshape(b * t, n, h, d)
        return self.to_out(attention_op(q, k, v).reshape(b, s, c))


@transformer_registry.register("wan.animate", aliases=("WanAnimateTransformer3DModel", "wan_animate"))
class WanAnimateTransformer3DModel(nn.Module):
    config_class = WanAnimateConfig

    def __init__(self, cfg: WanAnimateConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        patch = int(np.prod(cfg.patch_size))
        self.patch_embedding = Linear(cfg.in_channels * patch, d, dtype=dtype)
        self.pose_patch_embedding = Linear(cfg.out_channels * patch, d, dtype=dtype)
        self.time_embedder_linear_1 = Linear(cfg.freq_dim, d, dtype=dtype)
        self.time_embedder_linear_2 = Linear(d, d, dtype=dtype)
        self.time_proj = Linear(d, 6 * d, dtype=dtype)
        self.text_embedder_linear_1 = Linear(cfg.text_dim, d, dtype=dtype)
        self.text_embedder_linear_2 = Linear(d, d, dtype=dtype)
        if cfg.image_dim is not None:
            self.img_norm1 = nn.Parameter(torch.ones(cfg.image_dim, dtype=torch.float32))
            self.img_norm1_bias = nn.Parameter(torch.zeros(cfg.image_dim, dtype=torch.float32))
            self.img_ff1 = Linear(cfg.image_dim, cfg.image_dim, dtype=dtype)
            self.img_ff2 = Linear(cfg.image_dim, d, dtype=dtype)
            self.img_norm2 = nn.Parameter(torch.ones(d, dtype=torch.float32))
            self.img_norm2_bias = nn.Parameter(torch.zeros(d, dtype=torch.float32))
        self.motion_encoder = WanAnimateMotionEncoder(cfg)
        self.face_encoder = WanAnimateFaceEncoder(cfg)
        block_cfg = WanConfig(
            patch_size=cfg.patch_size, num_attention_heads=cfg.num_attention_heads,
            attention_head_dim=cfg.attention_head_dim, in_channels=cfg.in_channels, out_channels=cfg.out_channels,
            text_dim=cfg.text_dim, freq_dim=cfg.freq_dim, ffn_dim=cfg.ffn_dim, num_layers=cfg.num_layers,
            cross_attn_norm=cfg.cross_attn_norm, eps=cfg.eps, image_dim=cfg.image_dim,
            added_kv_proj_dim=cfg.dim if cfg.image_dim is not None else None)
        self.blocks = nn.ModuleList([WanTransformerBlock(block_cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        n_adapters = max(cfg.num_layers // cfg.inject_face_latents_blocks, 1)
        self.face_adapter = nn.ModuleList([FaceAdapterCrossAttention(cfg, dtype=dtype) for _ in range(n_adapters)])
        self.norm_out_scale_shift = nn.Parameter(torch.empty(1, 2, d, dtype=torch.float32))
        self.proj_out = Linear(d, cfg.out_channels * patch, dtype=dtype)
        self._tables = {}

    def rope_tables(self, t_tok, h_tok, w_tok, device=None):
        key = (t_tok, h_tok, w_tok, str(device))
        if key not in self._tables:
            ids = np.stack(np.meshgrid(np.arange(t_tok), np.arange(h_tok), np.arange(w_tok), indexing="ij"),
                           axis=-1).reshape(1, -1, 3)
            cos, sin = precompute_axial_freqs(ids, self.cfg.rope_axes_dims, 10000.0)
            self._tables[key] = tuple(torch.from_numpy(a[:, :, None, :]).to(device) for a in (cos, sin))
        return self._tables[key]

    def face_tokens(self, face_pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, 3, F, S, S] in [-1, 1] → [B, 1 + (F + 3)/4, heads + 1, dim] f32:
        a zero frame for the reference slot, then the face encoder's."""
        b, _, f = face_pixel_values.shape[:3]
        faces = face_pixel_values.transpose(1, 2).reshape(b * f, *face_pixel_values.shape[1:2],
                                                           *face_pixel_values.shape[3:]).float()
        motion = torch.cat([self.motion_encoder(faces[i:i + FACE_CHUNK]) for i in range(0, b * f, FACE_CHUNK)])
        tokens = self.face_encoder(motion.reshape(b, f, -1))
        return torch.cat([torch.zeros_like(tokens[:, :1]), tokens], dim=1)

    def forward(
        self,
        x: torch.Tensor,                                # [B, 36, T + 1, H, W]
        t: torch.Tensor,                                # [B]
        text: torch.Tensor,                             # [B, L, text_dim]
        image_embeds: Optional[torch.Tensor],           # [B, L_img, image_dim]
        pose_latents: Optional[torch.Tensor],           # [B, 16, T, H, W]
        face_pixel_values: Optional[torch.Tensor],      # [B, 3, 4T - 3, 512, 512]
    ) -> torch.Tensor:
        cfg = self.cfg
        b, _, tt, hh, ww = x.shape
        pt, ph, pw = cfg.patch_size
        n_t, n_h, n_w = tt // pt, hh // ph, ww // pw
        s_frame = n_h * n_w

        t_freq = timestep_embedding(t.float(), cfg.freq_dim, flip_sin_to_cos=True)
        temb = self.time_embedder_linear_2(F.silu(self.time_embedder_linear_1(t_freq.to(self.dtype))))
        temb6 = self.time_proj(F.silu(temb)).reshape(b, 6, cfg.dim).float()
        ctx = self.text_embedder_linear_2(
            F.gelu(self.text_embedder_linear_1(text.to(self.dtype)), approximate="tanh"))
        ctx_img = None
        if image_embeds is not None and cfg.image_dim is not None:
            y = layer_norm(image_embeds.to(self.dtype), self.img_norm1, self.img_norm1_bias, 1e-5)
            y = self.img_ff2(F.gelu(self.img_ff1(y)))
            ctx_img = layer_norm(y, self.img_norm2, self.img_norm2_bias, 1e-5)

        tokens = self.patch_embedding(_patchify(x, cfg.patch_size).to(self.dtype))
        if pose_latents is not None:
            pose_tok = self.pose_patch_embedding(_patchify(pose_latents, cfg.patch_size).to(self.dtype))
            tokens = torch.cat([tokens[:, :s_frame], tokens[:, s_frame:] + pose_tok], dim=1)  # slot 0: the reference
        face_tokens = self.face_tokens(face_pixel_values) if face_pixel_values is not None else None

        rope_cos, rope_sin = self.rope_tables(n_t, n_h, n_w, device=tokens.device)
        every = cfg.inject_face_latents_blocks
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens, ctx, temb6, rope_cos, rope_sin, context_image=ctx_img)
            if face_tokens is not None and i % every == 0:
                tokens = tokens + self.face_adapter[i // every](tokens, face_tokens)

        shift, scale = (self.norm_out_scale_shift + temb.float()[:, None, :]).chunk(2, dim=1)
        out = layer_norm(tokens, eps=cfg.eps) * (1 + scale.to(tokens.dtype)) + shift.to(tokens.dtype)
        out = self.proj_out(out).reshape(b, n_t, n_h, n_w, cfg.out_channels, pt, ph, pw)
        return out.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(b, cfg.out_channels, tt, hh, ww)
