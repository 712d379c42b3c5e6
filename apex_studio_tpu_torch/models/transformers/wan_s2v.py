"""Wan 2.2 S2V (speech-to-video) DiT, port of
``apex_studio_tpu/models/transformers/wan_s2v.py``.

The Wan backbone (dim 5120, 40 blocks, 40 heads of 128) extended with:

- ``CausalAudioEncoder``: a silu-softmaxed weighting of the wav2vec2 hidden
  states (25 for wav2vec2-large), then a replicate-padded causal conv stack
  (stride 4 in all) giving each latent frame ``num_audio_token`` tokens plus
  one learned padding token, and a global AdaIN vector a frame;
- ``AudioInjectorLayer`` after the blocks of ``audio_inject_layers``: each
  latent frame's noise tokens, layer-normed and AdaIN-modulated by the global
  vector (``attn_norm``), cross-attend to that frame's audio tokens: the
  frames as the batch, one flash launch (Sk = ``num_audio_token`` + 1);
- the reference image latent appended at RoPE time 30 and the motion latents
  at negative times, tagged through the 3-row ``trainable_condition_mask``;
  with ``enable_framepack`` the motion history is packed into 1 / 2 / 16-frame
  buckets patchified at 1x / 2x / 4x (``FramePackMotioner``);
- two-segment modulation: noise tokens take the adaLN row of the sampled t,
  the conditioning tokens the row of t = 0 (``zero_timestep``).

Every attention (self, text cross, audio injector) goes through the port's
``WanAttention``, the flash kernel on the card. RoPE tables come from float64
numpy ids, as in JAX.

Departure: the FramePack buckets patchify with a stride (as the published
motioner's strided ``Conv3d``s do): a latent grid that the 2x or 4x patch does
not divide is cropped to the patch's multiple, so that 480x832 (60 x 104
latent pixels, 7 x 13 at 4x) runs. The JAX module reshapes and fails there;
where the patch divides the grid the two agree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import GELUMLP, Linear
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.models.transformers.wan import WanAttention, _patchify
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import precompute_axial_freqs


@dataclasses.dataclass
class WanS2VConfig:
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_attention_heads: int = 40
    attention_head_dim: int = 128
    in_channels: int = 16
    out_channels: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    audio_dim: int = 1280
    num_wav2vec_layers: int = 25
    audio_inject_layers: Tuple[int, ...] = (0, 4, 8, 12, 16, 20, 24, 27)
    enable_adain: bool = True
    adain_mode: str = "attn_norm"
    pose_dim: Optional[int] = 16
    ffn_dim: int = 13824
    num_layers: int = 40
    cross_attn_norm: bool = True
    eps: float = 1e-6
    added_kv_proj_dim: Optional[int] = None
    enable_framepack: bool = False
    framepack_drop_mode: str = "padd"
    zero_timestep: bool = True
    num_audio_token: int = 4

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def rope_axes_dims(self) -> Tuple[int, int, int]:
        d = self.attention_head_dim
        h = w = 2 * (d // 6)
        return (d - 2 * h, h, w)

    @classmethod
    def from_dict(cls, cfg: dict) -> "WanS2VConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        for key in ("patch_size", "audio_inject_layers"):
            if key in kw:
                kw[key] = tuple(kw[key])
        return cls(**kw)


class CausalConv1d(nn.Module):
    """Replicate-padded causal conv over [B, T, C]; ``kernel_w`` in
    ``Conv1d``'s layout [out, in, k] (the JAX module keeps [k, in, out])."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.kernel_w = nn.Parameter(torch.empty(cout, cin, kernel, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=torch.float32))
        self.k, self.stride = kernel, stride

    def forward(self, x):
        x = x.transpose(1, 2)  # [B, C, T]
        x = torch.cat([x[:, :, :1].expand(-1, -1, self.k - 1), x], dim=2)
        return F.conv1d(x, self.kernel_w, self.bias, stride=self.stride).transpose(1, 2)


class MotionEncoder(nn.Module):
    """Causal conv stack over time (stride 4) → per-latent-frame token stacks
    [B, F, heads + 1, hidden] (the last a learned padding token) and, with
    ``need_global``, a global vector a frame."""

    def __init__(self, in_dim: int, hidden_dim: int, num_heads: int, need_global: bool):
        super().__init__()
        self.num_heads = num_heads
        self.need_global = need_global
        self.conv1_local = CausalConv1d(in_dim, hidden_dim // 4 * num_heads, 3)
        if need_global:
            self.conv1_global = CausalConv1d(in_dim, hidden_dim // 4, 3)
            self.final_linear = Linear(hidden_dim, hidden_dim, dtype=torch.float32)
        self.conv2 = CausalConv1d(hidden_dim // 4, hidden_dim // 2, 3, stride=2)
        self.conv3 = CausalConv1d(hidden_dim // 2, hidden_dim, 3, stride=2)
        self.padding_tokens = nn.Parameter(torch.zeros(1, 1, 1, hidden_dim, dtype=torch.float32))

    def _trunk(self, x):
        x = self.conv2(F.silu(layer_norm(x, eps=1e-6)))
        x = self.conv3(F.silu(layer_norm(x, eps=1e-6)))
        return F.silu(layer_norm(x, eps=1e-6))

    def forward(self, x):  # [B, T, C_in]
        b = x.shape[0]
        local = self.conv1_local(x)
        t = local.shape[1]
        local = local.reshape(b, t, self.num_heads, -1).transpose(1, 2).reshape(b * self.num_heads, t, -1)
        local = self._trunk(local)
        f = local.shape[1]
        local = local.reshape(b, self.num_heads, f, -1).transpose(1, 2)
        pad = self.padding_tokens.expand(b, f, 1, local.shape[-1])
        x_local = torch.cat([local, pad], dim=2)
        if not self.need_global:
            return None, x_local
        return self.final_linear(self._trunk(self.conv1_global(x))), x_local


class CausalAudioEncoder(nn.Module):
    def __init__(self, cfg: WanS2VConfig):
        super().__init__()
        self.weights = nn.Parameter(torch.full((1, cfg.num_wav2vec_layers, 1, 1), 0.01, dtype=torch.float32))
        self.encoder = MotionEncoder(cfg.audio_dim, cfg.dim, cfg.num_audio_token, need_global=cfg.enable_adain)

    def forward(self, features):  # [B, L, C, T]
        w = F.silu(self.weights)
        feat = (features.float() * w / w.sum(dim=1, keepdim=True)).sum(dim=1)  # [B, C, T]
        return self.encoder(feat.transpose(1, 2))


class AudioInjectorLayer(nn.Module):
    def __init__(self, cfg: WanS2VConfig, *, dtype):
        super().__init__()
        self.attn = WanAttention(cfg, cross=True, dtype=dtype)
        self.adain_linear = Linear(cfg.dim, 2 * cfg.dim, dtype=torch.float32) if cfg.enable_adain else None

    def forward(self, frame_tokens, audio_tokens, global_vec):
        # frame_tokens [B·F, HW, C]; audio_tokens [B·F, n, C]; global_vec [B·F, C]
        if self.adain_linear is not None and global_vec is not None:
            shift, scale = self.adain_linear(F.silu(global_vec.float()))[:, None, :].chunk(2, dim=-1)
            normed = layer_norm(frame_tokens, eps=1e-5) * (1 + scale) + shift
        else:
            normed = layer_norm(frame_tokens, eps=1e-6)
        return self.attn(normed.to(frame_tokens.dtype), context=audio_tokens)


class WanS2VBlock(nn.Module):
    """A Wan block whose modulation has two segments: the first ``n_noise``
    tokens take the rows of the sampled t, the rest the rows of t = 0."""

    def __init__(self, cfg: WanS2VConfig, *, dtype):
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

    def forward(self, x, context, temb6_t, temb6_0, n_noise, rope_cos, rope_sin):
        sel = (torch.arange(x.shape[1], device=x.device) < n_noise)[None, :, None]
        mods_t = (self.scale_shift_table + temb6_t).to(x.dtype)
        mods_0 = (self.scale_shift_table + temb6_0).to(x.dtype)
        sh, sc, g, csh, csc, cg = (torch.where(sel, mods_t[:, i:i + 1], mods_0[:, i:i + 1]) for i in range(6))
        norm_x = layer_norm(x, eps=self.eps) * (1 + sc) + sh
        x = x + self.attn1(norm_x, rope_cos=rope_cos, rope_sin=rope_sin) * g
        norm_x = (layer_norm(x, self.norm2_weight, self.norm2_bias, self.eps)
                  if self.norm2_weight is not None else x)
        x = x + self.attn2(norm_x, context=context)
        norm_x = layer_norm(x, eps=self.eps) * (1 + csc) + csh
        return x + self.ffn(norm_x) * cg


def _strided_patch(x: torch.Tensor, pt: int, ph: int, pw: int) -> torch.Tensor:
    """[B, C, T, H, W] → [B, N, C·pt·ph·pw] patches, the grid cropped to the
    patch's multiples (a strided conv's footprint)."""
    _, _, t, h, w = x.shape
    return _patchify(x[:, :, : t - t % pt, : h - h % ph, : w - w % pw], (pt, ph, pw))


class FramePackMotioner(nn.Module):
    """The motion history packed into [1, 2, 16]-frame buckets, patchified at
    1x / 2x / 4x."""

    def __init__(self, cfg: WanS2VConfig, *, dtype):
        super().__init__()
        d, z = cfg.dim, cfg.in_channels
        self.proj = Linear(z * 1 * 2 * 2, d, dtype=dtype)
        self.proj_2x = Linear(z * 2 * 4 * 4, d, dtype=dtype)
        self.proj_4x = Linear(z * 4 * 8 * 8, d, dtype=dtype)
        self.buckets = (1, 2, 16)

    def forward(self, motion_latents):
        """[B, C, T_m, h, w] → (tokens [B, N, d], the buckets' RoPE grids)."""
        b, c, t_m, h, w = motion_latents.shape
        total = sum(self.buckets)
        overlap = min(total, t_m)
        pad = motion_latents.new_zeros(b, c, total, h, w)
        pad[:, :, total - overlap:] = motion_latents[:, :, t_m - overlap:]
        post, two_x, four_x = pad[:, :, -1:], pad[:, :, -3:-1], pad[:, :, :16]
        tokens = torch.cat([self.proj(_strided_patch(post, 1, 2, 2)),
                            self.proj_2x(_strided_patch(two_x, 2, 4, 4)),
                            self.proj_4x(_strided_patch(four_x, 4, 8, 8))], dim=1)
        grids = [
            (np.linspace(-1, -1, 1), np.arange(h // 2), np.arange(w // 2)),
            (np.linspace(-3, -3 + 1 - 1, 1), np.linspace(0, h // 2 - 1, h // 4), np.linspace(0, w // 2 - 1, w // 4)),
            (np.linspace(-19, -19 + 16 - 1, 4), np.linspace(0, h // 2 - 1, h // 8),
             np.linspace(0, w // 2 - 1, w // 8)),
        ]
        return tokens, grids


def _grid_ids(t_pos, h_pos, w_pos) -> np.ndarray:
    tt, hh, ww = np.meshgrid(np.asarray(t_pos, np.float64), np.asarray(h_pos, np.float64),
                             np.asarray(w_pos, np.float64), indexing="ij")
    return np.stack([tt, hh, ww], axis=-1).reshape(-1, 3)


@transformer_registry.register("wan.s2v", aliases=("WanS2VTransformer3DModel", "wan_s2v"))
class WanS2VTransformer3DModel(nn.Module):
    config_class = WanS2VConfig

    def __init__(self, cfg: WanS2VConfig, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.dim
        patch = int(np.prod(cfg.patch_size))
        self.patch_embedding = Linear(cfg.in_channels * patch, d, dtype=dtype)
        self.time_embedder_linear_1 = Linear(cfg.freq_dim, d, dtype=dtype)
        self.time_embedder_linear_2 = Linear(d, d, dtype=dtype)
        self.time_proj = Linear(d, 6 * d, dtype=dtype)
        self.text_embedder_linear_1 = Linear(cfg.text_dim, d, dtype=dtype)
        self.text_embedder_linear_2 = Linear(d, d, dtype=dtype)
        self.causal_audio_encoder = CausalAudioEncoder(cfg)
        self.pose_embedder = Linear(cfg.pose_dim * patch, d, dtype=dtype) if cfg.pose_dim is not None else None
        self.trainable_condition_mask = nn.Parameter(torch.empty(3, d, dtype=torch.float32))
        self.blocks = nn.ModuleList([WanS2VBlock(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        inject = sorted(i for i in cfg.audio_inject_layers if i < cfg.num_layers)
        self.audio_inject_map = {layer: idx for idx, layer in enumerate(inject)}
        self.injector = nn.ModuleList([AudioInjectorLayer(cfg, dtype=dtype) for _ in inject])
        self.frame_packer = FramePackMotioner(cfg, dtype=dtype) if cfg.enable_framepack else None
        self.norm_out_scale_shift = nn.Parameter(torch.empty(1, 2, d, dtype=torch.float32))
        self.proj_out = Linear(d, cfg.out_channels * patch, dtype=dtype)
        self._rope = {}  # the last segments' tables

    def _temb(self, t):
        freq = timestep_embedding(t.float(), self.cfg.freq_dim, flip_sin_to_cos=True)
        temb = self.time_embedder_linear_2(F.silu(self.time_embedder_linear_1(freq.to(self.dtype))))
        proj = self.time_proj(F.silu(temb)).reshape(t.shape[0], 6, self.cfg.dim).float()
        return temb.float(), proj

    def rope_tables(self, segments: Sequence[np.ndarray], device=None):
        ids = np.concatenate(segments, axis=0)
        key = (ids.shape, ids.tobytes(), str(device))
        if key not in self._rope:
            cos, sin = precompute_axial_freqs(ids[None], self.cfg.rope_axes_dims, 10000.0)
            self._rope = {key: tuple(torch.from_numpy(a[:, :, None, :]).to(device) for a in (cos, sin))}
        return self._rope[key]

    def forward(
        self,
        x: torch.Tensor,                                # [B, C, T, H, W] noisy latents
        t: torch.Tensor,                                # [B] timestep (0..1000)
        text: torch.Tensor,                             # [B, L, text_dim]
        motion_latents: torch.Tensor,                   # [B, C, T_m, h, w]
        audio_embeds: torch.Tensor,                     # [B, L_w2v, C_a, T_a]
        image_latents: torch.Tensor,                    # [B, C, 1, h_i, w_i]
        pose_latents: Optional[torch.Tensor] = None,    # [B, pose_dim, T, H, W]
        motion_frames: Tuple[int, int] = (17, 5),
        drop_motion_frames: bool = False,
    ) -> torch.Tensor:
        cfg = self.cfg
        b, _, tt, hh, ww = x.shape
        pt, ph, pw = cfg.patch_size
        n_t, n_h, n_w = tt // pt, hh // ph, ww // pw

        temb_t, proj_t = self._temb(t)
        proj_0 = self._temb(torch.zeros_like(t))[1] if cfg.zero_timestep else proj_t
        ctx = self.text_embedder_linear_2(F.gelu(self.text_embedder_linear_1(text.to(self.dtype)),
                                                 approximate="tanh"))

        # the audio: motion_frames[0] copies of the first column in front,
        # encoded, the motion span dropped
        first = audio_embeds[..., :1].expand(*audio_embeds.shape[:-1], motion_frames[0])
        audio_global, audio_tokens = self.causal_audio_encoder(torch.cat([first, audio_embeds], dim=-1))
        audio_tokens = audio_tokens[:, motion_frames[1]:]
        if audio_global is not None:
            audio_global = audio_global[:, motion_frames[1]:]

        tokens = self.patch_embedding(_patchify(x, cfg.patch_size).to(self.dtype))
        if self.pose_embedder is not None and pose_latents is not None:
            tokens = tokens + self.pose_embedder(_patchify(pose_latents, cfg.patch_size).to(self.dtype))
        n_noise = tokens.shape[1]
        img_tok = self.patch_embedding(_patchify(image_latents, cfg.patch_size).to(self.dtype))
        h_i, w_i = image_latents.shape[-2] // ph, image_latents.shape[-1] // pw
        segs = [_grid_ids(np.arange(n_t), np.arange(n_h), np.arange(n_w)),
                _grid_ids(np.asarray([30.0]), np.arange(h_i), np.arange(w_i))]
        parts = [tokens, img_tok]
        mask_ids = [np.zeros(n_noise, np.int64), np.ones(img_tok.shape[1], np.int64)]
        if not drop_motion_frames and motion_latents.shape[2] > 0:
            if self.frame_packer is not None:
                mot_tok, grids = self.frame_packer(motion_latents.to(self.dtype))
                segs.extend(_grid_ids(*g) for g in grids)
            else:
                t_m = motion_latents.shape[2]
                mot_tok = self.patch_embedding(_patchify(motion_latents, cfg.patch_size).to(self.dtype))
                segs.append(_grid_ids(np.arange(-t_m, 0), np.arange(motion_latents.shape[-2] // ph),
                                      np.arange(motion_latents.shape[-1] // pw)))
            parts.append(mot_tok)
            mask_ids.append(np.full(mot_tok.shape[1], 2, np.int64))
        seq = torch.cat(parts, dim=1)
        del parts, tokens, img_tok
        mask = torch.from_numpy(np.concatenate(mask_ids)).to(seq.device)
        seq = seq + self.trainable_condition_mask[mask].to(seq.dtype)
        rope_cos, rope_sin = self.rope_tables(segs, device=seq.device)

        n_frames_audio = audio_tokens.shape[1]
        a_tok = audio_tokens.reshape(b * n_frames_audio, audio_tokens.shape[2], -1).to(seq.dtype)
        g_vec = audio_global.reshape(b * n_frames_audio, -1) if audio_global is not None else None
        for i, blk in enumerate(self.blocks):
            seq = blk(seq, ctx, proj_t, proj_0, n_noise, rope_cos, rope_sin)
            if i in self.audio_inject_map:
                vid = seq[:, :n_noise]
                per_frame = vid.reshape(b * n_frames_audio, n_noise // n_frames_audio, -1)
                res = self.injector[self.audio_inject_map[i]](per_frame, a_tok, g_vec).reshape(b, n_noise, -1)
                seq = torch.cat([vid + res, seq[:, n_noise:]], dim=1)

        out = seq[:, :n_noise]
        shift, scale = (self.norm_out_scale_shift + temb_t[:, None, :]).chunk(2, dim=1)
        out = layer_norm(out, eps=cfg.eps) * (1 + scale.to(out.dtype)) + shift.to(out.dtype)
        out = self.proj_out(out)
        out = out.reshape(b, n_t, n_h, n_w, cfg.out_channels, pt, ph, pw).permute(0, 4, 1, 5, 2, 6, 3, 7)
        return out.reshape(b, cfg.out_channels, tt, hh, ww)
