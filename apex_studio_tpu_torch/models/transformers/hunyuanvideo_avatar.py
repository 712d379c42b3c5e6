"""HunyuanVideo Avatar (audio-driven talking portrait) DiT, port of
``apex_studio_tpu/models/transformers/hunyuanvideo_avatar.py``, on top of the
port's HunyuanVideo DiT (models/transformers/hunyuanvideo.py):

- the reference latents through a second patch embedding
  (``ref_latents_embedder``) and ``ref_latents_proj`` are added to the video
  tokens, and the reference's first latent frame, through ``x_embedder``, is
  prepended to the image sequence at RoPE time −1;
- the time embedding also takes the motion-expression and head-pose buckets
  (four values each, embedded to dim/4 and concatenated) and the fps;
- Whisper feature windows go through ``AudioProjNet2`` to 4 tokens a pixel
  frame; groups of four frames (the first repeated to fill its group) give
  each latent frame 16 audio tokens, injected after the dual blocks of
  ``double_stream_list`` through single-head perceiver cross-attentions
  (``PerceiverAttentionCA``: a ⁴√d scale on q and k, a plain einsum softmax,
  as JAX computes it outside the attention op), gated by the face mask
  (nearest-resized to the token grid by ``jax.image.resize``'s index rule);
- the joint attention is the base DiT's: ``[ref | image | text]`` with the
  text key padding as one ``[B, S]`` bias, the flash kernel on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.models.transformers.hunyuanvideo import HunyuanVideoConfig, HunyuanVideoTransformer3DModel
from apex_studio_tpu_torch.ops.attention import _prep_bias
from apex_studio_tpu_torch.ops.embeddings import timestep_embedding
from apex_studio_tpu_torch.ops.norms import layer_norm
from apex_studio_tpu_torch.ops.rope import precompute_axial_freqs


@dataclasses.dataclass
class HunyuanAvatarConfig(HunyuanVideoConfig):
    audio_seq_len: int = 10
    audio_blocks: int = 5
    audio_channels: int = 384
    audio_intermediate_dim: int = 1024
    audio_output_dim: int = 3072
    audio_context_tokens: int = 4
    audio_heads: int = 33
    double_stream_list: Tuple[int, ...] = (1, 3, 5, 7, 9, 11, 13, 15, 17, 19)


def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """``jax.image.resize(..., "nearest")``'s source index along one axis:
    ⌊f32((i + 0.5)·n_in) / f32(n_out)⌋."""
    return np.floor((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in)
                    / np.float32(n_out)).astype(np.int64)


class AudioProjNet2(nn.Module):
    """A pixel frame's window (seq_len × blocks × channels) → context tokens."""

    def __init__(self, cfg: HunyuanAvatarConfig, *, dtype):
        super().__init__()
        in_dim = cfg.audio_seq_len * cfg.audio_blocks * cfg.audio_channels
        mid, out = cfg.audio_intermediate_dim, cfg.audio_output_dim
        self.proj1 = Linear(in_dim, mid, dtype=dtype)
        self.proj2 = Linear(mid, mid, dtype=dtype)
        self.proj3 = Linear(mid, cfg.audio_context_tokens * out, dtype=dtype)
        self.norm_weight = nn.Parameter(torch.ones(out, dtype=torch.float32))
        self.norm_bias = nn.Parameter(torch.zeros(out, dtype=torch.float32))
        self.context_tokens, self.output_dim = cfg.audio_context_tokens, out

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        # [B, F, window, blocks, channels] → [B, F, ctx, out]
        b, f = audio.shape[:2]
        x = F.relu(self.proj1(audio.reshape(b * f, -1)))
        x = F.relu(self.proj2(x))
        x = self.proj3(x).reshape(b * f, self.context_tokens, self.output_dim)
        x = layer_norm(x, self.norm_weight, self.norm_bias, 1e-5)
        return x.reshape(b, f, self.context_tokens, self.output_dim)


class PerceiverAttentionCA(nn.Module):
    """Single-head perceiver cross-attention of frame tokens (queries) over
    audio tokens; inner width ``dim_head``."""

    def __init__(self, dim: int, dim_head: int, *, dtype):
        super().__init__()
        self.norm1_weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))
        self.norm1_bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32))
        self.norm2_weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))
        self.norm2_bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32))
        self.to_q = Linear(dim, dim_head, use_bias=False, dtype=dtype)
        self.to_kv = Linear(dim, dim_head * 2, use_bias=False, dtype=dtype)
        self.to_out = Linear(dim_head, dim, use_bias=False, dtype=dtype)
        self.dim_head = dim_head

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        # x: [B', A, D] audio tokens; latents: [B', S, D] frame tokens
        x = layer_norm(x, self.norm1_weight, self.norm1_bias, 1e-5)
        latents = layer_norm(latents, self.norm2_weight, self.norm2_bias, 1e-5)
        q = self.to_q(latents)
        k, v = self.to_kv(x).chunk(2, dim=-1)
        scale = 1.0 / float(np.sqrt(np.sqrt(self.dim_head)))
        w = torch.einsum("bsd,bad->bsa", q * scale, k * scale)
        w = torch.softmax(w.float(), dim=-1).to(v.dtype)
        return self.to_out(torch.einsum("bsa,bad->bsd", w, v))


@transformer_registry.register("hunyuanvideo.avatar", aliases=("HunyuanAvatarVideoTransformer3DModel",))
class HunyuanAvatarVideoModel(HunyuanVideoTransformer3DModel):
    config_class = HunyuanAvatarConfig

    def __init__(self, cfg: HunyuanAvatarConfig = None, *, dtype=torch.bfloat16):
        cfg = cfg or HunyuanAvatarConfig()
        super().__init__(cfg, dtype=dtype)
        d = cfg.dim
        patch_dim = cfg.in_channels * cfg.patch_size_t * cfg.patch_size ** 2
        self.ref_latents_embedder = Linear(patch_dim, d, dtype=dtype)
        self.ref_latents_proj = Linear(d, d, dtype=dtype)
        self.motion_exp_linear_1 = Linear(256, d // 4, dtype=dtype)
        self.motion_exp_linear_2 = Linear(d // 4, d // 4, dtype=dtype)
        self.motion_pose_linear_1 = Linear(256, d // 4, dtype=dtype)
        self.motion_pose_linear_2 = Linear(d // 4, d // 4, dtype=dtype)
        self.fps_linear_1 = Linear(256, d, dtype=dtype)
        self.fps_linear_2 = Linear(d, d, dtype=dtype)
        self.audio_projection = AudioProjNet2(cfg, dtype=dtype)
        self.audio_adapter_blocks = nn.ModuleList(
            [PerceiverAttentionCA(cfg.audio_output_dim, cfg.audio_intermediate_dim, dtype=dtype)
             for _ in cfg.double_stream_list])

    def rope_tables(self, t_tok: int, h_tok: int, w_tok: int, device=None):
        """The video grid's tables after one leading frame of reference
        tokens at time −1."""
        key = ("avatar", t_tok, h_tok, w_tok, str(device))
        if key not in self._rope:
            ids = np.stack(np.meshgrid(np.arange(-1, t_tok), np.arange(h_tok), np.arange(w_tok), indexing="ij"),
                           axis=-1).reshape(1, -1, 3)
            cos, sin = precompute_axial_freqs(ids, self.cfg.rope_axes_dim, self.cfg.rope_theta)
            self._rope = {key: tuple(torch.from_numpy(a[:, :, None, :]).to(device) for a in (cos, sin))}
        return self._rope[key]

    def _mlp(self, first, second, values: torch.Tensor) -> torch.Tensor:
        freq = timestep_embedding(values.reshape(-1).float(), 256, flip_sin_to_cos=True)
        return second(F.silu(first(freq.to(self.dtype))))

    def forward(
        self,
        x: torch.Tensor,                                # [B, C, T, H, W] noisy latents
        t: torch.Tensor,                                # [B]
        text: torch.Tensor,                             # [B, Lt, 4096]
        text_mask: Optional[torch.Tensor] = None,
        pooled: Optional[torch.Tensor] = None,
        guidance: Optional[torch.Tensor] = None,
        ref_latents: Optional[torch.Tensor] = None,     # [B, C, T, H, W]
        audio: Optional[torch.Tensor] = None,           # [B, F_pix, window, blocks, channels]
        face_mask: Optional[torch.Tensor] = None,       # [B, 1, T|1, H, W] in [0, 1]
        motion_exp: Optional[torch.Tensor] = None,      # [B, 4]
        motion_pose: Optional[torch.Tensor] = None,     # [B, 4]
        fps: Optional[torch.Tensor] = None,             # [B]
    ) -> torch.Tensor:
        cfg = self.cfg
        b, _, tt, hh, ww = x.shape
        p, pt = cfg.patch_size, cfg.patch_size_t
        ht, wt, n_frames = hh // p, ww // p, tt // pt

        temb = self._mlp(self.time_linear_1, self.time_linear_2, t)
        if guidance is not None and self.guidance_linear_1 is not None:
            temb = temb + self._mlp(self.guidance_linear_1, self.guidance_linear_2, guidance)
        if motion_exp is not None:
            temb = temb + self._mlp(self.motion_exp_linear_1, self.motion_exp_linear_2, motion_exp).reshape(b, -1)
        if motion_pose is not None:
            temb = temb + self._mlp(self.motion_pose_linear_1, self.motion_pose_linear_2,
                                    motion_pose).reshape(b, -1)
        if fps is not None:
            temb = temb + self._mlp(self.fps_linear_1, self.fps_linear_2, fps)
        if pooled is not None:
            temb = temb + self.text_linear_2(F.silu(self.text_linear_1(pooled.to(self.dtype))))

        # the first pixel frame's tokens repeated 3 times in front: each
        # latent frame takes a group of 4 pixel frames' tokens
        audio_tokens = self.audio_projection(audio.to(self.dtype))
        audio_all = torch.cat([audio_tokens[:, :1].expand(-1, 3, -1, -1), audio_tokens], dim=1)
        audio_all = audio_all.reshape(b * n_frames, 4 * cfg.audio_context_tokens, cfg.dim)

        img = self.x_embedder(self.patchify(x).to(self.dtype))
        ref_tok = self.ref_latents_embedder(self.patchify(ref_latents).to(self.dtype))
        ref_first = self.x_embedder(self.patchify(ref_latents[:, :, :pt]).to(self.dtype))
        img = img + self.ref_latents_proj(ref_tok)
        del ref_tok
        ref_len = ref_first.shape[1]
        img = torch.cat([ref_first, img], dim=1)

        txt = self.context_embedder(text.to(self.dtype), t, text_mask)
        rope_cos, rope_sin = self.rope_tables(n_frames, ht, wt, device=img.device)

        if face_mask is None:
            face_mask = torch.ones(b, 1, tt, hh, ww, device=img.device)
        if face_mask.shape[2] == 1:
            face_mask = face_mask.expand(-1, -1, tt, -1, -1)
        fm = face_mask.float()
        for axis, n_out in ((2, n_frames), (3, ht), (4, wt)):
            idx = torch.from_numpy(nearest_index(fm.shape[axis], n_out)).to(fm.device)
            fm = fm.index_select(axis, idx)
        fm = fm.reshape(b, n_frames * ht * wt, 1).to(img.dtype)

        n_img = img.shape[1]
        bias = None
        if text_mask is not None:
            keep = torch.cat([torch.ones(b, n_img, dtype=torch.bool, device=img.device), text_mask.bool()], dim=1)
            bias = _prep_bias(None, keep)

        adapter = {blk: j for j, blk in enumerate(cfg.double_stream_list)}
        for bi, blk in enumerate(self.transformer_blocks):
            img, txt = blk(img, txt, temb, None, 0, rope_cos, rope_sin, bias)
            if bi in adapter:
                real = img[:, ref_len:].reshape(b * n_frames, ht * wt, cfg.dim)
                inj = self.audio_adapter_blocks[adapter[bi]](audio_all, real)
                inj = inj.reshape(b, n_frames * ht * wt, cfg.dim) * fm
                img = torch.cat([img[:, :ref_len], img[:, ref_len:] + inj], dim=1)

        xseq = torch.cat([img, txt], dim=1)
        del img, txt
        for blk in self.single_transformer_blocks:
            xseq = blk(xseq, n_img, temb, None, 0, rope_cos, rope_sin, bias)
        img = xseq[:, ref_len:n_img]
        scale, shift = self.norm_out_linear(F.silu(temb))[:, None, :].chunk(2, dim=-1)
        img = layer_norm(img, eps=1e-6) * (1 + scale) + shift
        return self.unpatchify(self.proj_out(img), tt, hh, ww)
