"""Wan Apex-FramePack DiT, port of
``apex_studio_tpu/models/transformers/wan_framepack.py``: long video
denoised in sections of ``num_indices`` latent frames, the frames already
made re-entering the sequence as compressed context.

- ``LatentEmbedPacker``: one patch embedding a compression factor, a Conv3d
  with kernel = stride ``(kt, kh, kw)`` (factor 1: the base patch, 2: (2, 4,
  4), 4: (4, 8, 8), 8: (8, 16, 16)) held as a Linear over the flattened
  patches, the input edge-replicated up to the kernel's multiples
- ``FramepackSchedule``: the host planner; frames 0–1 (the anchors) first,
  then windows of ``num_indices`` from the back to the front, each with the
  anchors as past context (factor 1) and the frames after it split into the
  nearest-first future buckets (1 frame at 1×, 2 at 2×, 16 at 4×, 32 at 8×)
- the context chunks and the section's tokens form one sequence (context
  first); their RoPE is evaluated at the centre of each pooled block (the
  middle source frame in time, the block centre in h and w), with f32
  positions as in JAX; only the section's tokens reach the output
- the base ``patch_embedding`` is the factor-1 embedder
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from apex_studio_tpu_torch.models.layers import Linear
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.models.transformers.wan import WanConfig, WanTransformer3DModel
from apex_studio_tpu_torch.ops.rope import precompute_axial_freqs


@dataclasses.dataclass
class WanFramepackConfig(WanConfig):
    # factor → (kt, kh, kw) latent-space compression kernels
    framepack_compressors: Tuple[Tuple[int, Tuple[int, int, int]], ...] = (
        (1, (1, 2, 2)), (2, (2, 4, 4)), (4, (4, 8, 8)), (8, (8, 16, 16)),
    )
    num_indices: int = 9  # section frames
    # (name, max frames, compression factor), nearest first
    context_buckets: Tuple[Tuple[str, int, int], ...] = (
        ("F_1", 1, 1), ("F_2", 2, 2), ("F_4", 16, 4), ("F_8", 32, 8),
    )

    @classmethod
    def from_dict(cls, cfg: dict) -> "WanFramepackConfig":
        cfg = dict(cfg)
        fc = cfg.get("framepack_compressors")
        if isinstance(fc, dict):  # the reference's {1: "k1h2w2", ...}
            parsed = []
            for k, v in fc.items():
                m = re.match(r"k(\d+)h(\d+)w(\d+)", str(v))
                parsed.append((int(k), (int(m[1]), int(m[2]), int(m[3]))))
            cfg["framepack_compressors"] = tuple(sorted(parsed))
        elif isinstance(fc, (list, tuple)):
            cfg["framepack_compressors"] = tuple((int(f), tuple(k)) for f, k in fc)
        if isinstance(cfg.get("context_buckets"), list):
            cfg["context_buckets"] = tuple((str(n), int(a), int(b)) for n, a, b in cfg["context_buckets"])
        for key in ("patch_size", "vace_layers"):
            if key in cfg:
                cfg[key] = tuple(cfg[key])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in known})


class LatentEmbedPacker(nn.Module):
    """A patch embedding a compression factor (``embedders[str(factor)]``)."""

    def __init__(self, in_channels: int, dim: int, compressors: Sequence[Tuple[int, Tuple[int, int, int]]], *,
                 dtype):
        super().__init__()
        self.kernels: Dict[str, Tuple[int, int, int]] = {str(f): tuple(k) for f, k in compressors}
        self.embedders = nn.ModuleDict({str(f): Linear(in_channels * int(np.prod(k)), dim, dtype=dtype)
                                        for f, k in compressors})

    def embed(self, x: torch.Tensor, factor: str) -> torch.Tensor:
        """(B, C, T, H, W) → (B, N, dim) tokens at the factor's compression."""
        kt, kh, kw = self.kernels[factor]
        pads = (0, -x.shape[4] % kw, 0, -x.shape[3] % kh, 0, -x.shape[2] % kt)
        if any(pads):
            x = torch.nn.functional.pad(x.float(), pads, mode="replicate").to(x.dtype)
        b, c, t, h, w = x.shape
        x = x.reshape(b, c, t // kt, kt, h // kh, kh, w // kw, kw).permute(0, 2, 4, 6, 1, 3, 5, 7)
        x = x.reshape(b, -1, c * kt * kh * kw)
        emb = self.embedders[factor]
        return emb(x)

    def grid_shape(self, t: int, h: int, w: int, factor: str):
        k = self.kernels[factor]
        return (math.ceil(t / k[0]), math.ceil(h / k[1]), math.ceil(w / k[2]))


class FramepackSchedule:
    """The host planner: the anchor frames [0, 2) first, then the remaining
    frames back to front in windows of ``num_indices``; context = the past
    anchors (factor 1) + the future split into buckets."""

    def __init__(self, num_indices: int, buckets: Sequence[Tuple[str, int, int]]):
        self.num_indices = int(num_indices)
        self.buckets = list(buckets)

    def num_sections(self, total_frames: int) -> int:
        return math.ceil(max(0, total_frames - 2) / self.num_indices) + 1

    def get_inference_inputs(self, total_frames: int, denoised: np.ndarray):
        """→ (past, future, target) frame indices as numpy int arrays (None
        for an absent part)."""
        idx = np.arange(total_frames)
        if denoised.all():
            return None, None, None
        if not denoised.any():
            return None, None, idx[:2]
        end = total_frames - 1
        while denoised[end]:
            end -= 1
        end += 1
        start = max(end - self.num_indices, 2)
        future = idx[end:] if end < total_frames else None
        return idx[:2], future, idx[start:end]

    def split_future(self, future: np.ndarray) -> List[Tuple[np.ndarray, int]]:
        """Nearest-first bucket split → [(indices, factor)], ascending time."""
        counts = {name: 0 for name, _, _ in self.buckets}
        chunks: Dict[str, List[int]] = {name: [] for name, _, _ in self.buckets}
        for f in future:
            for name, limit, _ in self.buckets:
                if counts[name] < limit:
                    chunks[name].append(int(f))
                    counts[name] += 1
                    break
        return [(np.asarray(chunks[name]), factor) for name, _, factor in self.buckets if chunks[name]]


@transformer_registry.register("wan.apex_framepack",
                               aliases=("wan_framepack", "WanApexFramepackTransformer3DModel"))
class WanApexFramepackTransformer3DModel(WanTransformer3DModel):
    config_class = WanFramepackConfig
    # the factor-1 embedder is the patch embedding
    patch_embedding = property(lambda self: self.latent_embed_packer.embedders["1"])

    def __init__(self, cfg: WanFramepackConfig, *, dtype=torch.bfloat16):
        super().__init__(cfg, dtype=dtype)
        del self._modules["patch_embedding"]
        self.latent_embed_packer = LatentEmbedPacker(cfg.in_channels, cfg.dim, cfg.framepack_compressors,
                                                     dtype=dtype)
        self.framepack_schedule = FramepackSchedule(cfg.num_indices, cfg.context_buckets)

    def _rope_at(self, t_pos: np.ndarray, h_tok: int, w_tok: int, h_step: float, w_step: float, device):
        """RoPE tables at explicit (pooled-centre) positions, f32 positions."""
        hs = np.arange(h_tok, dtype=np.float64) * h_step + (h_step - 1) / 2.0
        ws = np.arange(w_tok, dtype=np.float64) * w_step + (w_step - 1) / 2.0
        grid = np.stack(np.meshgrid(np.asarray(t_pos, np.float64), hs, ws, indexing="ij"), axis=-1).reshape(1, -1, 3)
        cos, sin = precompute_axial_freqs(torch.from_numpy(grid.astype(np.float32)).to(device),
                                          self.cfg.rope_axes_dims, theta=10000.0)
        return cos[:, :, None, :], sin[:, :, None, :]

    def _chunk_tokens(self, latents: torch.Tensor, frame_idx: np.ndarray, factor: int):
        """A context chunk (or the section, factor 1) → (tokens, cos, sin)."""
        _, _, t, h, w = latents.shape
        _, ph, pw = self.cfg.patch_size
        key = str(factor)
        kt, kh, kw = self.latent_embed_packer.kernels[key]
        tok = self.latent_embed_packer.embed(latents, key)
        _, hg, wg = self.latent_embed_packer.grid_shape(t, h, w, key)
        # the middle source frame of each pooled block (padded with the last)
        fi = np.asarray(frame_idx, np.float64)
        pad = (-len(fi)) % kt
        if pad:
            fi = np.concatenate([fi, np.repeat(fi[-1:], pad)])
        t_pos = fi.reshape(-1, kt)[:, kt // 2]
        cos, sin = self._rope_at(t_pos, hg, wg, kh / ph, kw / pw, tok.device)
        return tok, cos, sin

    def forward(self, x, t, context, latent_context=None, indices=None, context_image=None, fps_index=None):
        """``x`` (B, C, T_s, H, W) the section's latents at the absolute
        latent frames ``indices``; ``latent_context`` [(latents, frame
        indices, factor)] of frames already denoised."""
        _, _, tt, hh, ww = x.shape
        if indices is None:
            indices = np.arange(tt)
        # the base conditioning (its tokens and tables unused, as in JAX)
        _, temb, temb6, ctx, ctx_img, _, _ = self._prepare_cond(x, t, context, context_image, fps_index)
        parts, coss, sins = [], [], []
        for lat, fidx, factor in list(latent_context or []) + [(x, indices, 1)]:
            tok, cos, sin = self._chunk_tokens(lat.to(self.dtype), np.asarray(fidx), int(factor))
            parts.append(tok)
            coss.append(cos)
            sins.append(sin)
        n_target = parts[-1].shape[1]
        tokens = torch.cat(parts, dim=1)
        rope_cos, rope_sin = torch.cat(coss, dim=1), torch.cat(sins, dim=1)
        for blk in self.blocks:
            tokens = blk(tokens, ctx, temb6, rope_cos, rope_sin, context_image=ctx_img)
        return self._finalize(tokens[:, -n_target:], temb, tt, hh, ww)
