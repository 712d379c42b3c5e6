"""MAGI-1 ViT video autoencoder, port of ``apex_studio_tpu/models/vaes/magi_vae.py``.

A pure transformer VAE: a 3D patch embedding (8×8 in space, 4 frames in time)
as a Linear, a cls token, a learned 3D position embedding resized
trilinearly to the grid at hand, pre-norm ViT blocks (12 heads of 64 over
every token and the cls token, in f32: the kernel's bf16 tiles on the card),
then a Linear to the latent moments (encode), or a Linear + LayerNorm to 4
channels a pixel, an unpatchify and a 3×3×3 conv in f32 (decode).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import LayerNorm, Linear
from apex_studio_tpu_torch.models.registry import vae_registry
from apex_studio_tpu_torch.ops.attention import attention


@dataclasses.dataclass
class MagiVAEConfig:
    video_size: int = 256
    video_length: int = 16
    patch_size: int = 8
    patch_length: int = 4
    in_chans: int = 3
    z_chans: int = 16
    double_z: bool = True
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = False
    with_cls_token: bool = True
    use_final_proj: bool = True  # decoder: 4-channel unpatch + final norm

    @property
    def spatial_compression_ratio(self) -> int:
        return self.patch_size

    @property
    def temporal_compression_ratio(self) -> int:
        return self.patch_length

    @classmethod
    def from_dict(cls, cfg: dict) -> "MagiVAEConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in known})


class _Conv3d(nn.Module):
    """3×3×3 conv, padding 1, in f32."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3, 3, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=torch.float32))

    def forward(self, x):  # (B, C, T, H, W)
        return F.conv3d(x, self.weight, self.bias, padding=1)


class _VAEAttention(nn.Module):
    def __init__(self, dim: int, heads: int, qkv_bias: bool, *, dtype):
        super().__init__()
        self.qkv = Linear(dim, dim * 3, use_bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.heads = heads

    def forward(self, x):
        b, n, d = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, d // self.heads)
        return self.proj(attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(b, n, d))


class _VAEBlock(nn.Module):
    def __init__(self, cfg: MagiVAEConfig, *, dtype):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.attn = _VAEAttention(d, cfg.num_heads, cfg.qkv_bias, dtype=dtype)
        self.norm2 = LayerNorm(d, eps=1e-5)
        self.fc1 = Linear(d, int(d * cfg.mlp_ratio), dtype=dtype)
        self.fc2 = Linear(int(d * cfg.mlp_ratio), d, dtype=dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x).to(x.dtype))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x).to(x.dtype))))


def _resize_pos_embed(pe: torch.Tensor, src: Tuple[int, int, int], dst: Tuple[int, int, int]) -> torch.Tensor:
    """Trilinear resize of the patch position embedding from the ``src`` grid
    to ``dst`` (align_corners False, no antialiasing, both directions)."""
    d = pe.shape[-1]
    grid = pe.reshape(1, *src, d).permute(0, 4, 1, 2, 3)
    grid = F.interpolate(grid, size=dst, mode="trilinear", align_corners=False)
    return grid.permute(0, 2, 3, 4, 1).reshape(1, dst[0] * dst[1] * dst[2], d)


class _ViTCore(nn.Module):
    """The shared trunk: cls token, position embedding (resized), blocks,
    final norm; the cls token is dropped at the end."""

    def __init__(self, cfg: MagiVAEConfig, *, dtype):
        super().__init__()
        d = cfg.embed_dim
        lt, ls = cfg.video_length // cfg.patch_length, cfg.video_size // cfg.patch_size
        self.src_shape = (lt, ls, ls)
        n = lt * ls * ls + (1 if cfg.with_cls_token else 0)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, dtype=torch.float32)) if cfg.with_cls_token else None
        self.pos_embed = nn.Parameter(torch.zeros(1, n, d, dtype=torch.float32))
        self.blocks = nn.ModuleList([_VAEBlock(cfg, dtype=dtype) for _ in range(cfg.depth)])
        self.norm = LayerNorm(d, eps=1e-5)

    def forward(self, tok: torch.Tensor, shape: Tuple[int, int, int]) -> torch.Tensor:
        pe = self.pos_embed
        cls_pe, patch_pe = (pe[:, :1], pe[:, 1:]) if self.cls_token is not None else (None, pe)
        if tuple(shape) != self.src_shape:
            patch_pe = _resize_pos_embed(patch_pe, self.src_shape, tuple(shape))
        if self.cls_token is not None:
            tok = torch.cat([self.cls_token.to(tok.dtype).expand(tok.shape[0], 1, tok.shape[-1]), tok], dim=1)
            patch_pe = torch.cat([cls_pe, patch_pe], dim=1)
        tok = tok + patch_pe.to(tok.dtype)
        for blk in self.blocks:
            tok = blk(tok)
        tok = self.norm(tok).to(tok.dtype)
        return tok[:, 1:] if self.cls_token is not None else tok


class MagiViTEncoder(nn.Module):
    def __init__(self, cfg: MagiVAEConfig, *, dtype):
        super().__init__()
        patch_dim = cfg.in_chans * cfg.patch_length * cfg.patch_size ** 2
        self.patch_embed = Linear(patch_dim, cfg.embed_dim, dtype=dtype)
        self.core = _ViTCore(cfg, dtype=dtype)
        self.last_layer = Linear(cfg.embed_dim, cfg.z_chans * (2 if cfg.double_z else 1), dtype=dtype)
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, T, H, W) → moments (B, 2z, T/pt, H/p, W/p)."""
        b, c, t, h, w = x.shape
        pt, p = self.cfg.patch_length, self.cfg.patch_size
        lt, lh, lw = t // pt, h // p, w // p
        tok = x.reshape(b, c, lt, pt, lh, p, lw, p).permute(0, 2, 4, 6, 1, 3, 5, 7)
        tok = self.patch_embed(tok.reshape(b, lt * lh * lw, c * pt * p * p))
        z = self.last_layer(self.core(tok, (lt, lh, lw)))
        return z.reshape(b, lt, lh, lw, -1).permute(0, 4, 1, 2, 3)


class MagiViTDecoder(nn.Module):
    def __init__(self, cfg: MagiVAEConfig, *, dtype):
        super().__init__()
        self.proj_in = Linear(cfg.z_chans, cfg.embed_dim, dtype=dtype)
        self.core = _ViTCore(cfg, dtype=dtype)
        vol = cfg.patch_length * cfg.patch_size ** 2
        if cfg.use_final_proj:
            self.unpatch_channels = 4
            self.final_proj = Linear(cfg.embed_dim, 4 * vol, dtype=dtype)
            self.final_norm = LayerNorm(4 * vol, eps=1e-5)
        else:
            self.unpatch_channels = cfg.embed_dim // vol
            self.final_proj = self.final_norm = None
        self.last_layer = _Conv3d(self.unpatch_channels, 3)
        self.dtype = dtype
        self.cfg = cfg

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, z, T', H', W') → (B, 3, T'·pt, H'·p, W'·p)."""
        b, c, lt, lh, lw = z.shape
        pt, p = self.cfg.patch_length, self.cfg.patch_size
        tok = self.proj_in(z.permute(0, 2, 3, 4, 1).reshape(b, lt * lh * lw, c).to(self.dtype))
        tok = self.core(tok, (lt, lh, lw))
        if self.final_proj is not None:
            tok = self.final_norm(self.final_proj(tok)).to(tok.dtype)
        u = self.unpatch_channels
        x = tok.reshape(b, lt, lh, lw, pt, p, p, u).permute(0, 7, 1, 4, 2, 5, 3, 6)
        return self.last_layer(x.reshape(b, u, lt * pt, lh * p, lw * p).float())


@vae_registry.register("magi.base", aliases=("magi", "AutoencoderKLMagi"))
class AutoencoderKLMagi(nn.Module):
    config_class = MagiVAEConfig

    def __init__(self, cfg: Optional[MagiVAEConfig] = None, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg = cfg or MagiVAEConfig()
        self.encoder = MagiViTEncoder(cfg, dtype=dtype)
        self.decoder = MagiViTDecoder(cfg, dtype=dtype)

    @property
    def spatial_compression_ratio(self) -> int:
        return self.cfg.patch_size

    @property
    def temporal_compression_ratio(self) -> int:
        return self.cfg.patch_length

    def encode(self, video: torch.Tensor, sample: bool = False, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, 3, T, H, W) in [-1, 1] → latents (B, z, T/4, H/8, W/8): the
        posterior mean, or a sample when ``noise`` is given."""
        mean, logvar = self.encoder(video).chunk(2, dim=1)
        if sample and noise is not None:
            return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
        return mean

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)
