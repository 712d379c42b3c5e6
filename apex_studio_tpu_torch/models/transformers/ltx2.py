"""LTX-2 audio-video DiT, port of ``apex_studio_tpu/models/transformers/ltx2.py``.

A dual-stream transformer that denoises video and audio latents together.
Each block runs, per modality: modulated self-attention (qk RMSNorm over the
full inner width, interleaved RoPE through LTX-Video's ``apply_ltx_rope``),
text cross-attention on the raw residual, then audio↔video cross-attention
(a2v: video queries audio; v2a: audio queries video) with time-only RoPE and
per-layer × global modulation, and a tanh-GELU feed-forward.

- Every attention runs on the flash kernel: the self- and AV cross launches
  without a bias, the text cross launches with the ``[B, 1, 1, L]`` key bias
  from ``ctx_mask`` (−1e30 on padded keys, so a fully masked row averages V).
- RoPE tables from host coordinates (numpy, as ``video_coords`` and
  ``audio_coords`` return them) are computed in float64 with the frequencies
  rounded to f32 first, as the JAX host path does, then land on the device as
  f32; coordinates given as a tensor take the f32 path the JAX package takes
  for traced coordinates (its keyframe engines). Host tables are kept per
  coordinate grid, so the steps of a request compute them once.
- The timestep modulation is per token when ``t`` is ``[B, S]``: each table
  row is added in f32 to the model-dtype embedding and cast back, one row at a
  time.
- ``skip_video_self_attn_blocks`` / ``skip_audio_self_attn_blocks`` (STG) and
  ``skip_av_cross_attn`` (the isolated-modality pass) drop those sublayers.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import GELUMLP, Linear, RMSNorm
from apex_studio_tpu_torch.models.registry import transformer_registry
from apex_studio_tpu_torch.models.transformers.ltx import apply_ltx_rope
from apex_studio_tpu_torch.ops.attention import attention


@dataclasses.dataclass
class LTX2Config:
    in_channels: int = 128
    out_channels: int = 128
    num_attention_heads: int = 32
    attention_head_dim: int = 128
    cross_attention_dim: int = 4096
    vae_scale_factors: Tuple[int, int, int] = (8, 32, 32)
    pos_embed_max_pos: int = 20
    base_height: int = 2048
    base_width: int = 2048
    audio_in_channels: int = 128
    audio_out_channels: int = 128
    audio_num_attention_heads: int = 32
    audio_attention_head_dim: int = 64
    audio_cross_attention_dim: int = 2048
    audio_scale_factor: int = 4
    audio_pos_embed_max_pos: int = 20
    audio_sampling_rate: int = 16000
    audio_hop_length: int = 160
    num_layers: int = 48
    caption_channels: int = 3840
    rope_theta: float = 10000.0
    causal_offset: int = 1
    timestep_scale_multiplier: float = 1000.0
    cross_attn_timestep_scale_multiplier: float = 1000.0
    norm_eps: float = 1e-6
    qk_norm_eps: float = 1e-6

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def audio_inner_dim(self) -> int:
        return self.audio_num_attention_heads * self.audio_attention_head_dim

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LTX2Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        if isinstance(kw.get("vae_scale_factors"), list):
            kw["vae_scale_factors"] = tuple(kw["vae_scale_factors"])
        return cls(**kw)


def ltx2_rope(coords, dim: int, theta: float, max_pos: Sequence[float],
              device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """coords [B, A, S] (A axes, in data space) → (cos, sin) [B, S, dim] f32.

    Per axis the fraction of ``max_pos``; frequencies theta**linspace(0, 1)·π/2
    at (2·frac − 1), interleaved frequency-major across the axes, each
    repeated twice; the remainder of ``dim`` padded at the front with cos 1 /
    sin 0. numpy coords take the float64 host path (the frequencies rounded to
    f32 before the angle product), a tensor the f32 path."""
    axes = coords.shape[1]
    n = dim // (axes * 2)
    if isinstance(coords, np.ndarray):
        frac = np.stack([coords[:, i].astype(np.float64) / max_pos[i] for i in range(axes)], axis=-1)
        indices = (theta ** np.linspace(0.0, 1.0, n, dtype=np.float64)
                   * (math.pi / 2)).astype(np.float32).astype(np.float64)
        freqs = indices[None, None, None, :] * (frac[..., None] * 2.0 - 1.0)  # [B, S, A, n]
        freqs = np.swapaxes(freqs, -1, -2).reshape(*freqs.shape[:2], axes * n)
        cos = torch.from_numpy(np.repeat(np.cos(freqs), 2, axis=-1).astype(np.float32)).to(device)
        sin = torch.from_numpy(np.repeat(np.sin(freqs), 2, axis=-1).astype(np.float32)).to(device)
    else:
        coords = coords.to(device) if device is not None else coords
        frac = torch.stack([coords[:, i].float() / max_pos[i] for i in range(axes)], dim=-1)
        indices = theta ** torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=frac.device) * (math.pi / 2)
        freqs = indices * (frac[..., None] * 2.0 - 1.0)
        freqs = freqs.transpose(-1, -2).reshape(*freqs.shape[:2], axes * n)
        cos = torch.cos(freqs).repeat_interleave(2, dim=-1)
        sin = torch.sin(freqs).repeat_interleave(2, dim=-1)
    pad = dim - cos.shape[-1]
    if pad:
        cos = torch.cat([torch.ones_like(cos[..., :pad]), cos], dim=-1)
        sin = torch.cat([torch.zeros_like(sin[..., :pad]), sin], dim=-1)
    return cos, sin


class LTX2Attention(nn.Module):
    """q from ``query_dim``, k/v from ``kv_dim``, inner = heads·head_dim,
    output back to ``query_dim``; qk RMSNorm over the inner width; separate
    q and k RoPE."""

    def __init__(self, query_dim: int, kv_dim: int, heads: int, head_dim: int, *, qk_eps: float, dtype):
        super().__init__()
        inner = heads * head_dim
        self.to_q = Linear(query_dim, inner, dtype=dtype)
        self.to_k = Linear(kv_dim, inner, dtype=dtype)
        self.to_v = Linear(kv_dim, inner, dtype=dtype)
        self.to_out = Linear(inner, query_dim, dtype=dtype)
        self.norm_q = RMSNorm(inner, eps=qk_eps)
        self.norm_k = RMSNorm(inner, eps=qk_eps)
        self.heads = heads
        self.head_dim = head_dim

    def forward(self, x, context=None, q_rope=None, k_rope=None, mask_bias=None):
        b, s, _ = x.shape
        kv_in = x if context is None else context
        q = self.norm_q(self.to_q(x)).to(x.dtype)
        k = self.norm_k(self.to_k(kv_in)).to(x.dtype)
        v = self.to_v(kv_in)
        if q_rope is not None:
            q = apply_ltx_rope(q, *q_rope)
        if k_rope is not None:
            k = apply_ltx_rope(k, *k_rope)
        q = q.reshape(b, s, self.heads, self.head_dim)
        k = k.reshape(b, -1, self.heads, self.head_dim)
        v = v.reshape(b, -1, self.heads, self.head_dim)
        out = attention(q, k, v, bias=mask_bias)
        return self.to_out(out.reshape(b, s, self.heads * self.head_dim))


class AdaLNSingle(nn.Module):
    """PixArt adaLN-single with ``n_params`` modulation rows."""

    def __init__(self, dim: int, n_params: int, *, dtype):
        super().__init__()
        self.emb_1 = Linear(256, dim, dtype=dtype)
        self.emb_2 = Linear(dim, dim, dtype=dtype)
        self.linear = Linear(dim, n_params * dim, dtype=dtype)
        self.n_params = n_params
        self.dim = dim

    def forward(self, t_flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """t_flat [N] → (mod [N, n_params·dim], embedded [N, dim])."""
        half = 128
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t_flat.device) / half)
        args = t_flat.float()[:, None] * freqs[None]
        sincos = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        embedded = self.emb_2(F.silu(self.emb_1(sincos.to(self.emb_1.dtype))))
        return self.linear(F.silu(embedded)), embedded


def _mods(temb: torch.Tensor, table: torch.Tensor, n: int, dt: torch.dtype):
    """temb [B, Tt, n, dim] + table [n, dim], in f32 → n × [B, Tt, dim] in ``dt``."""
    return [(table[i] + temb[:, :, i]).to(dt) for i in range(n)]


class LTX2Block(nn.Module):
    def __init__(self, cfg: LTX2Config, *, dtype):
        super().__init__()
        d, ad = cfg.inner_dim, cfg.audio_inner_dim
        eps, qk = cfg.norm_eps, cfg.qk_norm_eps
        h, hd = cfg.num_attention_heads, cfg.attention_head_dim
        ah, ahd = cfg.audio_num_attention_heads, cfg.audio_attention_head_dim
        kw = dict(dtype=dtype, qk_eps=qk)
        self.norm1 = RMSNorm(d, eps=eps, elementwise_affine=False)
        self.attn1 = LTX2Attention(d, d, h, hd, **kw)
        self.audio_norm1 = RMSNorm(ad, eps=eps, elementwise_affine=False)
        self.audio_attn1 = LTX2Attention(ad, ad, ah, ahd, **kw)
        self.norm2 = RMSNorm(d, eps=eps, elementwise_affine=False)
        self.attn2 = LTX2Attention(d, cfg.cross_attention_dim, h, hd, **kw)
        self.audio_norm2 = RMSNorm(ad, eps=eps, elementwise_affine=False)
        self.audio_attn2 = LTX2Attention(ad, cfg.audio_cross_attention_dim, ah, ahd, **kw)
        # a2v (video queries audio) and v2a (audio queries video) both take the audio head geometry
        self.audio_to_video_norm = RMSNorm(d, eps=eps, elementwise_affine=False)
        self.audio_to_video_attn = LTX2Attention(d, ad, ah, ahd, **kw)
        self.video_to_audio_norm = RMSNorm(ad, eps=eps, elementwise_affine=False)
        self.video_to_audio_attn = LTX2Attention(ad, d, ah, ahd, **kw)
        self.norm3 = RMSNorm(d, eps=eps, elementwise_affine=False)
        self.ff = GELUMLP(d, 4 * d, use_bias=True, approximate=True, dtype=dtype)
        self.audio_norm3 = RMSNorm(ad, eps=eps, elementwise_affine=False)
        self.audio_ff = GELUMLP(ad, 4 * ad, use_bias=True, approximate=True, dtype=dtype)
        self.scale_shift_table = nn.Parameter(torch.empty(6, d, dtype=torch.float32))
        self.audio_scale_shift_table = nn.Parameter(torch.empty(6, ad, dtype=torch.float32))
        self.video_a2v_cross_attn_scale_shift_table = nn.Parameter(torch.empty(5, d, dtype=torch.float32))
        self.audio_a2v_cross_attn_scale_shift_table = nn.Parameter(torch.empty(5, ad, dtype=torch.float32))

    def forward(self, x, xa, ctx, ctx_audio, temb, temb_audio, ca_ss, ca_ss_audio, ca_gate, ca_gate_audio,
                v_rope, a_rope, ca_v_rope, ca_a_rope, ctx_bias=None, ctx_audio_bias=None,
                skip_self_attn=False, skip_audio_self_attn=False, skip_av_cross=False):
        dt = x.dtype
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = _mods(temb, self.scale_shift_table, 6, dt)
        if not skip_self_attn:  # the STG perturbed pass skips video self-attention
            h = self.norm1(x).to(dt) * (1 + sc_msa) + s_msa
            x = x + g_msa * self.attn1(h, q_rope=v_rope, k_rope=v_rope)

        as_msa, asc_msa, ag_msa, as_mlp, asc_mlp, ag_mlp = _mods(temb_audio, self.audio_scale_shift_table, 6, dt)
        if not skip_audio_self_attn:
            ha = self.audio_norm1(xa).to(dt) * (1 + asc_msa) + as_msa
            xa = xa + ag_msa * self.audio_attn1(ha, q_rope=a_rope, k_rope=a_rope)

        # text cross-attention: pre-norm, ungated
        x = x + self.attn2(self.norm2(x).to(dt), context=ctx, mask_bias=ctx_bias)
        xa = xa + self.audio_attn2(self.audio_norm2(xa).to(dt), context=ctx_audio, mask_bias=ctx_audio_bias)

        # audio↔video cross-attention with global × per-layer modulation
        vt = self.video_a2v_cross_attn_scale_shift_table
        at = self.audio_a2v_cross_attn_scale_shift_table
        v_a2v_sc, v_a2v_sh, v_v2a_sc, v_v2a_sh = _mods(ca_ss, vt[:4], 4, dt)
        (a2v_gate,) = _mods(ca_gate, vt[4:], 1, dt)
        a_a2v_sc, a_a2v_sh, a_v2a_sc, a_v2a_sh = _mods(ca_ss_audio, at[:4], 4, dt)
        (v2a_gate,) = _mods(ca_gate_audio, at[4:], 1, dt)

        if not skip_av_cross:  # the isolated-modality guidance pass skips it
            nv = self.audio_to_video_norm(x).to(dt)
            na = self.video_to_audio_norm(xa).to(dt)
            x = x + a2v_gate * self.audio_to_video_attn(
                nv * (1 + v_a2v_sc) + v_a2v_sh, context=na * (1 + a_a2v_sc) + a_a2v_sh,
                q_rope=ca_v_rope, k_rope=ca_a_rope)
            xa = xa + v2a_gate * self.video_to_audio_attn(
                na * (1 + a_v2a_sc) + a_v2a_sh, context=nv * (1 + v_v2a_sc) + v_v2a_sh,
                q_rope=ca_a_rope, k_rope=ca_v_rope)

        h = self.norm3(x).to(dt) * (1 + sc_mlp) + s_mlp
        x = x + g_mlp * self.ff(h)
        ha = self.audio_norm3(xa).to(dt) * (1 + asc_mlp) + as_mlp
        xa = xa + ag_mlp * self.audio_ff(ha)
        return x, xa


def _ln_no_affine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) / torch.sqrt(var + eps)).to(x.dtype)


@transformer_registry.register("ltx2.base", aliases=("ltx2", "LTX2VideoTransformer3DModel"))
class LTX2VideoTransformer3D(nn.Module):
    config_class = LTX2Config
    _ROPE_CACHE_SIZE = 8

    def __init__(self, cfg: LTX2Config, *, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d, ad = cfg.inner_dim, cfg.audio_inner_dim
        self.proj_in = Linear(cfg.in_channels, d, dtype=dtype)
        self.audio_proj_in = Linear(cfg.audio_in_channels, ad, dtype=dtype)
        # PixArtAlphaTextProjection: linear_1, tanh-GELU, linear_2
        self.caption_projection_1 = Linear(cfg.caption_channels, d, dtype=dtype)
        self.caption_projection_2 = Linear(d, d, dtype=dtype)
        self.audio_caption_projection_1 = Linear(cfg.caption_channels, ad, dtype=dtype)
        self.audio_caption_projection_2 = Linear(ad, ad, dtype=dtype)
        self.time_embed = AdaLNSingle(d, 6, dtype=dtype)
        self.audio_time_embed = AdaLNSingle(ad, 6, dtype=dtype)
        self.av_cross_attn_video_scale_shift = AdaLNSingle(d, 4, dtype=dtype)
        self.av_cross_attn_audio_scale_shift = AdaLNSingle(ad, 4, dtype=dtype)
        self.av_cross_attn_video_a2v_gate = AdaLNSingle(d, 1, dtype=dtype)
        self.av_cross_attn_audio_v2a_gate = AdaLNSingle(ad, 1, dtype=dtype)
        self.scale_shift_table = nn.Parameter(torch.empty(2, d, dtype=torch.float32))
        self.audio_scale_shift_table = nn.Parameter(torch.empty(2, ad, dtype=torch.float32))
        self.blocks = nn.ModuleList([LTX2Block(cfg, dtype=dtype) for _ in range(cfg.num_layers)])
        self.proj_out = Linear(d, cfg.out_channels, dtype=dtype)
        self.audio_proj_out = Linear(ad, cfg.audio_out_channels, dtype=dtype)
        self._rope_cache: "OrderedDict[tuple, Tuple[torch.Tensor, torch.Tensor]]" = OrderedDict()

    # -- coordinates ---------------------------------------------------------------

    def video_coords(self, t_lat: int, h_lat: int, w_lat: int, fps: float, batch: int = 1) -> np.ndarray:
        """→ [B, 3, S] float64 patch-midpoint coordinates in (seconds, pixels, pixels)."""
        sf = self.cfg.vae_scale_factors
        grid = np.stack(np.meshgrid(np.arange(t_lat, dtype=np.float64), np.arange(h_lat, dtype=np.float64),
                                    np.arange(w_lat, dtype=np.float64), indexing="ij"))
        mids = []
        for i, s in enumerate(sf):
            start, end = grid[i] * s, (grid[i] + 1) * s
            if i == 0:
                start = np.clip(start + self.cfg.causal_offset - s, 0, None) / fps
                end = np.clip(end + self.cfg.causal_offset - s, 0, None) / fps
            mids.append((start + end) / 2.0)
        coords = np.stack(mids).reshape(3, -1)
        return np.broadcast_to(coords[None], (batch, *coords.shape))

    def audio_coords(self, t_lat: int, batch: int = 1) -> np.ndarray:
        """→ [B, 1, S] float64 latent-frame midpoint timestamps in seconds."""
        cfg = self.cfg
        s = cfg.audio_scale_factor
        gf = np.arange(t_lat, dtype=np.float64)
        start = np.clip(gf * s + cfg.causal_offset - s, 0, None)
        end = np.clip((gf + 1) * s + cfg.causal_offset - s, 0, None)
        secs = ((start + end) / 2.0) * cfg.audio_hop_length / cfg.audio_sampling_rate
        return np.broadcast_to(secs[None, None], (batch, 1, len(gf)))

    def rope(self, coords, dim: int, max_pos: Sequence[float], device) -> Tuple[torch.Tensor, torch.Tensor]:
        """``ltx2_rope`` with the host tables of a coordinate grid kept for
        later calls; a batch of equal rows is computed once and expanded."""
        if not isinstance(coords, np.ndarray):
            return ltx2_rope(coords, dim, self.cfg.rope_theta, max_pos, device)
        b = coords.shape[0]
        rows = coords[:1] if all(np.array_equal(coords[i], coords[0]) for i in range(1, b)) else coords
        rows = np.ascontiguousarray(rows)
        key = (rows.shape, hashlib.sha1(rows.tobytes()).hexdigest(), dim, tuple(max_pos), str(device))
        hit = self._rope_cache.get(key)
        if hit is None:
            hit = ltx2_rope(rows, dim, self.cfg.rope_theta, max_pos, device)
            self._rope_cache[key] = hit
            while len(self._rope_cache) > self._ROPE_CACHE_SIZE:
                self._rope_cache.popitem(last=False)
        else:
            self._rope_cache.move_to_end(key)
        return tuple(t.expand(b, -1, -1) for t in hit)

    def _temb(self, mod_layer: AdaLNSingle, t: torch.Tensor, batch: int):
        mod, emb = mod_layer(t.reshape(-1) * self.cfg.timestep_scale_multiplier)
        return (mod.reshape(batch, -1, mod_layer.n_params, mod_layer.dim),
                emb.reshape(batch, -1, mod_layer.dim))

    def forward(self, x: torch.Tensor, xa: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor,
                video_shape: Tuple[int, int, int], fps: float = 25.0, t_audio: Optional[torch.Tensor] = None,
                ctx_audio: Optional[torch.Tensor] = None, ctx_mask: Optional[torch.Tensor] = None,
                video_coords=None, skip_video_self_attn_blocks: Optional[Sequence[int]] = None,
                skip_audio_self_attn_blocks: Optional[Sequence[int]] = None,
                skip_av_cross_attn: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, S, in] video tokens, xa [B, Sa, audio_in], t [B] or [B, S] in
        [0, 1], ctx [B, L, caption] → (video, audio) outputs in f32.
        ``video_coords`` [B, 3, S] overrides the grid of ``video_shape`` (the
        keyframe engines' appended tokens)."""
        cfg = self.cfg
        b = x.shape[0]
        dev = x.device
        if t_audio is None:
            # per-token video timesteps do not map onto the audio stream: it
            # takes the denoise level of the first token
            t_audio = t if t.ndim == 1 else t[:, 0]

        vc = video_coords if video_coords is not None else self.video_coords(*video_shape, fps=fps, batch=b)
        ac = self.audio_coords(xa.shape[1], batch=b)
        d, ad = cfg.inner_dim, cfg.audio_inner_dim
        v_rope = self.rope(vc, d, (cfg.pos_embed_max_pos, cfg.base_height, cfg.base_width), dev)
        a_rope = self.rope(ac, ad, (cfg.audio_pos_embed_max_pos,), dev)
        ca_max = (max(cfg.pos_embed_max_pos, cfg.audio_pos_embed_max_pos),)
        ca_v_rope = self.rope(vc[:, :1], cfg.audio_cross_attention_dim, ca_max, dev)
        ca_a_rope = self.rope(ac, cfg.audio_cross_attention_dim, ca_max, dev)

        x = self.proj_in(x.to(self.dtype))
        xa = self.audio_proj_in(xa.to(self.dtype))
        ctx = ctx.to(self.dtype)
        # with the connectors each stream reads its own text; without, both read the same
        ctx_a_src = ctx if ctx_audio is None else ctx_audio.to(self.dtype)
        ctx_v = self.caption_projection_2(F.gelu(self.caption_projection_1(ctx), approximate="tanh"))
        ctx_a = self.audio_caption_projection_2(F.gelu(self.audio_caption_projection_1(ctx_a_src),
                                                       approximate="tanh"))
        ctx_bias = None
        if ctx_mask is not None:
            keep = ctx_mask[:, None, None, :].bool()
            ctx_bias = torch.where(keep, torch.zeros((), device=dev), torch.full((), -1e30, device=dev))

        temb, emb_t = self._temb(self.time_embed, t, b)
        temb_a, emb_ta = self._temb(self.audio_time_embed, t_audio, b)
        gs = cfg.cross_attn_timestep_scale_multiplier / cfg.timestep_scale_multiplier
        ca_ss, _ = self._temb(self.av_cross_attn_video_scale_shift, t, b)
        ca_ss_a, _ = self._temb(self.av_cross_attn_audio_scale_shift, t_audio, b)
        ca_g, _ = self._temb(self.av_cross_attn_video_a2v_gate, t * gs, b)
        ca_g_a, _ = self._temb(self.av_cross_attn_audio_v2a_gate, t_audio * gs, b)

        skip_v = set(skip_video_self_attn_blocks or ())
        skip_a = set(skip_audio_self_attn_blocks or ())
        for bi, blk in enumerate(self.blocks):
            x, xa = blk(x, xa, ctx_v, ctx_a, temb, temb_a, ca_ss, ca_ss_a, ca_g, ca_g_a,
                        v_rope, a_rope, ca_v_rope, ca_a_rope, ctx_bias=ctx_bias, ctx_audio_bias=ctx_bias,
                        skip_self_attn=bi in skip_v, skip_audio_self_attn=bi in skip_a,
                        skip_av_cross=skip_av_cross_attn)

        sst = self.scale_shift_table
        shift = (emb_t + sst[None, 0]).to(x.dtype)
        scale = (emb_t + sst[None, 1]).to(x.dtype)
        out_v = self.proj_out(_ln_no_affine(x) * (1 + scale) + shift)
        asst = self.audio_scale_shift_table
        a_shift = (emb_ta + asst[None, 0]).to(xa.dtype)
        a_scale = (emb_ta + asst[None, 1]).to(xa.dtype)
        out_a = self.audio_proj_out(_ln_no_affine(xa) * (1 + a_scale) + a_shift)
        return out_v.float(), out_a.float()
