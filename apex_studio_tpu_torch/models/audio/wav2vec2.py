"""Wav2Vec2 speech encoder, port of ``apex_studio_tpu/models/audio/wav2vec2.py``
(HF ``Wav2Vec2Model``, HuMo's audio encoder).

- a 7-layer strided conv feature extractor (a per-channel group norm after
  the first conv, or a layer norm after each: ``feat_extract_norm``), exact
  GELU;
- feature projection (layer norm, Linear), then the weight-normalised
  grouped positional conv (weight = g · v / ‖v‖ over the last two axes as
  the checkpoint stores them, normalised at call time) with one trailing
  output dropped for an even kernel;
- a post-norm (or, with ``do_stable_layer_norm``, pre-norm) transformer
  encoder; the forward returns every hidden state, embeddings first;
- optionally the conv features linearly resampled in time to ``seq_len``
  (``interpolate_linear``, ``align_corners=True``) before the encoder.

Everything runs in f32 whatever dtype the manifest names, as in JAX. The
attention takes the default route, as the JAX module's does: the flash
kernel on the card (f32 in and out, bf16 tiles inside), its plain version on
the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import LayerNorm, Linear
from apex_studio_tpu_torch.models.registry import text_encoder_registry
from apex_studio_tpu_torch.ops.attention import attention as attention_op


@dataclasses.dataclass
class Wav2Vec2Config:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    feat_extract_norm: str = "group"      # "group" | "layer"
    do_stable_layer_norm: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_dict(cls, cfg: dict) -> "Wav2Vec2Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        for key in ("conv_dim", "conv_kernel", "conv_stride"):
            if key in kw:
                kw[key] = tuple(kw[key])
        return cls(**kw)


class _Conv1d(nn.Module):
    """Conv1d over [B, L, C]; weight [Cout, Cin/groups, K]."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(cout, dtype=torch.float32)) if use_bias else None
        self.stride = stride

    def forward(self, x):
        return F.conv1d(x.transpose(1, 2), self.weight, self.bias, stride=self.stride).transpose(1, 2)


class _GroupNormCh(nn.Module):
    """Group norm over the channels of [B, L, C] (the feature extractor's
    groups == channels: a per-channel norm over time), in f32."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32))
        self.groups, self.eps = groups, eps

    def forward(self, x):
        return F.group_norm(x.float().transpose(1, 2), self.groups, self.weight, self.bias,
                            self.eps).transpose(1, 2).to(x.dtype)


class _ConvLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, i: int):
        super().__init__()
        cin = 1 if i == 0 else cfg.conv_dim[i - 1]
        cout = cfg.conv_dim[i]
        self.conv = _Conv1d(cin, cout, cfg.conv_kernel[i], cfg.conv_stride[i],
                            use_bias=cfg.feat_extract_norm == "layer")
        if i == 0 and cfg.feat_extract_norm == "group":
            self.layer_norm = _GroupNormCh(cout, cout)
        elif cfg.feat_extract_norm == "layer":
            self.layer_norm = LayerNorm(cout, eps=cfg.layer_norm_eps)
        else:
            self.layer_norm = None

    def forward(self, x):
        x = self.conv(x)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        d = cfg.hidden_size
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Linear(d, d, dtype=torch.float32))
        self.layer_norm = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.intermediate_dense = Linear(d, cfg.intermediate_size, dtype=torch.float32)
        self.output_dense = Linear(cfg.intermediate_size, d, dtype=torch.float32)
        self.final_layer_norm = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.heads = cfg.num_attention_heads
        self.head_dim = d // cfg.num_attention_heads
        self.stable = cfg.do_stable_layer_norm

    def _attn(self, x, mask):
        b, s, d = x.shape
        shape = (b, s, self.heads, self.head_dim)
        q, k, v = self.q_proj(x).reshape(shape), self.k_proj(x).reshape(shape), self.v_proj(x).reshape(shape)
        return self.out_proj(attention_op(q, k, v, mask=mask).reshape(b, s, d))

    def _ff(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))

    def forward(self, x, mask=None):
        if self.stable:
            x = x + self._attn(self.layer_norm(x), mask)
            return x + self._ff(self.final_layer_norm(x))
        x = self.layer_norm(x + self._attn(x, mask))
        return self.final_layer_norm(x + self._ff(x))


@text_encoder_registry.register("Wav2Vec2Model", aliases=("wav2vec2",))
class Wav2Vec2Model(nn.Module):
    config_class = Wav2Vec2Config

    def __init__(self, cfg: Wav2Vec2Config, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = torch.float32  # audio features stay f32
        d = cfg.hidden_size
        self.conv_layers = nn.ModuleList([_ConvLayer(cfg, i) for i in range(len(cfg.conv_dim))])
        self.fp_layer_norm = LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.fp_projection = Linear(cfg.conv_dim[-1], d, dtype=torch.float32)
        k, g = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
        self.pos_conv_g = nn.Parameter(torch.ones(1, 1, k, dtype=torch.float32))
        self.pos_conv_v = nn.Parameter(torch.empty(d, d // g, k, dtype=torch.float32))
        self.pos_conv_bias = nn.Parameter(torch.zeros(d, dtype=torch.float32))
        self.enc_layer_norm = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList([_EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])

    def _pos_conv(self, x):
        k = self.cfg.num_conv_pos_embeddings
        v = self.pos_conv_v
        w = self.pos_conv_g * v / torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True) + 1e-12)
        y = F.conv1d(x.transpose(1, 2), w, self.pos_conv_bias, padding=k // 2,
                     groups=self.cfg.num_conv_pos_embedding_groups).transpose(1, 2)
        if k % 2 == 0:  # SamePadLayer drops the trailing output
            y = y[:, :-1]
        return F.gelu(y)

    def extract_features(self, input_values: torch.Tensor) -> torch.Tensor:
        """[B, samples] waveform → [B, L, conv_dim[-1]] conv features."""
        x = input_values.float()[..., None]
        for layer in self.conv_layers:
            x = layer(x)
        return x

    def encode_features(self, features: torch.Tensor, mask: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """Conv features → the hidden states (embeddings, then each layer)."""
        x = self.fp_projection(self.fp_layer_norm(features))
        x = x + self._pos_conv(x)
        if not self.cfg.do_stable_layer_norm:
            x = self.enc_layer_norm(x)
        states = [x]
        for layer in self.layers:
            x = layer(x, mask)
            states.append(x)
        if self.cfg.do_stable_layer_norm:
            states[-1] = self.enc_layer_norm(x)
        return states

    def forward(self, input_values: torch.Tensor, seq_len: Optional[int] = None) -> List[torch.Tensor]:
        feats = self.extract_features(input_values)
        if seq_len is not None and feats.shape[1] != seq_len:
            feats = interpolate_linear(feats, seq_len)
        return self.encode_features(feats)


def interpolate_linear(features: torch.Tensor, out_len: int) -> torch.Tensor:
    """``F.interpolate(mode='linear', align_corners=True)`` over the time
    axis of [B, L, C], as the JAX function computes it (f32 positions)."""
    b, n, c = features.shape
    if n == out_len:
        return features
    if n == 1:
        return features.expand(b, out_len, c)
    pos = torch.linspace(0.0, n - 1.0, out_len, dtype=torch.float32, device=features.device)
    lo = pos.floor().long().clamp(0, n - 1)
    hi = (lo + 1).clamp(0, n - 1)
    w = (pos - lo.float())[None, :, None]
    return features[:, lo] * (1 - w) + features[:, hi] * w
