"""SAM2 promptable segmentation (port of ``apex_studio_tpu/mask/sam2.py``).

- Hiera trunk (windowed attention, query pooling between stages, global
  attention at selected blocks) and an FPN neck: a 256-channel embedding at
  stride 16 with stride-4/8 skip features
- SAM's prompt encoder: a random-Fourier positional encoding, point and box
  labels
- SAM's two-way mask decoder: token↔image attention, transposed-conv
  upscaling with high-res skips, per-mask hypernetwork MLPs, an IoU head and
  SAM2's object-score token
- the video memory bank: the memory encoder and memory attention
  (``SAM2VideoModel``)

Tensors are NHWC at every function, as in the JAX module, and the attribute
names are the JAX module's, so ``loaders/from_jax.py`` carries its parameters
(a conv kernel becomes an OIHW ``weight``). The model is f32, as in JAX. Every
Hiera and mask-decoder attention goes through the port's ``attention``, so on
the card it runs on the hand flash kernel (bf16 tiles, f32 out, the head dims
56 / 72 / 96 of the published trunks and the decoder's 32 and 16); on the CPU
it runs the kernel's plain version. The memory attention is an einsum
softmax in JAX, outside ``attention_op``, and stays plain PyTorch here.

Mirrored from the JAX module as it is: a q-pool block (the first of stages
2-4) attends globally, not inside its windows ("pool transitions use global
attention"), so at 1024² on Hiera-B+ its stage-2 transition scores 16,384
queries against 65,536 keys (ROADMAP Queue 3 records the departure from the
published Hiera, which pools inside windows).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_studio_tpu_torch.models.layers import LayerNorm, Linear
from apex_studio_tpu_torch.ops.attention import attention
from apex_studio_tpu_torch.utils.jax_resize import resize as jax_resize


@dataclasses.dataclass
class SAM2Config:
    # Hiera trunk (defaults = sam2-hiera-small-ish; tiny configs in tests)
    embed_dim: int = 96
    num_heads: int = 1
    stages: Tuple[int, ...] = (1, 2, 11, 2)
    window_specs: Tuple[int, ...] = (8, 4, 14, 7)
    global_att_blocks: Tuple[int, ...] = (7, 10, 13)
    img_size: int = 1024
    patch_kernel: int = 7
    patch_stride: int = 4
    patch_padding: int = 3
    # Neck / decoder
    d_model: int = 256
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_multimask_outputs: int = 3

    @classmethod
    def from_dict(cls, cfg: dict) -> "SAM2Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in cfg.items() if k in known}
        for key in ("stages", "window_specs", "global_att_blocks"):
            if key in kw:
                kw[key] = tuple(kw[key])
        return cls(**kw)


def _param(*shape, std: float = 0.0, fill: float = 0.0) -> nn.Parameter:
    """normal(0, std), else ``fill``. On the ``meta`` device (a module built
    to be filled from a checkpoint) nothing is drawn."""
    t = torch.full(shape, float(fill))
    if std and not t.is_meta:
        t.normal_(0.0, std)
    return nn.Parameter(t)


def _linear(cin: int, cout: int) -> Linear:
    """An f32 Linear with JAX's initialisers (lecun normal, zero bias)."""
    lin = Linear(cin, cout, dtype=torch.float32)
    lin.weight, lin.bias = _param(cout, cin, std=cin ** -0.5), _param(cout)
    return lin


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """``reduce_window(max, (1, 2, 2, 1), VALID)`` on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


# ------------------------------------------------------------------ Hiera trunk


class Conv2dHW(nn.Module):
    """Conv over NHWC; ``weight`` OIHW."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, groups=1):
        super().__init__()
        k = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        fan_in = cin // groups * k[0] * k[1]
        self.weight = _param(cout, cin // groups, *k, std=fan_in ** -0.5)
        self.bias = _param(cout)
        self.stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
        self.padding = (padding, padding) if isinstance(padding, int) else tuple(padding)
        self.groups = groups

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias, self.stride, self.padding,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)


def _window_partition(x, w):
    b, h, wdt, c = x.shape
    ph, pw = (-h) % w, (-wdt) % w
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hh, ww = x.shape[1], x.shape[2]
    x = x.reshape(b, hh // w, w, ww // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w, w, c), (hh, ww)


def _window_unpartition(win, w, padded_hw, orig_hw):
    hh, ww = padded_hw
    h, wdt = orig_hw
    b = win.shape[0] // ((hh // w) * (ww // w))
    x = win.reshape(b, hh // w, ww // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, hh, ww, -1)
    return x[:, :h, :wdt]


class HieraBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, heads: int, window: int, q_pool: bool):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.qkv = _linear(dim, 3 * dim_out)
        self.proj_attn = _linear(dim_out, dim_out)
        self.norm2 = LayerNorm(dim_out, eps=1e-6)
        self.mlp_lin1 = _linear(dim_out, 4 * dim_out)
        self.mlp_lin2 = _linear(4 * dim_out, dim_out)
        self.proj = _linear(dim, dim_out) if dim != dim_out else None
        self.dim, self.dim_out, self.heads = dim, dim_out, heads
        self.window = window
        self.q_pool = q_pool

    def _attend(self, x):
        b, h, w, _ = x.shape
        qkv = self.qkv(x).reshape(b, h * w, 3, self.heads, -1)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.q_pool:
            # Query pooling: 2x2 max-pool on q (Hiera stage transition).
            hd = q.shape[-1]
            qm = max_pool_2x2(q.reshape(b, h, w, self.heads * hd))
            h2, w2 = qm.shape[1], qm.shape[2]
            q = qm.reshape(b, h2 * w2, self.heads, hd)
            out = attention(q, k, v).reshape(b, h2, w2, -1)
        else:
            out = attention(q, k, v).reshape(b, h, w, -1)
        return self.proj_attn(out)

    def forward(self, x):
        shortcut = x
        y = self.norm1(x)
        if self.proj is not None:
            # Stage transition: project the residual and pool it like q.
            shortcut = self.proj(y)
        if self.q_pool:
            shortcut = max_pool_2x2(shortcut)
        if self.window > 0 and not self.q_pool:
            win, padded = _window_partition(y, self.window)
            att = _window_unpartition(self._attend(win), self.window, padded, y.shape[1:3])
        else:
            # global blocks, and q-pool blocks (global in the JAX module)
            att = self._attend(y)
        x = shortcut + att
        return x + self.mlp_lin2(F.gelu(self.mlp_lin1(self.norm2(x))))


class HieraTrunk(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.patch_embed = Conv2dHW(3, cfg.embed_dim, cfg.patch_kernel, cfg.patch_stride, cfg.patch_padding)
        side = cfg.img_size // cfg.patch_stride
        self.pos_embed = _param(1, side, side, cfg.embed_dim, std=0.02)
        blocks = []
        self.channel_list: List[int] = []
        dim, heads = cfg.embed_dim, cfg.num_heads
        idx = 0
        stage_ends = []
        for s, depth in enumerate(cfg.stages):
            window = cfg.window_specs[s]
            for d in range(depth):
                q_pool = s > 0 and d == 0
                dim_out = dim * 2 if q_pool else dim
                h_out = heads * 2 if q_pool else heads
                win = 0 if idx in cfg.global_att_blocks else window
                blocks.append(HieraBlock(dim, dim_out, h_out, win, q_pool))
                dim, heads = dim_out, h_out
                idx += 1
            self.channel_list.append(dim)
            stage_ends.append(idx - 1)
        self.blocks = nn.ModuleList(blocks)
        self._stage_ends = stage_ends

    def forward(self, x):  # x: [B, H, W, 3]
        x = self.patch_embed(x)
        pe = self.pos_embed
        if pe.shape[1:3] != x.shape[1:3]:
            pe = jax_resize(pe, (1, x.shape[1], x.shape[2], pe.shape[-1]), "bilinear")
        x = x + pe
        feats = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self._stage_ends:
                feats.append(x)
        return feats  # strides 4, 8, 16, 32


class FpnNeck(nn.Module):
    """1x1 convs to d_model + the top-down sum of the two deepest levels."""

    def __init__(self, cfg: SAM2Config, channel_list: Sequence[int]):
        super().__init__()
        self.convs = nn.ModuleList([Conv2dHW(c, cfg.d_model, 1, 1, 0) for c in channel_list])

    def forward(self, feats):
        outs = [conv(f) for conv, f in zip(self.convs, feats)]
        if len(outs) >= 2:
            i = len(outs) - 2
            outs[i] = outs[i] + jax_resize(outs[i + 1], outs[i].shape, "nearest")
        return outs


# ------------------------------------------------------ prompt encoder / decoder


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        d = cfg.d_model
        # Random-Fourier positional encoding matrix (SAM PositionEmbeddingRandom).
        self.pe_gaussian = _param(2, d // 2, std=1.0)
        # 0: neg point, 1: pos point, 2: box TL, 3: box BR (+ not-a-point).
        self.point_embeddings = nn.ParameterList([_param(1, d, std=0.02) for _ in range(4)])
        self.not_a_point_embed = _param(1, d, std=0.02)
        self.no_mask_embed = _param(1, d, std=0.02)
        self.d_model = d

    def encode_coords(self, coords01: torch.Tensor) -> torch.Tensor:
        """[..., 2] normalized (x, y) in [0,1] → [..., d_model]."""
        c = 2.0 * coords01 - 1.0
        proj = (2.0 * math.pi) * (c @ self.pe_gaussian)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def dense_pe(self, h: int, w: int) -> torch.Tensor:
        dev = self.pe_gaussian.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)  # [h,w,2]
        return self.encode_coords(grid)

    def forward(self, points01: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """points01: [B, N, 2] in [0,1]; labels: [B, N] ∈ {-1 pad, 0 neg,
        1 pos, 2 box TL, 3 box BR} → sparse embeddings [B, N, d]."""
        pe = self.encode_coords(points01)
        table = torch.cat(list(self.point_embeddings) + [self.not_a_point_embed], dim=0)  # [5, d]
        idx = torch.where(labels < 0, torch.full_like(labels, 4), labels).long()
        typ = table[idx]
        pad = (labels < 0)[..., None]
        return torch.where(pad, typ, pe + typ)


class TwoWayAttention(nn.Module):
    def __init__(self, d: int, heads: int, downsample: int = 1):
        super().__init__()
        inner = d // downsample
        self.q_proj = _linear(d, inner)
        self.k_proj = _linear(d, inner)
        self.v_proj = _linear(d, inner)
        self.out_proj = _linear(inner, d)
        self.heads = heads
        self.head_dim = inner // heads

    def forward(self, q, k, v):
        b, nq, _ = q.shape
        nk = k.shape[1]
        qh = self.q_proj(q).reshape(b, nq, self.heads, self.head_dim)
        kh = self.k_proj(k).reshape(b, nk, self.heads, self.head_dim)
        vh = self.v_proj(v).reshape(b, nk, self.heads, self.head_dim)
        return self.out_proj(attention(qh, kh, vh).reshape(b, nq, -1))


class TwoWayBlock(nn.Module):
    def __init__(self, cfg: SAM2Config, skip_first_pe: bool):
        super().__init__()
        d, h = cfg.d_model, cfg.decoder_heads
        self.self_attn = TwoWayAttention(d, h)
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.cross_attn_token_to_image = TwoWayAttention(d, h, 2)
        self.norm2 = LayerNorm(d, eps=1e-5)
        self.mlp_lin1 = _linear(d, cfg.decoder_mlp_dim)
        self.mlp_lin2 = _linear(cfg.decoder_mlp_dim, d)
        self.norm3 = LayerNorm(d, eps=1e-5)
        self.cross_attn_image_to_token = TwoWayAttention(d, h, 2)
        self.norm4 = LayerNorm(d, eps=1e-5)
        self.skip_first_pe = skip_first_pe

    def forward(self, tokens, image, token_pe, image_pe):
        q = tokens if self.skip_first_pe else tokens + token_pe
        tokens = self.norm1(tokens + self.self_attn(q, q, tokens))
        q = tokens + token_pe
        k = image + image_pe
        tokens = self.norm2(tokens + self.cross_attn_token_to_image(q, k, image))
        tokens = self.norm3(tokens + self.mlp_lin2(F.relu(self.mlp_lin1(tokens))))
        q = tokens + token_pe
        image = self.norm4(image + self.cross_attn_image_to_token(k, q, tokens))
        return tokens, image


class MLP(nn.Module):
    def __init__(self, din, dhid, dout, depth, sigmoid=False):
        super().__init__()
        dims = [din] + [dhid] * (depth - 1) + [dout]
        self.layers = nn.ModuleList([_linear(dims[i], dims[i + 1]) for i in range(depth)])
        self.sigmoid = sigmoid

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return torch.sigmoid(x) if self.sigmoid else x


class ConvTranspose2x(nn.Module):
    """``lax.conv_transpose`` with a 2x2 HWIO kernel, stride 2, VALID: output
    pixel (2i + a, 2j + b) takes kernel tap (1 - a, 1 - b). ``weight`` is the
    kernel as OIHW (what ``from_jax`` makes of it); torch's transposed
    convolution takes it as [in, out] with the taps flipped."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = _param(cout, cin, 2, 2, std=(4 * cin) ** -0.5)
        self.bias = _param(cout)

    def forward(self, x):
        w = self.weight.transpose(0, 1).flip(2, 3)
        return F.conv_transpose2d(x.permute(0, 3, 1, 2), w, self.bias, stride=2).permute(0, 2, 3, 1)


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        d = cfg.d_model
        n_masks = cfg.num_multimask_outputs + 1
        self.iou_token = _param(1, d, std=0.02)
        self.mask_tokens = _param(n_masks, d, std=0.02)
        self.obj_score_token = _param(1, d, std=0.02)
        self.layers = nn.ModuleList([TwoWayBlock(cfg, skip_first_pe=(i == 0)) for i in range(cfg.decoder_depth)])
        self.final_attn_token_to_image = TwoWayAttention(d, cfg.decoder_heads, 2)
        self.norm_final_attn = LayerNorm(d, eps=1e-5)
        self.upscale1 = ConvTranspose2x(d, d // 4)
        self.upscale2 = ConvTranspose2x(d // 4, d // 8)
        self.upscale_norm = LayerNorm(d // 4, eps=1e-6)
        self.output_hypernetworks_mlps = nn.ModuleList([MLP(d, d, d // 8, 3) for _ in range(n_masks)])
        self.iou_prediction_head = MLP(d, d, n_masks, 3)
        self.pred_obj_score_head = MLP(d, d, 1, 3)
        self.n_masks = n_masks

    def forward(self, image_embed, image_pe, sparse_prompt, hires_feats=None):
        """image_embed [B,h,w,d]; sparse_prompt [B,N,d] → (masks [B,M,4h,4w],
        iou [B,M], obj_score [B,1])."""
        b, h, w, d = image_embed.shape
        tokens = torch.cat([
            self.obj_score_token[None].expand(b, 1, d),
            self.iou_token[None].expand(b, 1, d),
            self.mask_tokens[None].expand(b, self.n_masks, d),
            sparse_prompt,
        ], dim=1)
        token_pe = tokens  # SAM adds the prompt tokens themselves as PE
        image = image_embed.reshape(b, h * w, d)
        img_pe = image_pe.reshape(1, h * w, d).expand(b, h * w, d)

        x_img = image
        for blk in self.layers:
            tokens, x_img = blk(tokens, x_img, token_pe, img_pe)
        q = tokens + token_pe
        tokens = self.norm_final_attn(tokens + self.final_attn_token_to_image(q, x_img + img_pe, x_img))

        obj_tok = tokens[:, 0]
        iou_tok = tokens[:, 1]
        mask_toks = tokens[:, 2:2 + self.n_masks]

        up = self.upscale1(x_img.reshape(b, h, w, d))
        if hires_feats is not None and hires_feats[0] is not None:
            up = up + hires_feats[0]  # stride-8 skip (d/4 channels)
        up = F.gelu(self.upscale_norm(up))
        up = self.upscale2(up)
        if hires_feats is not None and hires_feats[1] is not None:
            up = up + hires_feats[1]  # stride-4 skip (d/8 channels)
        up = F.gelu(up)  # [B, 4h, 4w, d/8]

        hyper = torch.stack([mlp(mask_toks[:, i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)],
                            dim=1)  # [B, M, d/8]
        masks = torch.einsum("bmc,bhwc->bmhw", hyper, up)
        return masks, self.iou_prediction_head(iou_tok), self.pred_obj_score_head(obj_tok)


# ----------------------------------------------------------------- full model


class SAM2ImageModel(nn.Module):
    config_class = SAM2Config

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        self.trunk = HieraTrunk(cfg)
        self.neck = FpnNeck(cfg, self.trunk.channel_list)
        d = cfg.d_model
        # High-res skip projections (SAM2 conv_s0/conv_s1 1x1 convs).
        self.conv_s0 = Conv2dHW(d, d // 8, 1, 1, 0)
        self.conv_s1 = Conv2dHW(d, d // 4, 1, 1, 0)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    def encode_image(self, image01: torch.Tensor):
        """image01: [B, H, W, 3] in [0,1], normalized inside."""
        mean = torch.tensor([0.485, 0.456, 0.406], device=image01.device)
        std = torch.tensor([0.229, 0.224, 0.225], device=image01.device)
        outs = self.neck(self.trunk((image01 - mean) / std))
        s4, s8, s16 = outs[0], outs[1], outs[2]
        return s16, self.conv_s1(s8), self.conv_s0(s4)

    def predict(self, image01, points01, labels):
        """→ (mask_logits [B,M,H/4,W/4], iou [B,M], obj [B,1])."""
        s16, hi_s8, hi_s4 = self.encode_image(image01)
        pe = self.prompt_encoder.dense_pe(s16.shape[1], s16.shape[2])[None]
        sparse = self.prompt_encoder(points01, labels)
        return self.mask_decoder(s16, pe, sparse, hires_feats=(hi_s8, hi_s4))


# ------------------------------------------------------------------------------
# Video memory bank (SAM2 memory attention + memory encoder)
# ------------------------------------------------------------------------------


class LayerNorm2d(nn.Module):
    """Channel LayerNorm over [B,H,W,C] (sam2 LayerNorm2d; weights [C])."""

    def __init__(self, dim):
        super().__init__()
        self.weight = _param(dim, fill=1.0)
        self.bias = _param(dim)

    def forward(self, x):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        return ((x32 - mu) / torch.sqrt(var + 1e-6) * self.weight + self.bias).to(x.dtype)


def _gelu_tanh(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class MaskDownSampler(nn.Module):
    """sam2 memory_encoder.mask_downsampler: 4× stride-2 3x3 convs
    (1→4→16→64→256) each followed by LayerNorm2d+GELU, then a 1x1 conv."""

    def __init__(self, d: int):
        super().__init__()
        chans = [1, 4, 16, 64, 256]
        layers = []
        for i in range(4):
            layers += [Conv2dHW(chans[i], chans[i + 1], 3, 2, 1), LayerNorm2d(chans[i + 1])]
        self.encoder = nn.ModuleList(layers + [Conv2dHW(256, d, 1, 1, 0)])

    def forward(self, m):  # [B,H,W,1] mask (16x total downsample)
        x = m
        for i in range(4):
            x = _gelu_tanh(self.encoder[2 * i + 1](self.encoder[2 * i](x)))
        return self.encoder[8](x)


class CXBlock(nn.Module):
    """ConvNeXt block (sam2 memory_encoder.fuser.layers): depthwise 7x7,
    LayerNorm, pointwise MLP ×4, layer-scale gamma."""

    def __init__(self, d: int):
        super().__init__()
        self.dwconv = Conv2dHW(d, d, 7, 1, 3, groups=d)
        self.norm = LayerNorm2d(d)
        self.pwconv1 = _linear(d, 4 * d)
        self.pwconv2 = _linear(4 * d, d)
        self.gamma = _param(d, fill=1e-6)

    def forward(self, x):  # [B,H,W,C]
        h = self.norm(self.dwconv(x))
        h = self.pwconv2(_gelu_tanh(self.pwconv1(h)))
        return x + h * self.gamma


class MemoryEncoder(nn.Module):
    """sam2 memory_encoder: downsampled mask + projected pixel features →
    fused 64-dim memory features."""

    def __init__(self, d_model: int, d_mem: int):
        super().__init__()
        self.mask_downsampler = MaskDownSampler(d_model)
        self.pix_feat_proj = Conv2dHW(d_model, d_model, 1, 1, 0)
        self.fuser = nn.ModuleList([CXBlock(d_model) for _ in range(2)])
        self.out_proj = Conv2dHW(d_model, d_mem, 1, 1, 0)

    def forward(self, pix_feat, mask_logits_hi):
        """pix_feat [B,h,w,256]; mask_logits_hi [B,16h,16w,1]: sigmoid, then
        downsampled."""
        x = self.pix_feat_proj(pix_feat) + self.mask_downsampler(torch.sigmoid(mask_logits_hi))
        for blk in self.fuser:
            x = blk(x)
        return self.out_proj(x)


class _MemAttention(nn.Module):
    """Plain einsum softmax attention (the JAX module's, outside
    ``attention_op``): f32 scores over every memory token."""

    def __init__(self, d: int, kv_in: int, heads: int):
        super().__init__()
        self.q_proj = _linear(d, d)
        self.k_proj = _linear(kv_in, d)
        self.v_proj = _linear(kv_in, d)
        self.out_proj = _linear(d, d)
        self.heads = heads
        self.d = d

    def forward(self, q, k, v):
        b = q.shape[0]
        hd = self.d // self.heads
        qh = self.q_proj(q).reshape(b, -1, self.heads, hd)
        kh = self.k_proj(k).reshape(b, -1, self.heads, hd)
        vh = self.v_proj(v).reshape(b, -1, self.heads, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", qh, kh).float() / math.sqrt(hd)
        attn = torch.softmax(attn, dim=-1).to(vh.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(b, -1, self.d)
        return self.out_proj(out)


class MemAttnLayer(nn.Module):
    """memory_attention.layers.N: self-attention on the current frame,
    cross-attention to the memory tokens (kv dim 64), MLP."""

    def __init__(self, d: int, d_mem: int, heads: int = 1):
        super().__init__()
        self.self_attn = _MemAttention(d, d, heads)
        self.cross_attn_image = _MemAttention(d, d_mem, heads)
        self.linear1 = _linear(d, 4 * d)
        self.linear2 = _linear(4 * d, d)
        self.norm1 = LayerNorm2d(d)
        self.norm2 = LayerNorm2d(d)
        self.norm3 = LayerNorm2d(d)

    def forward(self, x, mem_kv, x_pe, mem_pe):
        h = self.norm1(x)
        x = x + self.self_attn(h + x_pe, h + x_pe, h)
        h = self.norm2(x)
        x = x + self.cross_attn_image(h + x_pe, mem_kv + mem_pe, mem_kv)
        h = self.norm3(x)
        return x + self.linear2(F.relu(self.linear1(h)))


class SAM2VideoModel(SAM2ImageModel):
    """SAM2 with the video memory bank: each frame's features are conditioned
    on encoded memories of earlier frames before the mask decoder runs
    promptless, and each predicted mask is encoded into the rolling bank."""

    NUM_MASKMEM = 7

    def __init__(self, cfg: SAM2Config):
        super().__init__(cfg)
        d = cfg.d_model
        d_mem = getattr(cfg, "mem_dim", 64)
        self.memory_encoder = MemoryEncoder(d, d_mem)
        self.memory_attention = nn.ModuleList([MemAttnLayer(d, d_mem) for _ in range(4)])
        self.memory_attention_norm = LayerNorm2d(d)
        self.obj_ptr_proj = MLP(d, d, d, 3)
        self.no_mem_embed = _param(1, 1, d)
        self.maskmem_tpos_enc = _param(self.NUM_MASKMEM, 1, 1, d_mem)
        self._d_mem = d_mem

    def condition_features(self, s16, memories):
        """s16 [B,h,w,256]; memories: list of (feat [B,h,w,64], age 0..6).
        → conditioned s16."""
        b, h, w, d = s16.shape
        x = s16.reshape(b, h * w, d)
        if not memories:
            return (x + self.no_mem_embed).reshape(b, h, w, d)
        x_pe = self.prompt_encoder.dense_pe(h, w)[None].reshape(b, h * w, d)
        kv, pe = [], []
        for feat, age in memories:
            kv.append(feat.reshape(b, -1, self._d_mem))
            tpos = self.maskmem_tpos_enc[min(age, self.NUM_MASKMEM - 1), 0]
            pe.append(tpos.expand(b, feat.shape[1] * feat.shape[2], self._d_mem))
        mem_kv = torch.cat(kv, dim=1)
        mem_pe = torch.cat(pe, dim=1)
        for layer in self.memory_attention:
            x = layer(x, mem_kv, x_pe, mem_pe)
        return self.memory_attention_norm(x).reshape(b, h, w, d)

    def track_step(self, image01, memories, points01=None, labels=None):
        """One video step: encode the frame, condition it on the memory bank,
        decode a mask (with prompts only on conditioning frames), encode the
        new memory. → (mask_logits, iou, memory_feat)."""
        s16, hi_s8, hi_s4 = self.encode_image(image01)
        cond = self.condition_features(s16, memories)
        pe = self.prompt_encoder.dense_pe(cond.shape[1], cond.shape[2])[None]
        if points01 is None:
            points01 = torch.zeros(1, 1, 2, device=s16.device)
            labels = torch.full((1, 1), -1, dtype=torch.int32, device=s16.device)  # padding-only prompt
        sparse = self.prompt_encoder(points01, labels)
        masks, iou, _ = self.mask_decoder(cond, pe, sparse, hires_feats=(hi_s8, hi_s4))
        best = int(torch.argmax(iou[0]))
        mask = masks[:, best]
        up = jax_resize(mask[..., None], (mask.shape[0], cond.shape[1] * 16, cond.shape[2] * 16, 1), "bilinear")
        mem = self.memory_encoder(s16, up)
        return mask, iou, mem
