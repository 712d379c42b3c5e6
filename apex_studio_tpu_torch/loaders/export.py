"""A port module's state dict under its family's published checkpoint names:
the inverse of loaders/converters.py for ``flux`` (diffusers naming, or the
original BFL single-file naming with fused qkv), ``t5`` (byT5 too), ``clip``,
``autoencoder_kl``, ``hunyuanvideo15`` and ``hunyuanvideo15_vae`` (diffusers
naming) and ``tae_vae`` (TAEHV's ``nn.Sequential`` indices).

``safetensors_io.save_safetensors`` of the result is a file the engine loads
through ``convert_keys`` and ``apply_state_dict``: how a model with merged
LoRAs is written out, and how the tests and ``chip_smoke.py`` make the
checkpoints they load.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Sequence, Tuple

import torch

_FLUX = (
    (r"^time_text_embed\.(timestep|guidance|text)_linear_(\d)\.", r"time_text_embed.\1_embedder.linear_\2."),
    (r"\.norm1_linear\.", ".norm1.linear."),
    (r"\.norm1_context_linear\.", ".norm1_context.linear."),
    (r"^(single_transformer_blocks\.\d+)\.norm_linear\.", r"\1.norm.linear."),
    (r"^(single_transformer_blocks\.\d+)\.(to_q|to_k|to_v|norm_q|norm_k)\.", r"\1.attn.\2."),
    (r"^norm_out_linear\.", "norm_out.linear."),
    (r"\.attn\.to_out\.", ".attn.to_out.0."),
    (r"\.ff(_context)?\.fc1\.", r".ff\1.net.0.proj."),
    (r"\.ff(_context)?\.fc2\.", r".ff\1.net.2."),
)
_T5 = (
    (r"^shared$", "shared.weight"),
    (r"^blocks\.(\d+)\.attention\.relative_attention_bias$",
     r"encoder.block.\1.layer.0.SelfAttention.relative_attention_bias.weight"),
    (r"^blocks\.(\d+)\.attention\.([qkvo])\.", r"encoder.block.\1.layer.0.SelfAttention.\2."),
    (r"^blocks\.(\d+)\.layer_norm0\.", r"encoder.block.\1.layer.0.layer_norm."),
    (r"^blocks\.(\d+)\.ff\.", r"encoder.block.\1.layer.1.DenseReluDense."),
    (r"^blocks\.(\d+)\.layer_norm1\.", r"encoder.block.\1.layer.1.layer_norm."),
    (r"^final_layer_norm\.", "encoder.final_layer_norm."),
)
_CLIP = (
    (r"^(token|position)_embedding$", r"text_model.embeddings.\1_embedding.weight"),
    (r"^layers\.", "text_model.encoder.layers."),
    (r"^final_layer_norm\.", "text_model.final_layer_norm."),
)
_AUTOENCODER_KL = (
    (r"\.to_out\.", ".to_out.0."),
)
_HUNYUANVIDEO15 = (
    (r"^x_embedder\.", "x_embedder.proj."),
    (r"^time_linear_(\d)\.", r"time_embed.timestep_embedder.linear_\1."),
    (r"^cond_type_embed$", "cond_type_embed.weight"),
    (r"^context_embedder\.(timestep|text)_linear_(\d)\.",
     r"context_embedder.time_text_embed.\1_embedder.linear_\2."),
    (r"^context_embedder\.refiner_blocks\.(\d+)\.to_out\.", r"context_embedder.refiner_blocks.\1.attn.to_out.0."),
    (r"^context_embedder\.refiner_blocks\.(\d+)\.(to_q|to_k|to_v)\.", r"context_embedder.refiner_blocks.\1.attn.\2."),
    (r"^context_embedder\.refiner_blocks\.(\d+)\.ff_in\.", r"context_embedder.refiner_blocks.\1.ff.net.0.proj."),
    (r"^context_embedder\.refiner_blocks\.(\d+)\.ff_out\.", r"context_embedder.refiner_blocks.\1.ff.net.2."),
    (r"^context_embedder\.refiner_blocks\.(\d+)\.ada_linear\.", r"context_embedder.refiner_blocks.\1.norm_out.linear."),
    (r"^context_embedder\.refiner_blocks\.", "context_embedder.token_refiner.refiner_blocks."),
    (r"^byt5_norm\.", "context_embedder_2.norm."),
    (r"^byt5_linear_(\d)\.", r"context_embedder_2.linear_\1."),
    (r"^img_norm_(in|out)\.", r"image_embedder.norm_\1."),
    (r"^img_linear_(\d)\.", r"image_embedder.linear_\1."),
    (r"\.norm1_linear\.", ".norm1.linear."),
    (r"\.norm1_context_linear\.", ".norm1_context.linear."),
    (r"^(transformer_blocks\.\d+)\.to_out\.", r"\1.attn.to_out.0."),
    (r"^(transformer_blocks\.\d+)\.(to_q|to_k|to_v|add_q_proj|add_k_proj|add_v_proj|to_add_out|norm_q|norm_k|"
     r"norm_added_q|norm_added_k)\.", r"\1.attn.\2."),
    (r"\.ff(_context)?\.fc1\.", r".ff\1.net.0.proj."),
    (r"\.ff(_context)?\.fc2\.", r".ff\1.net.2."),
    (r"^norm_out_linear\.", "norm_out.linear."),
)
# every causal conv wraps its Conv3d as ``.conv``; attention projections, the
# 1×1 shortcut and the RMS norms' ``gamma`` have no extra level
_HUNYUANVIDEO15_VAE = (
    (r"^(?!.*\.(?:to_q|to_k|to_v|proj_out|conv_shortcut)\.)(.*)\.(weight|bias)$", r"\1.conv.\2"),
)
_TAE_VAE = (
    (r"\.conv_([024])\.", r".conv.\1."),
)
_TABLES: Dict[str, Sequence[Tuple[str, str]]] = {
    "flux": _FLUX, "t5": _T5, "clip": _CLIP, "autoencoder_kl": _AUTOENCODER_KL,
    "hunyuanvideo15": _HUNYUANVIDEO15, "hunyuanvideo15_vae": _HUNYUANVIDEO15_VAE, "tae_vae": _TAE_VAE}


def published_state_dict(family: str, state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` of an unquantized port module → the family's
    published (diffusers / transformers) key naming. Layouts are torch's on
    both sides, so values pass through untouched."""
    table = [(re.compile(p), r) for p, r in _TABLES[family]]
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if key.endswith("weight_scale"):
            raise ValueError(f"{key}: a quantized module has no published form")
        for pat, repl in table:
            key = pat.sub(repl, key)
        out[key] = value
    return out


def flux_bfl_state_dict(state: Mapping[str, torch.Tensor],
                        prefix: str = "model.diffusion_model.") -> Dict[str, torch.Tensor]:
    """A port Flux DiT's state dict in the original BFL / ComfyUI single-file
    layout: q, k, v (and, in single blocks, the MLP input projection) fused
    along the output axis, the final adaLN as [shift | scale]."""
    sd = published_state_dict("flux", state)
    out: Dict[str, torch.Tensor] = {}
    take: Callable[[str], torch.Tensor] = sd.pop

    def fused(names: Sequence[str], suffix: str) -> torch.Tensor:
        return torch.cat([take(f"{n}.{suffix}") for n in names], dim=0)

    for part, bfl in (("timestep", "time_in"), ("text", "vector_in"), ("guidance", "guidance_in")):
        for n, layer in (("1", "in_layer"), ("2", "out_layer")):
            for suffix in ("weight", "bias"):
                key = f"time_text_embed.{part}_embedder.linear_{n}.{suffix}"
                if key in sd:
                    out[f"{bfl}.{layer}.{suffix}"] = take(key)
    for suffix in ("weight", "bias"):
        out[f"img_in.{suffix}"] = take(f"x_embedder.{suffix}")
        out[f"txt_in.{suffix}"] = take(f"context_embedder.{suffix}")
        out[f"final_layer.linear.{suffix}"] = take(f"proj_out.{suffix}")
        scale, shift = torch.chunk(take(f"norm_out.linear.{suffix}"), 2, dim=0)
        out[f"final_layer.adaLN_modulation.1.{suffix}"] = torch.cat([shift, scale], dim=0)

    doubles = sorted({int(k.split(".")[1]) for k in sd if k.startswith("transformer_blocks.")})
    for i in doubles:
        src, dst = f"transformer_blocks.{i}", f"double_blocks.{i}"
        streams = (
            ("img", "norm1", ("to_q", "to_k", "to_v"), "norm_q", "norm_k", "to_out.0", "ff"),
            ("txt", "norm1_context", ("add_q_proj", "add_k_proj", "add_v_proj"),
             "norm_added_q", "norm_added_k", "to_add_out", "ff_context"),
        )
        for s, mod, qkv, nq, nk, proj, ff in streams:
            out[f"{dst}.{s}_attn.norm.query_norm.scale"] = take(f"{src}.attn.{nq}.weight")
            out[f"{dst}.{s}_attn.norm.key_norm.scale"] = take(f"{src}.attn.{nk}.weight")
            for suffix in ("weight", "bias"):
                out[f"{dst}.{s}_mod.lin.{suffix}"] = take(f"{src}.{mod}.linear.{suffix}")
                out[f"{dst}.{s}_attn.qkv.{suffix}"] = fused([f"{src}.attn.{n}" for n in qkv], suffix)
                out[f"{dst}.{s}_attn.proj.{suffix}"] = take(f"{src}.attn.{proj}.{suffix}")
                out[f"{dst}.{s}_mlp.0.{suffix}"] = take(f"{src}.{ff}.net.0.proj.{suffix}")
                out[f"{dst}.{s}_mlp.2.{suffix}"] = take(f"{src}.{ff}.net.2.{suffix}")
    singles = sorted({int(k.split(".")[1]) for k in sd if k.startswith("single_transformer_blocks.")})
    for i in singles:
        src, dst = f"single_transformer_blocks.{i}", f"single_blocks.{i}"
        out[f"{dst}.norm.query_norm.scale"] = take(f"{src}.attn.norm_q.weight")
        out[f"{dst}.norm.key_norm.scale"] = take(f"{src}.attn.norm_k.weight")
        for suffix in ("weight", "bias"):
            out[f"{dst}.linear1.{suffix}"] = fused(
                [f"{src}.attn.to_q", f"{src}.attn.to_k", f"{src}.attn.to_v", f"{src}.proj_mlp"], suffix)
            out[f"{dst}.linear2.{suffix}"] = take(f"{src}.proj_out.{suffix}")
            out[f"{dst}.modulation.lin.{suffix}"] = take(f"{src}.norm.linear.{suffix}")
    if sd:
        raise KeyError(f"Flux keys with no BFL name: {sorted(sd)[:8]}")
    return {prefix + k: v for k, v in out.items()}
