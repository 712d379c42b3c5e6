"""Checkpoint key conversion: torch module paths → the port's module paths
(port of ``apex_studio_tpu/loaders/converters.py``, the families the ported
paths load: Flux text-to-image's ``flux``, ``t5``, ``clip``,
``autoencoder_kl``; HunyuanVideo 1.5's ``hunyuanvideo15``,
``hunyuanvideo15_vae``, ``qwen2``, ``siglip``, ``tae_vae``, and byT5 through
``t5``).

Each family registers an ordered list of regex renames plus prefixes to strip
(original / ComfyUI / diffusers layouts) and keys to drop. Converted Linear and
conv weights end in ``.kernel``, as in the JAX package, so one converter table
serves both; ``state_mapping.apply_state_dict`` maps ``.kernel`` to the port's
``.weight`` and knows the layouts. Values may be torch tensors or numpy arrays.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from apex_studio_tpu_torch.registry import Registry

converter_registry = Registry("converter")

# Prefixes seen across original/Comfy single-file checkpoints.
_COMMON_PREFIXES = (
    "model.diffusion_model.",
    "diffusion_model.",
    "model.model.",
    "net.",
)


def _split(v: Any, sections, axis: int = 0):
    """``np.split`` for arrays and tensors alike (views, no copy)."""
    if isinstance(v, torch.Tensor):
        return torch.tensor_split(v, sections, dim=axis)
    return np.split(np.asarray(v), sections, axis=axis)


def _concat(parts, axis: int = 0):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(list(parts), dim=axis)
    return np.concatenate(parts, axis=axis)


class KeyConverter:
    def __init__(
        self,
        renames: Sequence[Tuple[str, str]] = (),
        strip_prefixes: Sequence[str] = _COMMON_PREFIXES,
        drop: Sequence[str] = (),
    ):
        self.renames = [(re.compile(p), r) for p, r in renames]
        self.strip_prefixes = tuple(strip_prefixes)
        self.drop = [re.compile(p) for p in drop]

    def convert_key(self, key: str) -> str | None:
        for pref in self.strip_prefixes:
            if key.startswith(pref):
                key = key[len(pref):]
                break
        for pat in self.drop:
            if pat.search(key):
                return None
        for pat, repl in self.renames:
            key = pat.sub(repl, key)
        return key

    def convert(self, sd: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in sd.items():
            nk = self.convert_key(k)
            if nk is not None:
                out[nk] = v
        return out


def convert_keys(family: str, sd: Dict[str, Any]) -> Dict[str, Any]:
    if family == "flux" and any(
        k.split("model.diffusion_model.")[-1].startswith(("double_blocks.", "single_blocks."))
        for k in sd
    ):
        sd = convert_flux_bfl(sd)
    return converter_registry.get(family).convert(sd)


def convert_flux_bfl(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Original BFL / ComfyUI single-file flux layout → diffusers layout
    (which the 'flux' converter then maps to the port's paths). Fused qkv tensors are
    split; the final adaLN swaps from [shift|scale] to [scale|shift]."""
    out: Dict[str, Any] = {}

    def put(k: str, v: Any) -> None:
        out[k] = v

    def swap_scale_shift(w: Any) -> Any:
        shift, scale = _split(w, 2)
        return _concat([scale, shift])

    for key, v in sd.items():
        k = key
        for pref in _COMMON_PREFIXES:
            if k.startswith(pref):
                k = k[len(pref):]
                break
        if k.startswith("double_blocks."):
            _, n, rest = k.split(".", 2)
            base = f"transformer_blocks.{n}"
            stream = "img" if rest.startswith("img_") else "txt"
            r = rest.split(".", 1)[-1] if "." in rest else rest
            if rest.startswith(f"{stream}_mod.lin."):
                tgt = "norm1.linear" if stream == "img" else "norm1_context.linear"
                put(f"{base}.{tgt}.{rest.rsplit('.', 1)[-1]}", v)
            elif rest.startswith(f"{stream}_attn.qkv."):
                q, kk, vv = _split(v, 3)
                names = ("to_q", "to_k", "to_v") if stream == "img" else (
                    "add_q_proj", "add_k_proj", "add_v_proj")
                suffix = rest.rsplit(".", 1)[-1]
                for name, part in zip(names, (q, kk, vv)):
                    put(f"{base}.attn.{name}.{suffix}", part)
            elif rest.startswith(f"{stream}_attn.norm.query_norm.scale"):
                name = "norm_q" if stream == "img" else "norm_added_q"
                put(f"{base}.attn.{name}.weight", v)
            elif rest.startswith(f"{stream}_attn.norm.key_norm.scale"):
                name = "norm_k" if stream == "img" else "norm_added_k"
                put(f"{base}.attn.{name}.weight", v)
            elif rest.startswith(f"{stream}_attn.proj."):
                tgt = "attn.to_out.0" if stream == "img" else "attn.to_add_out"
                put(f"{base}.{tgt}.{rest.rsplit('.', 1)[-1]}", v)
            elif rest.startswith(f"{stream}_mlp.0."):
                tgt = "ff.net.0.proj" if stream == "img" else "ff_context.net.0.proj"
                put(f"{base}.{tgt}.{rest.rsplit('.', 1)[-1]}", v)
            elif rest.startswith(f"{stream}_mlp.2."):
                tgt = "ff.net.2" if stream == "img" else "ff_context.net.2"
                put(f"{base}.{tgt}.{rest.rsplit('.', 1)[-1]}", v)
        elif k.startswith("single_blocks."):
            _, n, rest = k.split(".", 2)
            base = f"single_transformer_blocks.{n}"
            suffix = rest.rsplit(".", 1)[-1]
            if rest.startswith("linear1."):
                # fused [q|k|v|mlp(4d)] along the output axis
                d = v.shape[0] // 7
                q, kk, vv, mlp = _split(v, [d, 2 * d, 3 * d])
                put(f"{base}.attn.to_q.{suffix}", q)
                put(f"{base}.attn.to_k.{suffix}", kk)
                put(f"{base}.attn.to_v.{suffix}", vv)
                put(f"{base}.proj_mlp.{suffix}", mlp)
            elif rest.startswith("linear2."):
                put(f"{base}.proj_out.{suffix}", v)
            elif rest.startswith("modulation.lin."):
                put(f"{base}.norm.linear.{suffix}", v)
            elif rest.startswith("norm.query_norm.scale"):
                put(f"{base}.attn.norm_q.weight", v)
            elif rest.startswith("norm.key_norm.scale"):
                put(f"{base}.attn.norm_k.weight", v)
        elif k.startswith("img_in."):
            put(k.replace("img_in.", "x_embedder."), v)
        elif k.startswith("txt_in."):
            put(k.replace("txt_in.", "context_embedder."), v)
        elif k.startswith("time_in.in_layer."):
            put(k.replace("time_in.in_layer.", "time_text_embed.timestep_embedder.linear_1."), v)
        elif k.startswith("time_in.out_layer."):
            put(k.replace("time_in.out_layer.", "time_text_embed.timestep_embedder.linear_2."), v)
        elif k.startswith("vector_in.in_layer."):
            put(k.replace("vector_in.in_layer.", "time_text_embed.text_embedder.linear_1."), v)
        elif k.startswith("vector_in.out_layer."):
            put(k.replace("vector_in.out_layer.", "time_text_embed.text_embedder.linear_2."), v)
        elif k.startswith("guidance_in.in_layer."):
            put(k.replace("guidance_in.in_layer.", "time_text_embed.guidance_embedder.linear_1."), v)
        elif k.startswith("guidance_in.out_layer."):
            put(k.replace("guidance_in.out_layer.", "time_text_embed.guidance_embedder.linear_2."), v)
        elif k.startswith("final_layer.linear."):
            put(k.replace("final_layer.linear.", "proj_out."), v)
        elif k.startswith("final_layer.adaLN_modulation.1."):
            put(k.replace("final_layer.adaLN_modulation.1.", "norm_out.linear."),
                swap_scale_shift(v))
        # anything else (e.g. distilled-guidance extras) is dropped
    return out



# -- family tables ------------------------------------------------------------------

converter_registry.add(
    "flux",
    KeyConverter(
        renames=[
            (r"^time_text_embed\.timestep_embedder\.linear_(\d)\.", r"time_text_embed.timestep_linear_\1."),
            (r"^time_text_embed\.guidance_embedder\.linear_(\d)\.", r"time_text_embed.guidance_linear_\1."),
            (r"^time_text_embed\.text_embedder\.linear_(\d)\.", r"time_text_embed.text_linear_\1."),
            (r"\.norm1\.linear\.", ".norm1_linear."),
            (r"\.norm1_context\.linear\.", ".norm1_context_linear."),
            (r"^(single_transformer_blocks\.\d+)\.norm\.linear\.", r"\1.norm_linear."),
            (r"^norm_out\.linear\.", "norm_out_linear."),
            (r"\.attn\.to_out\.0\.", ".attn.to_out."),
            (r"\.ff(_context)?\.net\.0\.proj\.", r".ff\1.fc1."),
            (r"\.ff(_context)?\.net\.2\.", r".ff\1.fc2."),
            # Single blocks keep attention projections under .attn in diffusers.
            (r"^(single_transformer_blocks\.\d+)\.attn\.", r"\1."),
            (r"(linear_\d|context_embedder|x_embedder|to_q|to_k|to_v|to_out|to_add_out|add_q_proj|add_k_proj|add_v_proj|fc1|fc2|proj_mlp|proj_out|norm1_linear|norm1_context_linear|norm_linear|norm_out_linear)\.weight$", r"\1.kernel"),
        ],
        drop=(r"^pos_embed", r"rotary"),
    ),
)

converter_registry.add(
    "t5",
    KeyConverter(
        renames=[
            (r"^encoder\.embed_tokens\.weight$", "shared"),
            (r"^shared\.weight$", "shared"),
            (r"^encoder\.block\.(\d+)\.layer\.0\.SelfAttention\.([qkvo])\.weight$",
             r"blocks.\1.attention.\2.kernel"),
            (r"^encoder\.block\.(\d+)\.layer\.0\.SelfAttention\.relative_attention_bias\.weight$",
             r"blocks.\1.attention.relative_attention_bias"),
            (r"^encoder\.block\.(\d+)\.layer\.0\.layer_norm\.weight$", r"blocks.\1.layer_norm0.weight"),
            (r"^encoder\.block\.(\d+)\.layer\.1\.DenseReluDense\.(wi_0|wi_1|wo)\.weight$",
             r"blocks.\1.ff.\2.kernel"),
            (r"^encoder\.block\.(\d+)\.layer\.1\.layer_norm\.weight$", r"blocks.\1.layer_norm1.weight"),
            (r"^encoder\.final_layer_norm\.weight$", "final_layer_norm.weight"),
        ],
        strip_prefixes=(),
        drop=(r"^decoder\.", r"^lm_head\."),
    ),
)

converter_registry.add(
    "clip",
    KeyConverter(
        renames=[
            (r"^text_model\.embeddings\.token_embedding\.weight$", "token_embedding"),
            (r"^text_model\.embeddings\.position_embedding\.weight$", "position_embedding"),
            (r"^text_model\.encoder\.layers\.", "layers."),
            (r"^text_model\.final_layer_norm\.", "final_layer_norm."),
            (r"(q_proj|k_proj|v_proj|out_proj|fc1|fc2)\.weight$", r"\1.kernel"),
        ],
        strip_prefixes=(),
        drop=(r"position_ids", r"^text_projection", r"logit_scale", r"^visual", r"^vision_model"),
    ),
)
converter_registry.add(
    "autoencoder_kl",
    KeyConverter(
        renames=[
            (r"\.to_out\.0\.", ".to_out."),
            (r"(conv|conv1|conv2|conv_shortcut|conv_in|conv_out|quant_conv|post_quant_conv)\.weight$", r"\1.kernel"),
            (r"(to_q|to_k|to_v|to_out)\.weight$", r"\1.kernel"),
            # Legacy SD attention naming → diffusers naming.
            (r"\.query\.", ".to_q."),
            (r"\.key\.", ".to_k."),
            (r"\.value\.", ".to_v."),
            (r"\.proj_attn\.", ".to_out."),
        ],
        strip_prefixes=("first_stage_model.",),
        drop=(),
    ),
)

converter_registry.add(
    "qwen2",
    KeyConverter(
        renames=[
            # Qwen2.5-VL exports nest the LM under language_model / model.
            (r"^model\.language_model\.", ""),
            (r"^language_model\.model\.", ""),
            (r"^language_model\.", ""),
            (r"^model\.", ""),
            (r"^embed_tokens\.weight$", "embed_tokens"),
            (r"(q_proj|k_proj|v_proj|o_proj)\.weight$", r"\1.kernel"),
            (r"\.mlp\.gate_proj\.", ".mlp.w1."),
            (r"\.mlp\.up_proj\.", ".mlp.w3."),
            (r"\.mlp\.down_proj\.", ".mlp.w2."),
            (r"(w1|w2|w3)\.weight$", r"\1.kernel"),
        ],
        strip_prefixes=(),
        drop=(r"^lm_head\.", r"^visual\.", r"^model\.visual\.", r"rotary_emb"),
    ),
)

converter_registry.add(
    "hunyuanvideo15",
    KeyConverter(
        renames=[
            (r"^x_embedder\.proj\.weight$", "x_embedder.kernel"),
            (r"^x_embedder\.proj\.bias$", "x_embedder.bias"),
            (r"^time_embed\.timestep_embedder\.linear_(\d)\.", r"time_linear_\1."),
            (r"^cond_type_embed\.weight$", "cond_type_embed"),
            (r"^context_embedder\.time_text_embed\.timestep_embedder\.linear_(\d)\.",
             r"context_embedder.timestep_linear_\1."),
            (r"^context_embedder\.time_text_embed\.text_embedder\.linear_(\d)\.",
             r"context_embedder.text_linear_\1."),
            (r"^context_embedder\.token_refiner\.refiner_blocks\.", "context_embedder.refiner_blocks."),
            (r"(refiner_blocks\.\d+)\.attn\.to_out\.0\.", r"\1.to_out."),
            (r"(refiner_blocks\.\d+)\.attn\.", r"\1."),
            (r"(refiner_blocks\.\d+)\.ff\.net\.0\.proj\.", r"\1.ff_in."),
            (r"(refiner_blocks\.\d+)\.ff\.net\.2\.", r"\1.ff_out."),
            (r"(refiner_blocks\.\d+)\.norm_out\.linear\.", r"\1.ada_linear."),
            (r"^context_embedder_2\.norm\.", "byt5_norm."),
            (r"^context_embedder_2\.linear_(\d)\.", r"byt5_linear_\1."),
            (r"^image_embedder\.norm_in\.", "img_norm_in."),
            (r"^image_embedder\.norm_out\.", "img_norm_out."),
            (r"^image_embedder\.linear_(\d)\.", r"img_linear_\1."),
            (r"\.norm1\.linear\.", ".norm1_linear."),
            (r"\.norm1_context\.linear\.", ".norm1_context_linear."),
            (r"\.attn\.to_out\.0\.", ".to_out."),
            (r"(transformer_blocks\.\d+)\.attn\.", r"\1."),
            (r"\.ff(_context)?\.net\.0\.proj\.", r".ff\1.fc1."),
            (r"\.ff(_context)?\.net\.2\.", r".ff\1.fc2."),
            (r"^norm_out\.linear\.", "norm_out_linear."),
            (r"(to_q|to_k|to_v|to_out|to_add_out|add_q_proj|add_k_proj|add_v_proj|fc1|fc2|ff_in|ff_out|ada_linear|proj_in|proj_out|norm1_linear|norm1_context_linear|norm_out_linear|time_linear_\d|timestep_linear_\d|text_linear_\d|byt5_linear_\d|img_linear_\d)\.weight$", r"\1.kernel"),
        ],
        drop=(r"^rope\.",),
    ),
)

converter_registry.add(
    "hunyuanvideo15_vae",
    KeyConverter(
        renames=[
            # CausalConv3d wraps its conv; flatten the extra level.
            (r"\.conv\.weight$", ".kernel"),
            (r"\.conv\.bias$", ".bias"),
            (r"(conv_shortcut)\.weight$", r"\1.kernel"),
            (r"(to_q|to_k|to_v|proj_out)\.weight$", r"\1.kernel"),
        ],
        strip_prefixes=(),
        drop=(),
    ),
)

converter_registry.add(
    "tae_vae",
    KeyConverter(
        renames=[
            # MemBlock inner Sequential: conv.{0,2,4} → conv_{0,2,4}
            (r"\.conv\.([024])\.weight$", r".conv_\1.kernel"),
            (r"\.conv\.([024])\.bias$", r".conv_\1.bias"),
            # TPool/TGrow wrap a conv; every remaining .weight is a conv kernel
            # (the TAE family has no norm layers).
            (r"\.weight$", ".kernel"),
        ],
        strip_prefixes=("taehv.", "vae.", "module."),
    ),
)

converter_registry.add(
    # SigLIP vision tower (transformers SiglipVisionModel layout).
    "siglip",
    KeyConverter(
        renames=[
            (r"^vision_model\.embeddings\.patch_embedding\.weight$", "patch_embedding.kernel"),
            (r"^vision_model\.embeddings\.patch_embedding\.bias$", "patch_embedding.bias"),
            (r"^vision_model\.embeddings\.position_embedding\.weight$", "position_embedding"),
            (r"^vision_model\.post_layernorm\.", "post_layernorm."),
            (r"^vision_model\.encoder\.layers\.", "layers."),
            (r"\.mlp\.fc1\.", ".fc1."),
            (r"\.mlp\.fc2\.", ".fc2."),
            (r"(q_proj|k_proj|v_proj|out_proj|fc1|fc2)\.weight$", r"\1.kernel"),
        ],
        strip_prefixes=(),
        drop=(r"^vision_model\.head", r"^text_model", r"^logit_"),
    ),
)
