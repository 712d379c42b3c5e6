"""Checkpoint key conversion: torch module paths → the port's module paths
(port of ``apex_studio_tpu/loaders/converters.py``, the families the ported
paths load: Flux text-to-image's ``flux``, ``t5``, ``clip``,
``autoencoder_kl``; HunyuanVideo 1.5's ``hunyuanvideo15``,
``hunyuanvideo15_vae``, ``qwen2``, ``siglip`` (and ``siglip_pooled``, with
the MAP head, for the Cosmos guardrail), ``tae_vae``, and byT5 through
``t5``; ZImage's ``zimage`` (base and control, the Comfy single-file names
too) and ``qwen3``; QwenImage's ``qwenimage`` (DiT and ControlNet) and
``wan_vae``; Wan's ``wan`` DiT (its VACE keys too) and SkyReels V2's
``skyreels`` (the same with the fps embedding), UMT5 through ``t5``, and
the Wan 2.1 i2v image encoder's ``clip_vision``; FLUX.2's ``flux2`` and
``flux2_control`` DiTs (diffusers naming), ``flux2_vae`` (``AutoencoderKLFlux2``
with its BatchNorm running statistics) and the ``llama`` text towers
(Llama, Llava, Mistral3); HunyuanVideo's ``hunyuanvideo`` (the DiT and
FramePack's, diffusers naming) and ``hunyuanvideo_vae``; HuMo's ``wan_humo``
and ``wav2vec2``; the audio-driven DiTs' ``wan_s2v``, ``wan_multitalk`` and
``hunyuanvideo_avatar``, whose audio encoders load through ``wav2vec2``;
SAM2's ``sam2`` (the image model) and ``sam2_video`` (the memory bank);
the last Wan DiTs' ``wan_animate``, ``wan_lynx`` and ``wan_scail``, Lynx's
``lynx_resampler``, and ReCamMaster's, Apex-FramePack's and HoloCine's extra
keys in ``wan``); the other image families' ``chroma``, ``ovis``, ``fibo``,
``hidream`` (the MoE gate as a raw matrix), ``hunyuanimage`` and
``hunyuanimage_vae``, their text encoders through ``t5``, ``clip``,
``llama``, ``qwen2`` and ``qwen3``; the video DiTs on the ported VAEs and
encoders: ``longcat``, ``cosmos`` and ``kandinsky5``; HunyuanImage 3's
``hunyuanimage3`` and ``hunyuanimage3_vae``, CogVideoX's ``cogvideo`` and
``cogvideo_vae``, its T5-XXL through ``t5``; Mochi-1's ``mochi`` and
``mochi_vae``, LTX-Video's ``ltx`` and ``ltx_vae``).

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
    # HunyuanVideo (diffusers HunyuanVideoTransformer3DModel naming) and its
    # FramePack variant's history embedders and image projection
    "hunyuanvideo",
    KeyConverter(
        renames=[
            (r"^x_embedder\.proj\.weight$", "x_embedder.kernel"),
            (r"^x_embedder\.proj\.bias$", "x_embedder.bias"),
            (r"^time_text_embed\.timestep_embedder\.linear_(\d)\.", r"time_linear_\1."),
            (r"^time_text_embed\.text_embedder\.linear_(\d)\.", r"text_linear_\1."),
            (r"^time_text_embed\.guidance_embedder\.linear_(\d)\.", r"guidance_linear_\1."),
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
            (r"\.norm1\.linear\.", ".norm1_linear."),
            (r"\.norm1_context\.linear\.", ".norm1_context_linear."),
            (r"\.norm\.linear\.", ".norm_linear."),  # single-block adaLN
            (r"\.attn\.to_out\.0\.", ".to_out."),
            (r"(transformer_blocks\.\d+)\.attn\.", r"\1."),
            (r"(single_transformer_blocks\.\d+)\.attn\.", r"\1."),
            (r"\.ff(_context)?\.net\.0\.proj\.", r".ff\1.fc1."),
            (r"\.ff(_context)?\.net\.2\.", r".ff\1.fc2."),
            (r"^norm_out\.linear\.", "norm_out_linear."),
            (r"^clean_x_embedder\.(proj(?:_2x|_4x)?)\.weight$", r"clean_x_embedder.\1.kernel"),
            (r"^image_projection\.(up|down)\.weight$", r"image_projection.\1.kernel"),
            (r"(to_q|to_k|to_v|to_out|to_add_out|add_q_proj|add_k_proj|add_v_proj|fc1|fc2|ff_in|ff_out|ada_linear|"
             r"proj_in|proj_mlp|proj_out|norm1_linear|norm1_context_linear|norm_linear|norm_out_linear|"
             r"time_linear_\d|timestep_linear_\d|text_linear_\d|guidance_linear_\d)\.weight$", r"\1.kernel"),
        ],
        drop=(r"^rope\.",),
    ),
)

converter_registry.add(
    # diffusers AutoencoderKLHunyuanVideo: each causal conv wraps its Conv3d
    # as ``.conv``; the mid attention keeps the deprecated ``to_out.0``
    "hunyuanvideo_vae",
    KeyConverter(
        renames=[
            (r"\.conv\.weight$", ".kernel"),
            (r"\.conv\.bias$", ".bias"),
            (r"^(post_)?quant_conv\.weight$", r"\1quant_conv.kernel"),
            (r"\.attentions\.0\.to_out\.0\.", ".attentions.0.to_out."),
            (r"(to_q|to_k|to_v|to_out|conv_shortcut)\.weight$", r"\1.kernel"),
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

converter_registry.add(
    # The same vision tower with the MAP attention-pooling head kept
    # (get_image_features): the Cosmos guardrail's frame embedding
    # (reference postprocess/cosmos/guardrail.py:505).
    "siglip_pooled",
    KeyConverter(
        renames=[
            (r"^vision_model\.embeddings\.patch_embedding\.weight$", "patch_embedding.kernel"),
            (r"^vision_model\.embeddings\.patch_embedding\.bias$", "patch_embedding.bias"),
            (r"^vision_model\.embeddings\.position_embedding\.weight$", "position_embedding"),
            (r"^vision_model\.post_layernorm\.", "post_layernorm."),
            (r"^vision_model\.encoder\.layers\.", "layers."),
            (r"^vision_model\.head\.attention\.in_proj_weight$", "head.in_proj_weight"),
            (r"^vision_model\.head\.attention\.in_proj_bias$", "head.in_proj_bias"),
            (r"^vision_model\.head\.attention\.out_proj\.", "head.out_proj."),
            (r"^vision_model\.head\.mlp\.fc1\.", "head.fc1."),
            (r"^vision_model\.head\.mlp\.fc2\.", "head.fc2."),
            (r"^vision_model\.head\.layernorm\.", "head.layernorm."),
            (r"^vision_model\.head\.probe$", "head.probe"),
            (r"\.mlp\.fc1\.", ".fc1."),
            (r"\.mlp\.fc2\.", ".fc2."),
            (r"(q_proj|k_proj|v_proj|out_proj|fc1|fc2)\.weight$", r"\1.kernel"),
        ],
        strip_prefixes=(),
        drop=(r"^text_model", r"^logit_"),
    ),
)

converter_registry.add(
    # Z-Image DiT, base and control; the Comfy single-file names
    # (all_x_embedder.2-1, all_final_layer.2-1, cap_embedder.0/1, t_embedder.mlp.0/2)
    "zimage",
    KeyConverter(
        renames=[
            (r"^control_all_x_embedder\.[0-9]+-[0-9]+\.", "control_x_embedder."),
            (r"^all_x_embedder\.[0-9]+-[0-9]+\.", "x_embedder."),
            (r"^all_final_layer\.[0-9]+-[0-9]+\.", "final_layer."),
            (r"^cap_embedder\.0\.", "cap_embedder_norm."),
            (r"^cap_embedder\.1\.", "cap_embedder_linear."),
            (r"^t_embedder\.mlp\.0\.", "t_embedder.in_layer."),
            (r"^t_embedder\.mlp\.2\.", "t_embedder.out_layer."),
            (r"\.attention\.to_out\.0\.", ".attention.to_out."),
            # block adaLN is Sequential(Linear); the final layer's Sequential(SiLU, Linear)
            (r"\.adaLN_modulation\.0\.", ".adaLN_modulation."),
            (r"\.adaLN_modulation\.1\.", ".adaLN_modulation."),
            (r"(linear|to_q|to_k|to_v|to_out|w1|w2|w3|in_layer|out_layer|adaLN_modulation|x_embedder|"
             r"cap_embedder_linear|before_proj|after_proj)\.weight$", r"\1.kernel"),
        ],
        drop=(r"rope_embedder", r"\.freqs", r"^siglip_"),
    ),
)

converter_registry.add(
    "qwen3",
    KeyConverter(
        renames=[
            (r"^model\.", ""),
            (r"^embed_tokens\.weight$", "embed_tokens"),
            (r"(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj)\.weight$", r"\1.kernel"),
            # HF MLP names → SwiGLU leaf names
            (r"\.mlp\.gate_proj\.", ".mlp.w1."),
            (r"\.mlp\.up_proj\.", ".mlp.w3."),
            (r"\.mlp\.down_proj\.", ".mlp.w2."),
        ],
        strip_prefixes=(),
        drop=(r"^lm_head\.", r"rotary_emb"),
    ),
)

converter_registry.add(
    # QwenImage DiT and its ControlNet (diffusers naming)
    "qwenimage",
    KeyConverter(
        renames=[
            (r"^time_text_embed\.timestep_embedder\.linear_(\d)\.", r"timestep_linear_\1."),
            (r"\.img_mod\.1\.", ".img_mod."),
            (r"\.txt_mod\.1\.", ".txt_mod."),
            (r"\.attn\.to_out\.0\.", ".to_out."),
            (r"(transformer_blocks\.\d+)\.attn\.", r"\1."),
            (r"\.(img|txt)_mlp\.net\.0\.proj\.", r".\1_mlp.fc1."),
            (r"\.(img|txt)_mlp\.net\.2\.", r".\1_mlp.fc2."),
            (r"^norm_out\.linear\.", "norm_out_linear."),
            (r"(controlnet_blocks\.\d+)\.weight$", r"\1.kernel"),
            (r"(img_in|txt_in|to_q|to_k|to_v|to_out|to_add_out|add_q_proj|add_k_proj|add_v_proj|img_mod|"
             r"txt_mod|fc1|fc2|proj_out|norm_out_linear|timestep_linear_\d|controlnet_x_embedder)\.weight$",
             r"\1.kernel"),
        ],
        drop=(r"^pos_embed", r"rotary"),
    ),
)

converter_registry.add(
    # the Wan VAE (diffusers AutoencoderKLWan / AutoencoderKLQwenImage naming):
    # the resample conv sits at index 1 of a Sequential, the attention's 1×1
    # convs become raw matrices, RMS gammas are [C, 1, 1(, 1)]
    "wan_vae",
    KeyConverter(
        renames=[
            (r"\.resample\.1\.", ".resample_conv."),
            (r"\.to_qkv\.weight$", ".to_qkv_kernel"),
            (r"\.to_qkv\.bias$", ".to_qkv_bias"),
            (r"\.proj\.weight$", ".proj_kernel"),
            (r"\.proj\.bias$", ".proj_bias"),
            (r"(conv1|conv2|conv_shortcut|conv_in|conv_out|quant_conv|post_quant_conv|time_conv|resample_conv)"
             r"\.weight$", r"\1.kernel"),
        ],
        strip_prefixes=(),
        drop=(),
    ),
)

converter_registry.add(
    # the Wan DiT (diffusers WanTransformer3DModel naming); patch_embedding is a
    # Conv3d weight [O, C, pt, ph, pw] that apply_state_dict flattens into the
    # patch Linear
    "wan",
    KeyConverter(
        renames=[
            (r"^condition_embedder\.time_embedder\.linear_(\d)\.", r"time_embedder_linear_\1."),
            (r"^condition_embedder\.time_proj\.", "time_proj."),
            (r"^condition_embedder\.text_embedder\.linear_(\d)\.", r"text_embedder_linear_\1."),
            (r"^condition_embedder\.image_embedder\.norm1\.weight$", "img_norm1"),
            (r"^condition_embedder\.image_embedder\.norm1\.bias$", "img_norm1_bias"),
            (r"^condition_embedder\.image_embedder\.norm2\.weight$", "img_norm2"),
            (r"^condition_embedder\.image_embedder\.norm2\.bias$", "img_norm2_bias"),
            (r"^condition_embedder\.image_embedder\.ff\.net\.0\.proj\.", "img_ff1."),
            (r"^condition_embedder\.image_embedder\.ff\.net\.2\.", "img_ff2."),
            (r"\.to_out\.0\.", ".to_out."),
            (r"\.norm2\.weight$", ".norm2_weight"),
            (r"\.norm2\.bias$", ".norm2_bias"),
            (r"\.ffn\.net\.0\.proj\.", ".ffn.fc1."),
            (r"\.ffn\.net\.2\.", ".ffn.fc2."),
            (r"^(vace_)?patch_embedding\.weight$", r"\1patch_embedding.kernel"),
            # ReCamMaster's per-block camera encoder, Apex-FramePack's packer
            # (Conv3d weights flattened into its Linears) and HoloCine's shot
            # table: the JAX table has none of them (ROADMAP Queue 3)
            (r"\.cam_encoder\.weight$", ".cam_encoder.kernel"),
            (r"^latent_embed_packer\.embedders\.(\d+)\.weight$", r"latent_embed_packer.embedders.\1.kernel"),
            (r"^shot_embedding\.weight$", "shot_embedding"),
            (r"(to_q|to_k|to_v|to_out|add_k_proj|add_v_proj|time_proj|fc1|fc2|img_ff1|img_ff2|proj_in|proj_out|"
             r"time_embedder_linear_\d|text_embedder_linear_\d)\.weight$", r"\1.kernel"),
        ],
        drop=(r"^rope\.", r"\.freqs"),
    ),
)

converter_registry.add(
    # SkyReels V2: the Wan DiT's layout plus the fps embedding and its
    # projection (reference transformer/skyreels/base/model.py:102)
    "skyreels",
    KeyConverter(
        renames=[
            (r"^condition_embedder\.time_embedder\.linear_(\d)\.", r"time_embedder_linear_\1."),
            (r"^condition_embedder\.time_proj\.", "time_proj."),
            (r"^condition_embedder\.text_embedder\.linear_(\d)\.", r"text_embedder_linear_\1."),
            (r"^condition_embedder\.fps_embedding\.weight$", "fps_embedding"),
            (r"^condition_embedder\.fps_projection\.0\.", "fps_projection_1."),
            (r"^condition_embedder\.fps_projection\.2\.", "fps_projection_2."),
            (r"^condition_embedder\.image_embedder\.norm1\.weight$", "img_norm1"),
            (r"^condition_embedder\.image_embedder\.norm1\.bias$", "img_norm1_bias"),
            (r"^condition_embedder\.image_embedder\.norm2\.weight$", "img_norm2"),
            (r"^condition_embedder\.image_embedder\.norm2\.bias$", "img_norm2_bias"),
            (r"^condition_embedder\.image_embedder\.ff\.net\.0\.proj\.", "img_ff1."),
            (r"^condition_embedder\.image_embedder\.ff\.net\.2\.", "img_ff2."),
            (r"\.to_out\.0\.", ".to_out."),
            (r"\.norm2\.weight$", ".norm2_weight"),
            (r"\.norm2\.bias$", ".norm2_bias"),
            (r"\.ffn\.net\.0\.proj\.", ".ffn.fc1."),
            (r"\.ffn\.net\.2\.", ".ffn.fc2."),
            (r"^patch_embedding\.weight$", "patch_embedding.kernel"),
            (r"(to_q|to_k|to_v|to_out|add_k_proj|add_v_proj|time_proj|fc1|fc2|img_ff1|img_ff2|proj_out|"
             r"fps_projection_\d|time_embedder_linear_\d|text_embedder_linear_\d)\.weight$", r"\1.kernel"),
        ],
        drop=(r"^rope\.", r"\.freqs"),
    ),
)

converter_registry.add(
    # transformers' CLIPVisionModel(WithProjection): the Wan 2.1 i2v image
    # encoder. Published files name the MLP ``layers.N.mlp.fc1``; the JAX
    # converter keeps ``.mlp.`` and so cannot load them (ROADMAP Queue 3):
    # here it is dropped, and keys without it load as well.
    "clip_vision",
    KeyConverter(
        renames=[
            (r"^vision_model\.embeddings\.class_embedding$", "class_embedding"),
            (r"^vision_model\.embeddings\.patch_embedding\.weight$", "patch_embedding.kernel"),
            (r"^vision_model\.embeddings\.position_embedding\.weight$", "position_embedding"),
            (r"^vision_model\.pre_layrnorm\.", "pre_layrnorm."),
            (r"^vision_model\.post_layernorm\.", "post_layernorm."),
            (r"^vision_model\.encoder\.layers\.", "layers."),
            (r"\.mlp\.(fc[12])\.", r".\1."),
            (r"(q_proj|k_proj|v_proj|out_proj|fc1|fc2)\.weight$", r"\1.kernel"),
        ],
        strip_prefixes=(),
        drop=(r"^visual_projection", r"^text_model", r"position_ids", r"logit_scale"),
    ),
)

_FLUX2_RENAMES = [
    (r"^time_guidance_embed\.timestep_embedder\.linear_(\d)\.", r"timestep_linear_\1."),
    (r"^time_guidance_embed\.guidance_embedder\.linear_(\d)\.", r"guidance_linear_\1."),
    (r"^(double_stream_modulation_img|double_stream_modulation_txt|single_stream_modulation)\.linear\.",
     r"\1."),
    (r"\.attn\.to_out\.0\.", ".to_out."),
    (r"\.attn\.to_out\.", ".to_out."),  # single blocks: a plain Linear
    (r"(transformer_blocks\.\d+)\.attn\.", r"\1."),
    (r"(single_transformer_blocks\.\d+)\.attn\.", r"\1."),
    (r"\.ff(_context)?\.linear_in\.", r".ff\1.linear_in."),
    (r"^norm_out\.linear\.", "norm_out_linear."),
]
_FLUX2_LINEARS = ("to_q|to_k|to_v|to_out|to_add_out|add_q_proj|add_k_proj|add_v_proj|to_qkv_mlp_proj|linear_in|"
                  "linear_out|x_embedder|context_embedder|proj_out|norm_out_linear|timestep_linear_\\d|"
                  "guidance_linear_\\d|double_stream_modulation_img|double_stream_modulation_txt|"
                  "single_stream_modulation")

converter_registry.add(
    # FLUX.2's DiT (diffusers Flux2Transformer2DModel naming)
    "flux2",
    KeyConverter(
        renames=_FLUX2_RENAMES + [(rf"({_FLUX2_LINEARS})\.weight$", r"\1.kernel")],
        drop=(r"^pos_embed\.",),
    ),
)

converter_registry.add(
    # Flux2ControlTransformer2DModel: the flux2 layout plus the control chain
    "flux2_control",
    KeyConverter(
        renames=_FLUX2_RENAMES + [(rf"({_FLUX2_LINEARS}|before_proj|after_proj|control_img_in)\.weight$",
                                   r"\1.kernel")],
        drop=(r"^pos_embed\.",),
    ),
)

converter_registry.add(
    # FLUX.2's VAE (diffusers AutoencoderKLFlux2): AutoencoderKL plus the
    # BatchNorm running statistics of the packed latents
    "flux2_vae",
    KeyConverter(
        renames=[
            (r"^bn\.running_mean$", "bn_mean"),
            (r"^bn\.running_var$", "bn_var"),
            (r"\.to_out\.0\.", ".to_out."),
            (r"(conv|conv1|conv2|conv_shortcut|conv_in|conv_out|quant_conv|post_quant_conv)\.weight$",
             r"\1.kernel"),
            (r"(to_q|to_k|to_v|to_out)\.weight$", r"\1.kernel"),
        ],
        strip_prefixes=(),
        drop=(r"num_batches_tracked",),
    ),
)

converter_registry.add(
    # Llama-architecture text towers (LlamaModel, Llava's and Mistral3's
    # language model)
    "llama",
    KeyConverter(
        renames=[
            # llava checkpoints nest the text tower; plain LlamaModel does not
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
        drop=(r"^lm_head\.", r"rotary_emb", r"^vision_tower\.", r"^multi_modal_projector\."),
    ),
)

converter_registry.add(
    # transformers' Wav2Vec2Model (HuMo's audio encoder); Wav2Vec2ForCTC nests
    # it under ``wav2vec2.``; the positional conv's weight norm is kept as
    # (g, v) in either of torch's two spellings
    "wav2vec2",
    KeyConverter(
        renames=[
            (r"^wav2vec2\.", ""),
            (r"^feature_extractor\.conv_layers\.(\d+)\.conv\.weight$", r"conv_layers.\1.conv.kernel"),
            (r"^feature_extractor\.conv_layers\.(\d+)\.conv\.bias$", r"conv_layers.\1.conv.bias"),
            (r"^feature_extractor\.conv_layers\.(\d+)\.layer_norm\.", r"conv_layers.\1.layer_norm."),
            (r"^feature_projection\.layer_norm\.", "fp_layer_norm."),
            (r"^feature_projection\.projection\.weight$", "fp_projection.kernel"),
            (r"^feature_projection\.projection\.bias$", "fp_projection.bias"),
            (r"^encoder\.pos_conv_embed\.conv\.parametrizations\.weight\.original0$", "pos_conv_g"),
            (r"^encoder\.pos_conv_embed\.conv\.parametrizations\.weight\.original1$", "pos_conv_v"),
            (r"^encoder\.pos_conv_embed\.conv\.weight_g$", "pos_conv_g"),
            (r"^encoder\.pos_conv_embed\.conv\.weight_v$", "pos_conv_v"),
            (r"^encoder\.pos_conv_embed\.conv\.bias$", "pos_conv_bias"),
            (r"^encoder\.layer_norm\.", "enc_layer_norm."),
            (r"^encoder\.layers\.(\d+)\.attention\.", r"layers.\1."),
            (r"^encoder\.layers\.(\d+)\.feed_forward\.", r"layers.\1."),
            (r"^encoder\.layers\.(\d+)\.", r"layers.\1."),
            (r"(q_proj|k_proj|v_proj|out_proj|intermediate_dense|output_dense)\.weight$", r"\1.kernel"),
        ],
        strip_prefixes=(),
        drop=(r"^masked_spec_embed$", r"^quantizer\.", r"^project_q\.", r"^project_hid\.", r"adapter"),
    ),
)

converter_registry.add(
    # HuMo (q/k/v/o attention naming, the audio projection's DummyAdapterLayer
    # wrappers)
    "wan_humo",
    KeyConverter(
        renames=[
            (r"^patch_embedding\.weight$", "patch_embedding.kernel"),
            (r"^text_embedding\.0\.", "text_embedding_1."),
            (r"^text_embedding\.2\.", "text_embedding_2."),
            (r"^time_embedding\.0\.", "time_embedding_1."),
            (r"^time_embedding\.2\.", "time_embedding_2."),
            (r"^time_projection\.1\.", "time_projection."),
            (r"^audio_proj\.audio_proj_glob_(\d)\.layer\.", r"audio_proj.glob_\1."),
            (r"^audio_proj\.audio_proj_glob_norm\.layer\.", "audio_proj.glob_norm."),
            (r"\.self_attn\.([qkvo])\.", r".to_\1."),
            (r"\.self_attn\.norm_([qk])\.", r".norm_\1."),
            (r"\.cross_attn\.([qkvo])\.", r".c_to_\1."),
            (r"\.cross_attn\.norm_([qk])\.", r".c_norm_\1."),
            (r"\.audio_cross_attn_wrapper\.audio_cross_attn\.([qkvo])\.", r".a_to_\1."),
            (r"\.audio_cross_attn_wrapper\.audio_cross_attn\.norm_([qk])\.", r".a_norm_\1."),
            (r"\.audio_cross_attn_wrapper\.norm1_audio\.(weight|bias)$", r".norm1_audio_\1"),
            (r"\.norm3\.(weight|bias)$", r".norm3_\1"),
            (r"\.ffn\.0\.", ".ffn.fc1."),
            (r"\.ffn\.2\.", ".ffn.fc2."),
            (r"^head\.modulation$", "head_norm_mod"),
            (r"^head\.head\.weight$", "head.kernel"),
            (r"^head\.head\.bias$", "head.bias"),
            (r"(to_q|to_k|to_v|to_o|c_to_q|c_to_k|c_to_v|c_to_o|a_to_q|a_to_k|a_to_v|a_to_o|fc1|fc2|glob_\d|"
             r"text_embedding_\d|time_embedding_\d|time_projection)\.weight$", r"\1.kernel"),
        ],
        drop=(r"^freqs", r"^head\.norm\."),
    ),
)


converter_registry.add(
    "hunyuanvideo_avatar",
    KeyConverter(
        # HunyuanAvatarVideoTransformer3DModel (reference
        # src/transformer/hunyuanvideo/avatar/model.py:780): hunyuanvideo
        # layout plus ref embedders, motion/fps condition MLPs, whisper
        # audio projection and the perceiver audio adapters.
        renames=[
            (r"^x_embedder\.proj\.weight$", "x_embedder.kernel"),
            (r"^x_embedder\.proj\.bias$", "x_embedder.bias"),
            (r"^ref_latents_embedder\.proj\.weight$",
             "ref_latents_embedder.kernel"),
            (r"^ref_latents_embedder\.proj\.bias$",
             "ref_latents_embedder.bias"),
            (r"^time_text_embed\.timestep_embedder\.linear_(\d)\.",
             r"time_linear_\1."),
            (r"^time_text_embed\.text_embedder\.linear_(\d)\.",
             r"text_linear_\1."),
            (r"^time_text_embed\.guidance_embedder\.linear_(\d)\.",
             r"guidance_linear_\1."),
            (r"^time_text_embed\.motion_exp\.linear_(\d)\.",
             r"motion_exp_linear_\1."),
            (r"^time_text_embed\.motion_pose\.linear_(\d)\.",
             r"motion_pose_linear_\1."),
            (r"^time_text_embed\.fps_proj\.linear_(\d)\.", r"fps_linear_\1."),
            (r"^context_embedder\.time_text_embed\.timestep_embedder\.linear_(\d)\.",
             r"context_embedder.timestep_linear_\1."),
            (r"^context_embedder\.time_text_embed\.text_embedder\.linear_(\d)\.",
             r"context_embedder.text_linear_\1."),
            (r"^context_embedder\.token_refiner\.refiner_blocks\.",
             "context_embedder.refiner_blocks."),
            (r"(refiner_blocks\.\d+)\.attn\.to_out\.0\.", r"\1.to_out."),
            (r"(refiner_blocks\.\d+)\.attn\.", r"\1."),
            (r"(refiner_blocks\.\d+)\.ff\.net\.0\.proj\.", r"\1.ff_in."),
            (r"(refiner_blocks\.\d+)\.ff\.net\.2\.", r"\1.ff_out."),
            (r"(refiner_blocks\.\d+)\.norm_out\.linear\.", r"\1.ada_linear."),
            (r"^audio_projection\.norm\.weight$",
             "audio_projection.norm_weight"),
            (r"^audio_projection\.norm\.bias$", "audio_projection.norm_bias"),
            (r"^audio_projection\.(proj\d)\.", r"audio_projection.\1."),
            (r"(audio_adapter_blocks\.\d+)\.norm(\d)\.weight$",
             r"\1.norm\2_weight"),
            (r"(audio_adapter_blocks\.\d+)\.norm(\d)\.bias$",
             r"\1.norm\2_bias"),
            (r"\.norm1\.linear\.", ".norm1_linear."),
            (r"\.norm1_context\.linear\.", ".norm1_context_linear."),
            (r"\.norm\.linear\.", ".norm_linear."),
            (r"\.attn\.to_out\.0\.", ".to_out."),
            (r"(transformer_blocks\.\d+)\.attn\.", r"\1."),
            (r"(single_transformer_blocks\.\d+)\.attn\.", r"\1."),
            (r"\.ff(_context)?\.net\.0\.proj\.", r".ff\1.fc1."),
            (r"\.ff(_context)?\.net\.2\.", r".ff\1.fc2."),
            (r"^norm_out\.linear\.", "norm_out_linear."),
            (r"(to_q|to_k|to_v|to_kv|to_out|to_add_out|add_q_proj|add_k_proj|"
             r"add_v_proj|fc1|fc2|ff_in|ff_out|ada_linear|proj_in|proj_mlp|"
             r"proj_out|proj\d|norm1_linear|norm1_context_linear|norm_linear|"
             r"norm_out_linear|ref_latents_proj|time_linear_\d|"
             r"timestep_linear_\d|text_linear_\d|guidance_linear_\d|"
             r"motion_exp_linear_\d|motion_pose_linear_\d|fps_linear_\d)"
             r"\.weight$", r"\1.kernel"),
        ],
        drop=(r"^rope\.",),
    ),
)


converter_registry.add(
    "wan_s2v",
    KeyConverter(
        # Wan 2.2 S2V (reference src/transformer/wan/s2v/model.py:886).
        renames=[
            (r"^patch_embedding\.weight$", "patch_embedding.kernel"),
            (r"^condition_embedder\.time_embedder\.linear_(\d)\.",
             r"time_embedder_linear_\1."),
            (r"^condition_embedder\.time_proj\.", "time_proj."),
            (r"^condition_embedder\.text_embedder\.linear_(\d)\.",
             r"text_embedder_linear_\1."),
            (r"^condition_embedder\.causal_audio_encoder\.weights$",
             "causal_audio_encoder.weights"),
            (r"^condition_embedder\.causal_audio_encoder\.encoder\.",
             "causal_audio_encoder.encoder."),
            (r"^condition_embedder\.pose_embedder\.weight$", "pose_embedder.kernel"),
            (r"^condition_embedder\.pose_embedder\.bias$", "pose_embedder.bias"),
            (r"(conv1_local|conv1_global|conv2|conv3)\.conv\.weight$", r"\1.kernel_w"),
            (r"(conv1_local|conv1_global|conv2|conv3)\.conv\.bias$", r"\1.bias"),
            (r"^trainable_condition_mask\.weight$", "trainable_condition_mask"),
            (r"^audio_injector\.injector\.(\d+)\.", r"injector.\1.attn."),
            (r"^audio_injector\.injector_adain_layers\.(\d+)\.linear\.",
             r"injector.\1.adain_linear."),
            (r"^audio_injector\.injector_pre_norm_feat\.\d+\.", "DROPME."),
            (r"^audio_injector\.injector_pre_norm_vec\.\d+\.", "DROPME."),
            (r"^blocks\.(\d+)\.attn1\.", r"blocks.\1.attn1."),
            (r"^blocks\.(\d+)\.attn2\.", r"blocks.\1.attn2."),
            (r"\.attn(\d)\.norm_q\.", r".attn\1.norm_q."),
            (r"\.attn(\d)\.to_out\.0\.", r".attn\1.to_out."),
            (r"^blocks\.(\d+)\.norm2\.weight$", r"blocks.\1.norm2_weight"),
            (r"^blocks\.(\d+)\.norm2\.bias$", r"blocks.\1.norm2_bias"),
            (r"^blocks\.(\d+)\.ffn\.net\.0\.proj\.", r"blocks.\1.ffn.fc1."),
            (r"^blocks\.(\d+)\.ffn\.net\.2\.", r"blocks.\1.ffn.fc2."),
            (r"^norm_out\.", "DROPME."),  # affine-free
            (r"^scale_shift_table$", "norm_out_scale_shift"),
            (r"^frame_packer\.proj(_2x|_4x)?\.weight$", r"frame_packer.proj\1.kernel"),
            (r"^frame_packer\.proj(_2x|_4x)?\.bias$", r"frame_packer.proj\1.bias"),
            (r"(to_q|to_k|to_v|to_out|add_k_proj|add_v_proj|fc1|fc2|final_linear|adain_linear|time_embedder_linear_\d|text_embedder_linear_\d|time_proj|proj_out)\.weight$",
             r"\1.kernel"),
        ],
        drop=(r"DROPME", r"^rope\.", r"frame_packer\.rope"),
    ),
)


converter_registry.add(
    "wan_multitalk",
    KeyConverter(
        # Wan MultiTalk (reference src/transformer/wan/multitalk/model.py:982).
        renames=[
            (r"^patch_embedding\.weight$", "patch_embedding.kernel"),
            (r"^condition_embedder\.time_embedder\.linear_(\d)\.",
             r"time_embedder_linear_\1."),
            (r"^condition_embedder\.time_proj\.", "time_proj."),
            (r"^condition_embedder\.text_embedder\.linear_(\d)\.",
             r"text_embedder_linear_\1."),
            (r"^condition_embedder\.image_embedder\.norm1\.weight$", "img_norm1"),
            (r"^condition_embedder\.image_embedder\.norm1\.bias$", "img_norm1_bias"),
            (r"^condition_embedder\.image_embedder\.norm2\.weight$", "img_norm2"),
            (r"^condition_embedder\.image_embedder\.norm2\.bias$", "img_norm2_bias"),
            (r"^condition_embedder\.image_embedder\.ff\.net\.0\.proj\.", "img_ff1."),
            (r"^condition_embedder\.image_embedder\.ff\.net\.2\.", "img_ff2."),
            (r"^audio_proj\.", "audio_proj."),
            (r"\.attn1\.to_out\.0\.", ".to_out."),
            (r"\.attn1\.", "."),
            (r"\.attn2\.to_out\.0\.", ".c_to_out."),
            (r"\.attn2\.to_q\.", ".c_to_q."),
            (r"\.attn2\.to_k\.", ".c_to_k."),
            (r"\.attn2\.to_v\.", ".c_to_v."),
            (r"\.attn2\.norm_q\.", ".c_norm_q."),
            (r"\.attn2\.norm_k\.", ".c_norm_k."),
            (r"\.attn2\.add_k_proj\.", ".add_k_proj."),
            (r"\.attn2\.add_v_proj\.", ".add_v_proj."),
            (r"\.attn2\.norm_added_k\.", ".norm_added_k."),
            (r"\.audio_attn2\.q_linear\.", ".a_q_linear."),
            (r"\.audio_attn2\.kv_linear\.", ".a_kv_linear."),
            (r"\.audio_attn2\.proj\.", ".a_proj."),
            (r"\.norm2\.weight$", ".norm2_weight"),
            (r"\.norm2\.bias$", ".norm2_bias"),
            (r"\.norm_x\.weight$", ".norm_x_weight"),
            (r"\.norm_x\.bias$", ".norm_x_bias"),
            (r"\.ffn\.net\.0\.proj\.", ".ffn.fc1."),
            (r"\.ffn\.net\.2\.", ".ffn.fc2."),
            (r"^scale_shift_table$", "norm_out_scale_shift"),
            (r"(to_q|to_k|to_v|to_out|c_to_q|c_to_k|c_to_v|c_to_out|add_k_proj|add_v_proj|a_q_linear|a_kv_linear|a_proj|fc1|fc2|img_ff1|img_ff2|proj1|proj1_vf|proj2|proj3|time_embedder_linear_\d|text_embedder_linear_\d|time_proj|proj_out)\.weight$",
             r"\1.kernel"),
        ],
        drop=(r"^rope\.", r"audio_attn2\.(q_norm|k_norm|add_q_norm|add_k_norm)"),
    ),
)

converter_registry.add(
    # Official SAM2 checkpoint layout (sam2 package) → mask/sam2.py modules.
    "sam2",
    KeyConverter(
        renames=[
            (r"^image_encoder\.trunk\.", "trunk."),
            (r"^image_encoder\.neck\.convs\.(\d+)\.conv\.", r"neck.convs.\1."),
            (r"^sam_prompt_encoder\.pe_layer\.positional_encoding_gaussian_matrix$",
             "prompt_encoder.pe_gaussian"),
            (r"^sam_prompt_encoder\.point_embeddings\.(\d+)\.weight$",
             r"prompt_encoder.point_embeddings.\1"),
            (r"^sam_prompt_encoder\.not_a_point_embed\.weight$",
             "prompt_encoder.not_a_point_embed"),
            (r"^sam_prompt_encoder\.no_mask_embed\.weight$", "prompt_encoder.no_mask_embed"),
            (r"^sam_mask_decoder\.transformer\.layers\.", "mask_decoder.layers."),
            (r"^sam_mask_decoder\.transformer\.final_attn_token_to_image\.",
             "mask_decoder.final_attn_token_to_image."),
            (r"^sam_mask_decoder\.transformer\.norm_final_attn\.",
             "mask_decoder.norm_final_attn."),
            (r"^sam_mask_decoder\.iou_token\.weight$", "mask_decoder.iou_token"),
            (r"^sam_mask_decoder\.mask_tokens\.weight$", "mask_decoder.mask_tokens"),
            (r"^sam_mask_decoder\.obj_score_token\.weight$", "mask_decoder.obj_score_token"),
            (r"^sam_mask_decoder\.output_upscaling\.0\.", "mask_decoder.upscale1."),
            (r"^sam_mask_decoder\.output_upscaling\.1\.", "mask_decoder.upscale_norm."),
            (r"^sam_mask_decoder\.output_upscaling\.3\.", "mask_decoder.upscale2."),
            (r"^sam_mask_decoder\.", "mask_decoder."),
            (r"^sam_mask_decoder_extra\.", "mask_decoder."),
            (r"\.attn\.qkv\.", ".qkv."),
            (r"\.attn\.proj\.", ".proj_attn."),
            (r"\.mlp\.layers\.0\.", ".mlp_lin1."),
            (r"\.mlp\.layers\.1\.", ".mlp_lin2."),
            (r"\.mlp\.lin1\.", ".mlp_lin1."),
            (r"\.mlp\.lin2\.", ".mlp_lin2."),
            # before the generic ``proj.weight`` rule, which in the JAX table
            # takes it first and leaves ``patch_embed.proj.kernel`` (ROADMAP
            # Queue 3)
            (r"(patch_embed)\.proj\.weight$", r"\1.kernel"),
            (r"(q_proj|k_proj|v_proj|out_proj|qkv|proj_attn|proj|mlp_lin1|mlp_lin2)\.weight$",
             r"\1.kernel"),
            (r"(layers\.\d+)\.weight$", r"\1.kernel"),  # MLP heads
            (r"^conv_s0\.weight$", "conv_s0.kernel"),
            (r"^conv_s1\.weight$", "conv_s1.kernel"),
            (r"(neck\.convs\.\d+)\.weight$", r"\1.kernel"),
            (r"(patch_embed)\.proj\.weight$", r"\1.kernel"),
            (r"(patch_embed)\.proj\.bias$", r"\1.bias"),
            (r"(upscale1|upscale2)\.weight$", r"\1.kernel"),
        ],
        drop=(r"memory_", r"mask_downsample", r"maskmem", r"^obj_ptr", r"no_obj",
              r"temporal", r"^image_encoder\.neck\.position_encoding"),
    ),
)

converter_registry.add(
    "sam2_video",
    KeyConverter(
        renames=[
            # memory components (sam2 video checkpoints; the image keys go
            # through the "sam2" table)
            (r"^memory_attention\.layers\.", "memory_attention."),
            (r"^memory_attention\.norm\.", "memory_attention_norm."),
            # mask_downsampler Sequential (conv,LN,GELU)×4 + conv → packed
            (r"mask_downsampler\.encoder\.0\.", "mask_downsampler.encoder.0."),
            (r"mask_downsampler\.encoder\.1\.", "mask_downsampler.encoder.1."),
            (r"mask_downsampler\.encoder\.3\.", "mask_downsampler.encoder.2."),
            (r"mask_downsampler\.encoder\.4\.", "mask_downsampler.encoder.3."),
            (r"mask_downsampler\.encoder\.6\.", "mask_downsampler.encoder.4."),
            (r"mask_downsampler\.encoder\.7\.", "mask_downsampler.encoder.5."),
            (r"mask_downsampler\.encoder\.9\.", "mask_downsampler.encoder.6."),
            (r"mask_downsampler\.encoder\.10\.", "mask_downsampler.encoder.7."),
            (r"mask_downsampler\.encoder\.12\.", "mask_downsampler.encoder.8."),
            (r"fuser\.layers\.", "fuser."),
            (r"^obj_ptr_proj\.layers\.(\d+)\.weight$", r"obj_ptr_proj.layers.\1.kernel"),
            (r"(q_proj|k_proj|v_proj|out_proj|linear1|linear2|pwconv1|pwconv2)\.weight$",
             r"\1.kernel"),
            (r"(pix_feat_proj|out_proj|dwconv)\.weight$", r"\1.kernel"),
            (r"(mask_downsampler\.encoder\.\d+)\.weight$", r"\1.kernel"),
        ],
        drop=(r"no_mem_pos_enc", r"no_obj_ptr", r"obj_ptr_tpos_proj",
              r"\.freqs", r"rotary"),
    ),
)


converter_registry.add(
    # Wan 2.2 Animate (reference transformer/wan/animate/model.py:946): the
    # motion encoder's equalized-lr weights keep their names and published
    # layouts ([O, I, k, k] convs, [out, in] linears), the face encoder's
    # causal convs load as ``kernel_w`` [out, in, k], the face adapters' affine
    # pre-norms are dropped (the adapters normalise without affine, as in JAX)
    "wan_animate",
    KeyConverter(
        renames=[
            (r"^patch_embedding\.weight$", "patch_embedding.kernel"),
            (r"^pose_patch_embedding\.weight$", "pose_patch_embedding.kernel"),
            (r"^condition_embedder\.time_embedder\.linear_(\d)\.", r"time_embedder_linear_\1."),
            (r"^condition_embedder\.time_proj\.", "time_proj."),
            (r"^condition_embedder\.text_embedder\.linear_(\d)\.", r"text_embedder_linear_\1."),
            (r"^condition_embedder\.image_embedder\.norm1\.weight$", "img_norm1"),
            (r"^condition_embedder\.image_embedder\.norm1\.bias$", "img_norm1_bias"),
            (r"^condition_embedder\.image_embedder\.norm2\.weight$", "img_norm2"),
            (r"^condition_embedder\.image_embedder\.norm2\.bias$", "img_norm2_bias"),
            (r"^condition_embedder\.image_embedder\.ff\.net\.0\.proj\.", "img_ff1."),
            (r"^condition_embedder\.image_embedder\.ff\.net\.2\.", "img_ff2."),
            (r"^motion_encoder\.conv_in\.act_fn\.bias$", "motion_encoder.conv_in.act_bias"),
            (r"(res_blocks\.\d+\.conv\d(_skip)?)\.act_fn\.bias$", r"\1.act_bias"),
            (r"^face_encoder\.(conv1_local|conv2|conv3)\.weight$", r"face_encoder.\1.kernel_w"),
            (r"^face_encoder\.out_proj\.weight$", "face_encoder.out_proj.kernel"),
            (r"\.attn([12])\.to_out\.0\.", r".attn\1.to_out."),
            (r"^blocks\.(\d+)\.norm2\.(weight|bias)$", r"blocks.\1.norm2_\2"),
            (r"\.ffn\.net\.0\.proj\.", ".ffn.fc1."),
            (r"\.ffn\.net\.2\.", ".ffn.fc2."),
            (r"^scale_shift_table$", "norm_out_scale_shift"),
            (r"(to_q|to_k|to_v|to_out|add_k_proj|add_v_proj|fc1|fc2|img_ff1|img_ff2|time_embedder_linear_\d|"
             r"text_embedder_linear_\d|time_proj|proj_out)\.weight$", r"\1.kernel"),
        ],
        drop=(r"^face_adapter\.\d+\.pre_norm_(q|kv)\.", r"^rope\.", r"blur_kernel"),
    ),
)

converter_registry.add(
    # Lynx (reference transformer/wan/lynx/model.py:522): the IP adapter's
    # projections and registers live under ``attn2.processor``
    "wan_lynx",
    KeyConverter(
        renames=[
            (r"^patch_embedding\.weight$", "patch_embedding.kernel"),
            (r"^condition_embedder\.time_embedder\.linear_(\d)\.", r"time_embedder_linear_\1."),
            (r"^condition_embedder\.time_proj\.", "time_proj."),
            (r"^condition_embedder\.text_embedder\.linear_(\d)\.", r"text_embedder_linear_\1."),
            (r"\.attn2\.processor\.(to_k_ip|to_v_ip)\.", r".\1."),
            (r"\.attn2\.processor\.registers$", ".registers"),
            (r"\.attn(\d)\.to_out\.0\.", r".attn\1.to_out."),
            (r"\.norm2\.(weight|bias)$", r".norm2_\1"),
            (r"\.ffn\.net\.0\.proj\.", ".ffn.fc1."),
            (r"\.ffn\.net\.2\.", ".ffn.fc2."),
            (r"^scale_shift_table$", "norm_out_scale_shift"),
            (r"(to_q|to_k|to_v|to_out|to_k_ip|to_v_ip|fc1|fc2|time_embedder_linear_\d|text_embedder_linear_\d|"
             r"time_proj|proj_out)\.weight$", r"\1.kernel"),
        ],
        drop=(r"^rope\.",),
    ),
)

converter_registry.add(
    # Lynx's perceiver resampler: ``layers.N.0`` the attention, ``layers.N.1``
    # the feed-forward (its leading LayerNorm dropped, as in JAX)
    "lynx_resampler",
    KeyConverter(
        renames=[
            (r"^layers\.(\d+)\.0\.", r"attn_layers.\1."),
            (r"^layers\.(\d+)\.1\.1\.", r"ff_layers.\1.fc1."),
            (r"^layers\.(\d+)\.1\.3\.", r"ff_layers.\1.fc2."),
            (r"(to_q|to_kv|to_out|proj_in|proj_out|fc1|fc2)\.weight$", r"\1.kernel"),
        ],
        strip_prefixes=(),
        drop=(r"^layers\.\d+\.1\.0\.", r"^pos_emb"),
    ),
)

converter_registry.add(
    # SCAIL (reference transformer/wan/scail/model.py:1017): the original Wan
    # q/k/v/o naming, the i2v cross-attention's k_img / v_img
    "wan_scail",
    KeyConverter(
        renames=[
            (r"^patch_embedding(_pose)?\.weight$", r"patch_embedding\1.kernel"),
            (r"^text_embedding\.0\.", "text_embedding_1."),
            (r"^text_embedding\.2\.", "text_embedding_2."),
            (r"^time_embedding\.0\.", "time_embedding_1."),
            (r"^time_embedding\.2\.", "time_embedding_2."),
            (r"^time_projection\.1\.", "time_projection."),
            (r"^img_emb\.proj\.0\.", "img_norm_in."),
            (r"^img_emb\.proj\.1\.", "img_linear_1."),
            (r"^img_emb\.proj\.3\.", "img_linear_2."),
            (r"^img_emb\.proj\.4\.", "img_norm_out."),
            (r"\.self_attn\.([qkvo])\.", r".to_\1."),
            (r"\.self_attn\.norm_([qk])\.", r".norm_\1."),
            (r"\.cross_attn\.([qkvo])\.", r".c_to_\1."),
            (r"\.cross_attn\.norm_([qk])\.", r".c_norm_\1."),
            (r"\.cross_attn\.(k_img|v_img|norm_k_img)\.", r".\1."),
            (r"\.norm3\.(weight|bias)$", r".norm3_\1"),
            (r"\.ffn\.0\.", ".ffn.fc1."),
            (r"\.ffn\.2\.", ".ffn.fc2."),
            (r"^head\.modulation$", "head_norm_mod"),
            (r"^head\.head\.weight$", "head.kernel"),
            (r"^head\.head\.bias$", "head.bias"),
            # anchored at a dot: the JAX rule also renames ``norm_k_img.weight``
            # (ROADMAP Queue 3)
            (r"(^|\.)(to_q|to_k|to_v|to_o|c_to_q|c_to_k|c_to_v|c_to_o|k_img|v_img|fc1|fc2|img_linear_\d|"
             r"text_embedding_\d|time_embedding_\d|time_projection)\.weight$", r"\1\2.kernel"),
        ],
        drop=(r"^freqs", r"^head\.norm\."),
    ),
)

converter_registry.add(
    # Chroma (reference transformer/chroma/base/model.py; diffusers layout)
    "chroma",
    KeyConverter(
        renames=[
            (r"^distilled_guidance_layer\.layers\.(\d+)\.linear_1\.", r"distilled_guidance_layer.layers_1.\1."),
            (r"^distilled_guidance_layer\.layers\.(\d+)\.linear_2\.", r"distilled_guidance_layer.layers_2.\1."),
            (r"\.attn\.to_out\.0\.", ".attn.to_out."),
            (r"(single_transformer_blocks\.\d+)\.attn\.", r"\1."),
            (r"\.ff(_context)?\.net\.0\.proj\.", r".ff\1.fc1."),
            (r"\.ff(_context)?\.net\.2\.", r".ff\1.fc2."),
            (r"(x_embedder|context_embedder|to_q|to_k|to_v|to_out|to_add_out|add_q_proj|add_k_proj|add_v_proj|fc1|"
             r"fc2|proj_mlp|proj_out|in_proj|out_proj|linear_1|linear_2|layers_1\.\d+|layers_2\.\d+)\.weight$",
             r"\1.kernel"),
        ],
        drop=(r"^pos_embed", r"mod_proj"),
    ),
)

converter_registry.add(
    # HiDream-I1 (reference transformer/hidream/base/model.py, diffusers
    # layout); the MoE gate is a raw [experts, dim] matrix
    "hidream",
    KeyConverter(
        renames=[
            (r"^x_embedder\.proj\.", "x_embedder."),
            (r"^t_embedder\.timestep_embedder\.linear_1\.", "t_in_1."),
            (r"^t_embedder\.timestep_embedder\.linear_2\.", "t_in_2."),
            (r"^p_embedder\.pooled_embedder\.linear_1\.", "p_in_1."),
            (r"^p_embedder\.pooled_embedder\.linear_2\.", "p_in_2."),
            (r"^caption_projection\.(\d+)\.linear\.", r"caption_projection.\1."),
            (r"^(double|single)_stream_blocks\.(\d+)\.block\.", r"\1_stream_blocks.\2."),
            (r"^final_layer\.adaLN_modulation\.1\.", "final_adaln."),
            (r"\.adaLN_modulation\.1\.", ".adaln."),
            (r"^final_layer\.linear\.", "proj_out."),
            (r"\.ff_i\.gate\.weight$", ".ff_i.gate_weight"),
            (r"(to_q|to_k|to_v|to_out|to_q_t|to_k_t|to_v_t|to_out_t|w1|w2|w3|x_embedder|t_in_\d|p_in_\d|"
             r"caption_projection\.\d+|adaln|final_adaln|proj_out)\.weight$", r"\1.kernel"),
        ],
    ),
)

converter_registry.add(
    # HunyuanImage 2.1 (reference transformer/hunyuanimage/base/model.py):
    # HunyuanVideo's layout with time_guidance_embed, the meanflow
    # timestep_embedder_r and the byT5 projection context_embedder_2
    "hunyuanimage",
    KeyConverter(
        renames=[
            (r"^x_embedder\.proj\.weight$", "x_embedder.kernel"),
            (r"^x_embedder\.proj\.bias$", "x_embedder.bias"),
            (r"^time_guidance_embed\.timestep_embedder\.linear_(\d)\.", r"time_linear_\1."),
            (r"^time_guidance_embed\.timestep_embedder_r\.linear_(\d)\.", r"time_r_linear_\1."),
            (r"^time_guidance_embed\.guidance_embedder\.linear_(\d)\.", r"guidance_linear_\1."),
            (r"^context_embedder\.time_text_embed\.timestep_embedder\.linear_(\d)\.",
             r"context_embedder.timestep_linear_\1."),
            (r"^context_embedder\.time_text_embed\.text_embedder\.linear_(\d)\.", r"context_embedder.text_linear_\1."),
            (r"^context_embedder\.token_refiner\.refiner_blocks\.", "context_embedder.refiner_blocks."),
            (r"(refiner_blocks\.\d+)\.attn\.to_out\.0\.", r"\1.to_out."),
            (r"(refiner_blocks\.\d+)\.attn\.", r"\1."),
            (r"(refiner_blocks\.\d+)\.ff\.net\.0\.proj\.", r"\1.ff_in."),
            (r"(refiner_blocks\.\d+)\.ff\.net\.2\.", r"\1.ff_out."),
            (r"(refiner_blocks\.\d+)\.norm_out\.linear\.", r"\1.ada_linear."),
            (r"^context_embedder_2\.norm\.", "byt5_norm."),
            (r"^context_embedder_2\.linear_(\d)\.", r"byt5_linear_\1."),
            (r"\.norm1\.linear\.", ".norm1_linear."),
            (r"\.norm1_context\.linear\.", ".norm1_context_linear."),
            (r"\.norm\.linear\.", ".norm_linear."),
            (r"\.attn\.to_out\.0\.", ".to_out."),
            (r"(transformer_blocks\.\d+)\.attn\.", r"\1."),
            (r"(single_transformer_blocks\.\d+)\.attn\.", r"\1."),
            (r"\.ff(_context)?\.net\.0\.proj\.", r".ff\1.fc1."),
            (r"\.ff(_context)?\.net\.2\.", r".ff\1.fc2."),
            (r"^norm_out\.linear\.", "norm_out_linear."),
            (r"(to_q|to_k|to_v|to_out|to_add_out|add_q_proj|add_k_proj|add_v_proj|fc1|fc2|ff_in|ff_out|ada_linear|"
             r"proj_in|proj_mlp|proj_out|norm1_linear|norm1_context_linear|norm_linear|norm_out_linear|"
             r"time_linear_\d|time_r_linear_\d|timestep_linear_\d|text_linear_\d|guidance_linear_\d|"
             r"byt5_linear_\d)\.weight$", r"\1.kernel"),
        ],
        drop=(r"^rope\.",),
    ),
)

converter_registry.add(
    # HunyuanImage 2.1's 32x VAE (reference vae/hunyuanimage/model.py)
    "hunyuanimage_vae",
    KeyConverter(
        renames=[
            (r"\.attentions\.0\.norm\.", ".attentions.0.group_norm."),
            (r"\.attentions\.0\.proj\.", ".attentions.0.to_out."),
            (r"(conv|conv1|conv2|conv_shortcut|conv_in|conv_out)\.weight$", r"\1.kernel"),
            (r"(to_q|to_k|to_v|to_out)\.weight$", r"\1.kernel"),
        ],
        strip_prefixes=(),
    ),
)

converter_registry.add(
    # Ovis-Image (reference transformer/ovis/base/model.py): Flux's layout
    # with fused-SwiGLU feed-forwards and a context RMSNorm
    "ovis",
    KeyConverter(
        renames=[
            (r"^timestep_embedder\.linear_(\d)\.", r"timestep_linear_\1."),
            (r"\.norm1\.linear\.", ".norm1_linear."),
            (r"\.norm1_context\.linear\.", ".norm1_context_linear."),
            (r"\.norm\.linear\.", ".norm_linear."),
            (r"\.attn\.to_out\.0\.", ".attn.to_out."),
            # dual blocks keep their attention under .attn, single blocks hold the projections
            (r"(single_transformer_blocks\.\d+)\.attn\.", r"\1."),
            (r"\.ff(_context)?\.net\.0\.proj\.", r".ff\1.fc1."),
            (r"\.ff(_context)?\.net\.2\.", r".ff\1.fc2."),
            (r"^norm_out\.linear\.", "norm_out_linear."),
            (r"(to_q|to_k|to_v|to_out|to_add_out|add_q_proj|add_k_proj|add_v_proj|fc1|fc2|proj_mlp|proj_out|"
             r"x_embedder|context_embedder|norm1_linear|norm1_context_linear|norm_linear|norm_out_linear|"
             r"timestep_linear_\d)\.weight$", r"\1.kernel"),
        ],
        drop=(r"^pos_embed\.",),
    ),
)

converter_registry.add(
    # Bria FIBO (reference transformer/fibo/base/model.py): Flux's layout with
    # one caption projection a block
    "fibo",
    KeyConverter(
        renames=[
            (r"^time_embed\.timestep_embedder\.linear_(\d)\.", r"time_linear_\1."),
            (r"^caption_projection\.(\d+)\.linear\.", r"caption_projection.\1."),
            (r"\.norm1\.linear\.", ".norm1_linear."),
            (r"\.norm1_context\.linear\.", ".norm1_context_linear."),
            (r"\.norm\.linear\.", ".norm_linear."),
            (r"\.attn\.to_out\.0\.", ".attn.to_out."),
            (r"(single_transformer_blocks\.\d+)\.attn\.", r"\1."),
            (r"\.ff(_context)?\.net\.0\.proj\.", r".ff\1.fc1."),
            (r"\.ff(_context)?\.net\.2\.", r".ff\1.fc2."),
            (r"^norm_out\.linear\.", "norm_out_linear."),
            (r"(to_q|to_k|to_v|to_out|to_add_out|add_q_proj|add_k_proj|add_v_proj|fc1|fc2|proj_mlp|proj_out|"
             r"x_embedder|context_embedder|norm1_linear|norm1_context_linear|norm_linear|norm_out_linear|"
             r"time_linear_\d)\.weight$", r"\1.kernel"),
            (r"(caption_projection\.\d+)\.weight$", r"\1.kernel"),
        ],
        drop=(r"^pos_embed\.",),
    ),
)

converter_registry.add(
    # LongCat-Video DiT (reference src/transformer/longcat/base/model.py:171):
    # the patch embedding is a Conv3d, flattened to the Linear by the loader
    "longcat",
    KeyConverter(
        renames=[
            (r"^x_embedder\.proj\.weight$", "x_embedder.kernel"),
            (r"^x_embedder\.proj\.bias$", "x_embedder.bias"),
            (r"^t_embedder\.mlp\.0\.", "t_linear_1."),
            (r"^t_embedder\.mlp\.2\.", "t_linear_2."),
            (r"^y_embedder\.y_proj\.0\.", "y_linear_1."),
            (r"^y_embedder\.y_proj\.2\.", "y_linear_2."),
            (r"^final_layer\.adaLN_modulation\.1\.", "final_adaLN_linear."),
            (r"\.adaLN_modulation\.1\.", ".adaLN_linear."),
            (r"\.cross_attn\.q_linear\.", ".q_linear."),
            (r"\.cross_attn\.kv_linear\.", ".kv_linear."),
            (r"\.cross_attn\.proj\.", ".cross_proj."),
            (r"\.cross_attn\.q_norm\.", ".cross_q_norm."),
            (r"\.cross_attn\.k_norm\.", ".cross_k_norm."),
            (r"\.attn\.", "."),
            (r"\.ffn\.w(\d)\.", r".ffn_w\1."),
            (r"^final_layer\.linear\.", "final_linear."),
            (r"(qkv|proj|cross_proj|q_linear|kv_linear|ffn_w\d|adaLN_linear|final_adaLN_linear|final_linear|"
             r"t_linear_\d|y_linear_\d)\.weight$", r"\1.kernel"),
        ],
        drop=(r"^rope",),
    ),
)

converter_registry.add(
    # Cosmos Predict2 (diffusers' CosmosTransformer3DModel, reference
    # transformer/cosmos/base/model.py:489); the learnable position embedding
    # and the RoPE buffers are dropped, as the JAX table drops them
    "cosmos",
    KeyConverter(
        renames=[
            (r"^time_embed\.t_embedder\.linear_(\d)\.", r"t_linear_\1."),
            (r"^time_embed\.norm\.", "t_norm."),
            (r"^patch_embed\.proj\.", "patch_embed."),
            (r"\.attn(\d)\.to_out\.0\.", r".attn\1.to_out."),
            (r"\.ff\.net\.0\.proj\.", ".ff_in."),
            (r"\.ff\.net\.2\.", ".ff_out."),
            (r"(to_q|to_k|to_v|to_out|ff_in|ff_out|patch_embed|proj_out|t_linear_\d|linear_1|linear_2)\.weight$",
             r"\1.kernel"),
        ],
        drop=(r"^learnable_pos_embed", r"\.rope\."),
    ),
)

converter_registry.add(
    # Kandinsky 5.0 (reference transformer/kandinsky5/base/model.py:592)
    "kandinsky5",
    KeyConverter(
        renames=[
            (r"^time_embeddings\.in_layer\.", "time_in."),
            (r"^time_embeddings\.out_layer\.", "time_out."),
            (r"^text_embeddings\.in_layer\.", "text_in."),
            (r"^text_embeddings\.norm\.", "text_norm."),
            (r"^pooled_text_embeddings\.in_layer\.", "pooled_in."),
            (r"^pooled_text_embeddings\.norm\.", "pooled_norm."),
            (r"^visual_embeddings\.in_layer\.", "visual_in."),
            (r"^out_layer\.modulation\.out_layer\.", "out_modulation.out_layer."),
            (r"^out_layer\.out_layer\.", "out_layer."),
            (r"(to_query|to_key|to_value|in_layer|out_layer|time_in|time_out|text_in|pooled_in|visual_in)"
             r"\.weight$", r"\1.kernel"),
        ],
    ),
)

converter_registry.add(
    # CogVideoX DiT (diffusers CogVideoXTransformer3DModel)
    "cogvideo",
    KeyConverter(
        renames=[
            (r"^patch_embed\.proj\.", "patch_embed_proj."),
            (r"^patch_embed\.text_proj\.", "text_proj."),
            (r"^time_embedding\.linear_1\.", "time_embed.in_layer."),
            (r"^time_embedding\.linear_2\.", "time_embed.out_layer."),
            (r"\.attn1\.to_out\.0\.", ".attn1.to_out."),
            (r"\.ff\.net\.0\.proj\.", ".ff.fc1."),
            (r"\.ff\.net\.2\.", ".ff.fc2."),
            (r"^norm_out\.linear\.", "norm_out_linear."),
            (r"(to_q|to_k|to_v|to_out|fc1|fc2|patch_embed_proj|text_proj|in_layer|out_layer|norm_out_linear|proj_out|"
             r"norm1\.linear|norm2\.linear)\.weight$", r"\1.kernel"),
        ],
        # 2B-style learned positional embeddings and the param-free output norm
        drop=(r"^patch_embed\.pos_embedding", r"^norm_out\.norm\.", r"^time_proj\."),
    ),
)

converter_registry.add(
    # CogVideoX VAE (diffusers AutoencoderKLCogVideoX)
    "cogvideo_vae",
    KeyConverter(
        renames=[
            # (down|up)samplers are plain Conv2ds named .conv in both layouts
            (r"(downsamplers|upsamplers)\.0\.conv\.weight$", r"\1.0.conv.kernel"),
            # CogVideoXCausalConv3d wraps a .conv submodule (samplers keep theirs)
            (r"(?<!samplers\.0)\.conv\.weight$", ".kernel"),
            (r"(?<!samplers\.0)\.conv\.bias$", ".bias"),
            (r"^(encoder|decoder)\.conv_in\.weight$", r"\1.conv_in.kernel"),
            (r"^(encoder|decoder)\.conv_out\.weight$", r"\1.conv_out.kernel"),
            (r"\.conv_shortcut\.weight$", ".conv_shortcut.kernel"),
            (r"\.(conv1|conv2)\.weight$", r".\1.kernel"),
        ],
        drop=(r"^quant_conv\.", r"^post_quant_conv\."),
    ),
)

converter_registry.add(
    # LTX-Video DiT: the diffusers layout and the original Lightricks naming,
    # the latter pre-renamed to the former first
    "ltx",
    KeyConverter(
        renames=[
            (r"^proj_in\.", "patchify_proj."),
            (r"^time_embed\.", "adaln_single."),
            (r"\.norm_q\.", ".q_norm."),
            (r"\.norm_k\.", ".k_norm."),
            (r"^adaln_single\.emb\.timestep_embedder\.linear_1\.", "time_embed.in_layer."),
            (r"^adaln_single\.emb\.timestep_embedder\.linear_2\.", "time_embed.out_layer."),
            (r"^adaln_single\.linear\.", "time_proj."),
            (r"^caption_projection\.linear_1\.", "caption_in."),
            (r"^caption_projection\.linear_2\.", "caption_out."),
            (r"^transformer_blocks\.", "blocks."),
            (r"\.to_out\.0\.", ".to_out."),
            (r"\.ff\.net\.0\.proj\.", ".ff.fc1."),
            (r"\.ff\.net\.2\.", ".ff.fc2."),
            (r"(to_q|to_k|to_v|to_out|fc1|fc2|patchify_proj|proj_out|in_layer|out_layer|time_proj|caption_in|"
             r"caption_out)\.weight$", r"\1.kernel"),
        ],
        drop=(r"^rope\.",),
    ),
)

converter_registry.add(
    # LTX causal video VAE: convs inside CausalConv3d wrappers (".conv.weight"),
    # LayerNorms one level deeper, the per-channel statistics under hyphenated
    # buffer names
    "ltx_vae",
    KeyConverter(
        renames=[
            (r"^vae\.", ""),
            (r"^per_channel_statistics\.std-of-means$", "std_of_means"),
            (r"^per_channel_statistics\.mean-of-means$", "mean_of_means"),
            (r"\.time_embedder\.timestep_embedder\.linear_1\.", ".time_embedder.in_layer."),
            (r"\.time_embedder\.timestep_embedder\.linear_2\.", ".time_embedder.out_layer."),
            (r"^decoder\.last_time_embedder\.timestep_embedder\.linear_1\.", "decoder.last_time_embedder.in_layer."),
            (r"^decoder\.last_time_embedder\.timestep_embedder\.linear_2\.", "decoder.last_time_embedder.out_layer."),
            (r"\.norm(\d)\.norm\.", r".norm\1."),
            (r"\.conv_norm_out\.norm\.", ".conv_norm_out."),
            (r"\.conv\.conv\.weight$", ".conv.kernel"),
            (r"\.conv\.conv\.bias$", ".conv.bias"),
            (r"(conv_in|conv_out|conv1|conv2)\.conv\.weight$", r"\1.kernel"),
            (r"(conv_in|conv_out|conv1|conv2)\.conv\.bias$", r"\1.bias"),
            (r"(conv_shortcut)\.weight$", r"\1.kernel"),
            (r"(in_layer|out_layer)\.weight$", r"\1.kernel"),
        ],
        drop=(r"per_channel_statistics\.(channel|mean-of-stds)",),
    ),
)

converter_registry.add(
    # Mochi-1 AsymmDiT (diffusers MochiTransformer3DModel)
    "mochi",
    KeyConverter(
        renames=[
            (r"^patch_embed\.proj\.", "patch_proj."),
            (r"^time_embed\.timestep_embedder\.linear_1\.", "time_embed.in_layer."),
            (r"^time_embed\.timestep_embedder\.linear_2\.", "time_embed.out_layer."),
            (r"^time_embed\.pooler\.", "pooler."),
            (r"^time_embed\.caption_proj\.", "caption_proj."),
            (r"^pos_frequencies$", "rope.pos_frequencies"),
            (r"^transformer_blocks\.(\d+)\.norm1\.linear\.", r"blocks.\1.mod_x."),
            (r"^transformer_blocks\.(\d+)\.norm1_context\.linear(_1)?\.", r"blocks.\1.mod_y."),
            (r"^transformer_blocks\.(\d+)\.attn1\.", r"blocks.\1.attn."),
            (r"^transformer_blocks\.(\d+)\.ff\.net\.0\.proj\.", r"blocks.\1.ff_x.proj_in."),
            (r"^transformer_blocks\.(\d+)\.ff\.net\.2\.", r"blocks.\1.ff_x.proj_out."),
            (r"^transformer_blocks\.(\d+)\.ff_context\.net\.0\.proj\.", r"blocks.\1.ff_y.proj_in."),
            (r"^transformer_blocks\.(\d+)\.ff_context\.net\.2\.", r"blocks.\1.ff_y.proj_out."),
            (r"^norm_out\.linear(_1)?\.", "norm_out_linear."),
            (r"\.to_out\.0\.", ".to_out."),
            # the per-head RMS-norm scales are bare parameters
            (r"\.(norm_q|norm_k|norm_added_q|norm_added_k)\.weight$", r".\1"),
            (r"(to_q|to_k|to_v|to_kv|add_q_proj|add_k_proj|add_v_proj|to_out|to_add_out|proj_in|proj_out|in_layer|"
             r"out_layer|mod_x|mod_y|patch_proj|caption_proj|norm_out_linear|pooler\.to_q|pooler\.to_kv|"
             r"pooler\.to_out)\.weight$", r"\1.kernel"),
        ],
        drop=(r"^norm_out\.norm\.",),
    ),
)

converter_registry.add(
    # Mochi-1 VAE (diffusers AutoencoderKLMochi), encoder and decoder: the norms
    # wrap a ".norm_layer", the causal convs a ".conv"; the up blocks'
    # projections, proj_in and proj_out are Linears
    "mochi_vae",
    KeyConverter(
        renames=[
            (r"\.norm_layer\.", "."),
            (r"\.conv\.weight$", ".kernel"),
            (r"\.conv\.bias$", ".bias"),
            (r"^decoder\.conv_in\.weight$", "decoder.conv_in.kernel"),
            (r"\.to_out\.0\.", ".to_out."),
            (r"(to_q|to_k|to_v|to_out|proj|proj_in|proj_out)\.weight$", r"\1.kernel"),
        ],
        drop=(),
    ),
)

converter_registry.add(
    # HunyuanImage 3.0 3D-conv DC-AE (reference src/vae/hunyuanimage3/model.py:554
    # AutoencoderKLConv3D); GroupNorm names already match
    "hunyuanimage3_vae",
    KeyConverter(
        renames=[
            (r"\.down\.(\d+)\.block\.(\d+)\.", r".down_blocks.\1.resnets.\2."),
            (r"\.down\.(\d+)\.downsample\.", r".down_blocks.\1.downsamplers.0."),
            (r"\.up\.(\d+)\.block\.(\d+)\.", r".up_blocks.\1.resnets.\2."),
            (r"\.up\.(\d+)\.upsample\.", r".up_blocks.\1.upsamplers.0."),
            (r"\.mid\.block_1\.", ".mid_block_1."),
            (r"\.mid\.attn_1\.", ".mid_attn_1."),
            (r"\.mid\.block_2\.", ".mid_block_2."),
            (r"\.(q|k|v|proj_out|conv|conv1|conv2|nin_shortcut|conv_in|conv_out)\.weight$", r".\1.kernel"),
        ],
        strip_prefixes=("vae.",),
        drop=(),
    ),
)

converter_registry.add(
    # HunyuanImage 3.0 causal-MM MoE backbone (reference
    # src/transformer/hunyuanimage3/base/model.py:2189 HunyuanImage3ForCausalMM):
    # the decoder under `model.`, the UNet patch embed / final layer and three
    # TimestepEmbedders at the top level
    "hunyuanimage3",
    KeyConverter(
        renames=[
            (r"^model\.wte\.weight$", "wte"),
            (r"^model\.layers\.", "layers."),
            (r"\.mlp\.0\.(weight|bias)$", r".mlp_0.\1"),
            (r"\.mlp\.2\.(weight|bias)$", r".mlp_2.\1"),
            (r"\.in_layers\.0\.", ".in_norm."),
            (r"\.in_layers\.2\.", ".in_conv."),
            (r"\.emb_layers\.1\.", ".emb_layers."),
            (r"\.out_layers\.0\.", ".out_norm."),
            (r"\.out_layers\.3\.", ".out_conv."),
            (r"(final_layer\.model\.\d+)\.0\.(weight|bias)$", r"\1.norm.\2"),
            (r"(final_layer\.model\.\d+)\.2\.(weight|bias)$", r"\1.conv.\2"),
            (r"\.(qkv_proj|o_proj|wg|gate_and_up_proj|down_proj|emb_layers|mlp_0|mlp_2)\.weight$", r".\1.kernel"),
            (r"(patch_embed\.model\.0)\.weight$", r"\1.kernel"),
            (r"\.(in_conv|out_conv|skip_connection|conv)\.weight$", r".\1.kernel"),
        ],
        strip_prefixes=(),
        drop=(r"rotary_emb", r"num_batches_tracked", r"lm_head"),
    ),
)
