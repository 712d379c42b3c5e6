"""A port module's state dict under its family's published checkpoint names:
the inverse of loaders/converters.py for ``flux`` (diffusers naming, or the
original BFL single-file naming with fused qkv), ``t5`` (byT5 too), ``clip``,
``autoencoder_kl``, ``hunyuanvideo15`` and ``hunyuanvideo15_vae`` (diffusers
naming), ``tae_vae`` (TAEHV's ``nn.Sequential`` indices), ``zimage`` (the
single-file names of the Comfy-Org Z-Image files, control keys included),
``qwen3`` (transformers' ``Qwen3ForCausalLM``), ``rife`` (Practical-RIFE's
``flownet`` keys), ``qwenimage`` (diffusers' QwenImage DiT and ControlNet) and
``wan_vae`` (diffusers' ``AutoencoderKLWan``, with its ``[C, 1, 1(, 1)]`` RMS
gammas and 1×1-conv attention weights), ``wan`` (diffusers'
``WanTransformer3DModel`` and its VACE keys, ``patch_embedding`` and
``vace_patch_embedding`` as their Conv3d weights), ``clip_vision``
(transformers' ``CLIPVisionModel``, the patch embedding as its Conv2d weight),
``flux2`` (diffusers' ``Flux2Transformer2DModel``, its control variant's chain
too), ``flux2_vae`` (``AutoencoderKLFlux2``, the running statistics as
``bn.running_mean`` / ``bn.running_var``), ``llama`` (Mistral3's text
tower under ``language_model.model.``), ``hunyuanvideo`` and
``hunyuanvideo_vae`` (diffusers' ``HunyuanVideoTransformer3DModel``, with
FramePack's extra keys, and ``AutoencoderKLHunyuanVideo``), ``wan_humo``
(HuMo's reference names, ``patch_embedding`` as its Conv3d weight) and
``wav2vec2`` (transformers' ``Wav2Vec2Model``, the positional conv's weight
norm as ``weight_g`` / ``weight_v``), ``wan_s2v``, ``wan_multitalk`` and
``hunyuanvideo_avatar`` (the names their converters read: the reference's
``condition_embedder`` / ``audio_injector`` / ``audio_attn2`` levels, the
patch, pose and FramePack embeddings as Conv3d weights, the causal audio
convs as ``.conv.weight``).

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
_ZIMAGE = (
    (r"^control_x_embedder\.", "control_all_x_embedder.2-1."),
    (r"^x_embedder\.", "all_x_embedder.2-1."),
    (r"^final_layer\.adaLN_modulation\.", "all_final_layer.2-1.adaLN_modulation.1."),
    (r"^final_layer\.", "all_final_layer.2-1."),
    (r"^cap_embedder_norm\.", "cap_embedder.0."),
    (r"^cap_embedder_linear\.", "cap_embedder.1."),
    (r"^t_embedder\.in_layer\.", "t_embedder.mlp.0."),
    (r"^t_embedder\.out_layer\.", "t_embedder.mlp.2."),
    (r"\.attention\.to_out\.", ".attention.to_out.0."),
    (r"^((?:control_)?(?:layers|noise_refiner|context_refiner)\.\d+)\.adaLN_modulation\.",
     r"\1.adaLN_modulation.0."),
)
_QWEN3 = (
    (r"^embed_tokens$", "model.embed_tokens.weight"),
    (r"\.mlp\.w1\.", ".mlp.gate_proj."),
    (r"\.mlp\.w3\.", ".mlp.up_proj."),
    (r"\.mlp\.w2\.", ".mlp.down_proj."),
    (r"^(layers|norm)\.", r"model.\1."),
)
# Practical-RIFE ``flownet``: conv0 entries are Sequential(conv, PReLU), the
# residual units name their slope ``relu``, lastconv is Sequential(ConvTranspose2d,
# PixelShuffle)
_RIFE = (
    (r"^blocks\.(\d+)\.conv0\.(\d+)\.conv\.", r"block\1.conv0.\2.0."),
    (r"^blocks\.(\d+)\.conv0\.(\d+)\.act\.", r"block\1.conv0.\2.1."),
    (r"^blocks\.(\d+)\.convblock\.(\d+)\.act\.", r"block\1.convblock.\2.relu."),
    (r"^blocks\.(\d+)\.lastconv\.", r"block\1.lastconv.0."),
    (r"^blocks\.(\d+)\.", r"block\1."),
)
_QWENIMAGE = (
    (r"^timestep_linear_(\d)\.", r"time_text_embed.timestep_embedder.linear_\1."),
    (r"^(transformer_blocks\.\d+)\.(img|txt)_mod\.", r"\1.\2_mod.1."),
    (r"^(transformer_blocks\.\d+)\.to_out\.", r"\1.attn.to_out.0."),
    (r"^(transformer_blocks\.\d+)\.(to_q|to_k|to_v|add_q_proj|add_k_proj|add_v_proj|to_add_out|norm_q|norm_k|"
     r"norm_added_q|norm_added_k)\.", r"\1.attn.\2."),
    (r"\.(img|txt)_mlp\.fc1\.", r".\1_mlp.net.0.proj."),
    (r"\.(img|txt)_mlp\.fc2\.", r".\1_mlp.net.2."),
    (r"^norm_out_linear\.", "norm_out.linear."),
)
_WAN_VAE = (
    (r"\.resample_conv\.", ".resample.1."),
    (r"\.to_qkv_(weight|bias)$", r".to_qkv.\1"),
    (r"\.proj_(weight|bias)$", r".proj.\1"),
)

_WAN = (
    (r"^time_embedder_linear_(\d)\.", r"condition_embedder.time_embedder.linear_\1."),
    (r"^time_proj\.", "condition_embedder.time_proj."),
    (r"^text_embedder_linear_(\d)\.", r"condition_embedder.text_embedder.linear_\1."),
    (r"^img_norm([12])$", r"condition_embedder.image_embedder.norm\1.weight"),
    (r"^img_norm([12])_bias$", r"condition_embedder.image_embedder.norm\1.bias"),
    (r"^img_ff1\.", "condition_embedder.image_embedder.ff.net.0.proj."),
    (r"^img_ff2\.", "condition_embedder.image_embedder.ff.net.2."),
    (r"\.(attn[12])\.to_out\.", r".\1.to_out.0."),
    (r"\.norm2_(weight|bias)$", r".norm2.\1"),
    (r"\.ffn\.fc1\.", ".ffn.net.0.proj."),
    (r"\.ffn\.fc2\.", ".ffn.net.2."),
)
_CLIP_VISION = (
    (r"^class_embedding$", "vision_model.embeddings.class_embedding"),
    (r"^patch_embedding\.", "vision_model.embeddings.patch_embedding."),
    (r"^position_embedding$", "vision_model.embeddings.position_embedding.weight"),
    (r"^(pre_layrnorm|post_layernorm)\.", r"vision_model.\1."),
    (r"^layers\.(\d+)\.(fc[12])\.", r"vision_model.encoder.layers.\1.mlp.\2."),
    (r"^layers\.", "vision_model.encoder.layers."),
)

_FLUX2 = (
    (r"^(timestep|guidance)_linear_(\d)\.", r"time_guidance_embed.\1_embedder.linear_\2."),
    (r"^(double_stream_modulation_img|double_stream_modulation_txt|single_stream_modulation)\.",
     r"\1.linear."),
    (r"^((?:control_)?transformer_blocks\.\d+)\.to_out\.", r"\1.attn.to_out.0."),
    (r"^((?:control_)?transformer_blocks\.\d+)\.(to_q|to_k|to_v|add_q_proj|add_k_proj|add_v_proj|to_add_out|"
     r"norm_q|norm_k|norm_added_q|norm_added_k)\.", r"\1.attn.\2."),
    (r"^(single_transformer_blocks\.\d+)\.(to_qkv_mlp_proj|to_out|norm_q|norm_k)\.", r"\1.attn.\2."),
    (r"^norm_out_linear\.", "norm_out.linear."),
)
_FLUX2_VAE = (
    (r"^bn_mean$", "bn.running_mean"),
    (r"^bn_var$", "bn.running_var"),
    (r"\.to_out\.", ".to_out.0."),
)
_LLAMA = (
    (r"^embed_tokens$", "language_model.model.embed_tokens.weight"),
    (r"\.mlp\.w1\.", ".mlp.gate_proj."),
    (r"\.mlp\.w3\.", ".mlp.up_proj."),
    (r"\.mlp\.w2\.", ".mlp.down_proj."),
    (r"^(layers|norm)\.", r"language_model.model.\1."),
)

_HUNYUANVIDEO = (
    (r"^x_embedder\.", "x_embedder.proj."),
    (r"^(time|text|guidance)_linear_(\d)\.", r"time_text_embed.\1_embedder.linear_\2."),
    (r"^time_text_embed\.time_embedder\.", "time_text_embed.timestep_embedder."),
    (r"^context_embedder\.(timestep|text)_linear_(\d)\.",
     r"context_embedder.time_text_embed.\1_embedder.linear_\2."),
    (r"^context_embedder\.refiner_blocks\.(\d+)\.to_out\.", r"context_embedder.refiner_blocks.\1.attn.to_out.0."),
    (r"^context_embedder\.refiner_blocks\.(\d+)\.(to_q|to_k|to_v)\.", r"context_embedder.refiner_blocks.\1.attn.\2."),
    (r"^context_embedder\.refiner_blocks\.(\d+)\.ff_in\.", r"context_embedder.refiner_blocks.\1.ff.net.0.proj."),
    (r"^context_embedder\.refiner_blocks\.(\d+)\.ff_out\.", r"context_embedder.refiner_blocks.\1.ff.net.2."),
    (r"^context_embedder\.refiner_blocks\.(\d+)\.ada_linear\.", r"context_embedder.refiner_blocks.\1.norm_out.linear."),
    (r"^context_embedder\.refiner_blocks\.", "context_embedder.token_refiner.refiner_blocks."),
    (r"\.norm1_linear\.", ".norm1.linear."),
    (r"\.norm1_context_linear\.", ".norm1_context.linear."),
    (r"^(single_transformer_blocks\.\d+)\.norm_linear\.", r"\1.norm.linear."),
    (r"^(single_transformer_blocks\.\d+)\.(to_q|to_k|to_v|norm_q|norm_k)\.", r"\1.attn.\2."),
    (r"^(transformer_blocks\.\d+)\.to_out\.", r"\1.attn.to_out.0."),
    (r"^(transformer_blocks\.\d+)\.(to_q|to_k|to_v|add_q_proj|add_k_proj|add_v_proj|to_add_out|norm_q|norm_k|"
     r"norm_added_q|norm_added_k)\.", r"\1.attn.\2."),
    (r"\.ff(_context)?\.fc1\.", r".ff\1.net.0.proj."),
    (r"\.ff(_context)?\.fc2\.", r".ff\1.net.2."),
    (r"^norm_out_linear\.", "norm_out.linear."),
)
# each causal conv wraps its Conv3d as ``.conv``; the quant convs, the group
# norms and the mid attention's projections have no extra level
_HUNYUANVIDEO_VAE = (
    (r"^(.*\.(?:conv_in|conv_out|conv1|conv2|conv_shortcut|conv))\.(weight|bias)$", r"\1.conv.\2"),
    (r"\.to_out\.", ".to_out.0."),
)
_WAN_HUMO = (
    (r"^text_embedding_([12])\.", lambda m: f"text_embedding.{2 * int(m.group(1)) - 2}."),
    (r"^time_embedding_([12])\.", lambda m: f"time_embedding.{2 * int(m.group(1)) - 2}."),
    (r"^time_projection\.", "time_projection.1."),
    (r"^audio_proj\.glob_(\d|norm)\.", r"audio_proj.audio_proj_glob_\1.layer."),
    (r"\.a_to_([qkvo])\.", r".audio_cross_attn_wrapper.audio_cross_attn.\1."),
    (r"\.a_norm_([qk])\.", r".audio_cross_attn_wrapper.audio_cross_attn.norm_\1."),
    (r"\.norm1_audio_(weight|bias)$", r".audio_cross_attn_wrapper.norm1_audio.\1"),
    (r"\.c_to_([qkvo])\.", r".cross_attn.\1."),
    (r"\.c_norm_([qk])\.", r".cross_attn.norm_\1."),
    (r"^(blocks\.\d+)\.to_([qkvo])\.", r"\1.self_attn.\2."),
    (r"^(blocks\.\d+)\.norm_([qk])\.", r"\1.self_attn.norm_\2."),
    (r"\.norm3_(weight|bias)$", r".norm3.\1"),
    (r"\.ffn\.fc1\.", ".ffn.0."),
    (r"\.ffn\.fc2\.", ".ffn.2."),
    (r"^head_norm_mod$", "head.modulation"),
    (r"^head\.(weight|bias)$", r"head.head.\1"),
)
_HUNYUANVIDEO_AVATAR = _HUNYUANVIDEO + (
    (r"^ref_latents_embedder\.", "ref_latents_embedder.proj."),
    (r"^(motion_exp|motion_pose)_linear_(\d)\.", r"time_text_embed.\1.linear_\2."),
    (r"^fps_linear_(\d)\.", r"time_text_embed.fps_proj.linear_\1."),
    (r"^audio_projection\.norm_(weight|bias)$", r"audio_projection.norm.\1"),
    (r"^(audio_adapter_blocks\.\d+)\.norm(\d)_(weight|bias)$", r"\1.norm\2.\3"),
)
_WAN_S2V = (
    (r"^(time|text)_embedder_linear_(\d)\.", r"condition_embedder.\1_embedder.linear_\2."),
    (r"^time_proj\.", "condition_embedder.time_proj."),
    (r"^(causal_audio_encoder|pose_embedder)\.", r"condition_embedder.\1."),
    (r"\.(conv1_local|conv1_global|conv2|conv3)\.kernel_w$", r".\1.conv.weight"),
    (r"\.(conv1_local|conv1_global|conv2|conv3)\.bias$", r".\1.conv.bias"),
    (r"^trainable_condition_mask$", "trainable_condition_mask.weight"),
    (r"^injector\.(\d+)\.attn\.", r"audio_injector.injector.\1."),
    (r"^injector\.(\d+)\.adain_linear\.", r"audio_injector.injector_adain_layers.\1.linear."),
    (r"^(blocks\.\d+)\.(attn\d)\.to_out\.", r"\1.\2.to_out.0."),
    (r"^(blocks\.\d+)\.norm2_(weight|bias)$", r"\1.norm2.\2"),
    (r"\.ffn\.fc1\.", ".ffn.net.0.proj."),
    (r"\.ffn\.fc2\.", ".ffn.net.2."),
    (r"^norm_out_scale_shift$", "scale_shift_table"),
)
_WAN_MULTITALK = (
    (r"^(time|text)_embedder_linear_(\d)\.", r"condition_embedder.\1_embedder.linear_\2."),
    (r"^time_proj\.", "condition_embedder.time_proj."),
    (r"^img_norm(\d)$", r"condition_embedder.image_embedder.norm\1.weight"),
    (r"^img_norm(\d)_bias$", r"condition_embedder.image_embedder.norm\1.bias"),
    (r"^img_ff1\.", "condition_embedder.image_embedder.ff.net.0.proj."),
    (r"^img_ff2\.", "condition_embedder.image_embedder.ff.net.2."),
    (r"^(blocks\.\d+)\.to_out\.", r"\1.attn1.to_out.0."),
    (r"^(blocks\.\d+)\.(to_q|to_k|to_v|norm_q|norm_k)\.", r"\1.attn1.\2."),
    (r"^(blocks\.\d+)\.c_to_out\.", r"\1.attn2.to_out.0."),
    (r"^(blocks\.\d+)\.c_(to_q|to_k|to_v|norm_q|norm_k)\.", r"\1.attn2.\2."),
    (r"^(blocks\.\d+)\.(add_k_proj|add_v_proj|norm_added_k)\.", r"\1.attn2.\2."),
    (r"^(blocks\.\d+)\.a_(q_linear|kv_linear)\.", r"\1.audio_attn2.\2."),
    (r"^(blocks\.\d+)\.a_proj\.", r"\1.audio_attn2.proj."),
    (r"^(blocks\.\d+)\.(norm2|norm_x)_(weight|bias)$", r"\1.\2.\3"),
    (r"\.ffn\.fc1\.", ".ffn.net.0.proj."),
    (r"\.ffn\.fc2\.", ".ffn.net.2."),
    (r"^norm_out_scale_shift$", "scale_shift_table"),
)
_WAV2VEC2 = (
    (r"^conv_layers\.", "feature_extractor.conv_layers."),
    (r"^fp_layer_norm\.", "feature_projection.layer_norm."),
    (r"^fp_projection\.", "feature_projection.projection."),
    (r"^pos_conv_(g|v)$", r"encoder.pos_conv_embed.conv.weight_\1"),
    (r"^pos_conv_bias$", "encoder.pos_conv_embed.conv.bias"),
    (r"^enc_layer_norm\.", "encoder.layer_norm."),
    (r"^layers\.(\d+)\.(q_proj|k_proj|v_proj|out_proj)\.", r"encoder.layers.\1.attention.\2."),
    (r"^layers\.(\d+)\.(intermediate_dense|output_dense)\.", r"encoder.layers.\1.feed_forward.\2."),
    (r"^layers\.", "encoder.layers."),
)


def _wan_vae_layout(key: str, value: torch.Tensor) -> torch.Tensor:
    """diffusers' shapes: the attention's 1×1 conv weights ``[O, C, 1, 1]``,
    its norm's gamma ``[C, 1, 1]``, every other gamma ``[C, 1, 1, 1]``."""
    if key.endswith((".to_qkv.weight", ".proj.weight")):
        return value[:, :, None, None]
    if key.endswith(".norm.gamma"):
        return value[:, None, None]
    if key.endswith(".gamma"):
        return value[:, None, None, None]
    return value


def _wan_layout(key: str, value: torch.Tensor) -> torch.Tensor:
    """``patch_embedding.weight`` (and VACE's ``vace_patch_embedding.weight``)
    as the published Conv3d weight ``[O, C, 1, 2, 2]`` (every published Wan
    DiT patches (1, 2, 2))."""
    if key in ("patch_embedding.weight", "vace_patch_embedding.weight"):
        return value.reshape(value.shape[0], -1, 1, 2, 2)
    return value


def _wan_humo_layout(key: str, value: torch.Tensor) -> torch.Tensor:
    """``patch_embedding.weight`` as the published Conv3d weight
    ``[O, C, 1, 2, 2]``."""
    if key == "patch_embedding.weight":
        return value.reshape(value.shape[0], -1, 1, 2, 2)
    return value


def _wan_s2v_layout(key: str, value: torch.Tensor) -> torch.Tensor:
    """The patch and pose embeddings and the FramePack projections as their
    published Conv3d weights ``[O, C, pt, ph, pw]``."""
    patch = {"patch_embedding.weight": (1, 2, 2), "condition_embedder.pose_embedder.weight": (1, 2, 2),
             "frame_packer.proj.weight": (1, 2, 2), "frame_packer.proj_2x.weight": (2, 4, 4),
             "frame_packer.proj_4x.weight": (4, 8, 8)}.get(key)
    return value.reshape(value.shape[0], -1, *patch) if patch else value


def _clip_vision_layout(key: str, value: torch.Tensor) -> torch.Tensor:
    """The patch embedding as the published Conv2d weight ``[O, 3, p, p]``."""
    if key == "vision_model.embeddings.patch_embedding.weight":
        p = int(round((value.shape[1] // 3) ** 0.5))
        return value.reshape(value.shape[0], 3, p, p)
    return value


_LAYOUTS: Dict[str, Callable[[str, torch.Tensor], torch.Tensor]] = {
    "wan_vae": _wan_vae_layout, "wan": _wan_layout, "clip_vision": _clip_vision_layout,
    "wan_humo": _wan_humo_layout, "wan_multitalk": _wan_humo_layout, "wan_s2v": _wan_s2v_layout}
_TABLES: Dict[str, Sequence[Tuple[str, str]]] = {
    "flux": _FLUX, "t5": _T5, "clip": _CLIP, "autoencoder_kl": _AUTOENCODER_KL,
    "hunyuanvideo15": _HUNYUANVIDEO15, "hunyuanvideo15_vae": _HUNYUANVIDEO15_VAE, "tae_vae": _TAE_VAE,
    "zimage": _ZIMAGE, "qwen3": _QWEN3, "rife": _RIFE, "qwenimage": _QWENIMAGE, "wan_vae": _WAN_VAE,
    "wan": _WAN, "clip_vision": _CLIP_VISION, "flux2": _FLUX2, "flux2_vae": _FLUX2_VAE, "llama": _LLAMA,
    "hunyuanvideo": _HUNYUANVIDEO, "hunyuanvideo_vae": _HUNYUANVIDEO_VAE, "wan_humo": _WAN_HUMO,
    "wav2vec2": _WAV2VEC2, "wan_s2v": _WAN_S2V, "wan_multitalk": _WAN_MULTITALK,
    "hunyuanvideo_avatar": _HUNYUANVIDEO_AVATAR}


def published_state_dict(family: str, state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` of an unquantized port module → the family's
    published (diffusers / transformers) key naming. Layouts are torch's on
    both sides, so values pass through untouched, except where the published
    file keeps broadcast singletons (``wan_vae``)."""
    table = [(re.compile(p), r) for p, r in _TABLES[family]]
    layout = _LAYOUTS.get(family, lambda key, value: value)
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if key.endswith("weight_scale"):
            raise ValueError(f"{key}: a quantized module has no published form")
        for pat, repl in table:
            key = pat.sub(repl, key)
        out[key] = layout(key, value)
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
