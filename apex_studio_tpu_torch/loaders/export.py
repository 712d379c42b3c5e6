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
``vace_patch_embedding`` as their Conv3d weights; ReCamMaster's
``cam_encoder``, Apex-FramePack's packer embedders as Conv3d weights and
HoloCine's ``shot_embedding.weight``), ``wan_animate``, ``wan_lynx`` and
``wan_scail`` (the names their converters read, the patch embeddings as
Conv3d weights), ``lynx_resampler`` (the perceiver's ``layers.N.0`` /
``layers.N.1.{1,3}``), ``skyreels`` (SkyReels
V2's: Wan's with ``condition_embedder.fps_embedding`` /
``fps_projection``), ``clip_vision``
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
convs as ``.conv.weight``), and the preprocessors' published checkpoints:
``depth_anything_v2``, ``openpose``, ``hed`` (``ControlNetHED.pth``, its
``norm`` as ``[1, 3, 1, 1]``), ``teed`` (``7_model.pth``), ``lineart``
(``sk_model.pth``, ``sk_model2.pth`` and the anime scribble generator),
``lineart_anime`` (``netG.pth``'s nested U-Net blocks), ``manga_line``
(``erika.pth``), ``mlsd`` (``mlsd_large_512_fp32.pth``), ``efficientnet``
(timm's ``tf_efficientnet_b5``), ``normalbae`` (``scannet.pt``'s ``model``,
its heads as Conv1d weights), ``dsine`` (``dsine.pt``'s ``model``) and
``leres`` (``res101.pth``'s ``depth_model``, ``module.`` prefixed), ``u2net``
(``u2net.pth`` / ``u2netp.pth``'s rebnconv layers), ``isnet``
(``isnetis.ckpt``'s ``state_dict``, ``net.`` prefixed), ``anime_face``
(``Annotators/UNet.pth``'s ``en_block`` slices), ``gmflow``
(``gmflow-*-mixdata.pth``'s ``model``) and ``metric3d``
(``metric_depth_vit_*_800k.pth``'s ``model_state_dict``, ``depth_model.``
prefixed, the blocks unchunked); the other image families' ``chroma``,
``ovis`` and ``fibo`` (diffusers' Flux block names under each family's own
heads), ``hidream`` (diffusers' ``HiDreamImageTransformer2DModel``, the MoE
gate as ``ff_i.gate.weight``), ``hunyuanimage`` (diffusers'
``HunyuanImageTransformer2DModel``) and ``hunyuanimage_vae``
(``AutoencoderKLHunyuanImage``); ``longcat`` (LongCat-Video's reference
names, ``x_embedder.proj`` as its Conv3d weight), ``cosmos`` (diffusers'
``CosmosTransformer3DModel``) and ``kandinsky5`` (Kandinsky 5.0's reference
names); ``hunyuanimage3`` (the reference's ``HunyuanImage3ForCausalMM``,
the decoder under ``model.``) and ``hunyuanimage3_vae`` (its
``AutoencoderKLConv3D``); ``cogvideo`` (diffusers'
``CogVideoXTransformer3DModel``) and ``cogvideo_vae``
(``AutoencoderKLCogVideoX``, each causal conv's ``.conv``); ``mochi`` and
``mochi_vae`` (diffusers' ``MochiTransformer3DModel`` and ``AutoencoderKLMochi``,
the norms' ``.norm_layer`` and the causal convs' ``.conv``), ``ltx`` and
``ltx_vae`` (diffusers' ``LTXVideoTransformer3DModel`` and the Lightricks
``CausalVideoAutoencoder``, its convs' ``.conv`` and ``per_channel_statistics``);
LTX-2's ``ltx2`` (diffusers' ``LTX2VideoTransformer3DModel``), ``ltx2_vae``
and ``ltx2_audio_vae`` (their resnets, samplers and causal convs' ``.conv``),
``ltx2_connectors``, ``ltx2_upsampler`` (the norms' ``.weight``),
``ltx2_vocoder`` (the transposed convs' ``.weight``) and ``gemma3``
(``Gemma3ForConditionalGeneration``'s text tower under ``language_model.model.``);
MAGI-1's ``magi`` (the reference's names, the zero-centred gammas less 1, the
patch embedding as its Conv3d weight) and ``magi_vae``; FlashVSR's
``wan_flashvsr`` (the original Wan layout with ``LQ_proj_in``, its RMS
gammas as ``[C, 1, 1, 1]``) and ``tiny_wan_vae`` (TAEHV's indices). PiDiNet
has none: its converter folds the published pixel-difference weights into
vanilla kernels, which is not invertible.

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
    (r"^shot_embedding$", "shot_embedding.weight"),
)
_SKYREELS = (
    (r"^fps_embedding$", "condition_embedder.fps_embedding.weight"),
    (r"^fps_projection_1\.", "condition_embedder.fps_projection.0."),
    (r"^fps_projection_2\.", "condition_embedder.fps_projection.2."),
    *_WAN,
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
_WAN_ANIMATE = (
    (r"^(time|text)_embedder_linear_(\d)\.", r"condition_embedder.\1_embedder.linear_\2."),
    (r"^time_proj\.", "condition_embedder.time_proj."),
    (r"^img_norm([12])$", r"condition_embedder.image_embedder.norm\1.weight"),
    (r"^img_norm([12])_bias$", r"condition_embedder.image_embedder.norm\1.bias"),
    (r"^img_ff1\.", "condition_embedder.image_embedder.ff.net.0.proj."),
    (r"^img_ff2\.", "condition_embedder.image_embedder.ff.net.2."),
    (r"\.act_bias$", ".act_fn.bias"),
    (r"^face_encoder\.(conv1_local|conv2|conv3)\.kernel_w$", r"face_encoder.\1.weight"),
    (r"\.(attn[12])\.to_out\.", r".\1.to_out.0."),
    (r"^(blocks\.\d+)\.norm2_(weight|bias)$", r"\1.norm2.\2"),
    (r"\.ffn\.fc1\.", ".ffn.net.0.proj."),
    (r"\.ffn\.fc2\.", ".ffn.net.2."),
    (r"^norm_out_scale_shift$", "scale_shift_table"),
)
_WAN_LYNX = (
    (r"^(time|text)_embedder_linear_(\d)\.", r"condition_embedder.\1_embedder.linear_\2."),
    (r"^time_proj\.", "condition_embedder.time_proj."),
    (r"^(blocks\.\d+)\.(to_k_ip|to_v_ip)\.", r"\1.attn2.processor.\2."),
    (r"^(blocks\.\d+)\.registers$", r"\1.attn2.processor.registers"),
    (r"\.(attn[12])\.to_out\.", r".\1.to_out.0."),
    (r"^(blocks\.\d+)\.norm2_(weight|bias)$", r"\1.norm2.\2"),
    (r"\.ffn\.fc1\.", ".ffn.net.0.proj."),
    (r"\.ffn\.fc2\.", ".ffn.net.2."),
    (r"^norm_out_scale_shift$", "scale_shift_table"),
)
_LYNX_RESAMPLER = (
    (r"^attn_layers\.(\d+)\.", r"layers.\1.0."),
    (r"^ff_layers\.(\d+)\.fc1\.", r"layers.\1.1.1."),
    (r"^ff_layers\.(\d+)\.fc2\.", r"layers.\1.1.3."),
)
_WAN_SCAIL = (
    (r"^(text|time)_embedding_([12])\.", lambda m: f"{m.group(1)}_embedding.{2 * int(m.group(2)) - 2}."),
    (r"^time_projection\.", "time_projection.1."),
    (r"^img_norm_in\.", "img_emb.proj.0."),
    (r"^img_linear_1\.", "img_emb.proj.1."),
    (r"^img_linear_2\.", "img_emb.proj.3."),
    (r"^img_norm_out\.", "img_emb.proj.4."),
    (r"^(blocks\.\d+)\.(k_img|v_img|norm_k_img)\.", r"\1.cross_attn.\2."),
    (r"^(blocks\.\d+)\.c_to_([qkvo])\.", r"\1.cross_attn.\2."),
    (r"^(blocks\.\d+)\.c_norm_([qk])\.", r"\1.cross_attn.norm_\2."),
    (r"^(blocks\.\d+)\.to_([qkvo])\.", r"\1.self_attn.\2."),
    (r"^(blocks\.\d+)\.norm_([qk])\.", r"\1.self_attn.norm_\2."),
    (r"\.norm3_(weight|bias)$", r".norm3.\1"),
    (r"\.ffn\.fc1\.", ".ffn.0."),
    (r"\.ffn\.fc2\.", ".ffn.2."),
    (r"^head_norm_mod$", "head.modulation"),
    (r"^head\.(weight|bias)$", r"head.head.\1"),
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


_FRAMEPACK_KERNELS = {"1": (1, 2, 2), "2": (2, 4, 4), "4": (4, 8, 8), "8": (8, 16, 16)}


def _wan_layout(key: str, value: torch.Tensor) -> torch.Tensor:
    """``patch_embedding.weight`` (VACE's ``vace_patch_embedding.weight``,
    Animate's ``pose_patch_embedding.weight``, SCAIL's
    ``patch_embedding_pose.weight``) as the published Conv3d weight
    ``[O, C, 1, 2, 2]`` (every published Wan DiT patches (1, 2, 2)), and
    Apex-FramePack's packer embedders as Conv3d weights of their factor's
    kernel ``(f, 2f, 2f)``."""
    if key in ("patch_embedding.weight", "vace_patch_embedding.weight", "pose_patch_embedding.weight",
               "patch_embedding_pose.weight"):
        return value.reshape(value.shape[0], -1, 1, 2, 2)
    m = re.fullmatch(r"latent_embed_packer\.embedders\.(\d+)\.weight", key)
    if m:
        return value.reshape(value.shape[0], -1, *_FRAMEPACK_KERNELS[m.group(1)])
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


# SAM2 (the sam2 package's names; ``conv_s0`` / ``conv_s1`` at the top level,
# where the ``sam2`` converter takes them)
_SAM2 = [
    (r"^trunk\.patch_embed\.", "image_encoder.trunk.patch_embed.proj."),
    (r"^trunk\.blocks\.(\d+)\.qkv\.", r"image_encoder.trunk.blocks.\1.attn.qkv."),
    (r"^trunk\.blocks\.(\d+)\.proj_attn\.", r"image_encoder.trunk.blocks.\1.attn.proj."),
    (r"^trunk\.blocks\.(\d+)\.mlp_lin1\.", r"image_encoder.trunk.blocks.\1.mlp.layers.0."),
    (r"^trunk\.blocks\.(\d+)\.mlp_lin2\.", r"image_encoder.trunk.blocks.\1.mlp.layers.1."),
    (r"^trunk\.", "image_encoder.trunk."),
    (r"^neck\.convs\.(\d+)\.", r"image_encoder.neck.convs.\1.conv."),
    (r"^prompt_encoder\.pe_gaussian$", "sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
    (r"^prompt_encoder\.(point_embeddings\.\d+|not_a_point_embed|no_mask_embed)$", r"sam_prompt_encoder.\1.weight"),
    (r"^mask_decoder\.(iou_token|mask_tokens|obj_score_token)$", r"sam_mask_decoder.\1.weight"),
    (r"^mask_decoder\.layers\.(\d+)\.mlp_lin1\.", r"sam_mask_decoder.transformer.layers.\1.mlp.layers.0."),
    (r"^mask_decoder\.layers\.(\d+)\.mlp_lin2\.", r"sam_mask_decoder.transformer.layers.\1.mlp.layers.1."),
    (r"^mask_decoder\.(layers|final_attn_token_to_image|norm_final_attn)\.", r"sam_mask_decoder.transformer.\1."),
    (r"^mask_decoder\.upscale1\.", "sam_mask_decoder.output_upscaling.0."),
    (r"^mask_decoder\.upscale_norm\.", "sam_mask_decoder.output_upscaling.1."),
    (r"^mask_decoder\.upscale2\.", "sam_mask_decoder.output_upscaling.3."),
    (r"^mask_decoder\.", "sam_mask_decoder."),
]

# the SAM2 video model's memory bank (its image keys go through _SAM2)
_SAM2_VIDEO = [
    # (conv, LayerNorm2d, GELU) x 4 + conv in the published Sequential; from the
    # last index down, so that no rule renames another's output
    *[(rf"^memory_encoder\.mask_downsampler\.encoder\.{i}\.", f"memory_encoder.mask_downsampler.encoder.{j}.")
      for i, j in reversed(list(enumerate((0, 1, 3, 4, 6, 7, 9, 10, 12))))],
    (r"^memory_encoder\.fuser\.(\d+)\.", r"memory_encoder.fuser.layers.\1."),
    (r"^memory_attention\.(\d+)\.", r"memory_attention.layers.\1."),
    (r"^memory_attention_norm\.", "memory_attention.norm."),
]

# Depth Anything V2 (the published depth_anything_v2_*.pth names)
_DEPTH_ANYTHING_V2 = [
    (r"^pretrained\.patch_embed\.", "pretrained.patch_embed.proj."),
    (r"^depth_head\.resize(\d)\.", r"depth_head.resize_layers.\1."),
    *[(rf"^depth_head\.layer_rn\.{i}\.", f"depth_head.scratch.layer{i + 1}_rn.") for i in range(4)],
    (r"^depth_head\.(refinenet\d|output_conv1)\.", r"depth_head.scratch.\1."),
    (r"^depth_head\.output_conv2_(\d)\.", r"depth_head.scratch.output_conv2.\1."),
]

# OpenPose body (the published body_pose_model.pth names)
_OPENPOSE_TRUNK = ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv3_3", "conv3_4",
                   "conv4_1", "conv4_2", "conv4_3_CPM", "conv4_4_CPM")
_OPENPOSE = [
    *[(rf"^trunk\.{i}\.", f"model0.{name}.") for i, name in enumerate(_OPENPOSE_TRUNK)],
    *[(rf"^stage1_l{b}\.convs\.{i}\.", f"model1_{b}.conv5_{i + 1}_CPM_L{b}.") for b in (1, 2) for i in range(5)],
    *[(rf"^refine_l{b}\.{s}\.convs\.{i}\.", f"model{s + 2}_{b}.Mconv{i + 1}_stage{s + 2}_L{b}.")
      for b in (1, 2) for s in range(5) for i in range(7)],
]


# The preprocessors' inference BatchNorms, kept as parameters: EfficientNet's
# BNInf, and M-LSD's / Manga Line's ``bn_*`` leaves.
_BN_STATS = (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"), ("var", "running_var"))

_HED: Sequence[Tuple[str, str]] = ()

_TEED = [
    (r"^dblock_3\.", "dblock_3.denselayer1."),
    (r"^(side_1|pre_dense_3)\.", r"\1.conv."),
    (r"^up_block_(1|2)\.conv\.", r"up_block_\1.features.0."),
    (r"^up_block_(1|2)\.deconv\.", r"up_block_\1.features.2."),
    *[(rf"^up_block_3\.{ours}\.", f"up_block_3.features.{i}.")
      for ours, i in (("conv_a", 0), ("deconv_a", 2), ("conv_b", 3), ("deconv_b", 5))],
    (r"^block_cat\.dwconv(\d)\.", r"block_cat.DWconv\1."),
]

# the sk_model generator (model0..model4 Sequential indices)
_LINEART = [
    (r"^conv_in\.", "model0.1."), (r"^down1\.", "model1.0."), (r"^down2\.", "model1.3."),
    (r"^res_blocks\.(\d+)\.conv1\.", r"model2.\1.conv_block.1."),
    (r"^res_blocks\.(\d+)\.conv2\.", r"model2.\1.conv_block.5."),
    (r"^up1\.", "model3.0."), (r"^up2\.", "model3.3."), (r"^conv_out\.", "model4.1."),
]


def _unet_prefix(depth: int) -> str:
    """netG.pth's nested UnetSkipConnectionBlock prefix of a depth."""
    return "model." + "".join("model.1." if d == 1 else "model.3." for d in range(1, depth + 1))


_LINEART_ANIME = [
    rule for depth in range(8) for rule in (
        (rf"^downs\.{depth}\.", f"{_unet_prefix(depth)}model.{0 if depth == 0 else 1}."),
        (rf"^ups\.{7 - depth}\.", f"{_unet_prefix(depth)}model.{5 if 0 < depth < 7 else 3}."))]

_MANGA_LINE = [
    *[(rf"^(block\d)\.(\d+)\.(conv1|residual)\.bn_{ours}$", rf"\1.model.\2.\3.model.0.{theirs}")
      for ours, theirs in _BN_STATS],
    (r"^(block\d)\.(\d+)\.(conv1|residual)\.(weight|bias)$", r"\1.model.\2.\3.model.2.\4"),
    (r"^(block\d)\.(\d+)\.shortcut\.(weight|bias)$", r"\1.model.\2.shortcut.model.0.\3"),
    *[(rf"^conv15\.bn_{ours}$", f"conv15.model.0.{theirs}") for ours, theirs in _BN_STATS],
    (r"^conv15\.(weight|bias)$", r"conv15.model.2.\1"),
]


def _mlsd_rules():
    """MobileV2_MLSD_Large's names: the trunk's ``backbone.features`` (the
    first InvertedResidual has no expansion conv), the FPN blocks'
    ``conv{c}.0`` / ``conv{c}.1`` Sequentials."""
    def bn(src: str, dst: str):
        return [(rf"^{src}\.bn_{ours}$", f"{dst}.{theirs}") for ours, theirs in _BN_STATS]

    rules = [(r"^features\.0\.weight$", "backbone.features.0.0.weight"),
             *bn(r"features\.0", "backbone.features.0.1")]
    for idx in range(1, 14):
        t, li = f"backbone.features.{idx}.conv", 0 if idx == 1 else 1
        if idx > 1:
            rules += [(rf"^features\.{idx}\.expand\.weight$", f"{t}.0.0.weight"),
                      *bn(rf"features\.{idx}\.expand", f"{t}.0.1")]
        rules += [(rf"^features\.{idx}\.dw\.weight$", f"{t}.{li}.0.weight"),
                  *bn(rf"features\.{idx}\.dw", f"{t}.{li}.1"),
                  (rf"^features\.{idx}\.pw\.weight$", f"{t}.{li + 1}.weight"),
                  *bn(rf"features\.{idx}\.pw", f"{t}.{li + 2}")]
    return rules + [(r"^(block\d+)\.(conv\d)\.(weight|bias)$", r"\1.\2.0.\3"),
                    *[(rf"^(block\d+)\.(conv\d)\.bn_{ours}$", rf"\1.\2.1.{theirs}") for ours, theirs in _BN_STATS],
                    (r"^block23\.conv3_(weight|bias)$", r"block23.conv3.\1")]


_MLSD = _mlsd_rules()

# timm's tf_efficientnet (the BNInf statistics under BatchNorm2d's names)
_EFFICIENTNET = [(rf"(^|\.)(bn\d)\.{ours}$", rf"\1\2.{theirs}") for ours, theirs in _BN_STATS]

_NORMALBAE = [
    (r"^encoder\.", "encoder.original_model."), *_EFFICIENTNET,
    (r"^conv2\.", "decoder.conv2."),
    (r"^up(\d)\.conv_a\.", r"decoder.up\1._net.0."),
    (r"^up(\d)\.conv_b\.", r"decoder.up\1._net.3."),
    *[(rf"^up(\d)\.bn_{ab}\.{ours}$", rf"decoder.up\1._net.{i}.{theirs}")
      for ab, i in (("a", 1), ("b", 4)) for ours, theirs in _BN_STATS],
    (r"^out_conv_res8\.", "decoder.out_conv_res8."),
    *[(rf"^out_conv_res(\d)\.c{c}\.", rf"decoder.out_conv_res\1.{2 * c}.") for c in range(4)],
]

_DSINE = [
    (r"^encoder\.", "encoder.original_model."), *_EFFICIENTNET,
    (r"^conv2\.", "decoder.conv2."),
    *[(rf"^up(\d)\.conv_{ab}\.conv\.", rf"decoder.up\1._net.{i}.") for ab, i in (("a", 0), ("b", 3))],
    *[(rf"^up(\d)\.gn_{ab}\.scale$", rf"decoder.up\1._net.{i}.weight") for ab, i in (("a", 1), ("b", 4))],
    *[(rf"^up(\d)\.gn_{ab}\.bias$", rf"decoder.up\1._net.{i}.bias") for ab, i in (("a", 1), ("b", 4))],
    *[(rf"^(normal_head|feature_head|hidden_head)\.c{c}\.", rf"decoder.\1.{2 * c}.") for c in range(3)],
    *[(rf"^(prob_head|xy_head|angle_head|up_prob_head)\.c{c}\.", rf"\1.{2 * c}.") for c in range(3)],
]

# AdelaiDepth's DepthModel under DataParallel
_LERES = [
    (r"^decoder\.outconv\.conv1\.", "decoder.outconv.adapt_conv.0."),
    (r"^decoder\.outconv\.bn\.", "decoder.outconv.adapt_conv.1."),
    (r"^decoder\.outconv\.conv2\.", "decoder.outconv.adapt_conv.3."),
    (r"\.down_conv\.", ".downsample.0."), (r"\.down_bn\.", ".downsample.1."),
    (r"\.branch_conv1\.", ".conv_branch.1."), (r"\.branch_bn\.", ".conv_branch.2."),
    (r"\.branch_conv2\.", ".conv_branch.4."),
    (r"^(encoder|decoder)\.", r"module.\1_modules."),
]


# U²-Net (u2net.pth, u2netp.pth): each RSU stage's rebnconv layers by depth
_U2NET_DEPTHS = {"stage1": 7, "stage2": 6, "stage3": 5, "stage4": 4, "stage5": 4, "stage6": 4, "stage5d": 4,
                 "stage4d": 4, "stage3d": 5, "stage2d": 6, "stage1d": 7}


def _u2net_rules():
    rules = []
    for stage, depth in _U2NET_DEPTHS.items():
        rules += [(rf"^{stage}\.bottom\.", f"{stage}.rebnconv{depth}."),
                  *[(rf"^{stage}\.dec\.{j}\.", f"{stage}.rebnconv{depth - 1 - j}d.") for j in range(depth - 1)],
                  *[(rf"^{stage}\.enc\.{i}\.", f"{stage}.rebnconv{i + 1}.") for i in range(depth - 1)]]
    return rules + [(r"^(stage\w+)\.convin\.", r"\1.rebnconvin."),
                    (r"^(stage\w+\.rebnconv\w+)\.(weight|bias)$", r"\1.conv_s1.\2"),
                    *[(rf"^(stage\w+\.rebnconv\w+)\.bn_{ours}$", rf"\1.bn_s1.{theirs}") for ours, theirs in _BN_STATS],
                    (r"^outconv_(weight|bias)$", r"outconv.\1")]


_U2NET = _u2net_rules()
# isnetis.ckpt's state_dict: ISNetDIS under the Lightning module's ``net.``
_ISNET = _U2NET + [(r"^(conv_in|side1)_(weight|bias)$", r"\1.\2"), (r"^", "net.")]


def _anime_face_rules():
    """Annotators/UNet.pth: the MobileNetV2 trunk in ``en_block`` slices."""
    def conv_bn(ours: str, conv: str, bn: str):
        return [(rf"^{ours}\.weight$", f"{conv}.weight"),
                *[(rf"^{ours}\.bn_{o}$", f"{bn}.{t}") for o, t in _BN_STATS]]

    spans = {0: (0, 2), 1: (2, 4), 2: (4, 7), 3: (7, 14), 4: (14, 17)}
    rules = []
    for blk, (start, end) in spans.items():
        for gi in range(start, end):
            t, j = f"en_block{blk}.{gi - start}", rf"features\.{gi}"
            if gi == 0:
                rules += conv_bn(j, f"{t}.0", f"{t}.1")
            elif gi == 1:
                rules += conv_bn(rf"{j}\.dw", f"{t}.conv.0.0", f"{t}.conv.0.1")
                rules += conv_bn(rf"{j}\.pw", f"{t}.conv.1", f"{t}.conv.2")
            else:
                rules += conv_bn(rf"{j}\.expand", f"{t}.conv.0.0", f"{t}.conv.0.1")
                rules += conv_bn(rf"{j}\.dw", f"{t}.conv.1.0", f"{t}.conv.1.1")
                rules += conv_bn(rf"{j}\.pw", f"{t}.conv.2", f"{t}.conv.3")
    return rules + [(r"^de_block(\d)\.(weight|bias)$", r"de_block\1.1.\2")]


_ANIME_FACE = _anime_face_rules()

# UniMatch's flow model (gmflow-*-mixdata.pth's ``model``)
_GMFLOW = [
    (r"\.downsample\.(weight|bias)$", r".downsample.0.\1"),
    (r"^backbone\.trident_weight$", "backbone.trident_conv.weight"),
    (r"^layers\.", "transformer.layers."), (r"\.mlp([02])\.", r".mlp.\1."),
    (r"^upsampler_conv1\.", "upsampler.0."), (r"^upsampler_conv2\.", "upsampler.2."),
    (r"^refine\.mask_conv1\.", "refine.mask.0."), (r"^refine\.mask_conv2\.", "refine.mask.2."),
]

# Metric3D v2 (metric_depth_vit_*_800k.pth's ``model_state_dict``)
_METRIC3D = [
    (r"^encoder\.patch_embed\.", "encoder.patch_embed.proj."),
    (r"^decoder\.depth_reg_conv1\.", "decoder.depth_regressor.0."),
    (r"^decoder\.depth_reg_conv2\.", "decoder.depth_regressor.2."),
    *[(rf"^decoder\.normal_conv{i + 1}\.", f"decoder.normal_predictor.{2 * i}.") for i in range(4)],
    (r"^decoder\.update_block\.mask_conv1\.", "decoder.update_block.mask.0."),
    (r"^decoder\.update_block\.mask_conv2\.", "decoder.update_block.mask.2."),
    (r"\.read_0\.sample\.", ".read_0.sample.0."),
    (r"\.res\.down_conv\.", ".res.downsample.0."), (r"\.res\.norm3\.", ".res.downsample.1."),
    (r"(outputs(?:04|08|16)\.\d+)\.res\.", r"\1.0."), (r"(outputs(?:04|08|16)\.\d+)\.out\.", r"\1.1."),
    (r"^", "depth_model."),
]


# the other image families: Flux's block names with each family's own heads
_CHROMA = (
    (r"^distilled_guidance_layer\.layers_([12])\.(\d+)\.", r"distilled_guidance_layer.layers.\2.linear_\1."),
    *_FLUX,
)
_OVIS = ((r"^timestep_linear_(\d)\.", r"timestep_embedder.linear_\1."), *_FLUX)
_FIBO = (
    (r"^time_linear_(\d)\.", r"time_embed.timestep_embedder.linear_\1."),
    (r"^caption_projection\.(\d+)\.", r"caption_projection.\1.linear."),
    *_FLUX,
)
_HIDREAM = (
    (r"^x_embedder\.", "x_embedder.proj."),
    (r"^t_in_(\d)\.", r"t_embedder.timestep_embedder.linear_\1."),
    (r"^p_in_(\d)\.", r"p_embedder.pooled_embedder.linear_\1."),
    (r"^caption_projection\.(\d+)\.", r"caption_projection.\1.linear."),
    (r"^(double|single)_stream_blocks\.(\d+)\.", r"\1_stream_blocks.\2.block."),
    (r"^final_adaln\.", "final_layer.adaLN_modulation.1."),
    (r"\.adaln\.", ".adaLN_modulation.1."),
    (r"^proj_out\.", "final_layer.linear."),
    (r"\.ff_i\.gate_weight$", ".ff_i.gate.weight"),
)
_HUNYUANIMAGE = (
    _HUNYUANVIDEO[0],
    (r"^time_linear_(\d)\.", r"time_guidance_embed.timestep_embedder.linear_\1."),
    (r"^time_r_linear_(\d)\.", r"time_guidance_embed.timestep_embedder_r.linear_\1."),
    (r"^guidance_linear_(\d)\.", r"time_guidance_embed.guidance_embedder.linear_\1."),
    (r"^byt5_norm\.", "context_embedder_2.norm."),
    (r"^byt5_linear_(\d)\.", r"context_embedder_2.linear_\1."),
    *_HUNYUANVIDEO[3:],
)
_HUNYUANIMAGE_VAE = (
    (r"\.attentions\.0\.group_norm\.", ".attentions.0.norm."),
    (r"\.attentions\.0\.to_out\.", ".attentions.0.proj."),
)


# the video DiTs on the ported VAEs and encoders
_LONGCAT = (
    (r"^x_embedder\.", "x_embedder.proj."),
    (r"^t_linear_1\.", "t_embedder.mlp.0."), (r"^t_linear_2\.", "t_embedder.mlp.2."),
    (r"^y_linear_1\.", "y_embedder.y_proj.0."), (r"^y_linear_2\.", "y_embedder.y_proj.2."),
    (r"^final_adaLN_linear\.", "final_layer.adaLN_modulation.1."),
    (r"^final_linear\.", "final_layer.linear."),
    (r"\.adaLN_linear\.", ".adaLN_modulation.1."),
    (r"\.(q_linear|kv_linear)\.", r".cross_attn.\1."),
    (r"\.cross_proj\.", ".cross_attn.proj."),
    (r"\.cross_(q_norm|k_norm)\.", r".cross_attn.\1."),
    (r"^(blocks\.\d+)\.(qkv|proj|q_norm|k_norm)\.", r"\1.attn.\2."),
    (r"\.ffn_w(\d)\.", r".ffn.w\1."),
)
_COSMOS = (
    (r"^t_linear_(\d)\.", r"time_embed.t_embedder.linear_\1."),
    (r"^t_norm\.", "time_embed.norm."),
    (r"^patch_embed\.", "patch_embed.proj."),
    (r"\.attn(\d)\.to_out\.", r".attn\1.to_out.0."),
    (r"\.ff_in\.", ".ff.net.0.proj."),
    (r"\.ff_out\.", ".ff.net.2."),
)
_KANDINSKY5 = (
    (r"^out_layer\.", "out_layer.out_layer."),
    (r"^out_modulation\.", "out_layer.modulation."),
    (r"^time_in\.", "time_embeddings.in_layer."),
    (r"^time_out\.", "time_embeddings.out_layer."),
    (r"^text_in\.", "text_embeddings.in_layer."),
    (r"^text_norm\.", "text_embeddings.norm."),
    (r"^pooled_in\.", "pooled_text_embeddings.in_layer."),
    (r"^pooled_norm\.", "pooled_text_embeddings.norm."),
    (r"^visual_in\.", "visual_embeddings.in_layer."),
)

# HunyuanImage 3.0 and CogVideoX
_HUNYUANIMAGE3 = (
    (r"^wte$", "model.wte.weight"),
    (r"^layers\.", "model.layers."),
    (r"\.mlp_(\d)\.", r".mlp.\1."),
    (r"\.in_norm\.", ".in_layers.0."),
    (r"\.in_conv\.", ".in_layers.2."),
    (r"\.emb_layers\.", ".emb_layers.1."),
    (r"\.out_norm\.", ".out_layers.0."),
    (r"\.out_conv\.", ".out_layers.3."),
    (r"^(final_layer\.model\.\d+)\.norm\.", r"\1.0."),
    (r"^(final_layer\.model\.\d+)\.conv\.", r"\1.2."),
)
_HUNYUANIMAGE3_VAE = (
    (r"\.(down|up)_blocks\.(\d+)\.resnets\.(\d+)\.", r".\1.\2.block.\3."),
    (r"\.down_blocks\.(\d+)\.downsamplers\.0\.", r".down.\1.downsample."),
    (r"\.up_blocks\.(\d+)\.upsamplers\.0\.", r".up.\1.upsample."),
    (r"\.mid_(block_1|attn_1|block_2)\.", r".mid.\1."),
)
_COGVIDEO = (
    (r"^patch_embed_proj\.", "patch_embed.proj."),
    (r"^text_proj\.", "patch_embed.text_proj."),
    (r"^time_embed\.in_layer\.", "time_embedding.linear_1."),
    (r"^time_embed\.out_layer\.", "time_embedding.linear_2."),
    (r"\.attn1\.to_out\.", ".attn1.to_out.0."),
    (r"\.ff\.fc1\.", ".ff.net.0.proj."),
    (r"\.ff\.fc2\.", ".ff.net.2."),
    (r"^norm_out_linear\.", "norm_out.linear."),
)
_COGVIDEO_VAE = ((r"\.(conv_in|conv_out|conv1|conv2|conv_y|conv_b)\.(weight|bias)$", r".\1.conv.\2"),)

_MOCHI = (
    (r"^patch_proj\.", "patch_embed.proj."),
    (r"^time_embed\.in_layer\.", "time_embed.timestep_embedder.linear_1."),
    (r"^time_embed\.out_layer\.", "time_embed.timestep_embedder.linear_2."),
    (r"^pooler\.", "time_embed.pooler."),
    (r"^caption_proj\.", "time_embed.caption_proj."),
    (r"^rope\.pos_frequencies$", "pos_frequencies"),
    (r"^blocks\.(\d+)\.mod_x\.", r"transformer_blocks.\1.norm1.linear."),
    (r"^blocks\.(\d+)\.mod_y\.", r"transformer_blocks.\1.norm1_context.linear."),
    (r"^blocks\.(\d+)\.attn\.", r"transformer_blocks.\1.attn1."),
    (r"^blocks\.(\d+)\.ff_x\.proj_in\.", r"transformer_blocks.\1.ff.net.0.proj."),
    (r"^blocks\.(\d+)\.ff_x\.proj_out\.", r"transformer_blocks.\1.ff.net.2."),
    (r"^blocks\.(\d+)\.ff_y\.proj_in\.", r"transformer_blocks.\1.ff_context.net.0.proj."),
    (r"^blocks\.(\d+)\.ff_y\.proj_out\.", r"transformer_blocks.\1.ff_context.net.2."),
    (r"^norm_out_linear\.", "norm_out.linear."),
    (r"\.attn1\.to_out\.", ".attn1.to_out.0."),
    (r"\.attn1\.(norm_q|norm_k|norm_added_q|norm_added_k)$", r".attn1.\1.weight"),
)
_MOCHI_VAE = (
    (r"\.(norm1|norm2|norm_out)\.(weight|bias)$", r".\1.norm_layer.\2"),
    (r"\.norms\.(\d+)\.(weight|bias)$", r".norms.\1.norm_layer.\2"),
    (r"\.(conv1|conv2)\.(weight|bias)$", r".\1.conv.\2"),
    (r"\.down_blocks\.(\d+)\.conv_in\.(weight|bias)$", r".down_blocks.\1.conv_in.conv.\2"),
    (r"\.attentions\.(\d+)\.to_out\.", r".attentions.\1.to_out.0."),
)
_LTX = (
    (r"^time_embed\.in_layer\.", "adaln_single.emb.timestep_embedder.linear_1."),
    (r"^time_embed\.out_layer\.", "adaln_single.emb.timestep_embedder.linear_2."),
    (r"^time_proj\.", "adaln_single.linear."),
    (r"^caption_in\.", "caption_projection.linear_1."),
    (r"^caption_out\.", "caption_projection.linear_2."),
    (r"^blocks\.", "transformer_blocks."),
    (r"\.to_out\.", ".to_out.0."),
    (r"\.q_norm\.", ".norm_q."),
    (r"\.k_norm\.", ".norm_k."),
    (r"\.ff\.fc1\.", ".ff.net.0.proj."),
    (r"\.ff\.fc2\.", ".ff.net.2."),
)
_LTX_VAE = (
    (r"^(encoder|decoder)\.(conv_in|conv_out)\.(weight|bias)$", r"\1.\2.conv.\3"),
    (r"\.(conv1|conv2)\.(weight|bias)$", r".\1.conv.\2"),
    (r"\.(down_blocks|up_blocks)\.(\d+)\.conv\.(weight|bias)$", r".\1.\2.conv.conv.\3"),
    (r"\.norm3\.(weight|bias)$", r".norm3.norm.\1"),
    (r"\.time_embedder\.in_layer\.", ".time_embedder.timestep_embedder.linear_1."),
    (r"\.time_embedder\.out_layer\.", ".time_embedder.timestep_embedder.linear_2."),
    (r"^decoder\.last_time_embedder\.in_layer\.", "decoder.last_time_embedder.timestep_embedder.linear_1."),
    (r"^decoder\.last_time_embedder\.out_layer\.", "decoder.last_time_embedder.timestep_embedder.linear_2."),
    (r"^std_of_means$", "per_channel_statistics.std-of-means"),
    (r"^mean_of_means$", "per_channel_statistics.mean-of-means"),
)

_LTX2 = (
    (r"^blocks\.", "transformer_blocks."),
    (r"^(audio_caption_projection|caption_projection)_(\d)\.", r"\1.linear_\2."),
    (r"\.emb_(\d)\.", r".emb.timestep_embedder.linear_\1."),
    (r"\.to_out\.", ".to_out.0."),
    (r"\.(ff|audio_ff)\.fc1\.", r".\1.net.0.proj."),
    (r"\.(ff|audio_ff)\.fc2\.", r".\1.net.2."),
)
_LTX2_VAE = (
    (r"\.mid_resnets\.", ".mid_block.resnets."),
    (r"\.down_blocks\.(\d+)\.0\.", r".down_blocks.\1.resnets."),
    (r"\.down_blocks\.(\d+)\.1\.", r".down_blocks.\1.downsamplers.0."),
    (r"\.up_blocks\.(\d+)\.0\.", r".up_blocks.\1.upsamplers.0."),
    (r"\.up_blocks\.(\d+)\.1\.", r".up_blocks.\1.resnets."),
    (r"(conv_in|conv_out|conv1|conv2|samplers\.0\.conv)\.(weight|bias)$", r"\1.conv.\2"),
)
_GEMMA3 = (
    (r"^embed_tokens$", "embed_tokens.weight"),
    (r"\.(gate_proj|up_proj|down_proj)\.", r".mlp.\1."),
    (r"^", "language_model.model."),
)
_LTX2_AUDIO_VAE = (
    (r"\.down\.(\d+)\.0\.(\d+)\.", r".down.\1.block.\2."),
    (r"\.down\.(\d+)\.1\.(weight|bias)$", r".down.\1.downsample.conv.\2"),
    (r"\.up\.(\d+)\.0\.(\d+)\.", r".up.\1.block.\2."),
    (r"\.up\.(\d+)\.1\.conv\.", r".up.\1.upsample.conv."),
    (r"\.mid_(\d)\.", r".mid.block_\1."),
    (r"(conv_in|conv_out|conv1|conv2|nin_shortcut|upsample\.conv)\.(weight|bias)$", r"\1.conv.\2"),
)
_LTX2_UPSAMPLER = (
    (r"^upsampler_conv\.", "upsampler.0."),
    (r"\.scale$", ".weight"),
)
_LTX2_VOCODER = ((r"^upsamplers\.(\d+)\.w$", r"upsamplers.\1.weight"),)
_LTX2_CONNECTORS = (
    (r"\.to_out\.", ".to_out.0."),
    (r"\.ff\.fc1\.", ".ff.net.0.proj."),
    (r"\.ff\.fc2\.", ".ff.net.2."),
)


_MAGI = (
    (r"^t_mlp1\.", "timestep_embedding.mlp.0."),
    (r"^t_mlp2\.", "timestep_embedding.mlp.2."),
    (r"^y_proj_(xattn|adaln)\.", r"caption_embedding.y_proj_\1.0."),
    (r"^null_caption_embedding$", "caption_embedding.null_caption_embedding"),
    (r"\.adaln_proj\.", ".adaln.proj.0."),
    (r"\.self_(q|k|v)\.", r".attn1.to_\1."),
    (r"\.self_norm_(q|k)\.norm\.", r".attn1.norm_\1."),
    (r"\.cross_q\.", ".attn2.to_q."),
    (r"\.cross_kv\.", ".attn2.to_kv."),
    (r"\.cross_norm_(q|k)\.norm\.", r".attn2.cross_\1_norm."),
    (r"\.(norm2|norm3)\.norm\.", r".\1."),
    (r"\.ffn_norm\.", ".ffn.norm."),
    (r"\.ffn_proj(\d)\.", r".ffn.proj\1."),
    (r"^norm_out\.norm\.", "norm_out."),
    (r"^proj_out\.", "proj_out.linear."),
)
_MAGI_VAE = (
    (r"^(encoder|decoder)\.core\.", r"\1."),
    (r"^encoder\.patch_embed\.", "encoder.patch_embed.proj."),
    (r"\.fc(\d)\.", r".mlp.fc\1."),
)
_WAN_FLASHVSR = (
    (r"^(text|time)_embedding_(\d)\.", r"\1_embedding.\2."),
    (r"^time_projection_1\.", "time_projection.1."),
    (r"\.ffn_(\d)\.", r".ffn.\1."),
)


def _longcat_layout(key: str, value: torch.Tensor) -> torch.Tensor:
    """``x_embedder.proj.weight`` as the published Conv3d weight
    ``[O, C, 1, 2, 2]``."""
    return value.reshape(value.shape[0], -1, 1, 2, 2) if key == "x_embedder.proj.weight" else value


def _hed_layout(key: str, value: torch.Tensor) -> torch.Tensor:
    """``norm`` as the published ``[1, 3, 1, 1]``."""
    return value.reshape(1, 3, 1, 1) if key == "norm" else value


def _normalbae_layout(key: str, value: torch.Tensor) -> torch.Tensor:
    """The res4 / res2 / res1 heads' 1×1 convs as the published Conv1d
    weights ``[out, in, 1]``."""
    if re.match(r"^decoder\.out_conv_res[124]\.\d\.weight$", key):
        return value.reshape(value.shape[0], value.shape[1], 1)
    return value


# MAGI-1's zero-centred LayerNorm gammas, published as gamma - 1 (the converter adds 1.0)
_MAGI_ZERO_CENTRED = re.compile(r"(attn1\.norm_[qk]|attn2\.cross_[qk]_norm|norm2|norm3|^norm_out)\.weight$")


def _magi_layout(key: str, value: torch.Tensor) -> torch.Tensor:
    """The zero-centred gammas less 1; ``patch_embedding.weight`` as the
    published Conv3d weight ``[O, C, 1, 2, 2]``."""
    if _MAGI_ZERO_CENTRED.search(key):
        return value - 1.0
    return value.reshape(value.shape[0], -1, 1, 2, 2) if key == "patch_embedding.weight" else value


def _magi_vae_layout(key: str, value: torch.Tensor) -> torch.Tensor:
    """The encoder's patch embedding as the published Conv3d weight
    ``[O, 3, 4, 8, 8]``."""
    return value.reshape(value.shape[0], 3, 4, 8, 8) if key == "encoder.patch_embed.proj.weight" else value


def _wan_flashvsr_layout(key: str, value: torch.Tensor) -> torch.Tensor:
    """``patch_embedding.weight`` as the published Conv3d weight
    ``[O, C, 1, 2, 2]``; the LQ projector's RMS gammas as ``[C, 1, 1, 1]``."""
    if key == "patch_embedding.weight":
        return value.reshape(value.shape[0], -1, 1, 2, 2)
    if re.match(r"^LQ_proj_in\.norm\d\.gamma$", key):
        return value.reshape(-1, 1, 1, 1)
    return value


_LAYOUTS: Dict[str, Callable[[str, torch.Tensor], torch.Tensor]] = {
    "wan_vae": _wan_vae_layout, "wan": _wan_layout, "skyreels": _wan_layout,
    "clip_vision": _clip_vision_layout,
    "wan_humo": _wan_humo_layout, "wan_multitalk": _wan_humo_layout, "wan_s2v": _wan_s2v_layout,
    "wan_animate": _wan_layout, "wan_lynx": _wan_layout, "wan_scail": _wan_layout,
    "hed": _hed_layout, "normalbae": _normalbae_layout, "longcat": _longcat_layout, "magi": _magi_layout,
    "magi_vae": _magi_vae_layout, "wan_flashvsr": _wan_flashvsr_layout}
_TABLES: Dict[str, Sequence[Tuple[str, str]]] = {
    "flux": _FLUX, "t5": _T5, "clip": _CLIP, "autoencoder_kl": _AUTOENCODER_KL,
    "hunyuanvideo15": _HUNYUANVIDEO15, "hunyuanvideo15_vae": _HUNYUANVIDEO15_VAE, "tae_vae": _TAE_VAE,
    "zimage": _ZIMAGE, "qwen3": _QWEN3, "rife": _RIFE, "qwenimage": _QWENIMAGE, "wan_vae": _WAN_VAE,
    "wan": _WAN, "skyreels": _SKYREELS, "clip_vision": _CLIP_VISION, "flux2": _FLUX2, "flux2_vae": _FLUX2_VAE,
    "llama": _LLAMA,
    "hunyuanvideo": _HUNYUANVIDEO, "hunyuanvideo_vae": _HUNYUANVIDEO_VAE, "wan_humo": _WAN_HUMO,
    "wav2vec2": _WAV2VEC2, "wan_s2v": _WAN_S2V, "wan_multitalk": _WAN_MULTITALK,
    "wan_animate": _WAN_ANIMATE, "wan_lynx": _WAN_LYNX, "lynx_resampler": _LYNX_RESAMPLER, "wan_scail": _WAN_SCAIL,
    "hunyuanvideo_avatar": _HUNYUANVIDEO_AVATAR, "sam2": _SAM2, "sam2_video": _SAM2_VIDEO,
    "depth_anything_v2": _DEPTH_ANYTHING_V2, "openpose": _OPENPOSE, "hed": _HED, "teed": _TEED,
    "lineart": _LINEART, "lineart_anime": _LINEART_ANIME, "manga_line": _MANGA_LINE, "mlsd": _MLSD,
    "efficientnet": _EFFICIENTNET, "normalbae": _NORMALBAE, "dsine": _DSINE, "leres": _LERES,
    "u2net": _U2NET, "isnet": _ISNET, "anime_face": _ANIME_FACE, "gmflow": _GMFLOW, "metric3d": _METRIC3D,
    "chroma": _CHROMA, "ovis": _OVIS, "fibo": _FIBO, "hidream": _HIDREAM, "hunyuanimage": _HUNYUANIMAGE,
    "hunyuanimage_vae": _HUNYUANIMAGE_VAE, "longcat": _LONGCAT, "cosmos": _COSMOS, "kandinsky5": _KANDINSKY5,
    "hunyuanimage3": _HUNYUANIMAGE3, "hunyuanimage3_vae": _HUNYUANIMAGE3_VAE, "cogvideo": _COGVIDEO,
    "cogvideo_vae": _COGVIDEO_VAE, "mochi": _MOCHI, "mochi_vae": _MOCHI_VAE, "ltx": _LTX, "ltx_vae": _LTX_VAE,
    "ltx2": _LTX2, "ltx2_vae": _LTX2_VAE, "gemma3": _GEMMA3, "ltx2_audio_vae": _LTX2_AUDIO_VAE,
    "ltx2_upsampler": _LTX2_UPSAMPLER, "ltx2_vocoder": _LTX2_VOCODER, "ltx2_connectors": _LTX2_CONNECTORS,
    "magi": _MAGI, "magi_vae": _MAGI_VAE, "wan_flashvsr": _WAN_FLASHVSR, "tiny_wan_vae": _TAE_VAE}


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
