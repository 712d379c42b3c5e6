"""Model family registries (port of ``models/registry.py``).

Keys match manifest ``base`` values: ``flux.base``, ``hunyuanvideo15.base``,
``auto`` (AutoencoderKL), ``hunyuanvideo15`` (its VAE), ``tae``,
``CLIPTextModel``, ``T5EncoderModel``, ``Qwen2_5_VLForConditionalGeneration``,
``SiglipVisionModel``, ``CLIPVisionModel``, ``Qwen3ForCausalLM``, ``zimage.base``, ``zimage.control``,
``qwenimage.base``, ``qwenimage.controlnet``, ``wan.base`` in the transformer
registry (the Wan DiT, alias ``wan``; its variants ``wan.causal``, ``wan.vace``
and ``wan.fun``) and ``wan.base`` in the VAE registry (the
Wan VAE, which ``qwenimage`` and ``AutoencoderKLQwenImage`` name too);
``flux2.base`` and ``flux2.control`` (FLUX.2's DiT and its control variant),
``AutoencoderKLFlux2`` / ``flux2`` (the packed-BatchNorm AutoencoderKL) and
``LlamaModel`` / ``Mistral3ForConditionalGeneration`` (FLUX.2's text tower,
llava-llama-3); ``hunyuanvideo.base`` and ``hunyuanvideo.framepack`` (the
original HunyuanVideo DiT and FramePack's) and ``AutoencoderKLHunyuanVideo``
(its VAE); ``wan.humo`` (HuMo's DiT) and ``Wav2Vec2Model`` (its audio
encoder, in the text-encoder registry as in JAX); ``wan.s2v``, ``wan.multitalk``
and ``hunyuanvideo.avatar`` (the audio-driven DiTs); ``wan.recam``,
``wan.holocine``, ``wan.apex_framepack``, ``wan.animate``, ``wan.lynx`` and
``wan.scail`` (the rest of the Wan family) and ``LynxResampler`` (Lynx's
identity resampler, in the text-encoder registry as in JAX); ``chroma.base``,
``ovis.base``, ``fibo.base``, ``hidream.base`` and ``hunyuanimage.base`` (the
other image DiTs), ``hunyuanimage.vae`` (HunyuanImage 2.1's 32× VAE) and
``longcat.base``, ``cosmos.base`` and ``kandinsky5.base`` (the video DiTs that
run on the ported VAEs and encoders); ``hunyuanimage3.base`` (HunyuanImage 3's
MoE backbone) and ``hunyuanimage3`` (its DC-AE VAE); ``cogvideo.base`` in the
transformer registry (the CogVideoX DiT) and in the VAE registry (its causal
VAE); ``mochi.base`` in both (Mochi-1's AsymmDiT and its VAE), ``ltx.base``
(the LTX-Video DiT) and ``ltx_vae.base`` (its causal VAE).
"""

import importlib

from apex_studio_tpu_torch.registry import Registry

transformer_registry = Registry("transformer")
vae_registry = Registry("vae")
text_encoder_registry = Registry("text_encoder")

_FAMILIES = (
    "apex_studio_tpu_torch.models.transformers.flux",
    "apex_studio_tpu_torch.models.vaes.autoencoder_kl",
    "apex_studio_tpu_torch.models.text_encoders.t5",
    "apex_studio_tpu_torch.models.text_encoders.clip",
    "apex_studio_tpu_torch.models.text_encoders.clip_vision",
    "apex_studio_tpu_torch.models.transformers.hunyuanvideo15",
    "apex_studio_tpu_torch.models.vaes.hunyuanvideo15_vae",
    "apex_studio_tpu_torch.models.vaes.tae_vae",
    "apex_studio_tpu_torch.models.text_encoders.qwen2",
    "apex_studio_tpu_torch.models.text_encoders.siglip",
    "apex_studio_tpu_torch.models.text_encoders.qwen3",
    "apex_studio_tpu_torch.models.transformers.zimage",
    "apex_studio_tpu_torch.models.transformers.qwenimage",
    "apex_studio_tpu_torch.models.vaes.wan_vae",
    "apex_studio_tpu_torch.models.transformers.wan",
    "apex_studio_tpu_torch.models.text_encoders.llama",
    "apex_studio_tpu_torch.models.transformers.flux2",
    "apex_studio_tpu_torch.models.transformers.hunyuanvideo",
    "apex_studio_tpu_torch.models.transformers.hunyuanvideo_framepack",
    "apex_studio_tpu_torch.models.vaes.hunyuanvideo_vae",
    "apex_studio_tpu_torch.models.audio.wav2vec2",
    "apex_studio_tpu_torch.models.transformers.wan_humo",
    "apex_studio_tpu_torch.models.transformers.wan_s2v",
    "apex_studio_tpu_torch.models.transformers.wan_multitalk",
    "apex_studio_tpu_torch.models.transformers.hunyuanvideo_avatar",
    "apex_studio_tpu_torch.models.transformers.wan_framepack",
    "apex_studio_tpu_torch.models.transformers.wan_animate",
    "apex_studio_tpu_torch.models.transformers.wan_lynx",
    "apex_studio_tpu_torch.models.transformers.wan_scail",
    "apex_studio_tpu_torch.models.transformers.chroma",
    "apex_studio_tpu_torch.models.transformers.ovis",
    "apex_studio_tpu_torch.models.transformers.fibo",
    "apex_studio_tpu_torch.models.transformers.hidream",
    "apex_studio_tpu_torch.models.transformers.hunyuanimage",
    "apex_studio_tpu_torch.models.vaes.hunyuanimage_vae",
    "apex_studio_tpu_torch.models.transformers.longcat",
    "apex_studio_tpu_torch.models.transformers.cosmos",
    "apex_studio_tpu_torch.models.transformers.kandinsky5",
    "apex_studio_tpu_torch.models.transformers.hunyuanimage3",
    "apex_studio_tpu_torch.models.vaes.hunyuanimage3_vae",
    "apex_studio_tpu_torch.models.transformers.cogvideox",
    "apex_studio_tpu_torch.models.vaes.cogvideox_vae",
    "apex_studio_tpu_torch.models.transformers.mochi",
    "apex_studio_tpu_torch.models.vaes.mochi_vae",
    "apex_studio_tpu_torch.models.transformers.ltx",
    "apex_studio_tpu_torch.models.vaes.ltx_vae",
)


def _load_builtin_families() -> None:
    """Import every ported family so registration side effects run."""
    for mod in _FAMILIES:
        importlib.import_module(mod)
