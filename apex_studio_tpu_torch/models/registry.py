"""Model family registries (port of ``models/registry.py``).

Keys match manifest ``base`` values: ``flux.base``, ``hunyuanvideo15.base``,
``auto`` (AutoencoderKL), ``hunyuanvideo15`` (its VAE), ``tae``,
``CLIPTextModel``, ``T5EncoderModel``, ``Qwen2_5_VLForConditionalGeneration``,
``SiglipVisionModel``.
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
    "apex_studio_tpu_torch.models.transformers.hunyuanvideo15",
    "apex_studio_tpu_torch.models.vaes.hunyuanvideo15_vae",
    "apex_studio_tpu_torch.models.vaes.tae_vae",
    "apex_studio_tpu_torch.models.text_encoders.qwen2",
    "apex_studio_tpu_torch.models.text_encoders.siglip",
)


def _load_builtin_families() -> None:
    """Import every ported family so registration side effects run."""
    for mod in _FAMILIES:
        importlib.import_module(mod)
