"""HunyuanVideo 1.5 engines, text-to-video and image-to-video (port of
``apex_studio_tpu/engine/hunyuanvideo15.py``).

- mllm conditioning: Qwen2.5-VL over the chat template with the
  video-description system message, the hidden state two layers from the top,
  the template prefix cropped (``crop_start`` 108), max length 1000 + crop;
  encoded before the DiT loads and disk-cached, then the encoders released
- byT5 glyph branch: text inside quotes goes through byT5; zeros otherwise
- FlowMatchDiscrete sampler; CFG as two single forwards and one combine +
  Euler step, with optional guidance rescale
- latent packing ``[noise(32) | cond(32) | mask(1)]``: zeros for t2v, the
  image latent at frame 0 with mask 1 for i2v, plus SigLIP's 729 tokens
  (t2v keeps those slots as the bare cond-type-2 embedding)
- at 720p-class sizes (latent h·w over ``APEX_VAE_TILE_THRESHOLD``) the VAE
  leaves the card during the denoise (previews through the light TAE only),
  the DiT leaves before the decode, and the decode is spatially tiled
  (``APEX_VAE_TILE`` latent pixels a tile)
"""

from __future__ import annotations

import gc
import logging
import os
import re
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine
from apex_studio_tpu_torch.engine.fused import cfg_combine
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.hunyuanvideo15")

SYSTEM_MESSAGE = (
    "You are a helpful assistant. Describe the video by detailing the following aspects: "
    "1. The main content and theme of the video. "
    "2. The color, shape, size, texture, quantity, text, and spatial relationships of the objects. "
    "3. Actions, events, behaviors temporal relationships, physical movement changes of the objects. "
    "4. background environment, light, style and atmosphere. "
    "5. camera angles, movements, and transitions used in the video."
)

_GLYPH_RE = re.compile(r"[\"“”'](.+?)[\"“”']")


def extract_glyph_text(prompt: str) -> Optional[str]:
    spans = _GLYPH_RE.findall(prompt or "")
    return ". ".join(spans) if spans else None


def mllm_text(prompt: str) -> str:
    """The Qwen2.5-VL chat text a prompt is encoded in."""
    return (f"<|im_start|>system\n{SYSTEM_MESSAGE}<|im_end|>\n"
            f"<|im_start|>user\n{prompt}<|im_end|>\n<|im_start|>assistant\n")


def cfg_rescale_combine(v: torch.Tensor, v_neg: torch.Tensor, g: float, g_re: float) -> torch.Tensor:
    """CFG in f32, then (``g_re`` > 0) the overexposure rescale of
    arXiv:2305.08891 §3.4 with population standard deviations."""
    out = cfg_combine(v, v_neg, g)
    if g_re > 0:
        std_pos = torch.std(v_neg + (out - v_neg) / g, correction=0)
        std_cfg = torch.std(out, correction=0)
        out = g_re * (out * (std_pos / std_cfg.clamp_min(1e-8))) + (1 - g_re) * out
    return out


@register_engine("hunyuanvideo15", "t2v")
class HunyuanVideo15T2VEngine(BaseEngine):
    # Latent grids with more than VAE_TILE_THRESHOLD pixels decode in tiles of
    # VAE_TILE latent pixels (128 px), the JAX engine's defaults.
    VAE_TILE = 8
    VAE_TILE_THRESHOLD = 40 * 40
    VISION_TOKENS = 729

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.text_encoder_2 = None

    def load_text_encoders(self) -> None:
        from apex_studio_tpu_torch.text_encoder import TextEncoder

        te_specs = [s for s in self.component_specs.values() if s.get("type") == "text_encoder"]
        mllm = next((s for s in te_specs if "Qwen" in (s.get("base") or "")), None)
        byt5 = next((s for s in te_specs if "T5" in (s.get("base") or "")), None)
        if self.text_encoder is None and mllm is not None:
            self.text_encoder = TextEncoder(self, mllm)
        if self.text_encoder_2 is None and byt5 is not None:
            self.text_encoder_2 = TextEncoder(self, byt5)

    def _encode_mllm(self, prompt: str, max_length: int = 1000, crop_start: int = 108):
        """→ (hidden [1, max_length, D], mask [1, max_length]) on the device;
        disk-cached, so a repeat prompt never rebuilds the 7B encoder."""
        from apex_studio_tpu_torch.utils.disk_cache import EmbeddingCache

        te = self.text_encoder
        cache = EmbeddingCache("hyv15_mllm")
        cache_key = {
            "prompt": prompt, "max_len": max_length, "crop": crop_start, "base": te.base,
            "weights": str(te.spec.get("model_path") or "")[:256],
            "config": te.spec.get("config") or te.spec.get("config_path") or "",
        }
        hit = cache.load(cache_key)
        if hit is not None:
            return tuple(torch.from_numpy(a).to(self.device) for a in hit)
        model = te._ensure_model()
        ids, mask = te.tokenize([mllm_text(prompt)], max_length + crop_start)
        with torch.inference_mode():
            hidden = model(torch.from_numpy(ids).long().to(self.device),
                           attention_mask=torch.from_numpy(mask).to(self.device),
                           num_hidden_layers_to_skip=2)
        hidden, mask = hidden[:, crop_start:], mask[:, crop_start:]
        cache.store(cache_key, hidden.float().cpu().numpy(), mask)
        return hidden, torch.from_numpy(np.ascontiguousarray(mask)).to(self.device)

    def _encode_byt5(self, prompt: str, max_length: int = 128):
        glyph = extract_glyph_text(prompt)
        dim = self.transformer.cfg.text_embed_2_dim
        if glyph is None or self.text_encoder_2 is None:
            return (torch.zeros(1, max_length, dim, device=self.device),
                    torch.zeros(1, max_length, dtype=torch.int32, device=self.device))
        return self.text_encoder_2.encode([glyph], max_sequence_length=max_length,
                                          use_chat_template=False)

    def _free_memory(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        height: int = 720,
        width: int = 1280,
        duration: Optional[float] = None,
        fps: int = 24,
        num_frames: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 6.0,
        guidance_rescale: float = 0.0,
        seed: Optional[int] = None,
        latents: Optional[np.ndarray] = None,
        shift: Optional[float] = None,
        timesteps: Optional[List[float]] = None,
        return_latents: bool = False,
        render_on_step: bool = False,
        render_on_step_callback: Optional[Callable] = None,
        render_on_step_interval: int = 5,
        progress_callback: Optional[Callable] = None,
        offload: bool = True,
        **_: Any,
    ):
        image = _.pop("_image", None)
        safe_emit_progress(progress_callback, 0.0, "Starting pipeline")
        # The 7B mllm encodes before the DiT loads; the small byT5 glyph
        # branch runs after, since it needs the transformer's dims.
        self.load_text_encoders()
        use_cfg = guidance_scale > 1.0
        text, text_mask = self._encode_mllm(prompt or "")
        if use_cfg:
            ntext, ntext_mask = self._encode_mllm(negative_prompt or "")
        if offload:
            self.maybe_release_text_encoders()
        safe_emit_progress(progress_callback, 0.02, "Encoded mllm prompts")
        if self.transformer is None:
            self.load_component_by_type("transformer")
        if self.vae is None:  # it defines the latent geometry
            self.load_component_by_type("vae")
        if self.scheduler is None:
            self.load_component_by_type("scheduler")
        safe_emit_progress(progress_callback, 0.05, "Components ready")

        s_scale, t_scale = self.vae.cfg.spatial_scale, self.vae.cfg.temporal_scale
        height -= height % s_scale
        width -= width % s_scale
        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1
        num_frames = max(1, num_frames - (num_frames - 1) % t_scale)

        text2, text2_mask = self._encode_byt5(prompt or "")
        if use_cfg:
            ntext2, ntext2_mask = self._encode_byt5(negative_prompt or "")
        safe_emit_progress(progress_callback, 0.2, "Prompts ready")

        tf = self.transformer
        cfg_t = tf.cfg
        lat_c = cfg_t.out_channels
        lat_t = (num_frames - 1) // t_scale + 1
        lat_h, lat_w = height // s_scale, width // s_scale
        x = self.get_latents((1, lat_c, lat_t, lat_h, lat_w), seed=seed, latents=latents)
        cond, mask_ch, image_embeds, img_zeroed = self._prepare_cond(
            image, height, width, lat_t, lat_h, lat_w, cfg_t, lat_c)

        big_run = lat_h * lat_w > int(os.environ.get("APEX_VAE_TILE_THRESHOLD", self.VAE_TILE_THRESHOLD))
        if num_inference_steps <= 8 and timesteps is None:
            render_on_step = False  # few-step runs never render intermediates
        # resolved before the denoise: a misdeclared light VAE raises here,
        # not inside the preview callback's guard
        light_vae = self._get_preview_vae() if render_on_step else None
        vae_released = False
        if offload:
            # The image encoders are consumed. At 720p-class sizes the VAE
            # leaves too (decode_latents reloads it once the DiT is gone);
            # previews then ride the light TAE only, and without one they are
            # skipped rather than reloading the full VAE mid-denoise.
            self.helpers.clear()
            if big_run and not return_latents:
                if render_on_step and light_vae is None:
                    logger.warning("big-run previews need the light VAE (none loadable); "
                                   "disabling render_on_step")
                    render_on_step = False
                self.vae, vae_released = None, True
            self._free_memory()
        safe_emit_progress(progress_callback, 0.3, "Initialized latent noise")

        ts, _n = self.get_timesteps(self.scheduler, num_inference_steps, timesteps=timesteps,
                                    **({"shift": shift} if shift is not None else {}))
        safe_emit_progress(progress_callback, 0.4, "Timesteps computed; starting denoise")

        img_kw = ({"image_embeds": image_embeds, "image_stream_zeroed": img_zeroed}
                  if image_embeds is not None else {})

        def forward(t_vec, txt, txt_mask, txt2, txt2_mask):
            x_in = torch.cat([x, cond, mask_ch], dim=1).to(tf.dtype)
            return tf(x_in, t_vec, txt, txt_mask, txt2, txt2_mask, **img_kw).float()

        denoise_cb = make_mapped_progress(progress_callback, 0.4, 0.9)
        if len(ts) <= 8:
            render_on_step = False
        for i, t in enumerate(ts):
            t_vec = torch.full((1,), float(t), dtype=torch.float32, device=self.device)
            # Split CFG: two single forwards, then one combine + Euler step.
            v = forward(t_vec, text, text_mask, text2, text2_mask)
            if use_cfg:
                v_neg = forward(t_vec, ntext, ntext_mask, ntext2, ntext2_mask)
                v = cfg_rescale_combine(v, v_neg, float(guidance_scale), float(guidance_rescale or 0.0))
                del v_neg
            sig, sig_next = np.float32(self.scheduler.sigmas[i]), np.float32(self.scheduler.sigmas[i + 1])
            x = x + float(sig_next - sig) * v
            del v
            if (render_on_step and render_on_step_callback is not None
                    and (i + 1) % render_on_step_interval == 0 and i + 1 < len(ts)):
                try:
                    render_on_step_callback(
                        self.preview_frames(x, None if vae_released else self.decode_latents), i)
                except Exception:
                    logger.exception("preview callback failed")
            if denoise_cb is not None:
                denoise_cb(min((i + 1) / len(ts), 1.0), f"Denoising step {i + 1}/{len(ts)}")

        safe_emit_progress(progress_callback, 0.9, "Denoising complete")
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        if offload and big_run:
            # A 720p-class tiled decode and the DiT need not share the card:
            # the DiT goes first and reloads on the next run.
            del tf
            self.transformer = None
            self._free_memory()
            logger.info("released transformer before %dx%d tiled decode", lat_h, lat_w)
        frames = self.decode_latents(x)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames

    @torch.inference_mode()
    def decode_latents(self, z: torch.Tensor) -> List[np.ndarray]:
        """Latents [1, C, T, h, w] → 4(T−1)+1 HWC uint8 frames; grids over the
        tile threshold decode in tiles (models/vaes/tiling.py)."""
        from apex_studio_tpu_torch.models.vaes.tiling import decode_tiled_3d

        if self.vae is None:  # released during a 720p-class denoise
            self.load_component_by_type("vae")
        thresh = int(os.environ.get("APEX_VAE_TILE_THRESHOLD", self.VAE_TILE_THRESHOLD))
        z = z.float()
        if z.ndim == 5 and z.shape[-2] * z.shape[-1] > thresh:
            tile = int(os.environ.get("APEX_VAE_TILE", self.VAE_TILE))
            video = decode_tiled_3d(self.vae.decode, z, self.vae.cfg.spatial_scale, tile=tile)
        else:
            video = self.vae.decode(z)
        b, c, t, h, w = video.shape
        return self.tensor_to_frames(video.transpose(1, 2).reshape(b * t, c, h, w))

    def _prepare_cond(self, image, height, width, lat_t, lat_h, lat_w, cfg_t, lat_c):
        """t2v: zero cond latents and mask channel; the zeroed vision stream."""
        dev = self.device
        cond = torch.zeros(1, cfg_t.in_channels - lat_c - 1, lat_t, lat_h, lat_w, device=dev)
        mask_ch = torch.zeros(1, 1, lat_t, lat_h, lat_w, device=dev)
        image_embeds = torch.zeros(1, self.VISION_TOKENS, cfg_t.image_embed_dim, device=dev)
        return cond, mask_ch, image_embeds, True


@register_engine("hunyuanvideo15", "i2v")
class HunyuanVideo15I2VEngine(HunyuanVideo15T2VEngine):
    """i2v: the first frame's latent as conditioning, plus SigLIP vision tokens."""

    def run(self, *args: Any, image=None, **kwargs: Any):
        if image is None:
            raise ValueError("hunyuanvideo15 i2v requires an input image")
        kwargs["_image"] = self.load_image_input(image)
        return super().run(*args, **kwargs)

    def _encode_image_latents(self, image: np.ndarray, height: int, width: int) -> torch.Tensor:
        import cv2

        resized = cv2.resize(np.asarray(image), (width, height), interpolation=cv2.INTER_LANCZOS4)
        px = resized.astype(np.float32) / 127.5 - 1.0
        return self.encode_video_latents(px.transpose(2, 0, 1)[None, :, None])  # [1,C,1,h,w]

    def encode_image_siglip(self, image: np.ndarray) -> torch.Tensor:
        from apex_studio_tpu_torch.models.text_encoders.siglip import preprocess_siglip_image

        encoder = self.load_helper("image_encoder")
        pixels = preprocess_siglip_image(np.asarray(image), getattr(encoder.cfg, "image_size", 384))
        with torch.inference_mode():
            return encoder(torch.from_numpy(pixels).to(self.device))

    def _prepare_cond(self, image, height, width, lat_t, lat_h, lat_w, cfg_t, lat_c):
        z = self._encode_image_latents(image, height, width).float()
        cond = torch.cat([z, torch.zeros(1, z.shape[1], lat_t - 1, lat_h, lat_w, device=z.device)], dim=2)
        mask_ch = torch.zeros(1, 1, lat_t, lat_h, lat_w, device=z.device)
        mask_ch[:, :, 0] = 1.0
        try:
            image_embeds, img_zeroed = self.encode_image_siglip(image), False
        except KeyError:
            logger.warning("no image_encoder helper in manifest; i2v falls back to the t2v "
                           "zeroed vision stream")
            image_embeds = torch.zeros(1, self.VISION_TOKENS, cfg_t.image_embed_dim, device=z.device)
            img_zeroed = True
        return cond, mask_ch, image_embeds, img_zeroed
