"""HunyuanVideo (the original) engines: t2v, i2v and FramePack (port of
``apex_studio_tpu/engine/hunyuanvideo.py``).

- llava-llama-3 conditioning: the video-description template, the hidden
  state three from the top (the encoder config's ``skip_last_layers`` 2),
  the first ``crop_start`` (95) tokens cropped, max length 256 + crop; CLIP-L
  pooled as the second encoder (zeros when the manifest names none). Both
  encodes are disk-cached by prompt, and the encoders released after them
  unless ``APEX_RELEASE_TEXT_ENCODERS=0``
- FlowMatchDiscrete with the manifest's shift; the distilled guidance
  embedded as ``guidance_scale × 1000``; true CFG ``vn + g·(v − vn)`` in f32
  when ``true_guidance_scale > 1`` and a negative prompt is given; each step
  the forward(s), the combine and the Euler update (engine/fused.py)
- i2v: the image latent mixed into the noise at t = 0.999; ``token_replace``
  pins the first latent frame to the image latent and zeroes its velocity,
  ``latent_concat`` packs ``[noise | image (frames > 0 zeroed) | mask]``
- the decode is whole, as in JAX, up to the 33-frame 720p latent size
  (``WHOLE_DECODE_LATENT_ELEMENTS``); larger latents decode in spatial tiles
  (models/vaes/tiling.py), so the frames are a function of the request alone.
  The JAX engine always decodes whole
- FramePack: sections of ``latent_window_size`` latent frames, each
  conditioned on the image latent and 1x / 2x / 4x clean history, blended in
  pixel space; ``inverted_anti_drifting`` and ``vanilla`` sampling. Where the
  manifest names an image encoder (``clip`` / ``image_encoder``) it must run:
  a failure raises (the JAX engine logs it and uses zeros); without one the
  image embeddings are zeros, as in JAX
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine, dynamic_shift_mu
from apex_studio_tpu_torch.engine.fused import build_euler_step, cfg_combine
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.hunyuanvideo")

PROMPT_TEMPLATE_TEXT = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by detailing the "
    "following aspects: 1. The main content and theme of the video."
    "2. The color, shape, size, texture, quantity, text, and spatial relationships of the objects."
    "3. Actions, events, behaviors temporal relationships, physical movement changes of the objects."
    "4. background environment, light, style and atmosphere."
    "5. camera angles, movements, and transitions used in the video:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
)
CROP_START_TEXT = 95
# the largest latent (frames × H × W) decoded whole: 33 frames of 720x1280,
# 9 x 90 x 160; its whole decode peaks at about 63 GiB on the card (PERF.md),
# the 81-frame one would need about 2.5 times that
WHOLE_DECODE_LATENT_ELEMENTS = 9 * 90 * 160
# a whole decode's peak, in units of its widest full-resolution activation
# (c0 channels × frames × H × W): the upsampler's conv at twice c0 and the
# last resnets (PERF.md)
DECODE_PEAK_ACTIVATIONS = 5


class HunyuanVideoShared(BaseEngine):
    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.text_encoder_2 = None  # CLIP-L pooled

    def load_text_encoders(self) -> None:
        from apex_studio_tpu_torch.text_encoder import TextEncoder

        te_specs = [s for s in self.component_specs.values() if s.get("type") == "text_encoder"]
        llama = next((s for s in te_specs if "Llama" in (s.get("base") or "") or "Llava" in (s.get("base") or "")),
                     None)
        clip = next((s for s in te_specs if "CLIP" in (s.get("base") or "")), None)
        if self.text_encoder is None and llama is not None:
            self.text_encoder = TextEncoder(self, llama)
        if self.text_encoder_2 is None and clip is not None:
            self.text_encoder_2 = TextEncoder(self, clip)

    def _cache_key(self, te, name: str, prompt: str, **extra) -> Dict[str, Any]:
        return {"fn": name, "prompt": prompt, "base": te.base, **extra,
                "weights": str(te.spec.get("model_path") or "")[:256],
                "config": te.spec.get("config") or te.spec.get("config_path") or ""}

    def _encode_llama(self, prompt: str, max_length: int = 256, crop_start: int = CROP_START_TEXT):
        """→ (hidden [1, max_length, D], mask [1, max_length]) on the device:
        the template's first ``crop_start`` tokens cropped."""
        from apex_studio_tpu_torch.utils.disk_cache import EmbeddingCache

        te = self.text_encoder
        cache = EmbeddingCache("hyv_llama")
        key = self._cache_key(te, "hyv_llama", prompt, max_len=max_length, crop=crop_start)
        hit = cache.load(key)
        if hit is not None:
            return tuple(torch.from_numpy(a).to(self.device) for a in hit)
        model = te._ensure_model()
        ids, mask = te.tokenize([PROMPT_TEMPLATE_TEXT.format(prompt or "")], max_length + crop_start)
        with torch.inference_mode():
            hidden = model(torch.from_numpy(ids).long().to(self.device),
                           attention_mask=torch.from_numpy(mask).to(self.device))
        hidden, mask = hidden[:, crop_start:], np.ascontiguousarray(mask[:, crop_start:])
        cache.store(key, hidden.float().cpu().numpy(), mask)
        return hidden, torch.from_numpy(mask).to(self.device)

    def _encode_clip_pooled(self, prompt: str) -> torch.Tensor:
        """CLIP-L's pooled output [1, 768] (77 tokens); zeros without CLIP."""
        from apex_studio_tpu_torch.utils.disk_cache import EmbeddingCache

        clip = self.text_encoder_2
        if clip is None:
            return torch.zeros(1, self.transformer.cfg.pooled_projection_dim, device=self.device)
        cache = EmbeddingCache("hyv_clip_pooled")
        key = self._cache_key(clip, "hyv_clip_pooled", prompt or "")
        hit = cache.load(key)
        if hit is not None:
            return torch.from_numpy(hit[0]).to(self.device)
        model = clip._ensure_model()
        ids, mask = clip.tokenize([prompt or ""], 77)
        with torch.inference_mode():
            _, pooled = model(torch.from_numpy(ids).long().to(self.device),
                              attention_mask=torch.from_numpy(mask).to(self.device))
        cache.store(key, pooled.float().cpu().numpy())
        return pooled

    def encode_prompts(self, prompt, negative_prompt, true_guidance_scale):
        """(text, text_mask, pooled, ntext, ntext_mask, npooled); the negative
        side is None without true CFG. The encoders are released after."""
        text, text_mask = self._encode_llama(prompt or "")
        pooled = self._encode_clip_pooled(prompt or "")
        ntext = ntext_mask = npooled = None
        if true_guidance_scale > 1.0 and negative_prompt is not None:
            ntext, ntext_mask = self._encode_llama(negative_prompt or "")
            npooled = self._encode_clip_pooled(negative_prompt or "")
        self.maybe_release_text_encoders()
        return text, text_mask, pooled, ntext, ntext_mask, npooled

    def load_components(self) -> None:
        self.load_text_encoders()
        if self.transformer is None:
            self.load_component_by_type("transformer")
        if self.vae is None:
            self.load_component_by_type("vae")
        if self.scheduler is None:
            self.load_component_by_type("scheduler")

    @staticmethod
    def _decode_whole(z: torch.Tensor) -> bool:
        """Whether latents ``z`` decode whole: up to
        ``WHOLE_DECODE_LATENT_ELEMENTS`` latent frames × H × W."""
        _, _, t, h, w = z.shape
        return t * h * w <= WHOLE_DECODE_LATENT_ELEMENTS

    def _whole_decode_gib(self, z: torch.Tensor) -> float:
        """The reckoned peak of a whole decode of ``z``: ``DECODE_PEAK_ACTIVATIONS``
        times its widest full-resolution activation."""
        cfg = self.vae.cfg
        _, _, t, h, w = z.shape
        frames = (t - 1) * cfg.temporal_scale + 1
        elem = torch.finfo(self.vae.decoder.conv_in.dtype).bits // 8
        return DECODE_PEAK_ACTIVATIONS * cfg.block_out_channels[0] * frames * h * w * cfg.spatial_scale**2 * elem / 2**30

    @torch.inference_mode()
    def decode_video(self, z: torch.Tensor) -> torch.Tensor:
        """Latents → video [B, 3, T, H, W] in [-1, 1], f32: whole up to the
        33-frame 720p size, else in spatial tiles of 16 latent pixels."""
        from apex_studio_tpu_torch.models.vaes.tiling import decode_tiled_3d

        z = z.float()
        if not self._decode_whole(z):
            return decode_tiled_3d(self.vae.decode, z, self.vae.cfg.spatial_scale, tile=16)
        try:
            return self.vae.decode(z)
        except torch.cuda.OutOfMemoryError as err:
            free = torch.cuda.mem_get_info(self.device)[0] / 2**30
            raise RuntimeError(f"the whole decode of latents {tuple(z.shape)} needs about "
                               f"{self._whole_decode_gib(z):.1f} GiB; {free:.1f} GiB of the card are free") from err

    def decode_latents(self, z: torch.Tensor) -> List[np.ndarray]:
        video = self.decode_video(z)
        b, c, t, h, w = video.shape
        return self.tensor_to_frames(video.transpose(1, 2).reshape(b * t, c, h, w))

    @torch.inference_mode()
    def _denoise(self, x, ts, text, text_mask, pooled, ntext, ntext_mask, npooled, guidance_scale: float,
                 true_cfg: float, cond_pack: Dict[str, Any], render_on_step: bool,
                 render_cb: Optional[Callable], render_interval: int, progress_cb: Optional[Callable]):
        tf = self.transformer
        use_cfg = true_cfg > 1.0 and ntext is not None
        cond_type = cond_pack.get("type")  # None | latent_concat | token_replace
        img_lat, mask_ch = cond_pack.get("image_latents"), cond_pack.get("mask")
        gvec = (torch.full((x.shape[0],), guidance_scale * 1000.0, dtype=torch.float32, device=x.device)
                if tf.cfg.guidance_embeds else None)

        def apply(x, t_vec):
            if cond_type == "latent_concat":
                x_in = torch.cat([x, img_lat, mask_ch], dim=1)
            elif cond_type == "token_replace":
                x_in = torch.cat([img_lat, x[:, :, 1:]], dim=2)
            else:
                x_in = x
            x_in = x_in.to(tf.dtype)
            v = tf(x_in, t_vec, text, text_mask, pooled=pooled, guidance=gvec).float()
            if use_cfg:
                v = cfg_combine(v, tf(x_in, t_vec, ntext, ntext_mask, pooled=npooled, guidance=gvec),
                                float(np.float32(true_cfg)))
            if cond_type == "token_replace":
                # the first latent frame stays pinned: its Euler update is 0
                v[:, :, :1] = 0.0
            return v

        step = build_euler_step(apply)
        if len(ts) <= 8:
            render_on_step = False
        for i, t in enumerate(ts):
            t_vec = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
            x = step(x, float(self.scheduler.sigmas[i]), float(self.scheduler.sigmas[i + 1]), t_vec)
            if render_on_step and render_cb is not None and (i + 1) % render_interval == 0 and i + 1 < len(ts):
                try:
                    render_cb(self.preview_frames(x, self.decode_latents), i)
                except Exception:
                    logger.exception("preview callback failed")
            if progress_cb is not None:
                progress_cb(min((i + 1) / len(ts), 1.0), f"Denoising step {i + 1}/{len(ts)}")
        return x

    def _image_pixels(self, image, height: int, width: int) -> np.ndarray:
        """An image input Lanczos-resized to (height, width): [3, H, W] f32 in
        [-1, 1], and the resized HWC uint8 array."""
        import cv2

        arr = cv2.resize(self.load_image_input(image), (width, height), interpolation=cv2.INTER_LANCZOS4)
        return (arr.astype(np.float32) / 127.5 - 1.0).transpose(2, 0, 1), arr

    @torch.inference_mode()
    def _run(self, prompt, negative_prompt, height, width, num_frames, duration, fps, num_inference_steps,
             guidance_scale, true_guidance_scale, seed, latents, shift, timesteps, return_latents,
             render_on_step, render_on_step_callback, render_on_step_interval, progress_callback, image=None,
             image_condition_type=None):
        safe_emit_progress(progress_callback, 0.0, "Starting pipeline")
        self.load_components()
        safe_emit_progress(progress_callback, 0.05, "Components ready")

        cfg_t = self.transformer.cfg
        vae_cfg = self.vae.cfg
        s_scale, t_scale, p = vae_cfg.spatial_scale, vae_cfg.temporal_scale, cfg_t.patch_size
        height -= height % (s_scale * p)
        width -= width % (s_scale * p)
        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1
        num_frames = max(1, num_frames - (num_frames - 1) % t_scale)
        lat_t = (num_frames - 1) // t_scale + 1
        lat_h, lat_w = height // s_scale, width // s_scale

        text, text_mask, pooled, ntext, ntext_mask, npooled = self.encode_prompts(
            prompt, negative_prompt, true_guidance_scale)
        use_cfg = ntext is not None
        safe_emit_progress(progress_callback, 0.2, "Prompts encoded")

        x = self.get_latents((1, vae_cfg.latent_channels, lat_t, lat_h, lat_w), seed=seed, latents=latents)
        cond_pack: Dict[str, Any] = {"type": None}
        if image is not None:
            px, _ = self._image_pixels(image, height, width)
            img_lat = self.encode_video_latents(px[None, :, None]).float()  # [1, C, 1, h, w]
            img_lat = img_lat.repeat_interleave(lat_t, dim=2)
            x = x * 0.999 + img_lat * (1.0 - 0.999)  # the noise mixed at t = 0.999
            ctype = image_condition_type or cfg_t.image_condition_type or "token_replace"
            if ctype == "latent_concat":
                img_cc = img_lat.clone()
                img_cc[:, :, 1:] = 0.0
                mask = torch.zeros(1, 1, lat_t, lat_h, lat_w, device=x.device)
                mask[:, :, :1] = 1.0
                cond_pack = {"type": "latent_concat", "image_latents": img_cc, "mask": mask}
            else:
                first = img_lat[:, :, :1]
                x = torch.cat([first, x[:, :, 1:]], dim=2)
                cond_pack = {"type": "token_replace", "image_latents": first}
        safe_emit_progress(progress_callback, 0.3, "Latents initialized")

        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps, timesteps=timesteps,
                                   **({"shift": shift} if shift is not None else {}))
        safe_emit_progress(progress_callback, 0.4, "Timesteps computed; starting denoise")
        x = self._denoise(x, ts, text, text_mask, pooled, ntext, ntext_mask, npooled, guidance_scale,
                          true_guidance_scale if use_cfg else 0.0, cond_pack, render_on_step,
                          render_on_step_callback, render_on_step_interval,
                          make_mapped_progress(progress_callback, 0.4, 0.9))
        safe_emit_progress(progress_callback, 0.9, "Denoising complete")
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self.decode_latents(x)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames


@register_engine("hunyuanvideo", "t2v")
class HunyuanVideoT2VEngine(HunyuanVideoShared):
    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        height: int = 720,
        width: int = 1280,
        duration: Optional[float] = None,
        fps: int = 16,
        num_frames: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 6.0,
        true_guidance_scale: float = 1.0,
        seed: Optional[int] = None,
        latents: Optional[np.ndarray] = None,
        shift: Optional[float] = None,
        timesteps: Optional[List[float]] = None,
        return_latents: bool = False,
        render_on_step: bool = False,
        render_on_step_callback: Optional[Callable] = None,
        render_on_step_interval: int = 5,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        return self._run(prompt, negative_prompt, height, width, num_frames, duration, fps, num_inference_steps,
                         guidance_scale, true_guidance_scale, seed, latents, shift, timesteps, return_latents,
                         render_on_step, render_on_step_callback, render_on_step_interval, progress_callback)


@register_engine("hunyuanvideo", "i2v")
class HunyuanVideoI2VEngine(HunyuanVideoShared):
    def run(
        self,
        image=None,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        height: int = 720,
        width: int = 1280,
        duration: Optional[float] = None,
        fps: int = 16,
        num_frames: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 6.0,
        true_guidance_scale: float = 1.0,
        seed: Optional[int] = None,
        latents: Optional[np.ndarray] = None,
        shift: Optional[float] = None,
        timesteps: Optional[List[float]] = None,
        return_latents: bool = False,
        render_on_step: bool = False,
        render_on_step_callback: Optional[Callable] = None,
        render_on_step_interval: int = 5,
        progress_callback: Optional[Callable] = None,
        image_condition_type: Optional[str] = None,
        **_: Any,
    ):
        if image is None:
            image = _.pop("_image", None)
        if image is None:
            raise ValueError("hunyuanvideo i2v requires an input image")
        return self._run(prompt, negative_prompt, height, width, num_frames, duration, fps, num_inference_steps,
                         guidance_scale, true_guidance_scale, seed, latents, shift, timesteps, return_latents,
                         render_on_step, render_on_step_callback, render_on_step_interval, progress_callback,
                         image=image, image_condition_type=image_condition_type)


@register_engine("hunyuanvideo", "framepack")
class HunyuanVideoFramepackEngine(HunyuanVideoShared):
    """FramePack long video: sections of ``latent_window_size`` latent frames
    denoised one at a time, conditioned on clean 1x / 2x / 4x history, each
    section's frames soft-appended in pixel space."""

    IMAGE_TOKENS = 729

    @staticmethod
    def _soft_append(history: np.ndarray, current: np.ndarray, overlap: int) -> np.ndarray:
        """[B,C,T,H,W] pixel blend over ``overlap`` frames."""
        if overlap <= 0:
            return np.concatenate([history, current], axis=2)
        w = np.linspace(1, 0, overlap, dtype=np.float32)[None, None, :, None, None]
        blended = w * history[:, :, -overlap:] + (1 - w) * current[:, :, :overlap]
        return np.concatenate([history[:, :, :-overlap], blended, current[:, :, overlap:]], axis=2)

    def _image_embeds(self, image_arr: np.ndarray, last_image_arr: Optional[np.ndarray] = None) -> torch.Tensor:
        """SigLIP embeddings of the image (averaged with the last image's)
        through the manifest's ``clip`` / ``image_encoder`` helper; zeros when
        the manifest names neither. A configured encoder that fails raises."""
        from apex_studio_tpu_torch.models.text_encoders.siglip import preprocess_siglip_image

        for name in ("clip", "image_encoder"):
            if name in self.component_specs:
                enc = self.load_helper(name)
                size = getattr(enc.cfg, "image_size", 384)

                def embed(arr):
                    return enc(torch.from_numpy(preprocess_siglip_image(np.asarray(arr), size)).to(self.device))

                emb = embed(image_arr)
                if last_image_arr is not None:
                    emb = (emb + embed(last_image_arr)) / 2.0
                return emb.float()
        dim = getattr(self.transformer.cfg, "image_proj_dim", 1152)
        return torch.zeros(1, self.IMAGE_TOKENS, dim, device=self.device)

    def _decode_np(self, lats: np.ndarray) -> np.ndarray:
        return self.decode_video(torch.from_numpy(lats).to(self.device)).cpu().numpy()

    @torch.inference_mode()
    def run(
        self,
        image: Any = None,
        last_image: Any = None,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        height: int = 480,
        width: int = 832,
        num_frames: Optional[int] = None,
        duration: Optional[float] = None,
        fps: float = 30.0,
        latent_window_size: int = 9,
        sampling_type: str = "inverted_anti_drifting",
        num_inference_steps: int = 25,
        guidance_scale: float = 6.0,
        true_guidance_scale: float = 1.0,
        seed: Optional[int] = None,
        return_latents: bool = False,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting framepack pipeline")
        self.load_components()
        if image is None:
            raise ValueError("framepack requires an input image")

        tf = self.transformer
        cfg_t = tf.cfg
        s_scale, t_scale = self.vae.cfg.spatial_scale, self.vae.cfg.temporal_scale
        height -= height % (s_scale * cfg_t.patch_size)
        width -= width % (s_scale * cfg_t.patch_size)
        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1
        lat_h, lat_w = height // s_scale, width // s_scale
        total_lat = (num_frames - 1) // t_scale + 1
        n_sections = max(1, math.ceil(total_lat / latent_window_size))

        def encode(img):
            px, arr = self._image_pixels(img, height, width)
            return self.encode_video_latents(px[None, :, None]).float().cpu().numpy(), arr

        image_latents, arr = encode(image)
        last_arr = last_image_latents = None
        if last_image is not None:
            last_image_latents, last_arr = encode(last_image)
        image_embeds = self._image_embeds(arr, last_arr)
        text, text_mask, pooled, ntext, ntext_mask, npooled = self.encode_prompts(
            prompt, negative_prompt, true_guidance_scale)
        use_cfg = ntext is not None

        inverted = sampling_type == "inverted_anti_drifting"
        history_sizes = [1, 2, 16] if inverted else [16, 2, 1]
        lat_c = cfg_t.in_channels
        history_latents = np.zeros((1, lat_c, sum(history_sizes), lat_h, lat_w), np.float32)
        if not inverted:
            history_latents = np.concatenate([history_latents, image_latents], axis=2)
        gvec = (torch.full((1,), guidance_scale * 1000.0, dtype=torch.float32, device=self.device)
                if cfg_t.guidance_embeds else None)
        total_generated, history_video, latents_out = 0, None, None

        for k in range(n_sections):
            x = self.get_latents((1, lat_c, latent_window_size, lat_h, lat_w), seed=None if seed is None else seed + k)
            mu = dynamic_shift_mu(self.scheduler, latent_window_size * lat_h * lat_w / cfg_t.patch_size ** 2)
            ts, _ = self.get_timesteps(self.scheduler, num_inference_steps,
                                       sigmas=np.linspace(1.0, 0.0, num_inference_steps + 1)[:-1],
                                       mu=min(mu, math.log(7.0)))

            # the section's frame-index layout
            if inverted:
                pads = list(reversed(range(n_sections)))
                if n_sections > 4:
                    pads = [3] + [2] * (n_sections - 3) + [1, 0]
                sizes = [1, pads[k] * latent_window_size, latent_window_size] + history_sizes
                bounds = np.cumsum([0] + sizes)
                idx_prefix, _, idx_lat, idx_h1, idx_h2, idx_h4 = (
                    np.arange(bounds[i], bounds[i + 1]) for i in range(len(sizes)))
                h1, h2, h4 = np.split(history_latents[:, :, :sum(history_sizes)],
                                      np.cumsum(history_sizes)[:-1], axis=2)
                if last_image_latents is not None and k == 0:
                    h1 = last_image_latents
            else:
                sizes = [1] + history_sizes + [latent_window_size]
                bounds = np.cumsum([0] + sizes)
                idx_prefix, idx_h4, idx_h2, idx_h1, idx_lat = (
                    np.arange(bounds[i], bounds[i + 1]) for i in range(len(sizes)))
                h4, h2, h1 = np.split(history_latents[:, :, -sum(history_sizes):],
                                      np.cumsum(history_sizes)[:-1], axis=2)
            idx_clean = np.concatenate([idx_prefix, idx_h1])
            history = {name: torch.from_numpy(np.ascontiguousarray(a)).to(self.device, tf.dtype)
                       for name, a in (("clean", np.concatenate([image_latents, h1], axis=2)), ("2x", h2),
                                       ("4x", h4))}
            kwargs = dict(image_embeds=image_embeds, indices_latents=idx_lat, latents_clean=history["clean"],
                          indices_latents_clean=idx_clean, latents_history_2x=history["2x"],
                          indices_latents_history_2x=idx_h2, latents_history_4x=history["4x"],
                          indices_latents_history_4x=idx_h4, guidance=gvec)

            def apply(x, t_vec):
                xd = x.to(tf.dtype)
                v = tf(xd, t_vec, text, text_mask, pooled=pooled, **kwargs).float()
                if use_cfg:
                    v = cfg_combine(v, tf(xd, t_vec, ntext, ntext_mask, pooled=npooled, **kwargs),
                                    float(np.float32(true_guidance_scale)))
                return v

            step = build_euler_step(apply)
            for i, t in enumerate(ts):
                t_vec = torch.full((1,), float(t), dtype=torch.float32, device=self.device)
                x = step(x, float(self.scheduler.sigmas[i]), float(self.scheduler.sigmas[i + 1]), t_vec)
            x_np = x.float().cpu().numpy()

            is_last = k == n_sections - 1
            if inverted:
                if is_last:
                    x_np = np.concatenate([image_latents, x_np], axis=2)
                total_generated += x_np.shape[2]
                history_latents = np.concatenate([x_np, history_latents], axis=2)
                real = history_latents[:, :, :total_generated]
                cur = real[:, :, :latent_window_size * 2 + 1 if is_last else latent_window_size * 2]
            else:
                total_generated += x_np.shape[2]
                history_latents = np.concatenate([history_latents, x_np], axis=2)
                real = history_latents[:, :, -total_generated:]
                cur = real[:, :, -latent_window_size * 2:]

            if return_latents:
                latents_out = real
            else:
                overlap = (latent_window_size - 1) * t_scale + 1
                if history_video is None:
                    history_video = self._decode_np(real)
                elif inverted:
                    history_video = self._soft_append(self._decode_np(cur), history_video, overlap)
                else:
                    history_video = self._soft_append(history_video, self._decode_np(cur), overlap)
            safe_emit_progress(progress_callback, 0.1 + 0.8 * (k + 1) / n_sections, f"Section {k + 1}/{n_sections}")

        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return torch.from_numpy(latents_out)
        n = (history_video.shape[2] - 1) // t_scale * t_scale + 1
        video = torch.from_numpy(history_video[:, :, :n])
        b, c, tt, hh, ww = video.shape
        frames = self.tensor_to_frames(video.transpose(1, 2).reshape(b * tt, c, hh, ww))
        safe_emit_progress(progress_callback, 1.0, "Completed framepack pipeline")
        return frames
