"""QwenImage engines (port of ``apex_studio_tpu/engine/qwenimage.py``):
text-to-image, instruction editing (``edit``, ``edit_plus``) and ControlNet.

- prompt → Qwen2.5-VL ChatML text with the family's system message, final
  (normed) hidden states, the template's first ``DROP_IDX`` tokens cropped,
  the real tokens zero-padded to a 32-multiple bucket; disk-cached under
  ``qwenimage_te`` with the JAX cache key's fields, so a repeat prompt never
  rebuilds the 7B encoder after it is released
- packed 2×2 latents from the seed contract; sigmas ``linspace(1, 1/n, n)``
  with the dynamic shift ``mu`` of the image token count; the DiT takes
  ``t/1000``
- true CFG only with a negative prompt **and** ``true_cfg_scale > 1``:
  ``v_neg + g·(v − v_neg)`` in f32
- a denoise step is the forward(s), CFG and the Euler update in one step
  function (engine/fused.py); previews only above 8 steps
- edit: each condition image is resized (Lanczos), VAE-encoded at T = 1 and
  packed; its tokens follow the noise tokens, each grid a later RoPE frame,
  and the output is sliced back to the noise tokens. As in the JAX engine,
  the encoder sees the edit system prompt only (no vision tower)
- controlnet: the ``controlnet`` transformer component's per-block residuals
  go into the main DiT, scaled by ``controlnet_conditioning_scale`` inside
  the ``control_guidance`` window; the branch runs again for the negative
  prompt under CFG. The DiT loads before the prompt is encoded, as in the
  JAX engine, so this engine does not stage the encoder out
- the Wan VAE decodes at T = 1
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine, dynamic_shift_mu
from apex_studio_tpu_torch.engine.fused import build_euler_step, cfg_combine
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.qwenimage")

SYSTEM_MESSAGE = (
    "Describe the image by detailing the color, shape, size, texture, quantity, "
    "text, spatial relationships of the objects and background:"
)
EDIT_SYSTEM_MESSAGE = (
    "Describe the key features of the input image (color, shape, size, texture, "
    "objects, background), then explain how the user's text instruction should "
    "alter or modify the image. Generate a new image that meets the user's "
    "requirements while maintaining consistency with the original input where "
    "appropriate."
)
DROP_IDX = 34  # tokens of the chat-template prefix to crop


def _f32(x: float) -> float:
    """A Python float holding the f32 value the JAX engine traces."""
    return float(np.float32(x))


@register_engine("qwenimage", "t2i")
class QwenImageT2IEngine(BaseEngine):
    system_message = SYSTEM_MESSAGE

    @torch.inference_mode()
    def encode_prompt(self, prompt: str, max_length: int = 1024) -> torch.Tensor:
        """→ f32 [1, bucket, 3584] on the device: the real tokens after the
        template prefix, then zeros up to a multiple of 32."""
        from apex_studio_tpu_torch.utils.disk_cache import EmbeddingCache

        if self.text_encoder is None:
            self.load_component_by_type("text_encoder")
        te = self.text_encoder
        cache = EmbeddingCache("qwenimage_te")
        cache_key = {
            "prompt": prompt, "max_len": max_length, "sys": self.system_message,
            "base": te.base,
            "weights": str(te.spec.get("model_path") or "")[:256],
            "config": te.spec.get("config") or te.spec.get("config_path") or "",
        }
        hit = cache.load(cache_key)
        if hit is not None:
            return torch.from_numpy(hit[0]).to(self.device)
        model = te._ensure_model()
        text = (
            f"<|im_start|>system\n{self.system_message}<|im_end|>\n"
            f"<|im_start|>user\n{prompt}<|im_end|>\n<|im_start|>assistant\n"
        )
        ids, mask = te.tokenize([text], max_length + DROP_IDX)
        hidden = model(torch.from_numpy(ids).long().to(self.device),
                       attention_mask=torch.from_numpy(mask).to(self.device), normalize_last=True)
        true_len = int(mask.sum())
        n = max(1, true_len - DROP_IDX)
        bucket = ((n + 31) // 32) * 32
        out = np.zeros((1, bucket, hidden.shape[-1]), np.float32)
        out[0, :n] = hidden[0, DROP_IDX:true_len].float().cpu().numpy()
        cache.store(cache_key, out, np.ones((1, bucket), np.int32))
        return torch.from_numpy(out).to(self.device)

    # -- shared pieces of the three pipelines -----------------------------------------

    def _load_denoise_components(self) -> None:
        if self.transformer is None:
            self.load_component_by_type("transformer")
        # the VAE defines the latent geometry: it loads even for return_latents runs
        if self.vae is None:
            self.load_component_by_type("vae")
        if self.scheduler is None:
            self.load_component_by_type("scheduler")

    def _geometry(self, height: int, width: int):
        lat_scale = self.vae.cfg.spatial_scale if self.vae is not None else 8
        height -= height % (lat_scale * 2)
        width -= width % (lat_scale * 2)
        return height, width, height // lat_scale, width // lat_scale

    def _timesteps(self, n_tokens: int, num_inference_steps: int, sigmas, timesteps):
        if sigmas is None:
            sigmas = np.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps)
        ts, n = self.get_timesteps(self.scheduler, num_inference_steps, timesteps=timesteps,
                                   sigmas=sigmas, mu=dynamic_shift_mu(self.scheduler, n_tokens))
        self.scheduler.set_begin_index(0)
        return ts, n

    def _denoise(self, x, ts, velocity, step_args: Callable, progress_callback, preview=None):
        """Euler steps over ``ts``: ``velocity(x, t_vec, *step_args(i))``.
        ``preview`` = (callback, interval, lat_h, lat_w) decodes every
        ``interval`` steps but the last."""
        step = build_euler_step(velocity)
        denoise_cb = make_mapped_progress(progress_callback, 0.4, 0.9)
        b = x.shape[0]
        for i, t in enumerate(ts):
            t_vec = torch.full((b,), float(t) / 1000.0, dtype=torch.float32, device=self.device)
            x = step(x, float(self.scheduler.sigmas[i]), float(self.scheduler.sigmas[i + 1]),
                     t_vec, *step_args(i))
            if preview is not None and (i + 1) % preview[1] == 0 and i + 1 < len(ts):
                try:
                    preview[0](self._decode_frames(x, *preview[2:]), i)
                except Exception:
                    logger.exception("preview callback failed")
            if denoise_cb is not None:
                denoise_cb(min((i + 1) / len(ts), 1.0), f"Denoising step {i + 1}/{len(ts)}")
        return x

    @staticmethod
    def _preview(render_on_step, callback, interval, num_inference_steps, lat_h, lat_w):
        if render_on_step and callback is not None and num_inference_steps > 8:
            return callback, interval, lat_h, lat_w
        return None

    def _finish(self, x, lat_h, lat_w, return_latents, progress_callback, done: str):
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self._decode_frames(x, lat_h, lat_w)
        safe_emit_progress(progress_callback, 1.0, done)
        return frames

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 50,
        true_cfg_scale: float = 4.0,
        guidance_scale: float = 1.0,
        num_images: int = 1,
        seed: Optional[int] = None,
        latents: Optional[np.ndarray] = None,
        sigmas: Optional[List[float]] = None,
        timesteps: Optional[List[float]] = None,
        return_latents: bool = False,
        render_on_step: bool = False,
        render_on_step_callback: Optional[Callable] = None,
        render_on_step_interval: int = 3,
        progress_callback: Optional[Callable] = None,
        offload: bool = True,
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting t2i pipeline")
        # encode before the 20B DiT loads (staged single-card residency)
        use_cfg = true_cfg_scale > 1.0 and negative_prompt is not None
        txt = self.encode_prompt(prompt or "")
        neg_txt = self.encode_prompt(negative_prompt or "") if use_cfg else None
        if offload:
            self.maybe_release_text_encoders()
        safe_emit_progress(progress_callback, 0.2, "Prompts ready")

        self._load_denoise_components()
        tf = self.transformer
        height, width, lat_h, lat_w = self._geometry(height, width)
        noise = self.get_latents((num_images, tf.cfg.out_channels, lat_h, lat_w), seed=seed, latents=latents)
        x = tf.pack_latents(noise.float())
        safe_emit_progress(progress_callback, 0.3, "Initialized latent noise")

        ts, num_inference_steps = self._timesteps(x.shape[1], num_inference_steps, sigmas, timesteps)
        safe_emit_progress(progress_callback, 0.4, "Timesteps computed")
        grid = (lat_h // 2, lat_w // 2)
        g = _f32(true_cfg_scale if use_cfg else 1.0)

        def velocity(x, t_vec):
            x_in = x.to(tf.dtype)
            v = tf(x_in, txt, t_vec, grid_hw=grid).float()
            if use_cfg:
                v = cfg_combine(v, tf(x_in, neg_txt, t_vec, grid_hw=grid).float(), g)
            return v

        preview = self._preview(render_on_step, render_on_step_callback, render_on_step_interval,
                                num_inference_steps, lat_h, lat_w)
        x = self._denoise(x, ts, velocity, lambda i: (), progress_callback, preview)
        safe_emit_progress(progress_callback, 0.9, "Denoising complete")
        return self._finish(x, lat_h, lat_w, return_latents, progress_callback, "Completed t2i pipeline")

    # -- image conditioning and decode ------------------------------------------------

    @torch.inference_mode()
    def encode_image_latents(self, image: np.ndarray, height: int, width: int) -> torch.Tensor:
        """RGB uint8 → packed latent tokens through the manifest's VAE (at
        T = 1 for the Wan VAE), not disk-cached, as in the JAX engine."""
        import cv2

        from apex_studio_tpu_torch.models.vaes.wan_vae import AutoencoderKLWan

        resized = cv2.resize(np.asarray(image), (width, height), interpolation=cv2.INTER_LANCZOS4)
        px = torch.from_numpy((resized.astype(np.float32) / 127.5 - 1.0).transpose(2, 0, 1)[None].copy())
        px = px.to(self.device)
        if isinstance(self.vae, AutoencoderKLWan):
            z = self.vae.encode(px[:, :, None])[:, :, 0]
        else:
            z = self.vae.encode(px)
        return self.transformer.pack_latents(z.float())

    @torch.inference_mode()
    def _decode_frames(self, packed: torch.Tensor, lat_h: int, lat_w: int) -> List[np.ndarray]:
        from apex_studio_tpu_torch.models.vaes.wan_vae import AutoencoderKLWan

        z = self.transformer.unpack_latents(packed, lat_h, lat_w).float()
        if isinstance(self.vae, AutoencoderKLWan):
            img = self.vae.decode(z[:, :, None])[:, :, 0]
        else:
            img = self.vae.decode(z)
        return self.tensor_to_frames(img)


@register_engine("qwenimage", "edit", "edit_plus")
class QwenImageEditEngine(QwenImageT2IEngine):
    """Instruction editing; ``edit_plus`` takes a list of condition images."""

    system_message = EDIT_SYSTEM_MESSAGE

    @torch.inference_mode()
    def run(
        self,
        image: Any = None,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 50,
        true_cfg_scale: float = 4.0,
        seed: Optional[int] = None,
        sigmas: Optional[List[float]] = None,
        timesteps: Optional[List[float]] = None,
        return_latents: bool = False,
        render_on_step: bool = False,
        render_on_step_callback: Optional[Callable] = None,
        render_on_step_interval: int = 3,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting edit pipeline")
        if image is None:
            raise ValueError("edit requires at least one input image")
        images = image if isinstance(image, (list, tuple)) else [image]
        images = [self.load_image_input(im) for im in images]

        use_cfg = true_cfg_scale > 1.0 and negative_prompt is not None
        txt = self.encode_prompt(prompt or "")
        neg_txt = self.encode_prompt(negative_prompt or "") if use_cfg else None
        self.maybe_release_text_encoders()
        safe_emit_progress(progress_callback, 0.15, "Prompts ready")

        self._load_denoise_components()
        tf = self.transformer
        height, width, lat_h, lat_w = self._geometry(height, width)
        cond_tokens = [self.encode_image_latents(im, height, width) for im in images]
        cond = torch.cat(cond_tokens, dim=1)
        cond_segments = tuple((lat_h // 2, lat_w // 2) for _ in cond_tokens)
        safe_emit_progress(progress_callback, 0.3, "Condition images encoded")

        noise = self.get_latents((1, tf.cfg.out_channels, lat_h, lat_w), seed=seed)
        x = tf.pack_latents(noise.float())
        n_noise = x.shape[1]
        ts, num_inference_steps = self._timesteps(n_noise, num_inference_steps, sigmas, timesteps)
        safe_emit_progress(progress_callback, 0.4, "Timesteps computed")
        grid = (lat_h // 2, lat_w // 2)
        g = _f32(true_cfg_scale if use_cfg else 1.0)

        def velocity(x, t_vec):
            x_in = x.to(tf.dtype)
            seq = torch.cat([x_in, cond.to(x_in.dtype)], dim=1)

            def fw(txt_):
                out = tf(seq, txt_, t_vec, grid_hw=grid, extra_segments=cond_segments)
                return out[:, :n_noise].float()

            v = fw(txt)
            return cfg_combine(v, fw(neg_txt), g) if use_cfg else v

        preview = self._preview(render_on_step, render_on_step_callback, render_on_step_interval,
                                num_inference_steps, lat_h, lat_w)
        x = self._denoise(x, ts, velocity, lambda i: (), progress_callback, preview)
        safe_emit_progress(progress_callback, 0.9, "Denoising complete")
        return self._finish(x, lat_h, lat_w, return_latents, progress_callback, "Completed edit pipeline")


@register_engine("qwenimage", "controlnet")
class QwenImageControlNetEngine(QwenImageT2IEngine):
    """t2i guided by a ``qwenimage.controlnet`` branch, declared in the
    manifest as a transformer component named ``controlnet``."""

    def _load_controlnet(self):
        if "controlnet" in self.helpers:
            return self.helpers["controlnet"]
        from apex_studio_tpu_torch.models.registry import transformer_registry

        spec = self.component_specs.get("controlnet")
        if spec is None:
            raise KeyError("manifest has no 'controlnet' component")
        cn = self._instantiate_family(transformer_registry, spec, "qwenimage")
        self.helpers["controlnet"] = cn
        return cn

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        control_image: Optional[Any] = None,
        controlnet_conditioning_scale: float = 1.0,
        control_guidance_start: float = 0.0,
        control_guidance_end: float = 1.0,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 50,
        true_cfg_scale: float = 4.0,
        seed: Optional[int] = None,
        sigmas: Optional[List[float]] = None,
        timesteps: Optional[List[float]] = None,
        return_latents: bool = False,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting controlnet pipeline")
        self._load_denoise_components()
        controlnet = self._load_controlnet()
        if control_image is None:
            raise ValueError("controlnet requires a control_image")

        use_cfg = true_cfg_scale > 1.0 and negative_prompt is not None
        txt = self.encode_prompt(prompt or "")
        neg_txt = self.encode_prompt(negative_prompt or "") if use_cfg else None

        tf = self.transformer
        height, width, lat_h, lat_w = self._geometry(height, width)
        cond = self.encode_image_latents(np.asarray(self.load_image_input(control_image)), height, width)
        noise = self.get_latents((1, tf.cfg.out_channels, lat_h, lat_w), seed=seed)
        x = tf.pack_latents(noise.float())
        ts, _n = self._timesteps(x.shape[1], num_inference_steps, sigmas, timesteps)
        grid = (lat_h // 2, lat_w // 2)
        g = _f32(true_cfg_scale if use_cfg else 1.0)

        def velocity(x, t_vec, cscale):
            x_in = x.to(tf.dtype)
            cond_in = cond.to(tf.dtype)

            def fw(txt_):
                samples = controlnet(x_in, cond_in, txt_, t_vec, grid_hw=grid, conditioning_scale=cscale)
                return tf(x_in, txt_, t_vec, grid_hw=grid, controlnet_block_samples=samples).float()

            v = fw(txt)
            return cfg_combine(v, fw(neg_txt), g) if use_cfg else v

        n_steps = len(ts)

        def step_args(i):
            # the control_guidance window: the branch's scale is 0 outside it
            frac = i / max(n_steps - 1, 1)
            keep = 1.0 - float(frac < control_guidance_start or frac > control_guidance_end)
            return (controlnet_conditioning_scale * keep,)

        x = self._denoise(x, ts, velocity, step_args, progress_callback)
        return self._finish(x, lat_h, lat_w, return_latents, progress_callback,
                            "Completed controlnet pipeline")
