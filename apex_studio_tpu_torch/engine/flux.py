"""Flux engines (port of ``apex_studio_tpu/engine/flux.py``): text-to-image
(CLIP pooled + T5 sequence conditioning, packed 2×2 latents, dynamic shift
from the image sequence length, embedded guidance for dev models, optional
true CFG, one Euler step per denoise step; seeded noise is drawn at the
unpacked latent shape, then packed) and the engines built on it:

- ``kontext``: the reference image's clean packed latents ride the image
  stream at RoPE t-index 1; only the noise tokens are denoised;
- ``fill``: 384 input channels, [noise (64) ‖ VAE(masked image) (64) ‖ the
  8×8 pixel-mask bits of each latent cell, packed 2×2 (256)];
- ``control``: 128 input channels, [noise ‖ VAE(control image)];
- ``dreamomni2``: several references, each at its preferred Kontext bucket,
  at t-index k+1 with accumulated width offsets.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine, dynamic_shift_mu
from apex_studio_tpu_torch.engine.fused import build_euler_step, cfg_combine
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.flux")


@register_engine("flux", "t2i")
class FluxT2IEngine(BaseEngine):
    """text_encoder = CLIP-L (pooled), text_encoder_2 = T5-XXL (sequence)."""

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.text_encoder_2 = None

    def load_text_encoders(self) -> None:
        from apex_studio_tpu_torch.text_encoder import TextEncoder

        te_specs = [s for s in self.component_specs.values() if s.get("type") == "text_encoder"]
        clip_spec = next((s for s in te_specs if "CLIP" in (s.get("base") or "")), None)
        t5_spec = next((s for s in te_specs if "T5" in (s.get("base") or "")), None)
        if clip_spec is None or t5_spec is None:
            raise KeyError("flux manifest requires CLIP and T5 text_encoder components")
        if self.text_encoder is None:
            self.text_encoder = TextEncoder(self, clip_spec)
        if self.text_encoder_2 is None:
            self.text_encoder_2 = TextEncoder(self, t5_spec)

    def encode_prompt(self, prompt: str, prompt_2: Optional[str], max_sequence_length: int):
        """→ (pooled [1, 768], t5_seq [1, L, 4096])."""
        self.load_text_encoders()
        clip = self.text_encoder
        ids, mask = clip.tokenize([prompt], 77)
        model = clip._ensure_model()
        _, pooled = model(torch.from_numpy(ids).long().to(self.device),
                          attention_mask=torch.from_numpy(mask).to(self.device))
        # T5 goes through the disk-cached TextEncoder.encode so a repeat
        # prompt never rebuilds the 4.7B encoder after release_text_encoders.
        seq, _ = self.text_encoder_2.encode([prompt_2 or prompt], max_sequence_length,
                                            use_chat_template=False)
        return pooled, seq

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        prompt_2: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        negative_prompt_2: Optional[str] = None,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 30,
        guidance_scale: float = 3.5,
        true_cfg_scale: float = 1.0,
        num_images: int = 1,
        seed: Optional[int] = None,
        latents: Optional[np.ndarray] = None,
        sigmas: Optional[List[float]] = None,
        timesteps: Optional[List[float]] = None,
        max_sequence_length: int = 512,
        return_latents: bool = False,
        render_on_step: bool = False,
        render_on_step_callback: Optional[Callable] = None,
        render_on_step_interval: int = 3,
        progress_callback: Optional[Callable] = None,
        offload: bool = True,
        _kontext_image: Any = None,
        _kontext_tokens: Any = None,  # (tokens [B, N, 64], grids), pre-packed
        _fill_cond: Optional[torch.Tensor] = None,  # [B, N, C]: fill or control features
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting t2i pipeline")
        if self.vae is None:
            self.load_component_by_type("vae")
        if self.scheduler is None:
            self.load_component_by_type("scheduler")

        use_cfg = true_cfg_scale > 1.0 and negative_prompt is not None

        # Encode before the transformer loads: the T5 and the DiT never need
        # to be resident together.
        safe_emit_progress(progress_callback, 0.02, "Encoding prompts")
        pooled, seq = self.encode_prompt(prompt or "", prompt_2, max_sequence_length)
        neg_pooled = neg_seq = None
        if use_cfg:
            neg_pooled, neg_seq = self.encode_prompt(negative_prompt or "", negative_prompt_2,
                                                     max_sequence_length)
        if offload:
            # only the T5: CLIP is small and its pooled output is not disk-cached
            self.maybe_release_text_encoders(names=("text_encoder_2",))
        safe_emit_progress(progress_callback, 0.20, "Encoded prompts")

        if self.transformer is None:
            self.load_component_by_type("transformer")

        tf = self.transformer
        cfg_t = tf.cfg
        lat_scale = self.vae.cfg.spatial_scale
        height = height - height % (lat_scale * 2)
        width = width - width % (lat_scale * 2)
        lat_c = cfg_t.out_channels // 4
        lat_h, lat_w = height // lat_scale, width // lat_scale
        b = num_images

        noise = self.get_latents((b, lat_c, lat_h, lat_w), seed=seed, latents=latents)
        x = tf.pack_latents(noise.float()).contiguous()

        cond_tokens = cond_grid = None
        if _kontext_tokens is not None:
            cond_tokens, cond_grid = _kontext_tokens
            cond_tokens = cond_tokens.expand(b, *cond_tokens.shape[1:])
        elif _kontext_image is not None:
            cond_tokens, cond_grid = self._encode_kontext_image(_kontext_image, height, width, b)
        safe_emit_progress(progress_callback, 0.38, "Initialized latent noise")

        image_seq_len = x.shape[1]
        if sigmas is None:
            sigmas = np.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps)
        ts, num_inference_steps = self.get_timesteps(
            self.scheduler, num_inference_steps, timesteps=timesteps, sigmas=sigmas,
            mu=dynamic_shift_mu(self.scheduler, image_seq_len))
        self.scheduler.set_begin_index(0)
        safe_emit_progress(progress_callback, 0.48, "Timesteps computed")

        guidance = (torch.full((b,), guidance_scale, dtype=torch.float32, device=self.device)
                    if cfg_t.guidance_embeds else None)
        grid = (lat_h // 2, lat_w // 2)
        rope = tf.rope_tables(seq.shape[1], *grid, cond_grid_hw=cond_grid, device=self.device)

        def apply(x, t_vec, seq, pooled, n_seq, n_pooled):
            x_in = x.to(tf.dtype)
            if _fill_cond is not None:
                # fill / control models: the features ride each noise token
                x_in = torch.cat([x_in, _fill_cond.to(tf.dtype)], dim=-1)

            def fw(s_, p_):
                return tf(x_in, s_, p_, t_vec, guidance, grid_hw=grid, cond_tokens=cond_tokens, rope=rope)

            v = fw(seq, pooled)
            if use_cfg:
                return cfg_combine(v, fw(n_seq, n_pooled), true_cfg_scale)
            return v

        step = build_euler_step(apply)
        denoise_cb = make_mapped_progress(progress_callback, 0.50, 0.90)
        for i, t in enumerate(ts):
            t_vec = torch.full((b,), float(t) / 1000.0, dtype=torch.float32, device=self.device)
            x = step(x, float(self.scheduler.sigmas[i]), float(self.scheduler.sigmas[i + 1]),
                     t_vec, seq, pooled, neg_seq, neg_pooled)
            if (render_on_step and render_on_step_callback is not None
                    and num_inference_steps > 8 and (i + 1) % render_on_step_interval == 0
                    and i + 1 < len(ts)):
                try:
                    render_on_step_callback(self._decode_frames(x, lat_h, lat_w), i)
                except Exception:
                    logger.exception("preview callback failed")
            if denoise_cb is not None:
                denoise_cb(min((i + 1) / len(ts), 1.0), f"Denoising step {i + 1}/{len(ts)}")

        safe_emit_progress(progress_callback, 0.90, "Denoising complete")
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x

        frames = self._decode_frames(x, lat_h, lat_w)
        safe_emit_progress(progress_callback, 1.0, "Completed t2i pipeline")
        return frames

    def _decode_frames(self, packed: torch.Tensor, lat_h: int, lat_w: int) -> List[np.ndarray]:
        z = self.transformer.unpack_latents(packed, lat_h, lat_w)
        return self.tensor_to_frames(self.vae.decode(z.float()))

    def _encode_packed(self, pixels: np.ndarray) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """HWC pixels in [-1, 1] → clean packed latent tokens [1, N, 4C] and
        their token grid, through the VAE's encode (not cached, as in JAX)."""
        px = torch.from_numpy(np.ascontiguousarray(pixels.transpose(2, 0, 1)[None], np.float32))
        z = self.vae.encode(px.to(self.device)).float()
        return self.transformer.pack_latents(z).contiguous(), (z.shape[-2] // 2, z.shape[-1] // 2)

    def _encode_kontext_image(self, image, height: int, width: int, b: int):
        """Reference image → clean packed latent tokens at the target size
        (cv2 Lanczos), broadcast to the batch."""
        import cv2

        resized = cv2.resize(_frame(image), (width, height), interpolation=cv2.INTER_LANCZOS4)
        tokens, grid = self._encode_packed(resized.astype(np.float32) / 127.5 - 1.0)
        return tokens.expand(b, *tokens.shape[1:]), grid

    def _load_vae_and_transformer(self) -> None:
        if self.vae is None:
            self.load_component_by_type("vae")
        if self.transformer is None:
            self.load_component_by_type("transformer")

    def _snapped_size(self, height: int, width: int) -> Tuple[int, int]:
        """The size snapped to the packing grid (2 latent pixels)."""
        self._load_vae_and_transformer()
        s = self.vae.cfg.spatial_scale
        return height - height % (s * 2), width - width % (s * 2)


def _frame(x) -> np.ndarray:
    """An image input as an HWC array: a path is decoded (``load_frames``), an
    array is taken as it is."""
    if isinstance(x, (str, bytes)) or hasattr(x, "__fspath__"):
        from apex_studio_tpu_torch.preprocess.base import load_frames

        return load_frames(x)[0]
    return np.asarray(x)


@register_engine("flux", "kontext")
class FluxKontextEngine(FluxT2IEngine):
    """Flux Kontext image editing: the reference image's clean VAE latents
    join the image stream at RoPE t-index 1; only the noisy target tokens are
    denoised and returned."""

    def run(self, image=None, **kwargs):
        if image is None:
            raise ValueError("kontext requires an input image")
        kwargs.pop("_kontext_image", None)
        return super().run(_kontext_image=image, **kwargs)


@register_engine("flux", "fill")
class FluxFillEngine(FluxT2IEngine):
    """Flux Fill inpainting: the model's 384 input channels are [noise (64) ‖
    VAE(masked image) (64) ‖ 8×8 pixel-mask bits per latent cell, packed 2×2
    (256)]."""

    @torch.inference_mode()
    def run(self, image=None, mask_image=None, height: int = 1024, width: int = 1024, **kwargs):
        if image is None or mask_image is None:
            raise ValueError("fill requires both image and mask_image")
        import cv2

        height, width = self._snapped_size(height, width)
        img = cv2.resize(_frame(image), (width, height), interpolation=cv2.INTER_LANCZOS4)
        mask = _frame(mask_image)
        if mask.ndim == 3:
            mask = mask[..., 0]
        mask = cv2.resize(mask, (width, height), interpolation=cv2.INTER_NEAREST)
        mask01 = (mask > 127).astype(np.float32)

        masked = (img.astype(np.float32) / 127.5 - 1.0) * (1.0 - mask01)[..., None]
        masked_tokens, _ = self._encode_packed(masked)
        # pixel mask → 8×8 bits per latent cell → packed 2×2 (256 a token)
        s = self.vae.cfg.spatial_scale
        lat_h, lat_w = height // s, width // s
        m = mask01.reshape(lat_h, s, lat_w, s).transpose(1, 3, 0, 2).reshape(1, s * s, lat_h, lat_w)
        mask_tokens = self.transformer.pack_latents(torch.from_numpy(np.ascontiguousarray(m)).to(self.device))
        kwargs.pop("_fill_cond", None)
        return super().run(height=height, width=width,
                           _fill_cond=torch.cat([masked_tokens, mask_tokens], dim=-1), **kwargs)


@register_engine("flux", "control")
class FluxControlEngine(FluxT2IEngine):
    """Flux Control (Canny / Depth): the model's 128 input channels are
    [noise (64) ‖ VAE(control image) (64)], the control map riding the same
    per-token feature concat as Fill, without a mask."""

    @torch.inference_mode()
    def run(self, control_image=None, height: int = 1024, width: int = 1024, **kwargs):
        if control_image is None:
            raise ValueError("control requires a control_image")
        height, width = self._snapped_size(height, width)
        tokens, _ = self._encode_kontext_image(control_image, height, width, 1)
        kwargs.pop("_fill_cond", None)
        return super().run(height=height, width=width, _fill_cond=tokens, **kwargs)


# Flux Kontext's preferred (height, width) buckets
PREFERRED_KONTEXT_RESOLUTIONS = [
    (672, 1568), (688, 1504), (720, 1456), (752, 1392), (800, 1328),
    (832, 1248), (880, 1184), (944, 1104), (1024, 1024), (1104, 944),
    (1184, 880), (1248, 832), (1328, 800), (1392, 752), (1456, 720),
    (1504, 688), (1568, 672),
]


@register_engine("flux", "dreamomni2")
class FluxDreamOmni2Engine(FluxT2IEngine):
    """DreamOmni2 multi-reference generation and editing on the Kontext
    backbone: every reference image is VAE-encoded at its preferred-aspect
    bucket and appended as clean tokens with RoPE frame id k+1 and
    accumulated width offsets. The prompt is taken as it is: no prompt
    rewriter runs, as in the JAX engine."""

    @torch.inference_mode()
    def run(self, prompt=None, image_list=None, image=None, task: str = "generation",
            resize_to_preferred_resolution: bool = True, **kwargs):
        import cv2

        images = image_list if image_list is not None else image
        if images is None:
            raise ValueError("dreamomni2 requires at least one reference image")
        if not isinstance(images, (list, tuple)):
            images = [images]
        self._load_vae_and_transformer()

        all_tokens, grids = [], []
        for im in images:
            arr = np.asarray(self.load_image_input(im))
            h0, w0 = arr.shape[:2]
            if resize_to_preferred_resolution:
                ar = w0 / max(h0, 1)
                _, w1, h1 = min((abs(ar - w / h), w, h) for h, w in PREFERRED_KONTEXT_RESOLUTIONS)
            else:
                w1, h1 = w0, h0
            w1, h1 = max(16, w1 - w1 % 16), max(16, h1 - h1 % 16)
            resized = cv2.resize(arr, (w1, h1), interpolation=cv2.INTER_LANCZOS4)
            tokens, grid = self._encode_packed(resized.astype(np.float32) / 127.5 - 1.0)
            all_tokens.append(tokens)
            grids.append(grid)
        kwargs.pop("_kontext_image", None)
        return super().run(prompt=prompt, _kontext_tokens=(torch.cat(all_tokens, dim=1), tuple(grids)),
                           **kwargs)
