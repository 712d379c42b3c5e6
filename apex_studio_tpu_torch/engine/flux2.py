"""FLUX.2 engines (port of ``apex_studio_tpu/engine/flux2.py``): ti2i, klein
and t2i on one engine, and control. Mistral- (or Qwen3-) conditioned and
guidance-distilled:

- the prompt in Mistral's ``[SYSTEM_PROMPT]…[INST]`` template (Qwen3's chat
  template with thinking off for a Qwen3 encoder), padded to the sequence
  length; the encoder's hidden states at ``stack_layers`` concatenated
  (15360 wide for Mistral-Small 3.2). Not disk-cached, as in JAX;
- the empirical-mu shift of the flow-match Euler schedule;
- 32-channel VAE latents packed 2×2 into 128-channel tokens, normalized by
  the VAE's BatchNorm running statistics;
- reference images ride the image stream as extra packed tokens at RoPE
  time offsets 10, 20, …; only the noise tokens are denoised and decoded;
- the guidance scale enters through the DiT's guidance embedding, no CFG;
- one Euler step a denoise step (``engine/fused.py``).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine
from apex_studio_tpu_torch.engine.fused import build_euler_step
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.flux2")

SYSTEM_MESSAGE = (
    "You are an AI that processes image generation requests. Follow the user's "
    "instruction precisely and describe the target image faithfully."
)


def compute_empirical_mu(image_seq_len: int, num_steps: int) -> float:
    """FLUX.2's resolution- and step-dependent shift."""
    a1, b1 = 8.73809524e-05, 1.89833333
    a2, b2 = 0.00016927, 0.45666666
    if image_seq_len > 4300:
        return float(a2 * image_seq_len + b2)
    m_200 = a2 * image_seq_len + b2
    m_10 = a1 * image_seq_len + b1
    a = (m_200 - m_10) / 190.0
    b = m_200 - 200.0 * a
    return float(a * num_steps + b)


def _pixels(arr: np.ndarray) -> torch.Tensor:
    """HWC uint8 → [1, 3, H, W] f32 in [-1, 1]."""
    return torch.from_numpy(np.ascontiguousarray((arr.astype(np.float32) / 127.5 - 1.0).transpose(2, 0, 1)[None]))


@register_engine("flux2", "ti2i", "klein", "t2i")
class Flux2TI2IEngine(BaseEngine):
    def load_components(self) -> None:
        for ctype in ("text_encoder", "transformer", "vae", "scheduler"):
            if getattr(self, ctype) is None:
                self.load_component_by_type(ctype)

    @torch.inference_mode()
    def encode_prompt(self, prompt: str, max_sequence_length: int = 512) -> torch.Tensor:
        """Templated prompt → the encoder's stacked hidden states [1, L, n·hidden]."""
        te = self.text_encoder
        model = te._ensure_model()
        if "Qwen3" in te.base:
            # apply_chat_template(add_generation_prompt=True, enable_thinking=False) of one user turn
            text = (f"<|im_start|>user\n{prompt or ''}<|im_end|>\n"
                    "<|im_start|>assistant\n<think>\n\n</think>\n\n")
        else:
            text = f"[SYSTEM_PROMPT]{SYSTEM_MESSAGE}[/SYSTEM_PROMPT][INST]{prompt or ''}[/INST]"
        ids, mask = te.tokenize([text], max_sequence_length)
        return model(torch.from_numpy(ids).long().to(self.device),
                     attention_mask=torch.from_numpy(mask).to(self.device))

    def _encode_packed(self, pixels: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        """[1, 3, H, W] pixels → packed latent tokens, BN-normalized if asked."""
        z = self.vae.encode(pixels.to(self.device)).float()
        packed = self.transformer.pack_latents(z).contiguous()
        return self.vae.normalize_packed(packed) if normalize else packed

    def _encode_reference_images(self, images: Sequence[Any], max_side: int = 1024):
        """Each reference image (cv2 Lanczos to at most ``max_side``, sides in
        multiples of 16) → packed, BN-normalized tokens and its token grid."""
        import cv2

        tokens, grids = [], []
        s = self.vae.cfg.spatial_scale
        for im in images:
            arr = self.load_image_input(im)
            h0, w0 = arr.shape[:2]
            scale = min(1.0, max_side / max(h0, w0))
            h = max(32, int(h0 * scale) // 16 * 16)
            w = max(32, int(w0 * scale) // 16 * 16)
            resized = cv2.resize(arr, (w, h), interpolation=cv2.INTER_LANCZOS4)
            tokens.append(self._encode_packed(_pixels(resized)))
            grids.append((h // s // 2, w // s // 2))
        return torch.cat(tokens, dim=1), tuple(grids)

    def _geometry(self, height: int, width: int):
        """The size snapped to the packing grid, latent channels and size, token grid."""
        cfg_t = self.transformer.cfg
        s = self.vae.cfg.spatial_scale
        height -= height % (s * 2)
        width -= width % (s * 2)
        lat_h, lat_w = height // s, width // s
        return height, width, (cfg_t.out_channels or cfg_t.in_channels) // 4, lat_h, lat_w, (lat_h // 2, lat_w // 2)

    def _denoise(self, x, ts, forward, progress_callback, preview=None):
        """The Euler loop: one step per timestep, ``forward(x_in, t_vec)`` the
        DiT's velocity; ``preview(x, i)`` after each step."""
        step = build_euler_step(lambda x, t_vec: forward(x.to(self.transformer.dtype), t_vec))
        denoise_cb = make_mapped_progress(progress_callback, 0.4, 0.9)
        for i, t in enumerate(ts):
            t_vec = torch.full((1,), float(t) / 1000.0, dtype=torch.float32, device=self.device)
            x = step(x, float(self.scheduler.sigmas[i]), float(self.scheduler.sigmas[i + 1]), t_vec)
            if preview is not None:
                preview(x, i)
            if denoise_cb is not None:
                denoise_cb(min((i + 1) / len(ts), 1.0), f"Denoising step {i + 1}/{len(ts)}")
        return x

    def _schedule(self, n_tokens: int, num_inference_steps: int, sigmas, timesteps):
        if sigmas is None:
            sigmas = np.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps)
        mu = compute_empirical_mu(n_tokens, num_inference_steps)
        return self.get_timesteps(self.scheduler, num_inference_steps, timesteps=timesteps, sigmas=sigmas, mu=mu)

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        images: Optional[List[Any]] = None,
        image=None,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 50,
        guidance_scale: float = 4.0,
        seed: Optional[int] = None,
        latents: Optional[np.ndarray] = None,
        sigmas: Optional[np.ndarray] = None,
        timesteps: Optional[List[float]] = None,
        max_sequence_length: int = 512,
        return_latents: bool = False,
        render_on_step: bool = False,
        render_on_step_callback: Optional[Callable] = None,
        render_on_step_interval: int = 5,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        safe_emit_progress(progress_callback, 0.0, "Starting pipeline")
        self.load_components()
        safe_emit_progress(progress_callback, 0.05, "Components ready")
        tf = self.transformer
        height, width, lat_c, lat_h, lat_w, grid = self._geometry(height, width)

        seq = self.encode_prompt(prompt or "", max_sequence_length)
        safe_emit_progress(progress_callback, 0.2, "Prompt encoded")

        refs = images if images is not None else ([image] if image is not None else [])
        cond_tokens, cond_grids = (None, ())
        if refs:
            cond_tokens, cond_grids = self._encode_reference_images(list(refs))
        safe_emit_progress(progress_callback, 0.3, "Reference images encoded")

        noise = self.get_latents((1, lat_c, lat_h, lat_w), seed=seed, latents=latents)
        x = tf.pack_latents(noise.float()).contiguous()
        ts, num_inference_steps = self._schedule(x.shape[1], num_inference_steps, sigmas, timesteps)
        safe_emit_progress(progress_callback, 0.4, "Timesteps computed")

        g_vec = torch.full((1,), guidance_scale, dtype=torch.float32, device=self.device)
        rope = tf.rope_tables(seq.shape[1], grid, cond_grids, device=self.device)
        preview = None
        if render_on_step and render_on_step_callback is not None and len(ts) > 8:
            def preview(x, i):
                if (i + 1) % render_on_step_interval == 0 and i + 1 < len(ts):
                    try:
                        render_on_step_callback(self._decode_frames(x, lat_h, lat_w), i)
                    except Exception:
                        logger.exception("preview callback failed")

        x = self._denoise(x, ts,
                          lambda x_in, t_vec: tf(x_in, seq, t_vec, guidance=g_vec, grid_hw=grid,
                                                 cond_tokens=cond_tokens, rope=rope),
                          progress_callback, preview)
        safe_emit_progress(progress_callback, 0.9, "Denoising complete")
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self._decode_frames(x, lat_h, lat_w)
        safe_emit_progress(progress_callback, 1.0, "Completed pipeline")
        return frames

    def _decode_frames(self, tokens: torch.Tensor, lat_h: int, lat_w: int) -> List[np.ndarray]:
        """Denormalize in packed space, then unpack and decode."""
        z = self.transformer.unpack_latents(self.vae.denormalize_packed(tokens.float()), lat_h, lat_w)
        return self.tensor_to_frames(self.vae.decode(z))


@register_engine("flux2", "control")
class Flux2ControlEngine(Flux2TI2IEngine):
    """FLUX.2 VACE-style control and inpainting: the packed context is
    [control latents ‖ inverted mask (4 packed channels) ‖ masked inpaint
    latents]; the control chain's hints are added into the main double
    stream at ``control_layers``."""

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        control_image: Optional[Any] = None,
        inpaint_image: Optional[Any] = None,
        mask_image: Optional[Any] = None,
        control_context_scale: float = 1.0,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 50,
        guidance_scale: float = 4.0,
        seed: Optional[int] = None,
        sigmas: Optional[np.ndarray] = None,
        timesteps: Optional[List[float]] = None,
        max_sequence_length: int = 512,
        return_latents: bool = False,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        import cv2

        safe_emit_progress(progress_callback, 0.0, "Starting flux2 control")
        self.load_components()
        tf = self.transformer
        height, width, lat_c, lat_h, lat_w, grid = self._geometry(height, width)
        seq = self.encode_prompt(prompt or "", max_sequence_length)

        def pixels(im):
            return _pixels(cv2.resize(self.load_image_input(im), (width, height), interpolation=cv2.INTER_LANCZOS4))

        # mask: 1 = the region to edit; the inpaint latents see (1 - mask)
        if mask_image is not None:
            m_arr = self.load_image_input(mask_image)
            if m_arr.ndim == 3:
                m_arr = m_arr[..., 0]
            m_arr = cv2.resize(m_arr, (width, height), interpolation=cv2.INTER_NEAREST)
            mask = (m_arr.astype(np.float32) / 255.0 >= 0.5).astype(np.float32)
        else:
            mask = np.ones((height, width), np.float32)
        if inpaint_image is not None:
            init_px = pixels(inpaint_image) * torch.from_numpy(mask[None, None] < 0.5)
        else:
            init_px = torch.zeros(1, 3, height, width)
        inpaint_tokens = self._encode_packed(init_px, normalize=inpaint_image is not None)
        control_tokens = (self._encode_packed(pixels(control_image)) if control_image is not None
                          else torch.zeros_like(inpaint_tokens))
        inv_mask = cv2.resize(1.0 - mask, (lat_w, lat_h), interpolation=cv2.INTER_NEAREST)
        mask_tokens = tf.pack_latents(torch.from_numpy(np.ascontiguousarray(inv_mask))[None, None].to(self.device))
        control_context = torch.cat([control_tokens, mask_tokens, inpaint_tokens], dim=-1)
        safe_emit_progress(progress_callback, 0.3, "Control context ready")

        noise = self.get_latents((1, lat_c, lat_h, lat_w), seed=seed)
        x = tf.pack_latents(noise.float()).contiguous()
        ts, num_inference_steps = self._schedule(x.shape[1], num_inference_steps, sigmas, timesteps)
        g_vec = torch.full((1,), guidance_scale, dtype=torch.float32, device=self.device)
        rope = tf.rope_tables(seq.shape[1], grid, device=self.device)
        x = self._denoise(x, ts,
                          lambda x_in, t_vec: tf(x_in, seq, t_vec, guidance=g_vec, grid_hw=grid,
                                                 control_context=control_context,
                                                 control_context_scale=control_context_scale, rope=rope),
                          progress_callback)
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self._decode_frames(x, lat_h, lat_w)
        safe_emit_progress(progress_callback, 1.0, "Flux2 control complete")
        return frames
