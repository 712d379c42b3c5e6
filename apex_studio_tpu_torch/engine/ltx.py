"""LTX-Video any-to-video engine (t2v, i2v, extension), port of
``apex_studio_tpu/engine/ltx.py``.

- T5-XXL conditioning at 128 tokens; without a negative prompt the
  negative embeddings are zeros (and so is their mask)
- token-sequence latents in (f, h, w) token order with per-token pixel
  coordinates, time scaled by 1/fps
- conditioning items (an ``image`` or ``conditions`` at frame 0; another
  frame raises, as in JAX): VAE-encoded latents lerped into the initial
  noise by their strength; per-token timesteps min(t, 1 − strength); a
  token integrates only once the global t drops below its level; the hard
  conditioned tokens get fresh noise every step (``image_cond_noise_scale``)
- ``initial_latents`` blended with the noise at the first timestep;
  ``skip_initial/final_inference_steps`` cut the grid
- guidance: CFG over [neg | pos] in one forward (optionally the CFG-zero*
  rescale), STG through the skip-block stream with std-ratio rescaling
- the rectified-flow sampler with its SD3 / LinearQuadratic shifting
- decode: denormalise, the decode-timestep noise blend, the tone map, and
  the decoder's noise injection from the JAX key 0
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils import jax_random
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.ltx")


def patchify_tokens(lat: torch.Tensor) -> torch.Tensor:
    """[B, C, F, H, W] → [B, F·H·W, C] (f, h, w token order)."""
    b, c, f, h, w = lat.shape
    return lat.permute(0, 2, 3, 4, 1).reshape(b, f * h * w, c)


def unpatchify_tokens(tok: torch.Tensor, f: int, h: int, w: int) -> torch.Tensor:
    b, s, c = tok.shape
    return tok.reshape(b, f, h, w, c).permute(0, 4, 1, 2, 3)


def latent_coords(f: int, h: int, w: int) -> np.ndarray:
    """[3, S] token-corner latent coordinates in (f, h, w) token order."""
    ft, hy, wx = np.meshgrid(np.arange(f), np.arange(h), np.arange(w), indexing="ij")
    return np.stack([ft.reshape(-1), hy.reshape(-1), wx.reshape(-1)], axis=0)


def tone_map_latents(latents: torch.Tensor, compression: float) -> torch.Tensor:
    if compression <= 0:
        return latents
    scale_factor = compression * 0.75
    sig = torch.sigmoid(4.0 * scale_factor * (latents.abs() - 1.0))
    return latents * (1.0 - 0.8 * scale_factor * sig)


@register_engine("ltx", "x2v")
class LTXX2VEngine(BaseEngine):
    def _encode_prompt(self, prompt: str, max_length: int = 128):
        hidden, mask = self.text_encoder.encode([prompt], max_sequence_length=max_length, use_chat_template=False)
        return hidden.float(), mask

    @torch.inference_mode()
    def run(self, prompt: Optional[str] = None, negative_prompt: Optional[str] = None,
            conditions: Optional[List[Dict[str, Any]]] = None, image: Optional[Any] = None,
            initial_latents: Optional[np.ndarray] = None, height: int = 480, width: int = 832,
            duration: Optional[float] = None, num_frames: Optional[int] = None, fps: int = 30,
            num_inference_steps: int = 30, skip_initial_inference_steps: int = 0,
            skip_final_inference_steps: int = 0, seed: Optional[int] = None, guidance_scale: float = 3.0,
            stg_scale: float = 0.0, rescaling_scale: float = 1.0, skip_block_list: Optional[List[int]] = None,
            cfg_star_rescale: bool = False, image_cond_noise_scale: float = 0.15,
            timesteps: Optional[List[float]] = None, decode_timestep: float = 0.0,
            decode_noise_scale: Optional[float] = None, tone_map_compression_ratio: float = 0.0,
            return_latents: bool = False, render_on_step: bool = False,
            render_on_step_callback: Optional[Callable] = None, render_on_step_interval: int = 5,
            progress_callback: Optional[Callable] = None, offload: bool = True, **_: Any):
        safe_emit_progress(progress_callback, 0.0, "Starting LTX any-to-video pipeline")
        self.load_missing("text_encoder", "vae", "transformer", "scheduler")
        safe_emit_progress(progress_callback, 0.05, "Components ready")
        dev = self.device

        vae_cfg = self.vae.cfg
        s_scale, t_scale = vae_cfg.spatial_scale, vae_cfg.temporal_scale
        height -= height % s_scale
        width -= width % s_scale
        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1
        num_frames = max(1, num_frames - (num_frames - 1) % t_scale)

        # the negative defaults to ZERO embeddings
        ctx_pos, mask_pos = self._encode_prompt(prompt or "")
        if negative_prompt:
            ctx_neg, mask_neg = self._encode_prompt(negative_prompt)
        else:
            ctx_neg, mask_neg = torch.zeros_like(ctx_pos), torch.zeros_like(mask_pos)
        safe_emit_progress(progress_callback, 0.15, "Prompts ready")

        cfg_t = self.transformer.cfg
        lat_f = (num_frames - 1) // t_scale + 1
        lat_h, lat_w = height // s_scale, width // s_scale
        shape = (1, cfg_t.in_channels, lat_f, lat_h, lat_w)
        noise = self.get_latents(shape, seed=seed)

        # the scheduler's resolution shift over the 5-D latent shape
        self.scheduler.set_timesteps(num_inference_steps, samples_shape=shape, timesteps=timesteps)
        ts = np.asarray(self.scheduler.timesteps, np.float64)
        if skip_initial_inference_steps or skip_final_inference_steps:
            ts = ts[skip_initial_inference_steps: len(ts) - skip_final_inference_steps]
            self.scheduler.timesteps = ts.astype(np.float32)
            self.scheduler.sigmas = np.concatenate([ts, [0.0]])

        # initial latents: pure noise, or noise blended onto an input clip's latents
        if initial_latents is not None:
            lat0 = torch.as_tensor(np.asarray(initial_latents), dtype=torch.float32).to(dev)
            lats = float(ts[0]) * noise + (1.0 - float(ts[0])) * lat0
        else:
            lats = noise
        safe_emit_progress(progress_callback, 0.25, "Initialized latent noise")

        # conditioning items → latents replaced in place + a strength mask
        conds = list(conditions or [])
        if image is not None:
            conds.insert(0, {"image": image, "frame_number": 0, "strength": 1.0})
        cond_mask_grid = None
        if conds:
            cond_mask_grid = torch.zeros((1, lat_f, lat_h, lat_w), dtype=torch.float32, device=dev)
            lats = lats.clone()
            for item in conds:
                if int(item.get("frame_number", 0)) != 0:
                    raise NotImplementedError("non-first-frame conditioning lands with the ltx2 engine")
                strength = float(item.get("strength", item.get("conditioning_strength", 1.0)))
                media = torch.from_numpy(self._load_condition_media(item, height, width)).to(dev)
                z = self.vae.encode(media).float()  # [1, C, fl, h, w]
                fl = z.shape[2]
                lats[:, :, :fl] = (1 - strength) * lats[:, :, :fl] + strength * z
                cond_mask_grid[:, :fl] = strength
        init_lats = lats

        tokens = patchify_tokens(lats)
        n_tok = tokens.shape[1]
        pix = latent_coords(lat_f, lat_h, lat_w).astype(np.float64) * np.array([t_scale, s_scale, s_scale],
                                                                                 np.float64)[:, None]
        if cfg_t.causal_temporal_positioning:
            pix[0] = np.clip(pix[0] + 1 - t_scale, 0, None)
        pix[0] = pix[0] / fps
        coords = torch.from_numpy(pix[None].astype(np.float32)).to(dev)  # [1, 3, S]
        cond_mask = patchify_tokens(cond_mask_grid[:, None])[..., 0] if cond_mask_grid is not None else None

        do_cfg = guidance_scale > 1.0
        do_stg = stg_scale > 0 and skip_block_list
        skips = tuple(int(i) for i in (skip_block_list or []))
        if do_cfg:
            ctx_b, mask_b = torch.cat([ctx_neg, ctx_pos]), torch.cat([mask_neg, mask_pos])
        else:
            ctx_b, mask_b = ctx_pos, mask_pos
        nb = ctx_b.shape[0]
        coords_b = coords.expand(nb, -1, -1)

        tf = self.transformer
        model_dtype = tf.dtype
        ctx_b_m, ctx_pos_m = ctx_b.to(model_dtype), ctx_pos.to(model_dtype)
        denoise_cb = make_mapped_progress(progress_callback, 0.3, 0.9)
        rng = np.random.default_rng(seed if seed is not None else 0)
        for i, t in enumerate(ts):
            t_f = float(t)
            # fresh noise on the hard-conditioned tokens
            if cond_mask is not None and image_cond_noise_scale > 0:
                fresh = torch.from_numpy(rng.standard_normal(tuple(init_lats.shape), np.float32)).to(dev)
                noised_init = init_lats + image_cond_noise_scale * (t_f ** 2) * fresh
                grid = unpatchify_tokens(tokens, lat_f, lat_h, lat_w)
                hard = (cond_mask_grid > 1.0 - 1e-6)[:, None]
                tokens = patchify_tokens(torch.where(hard, noised_init, grid))

            # per-token timesteps: conditioned tokens hold at 1 − strength
            if cond_mask is not None:
                t_tok = torch.minimum(torch.full_like(cond_mask, t_f), 1.0 - cond_mask)
            else:
                t_tok = torch.full((1, 1), t_f, dtype=torch.float32, device=dev)

            tok_m = tokens.to(model_dtype)
            out = tf(tok_m.expand(nb, -1, -1), ctx_b_m, t_tok.expand(nb, -1), encoder_attention_mask=mask_b,
                     video_coords=coords_b).float()
            if do_cfg:
                v_neg, v_pos = out[:1], out[1:2]
                if cfg_star_rescale:
                    v_neg = ((v_pos * v_neg).sum() / (v_neg.square().sum() + 1e-8)) * v_neg
                v = v_neg + guidance_scale * (v_pos - v_neg)
            else:
                v = v_pos = out[:1]
            if do_stg:
                v_ptb = tf(tok_m, ctx_pos_m, t_tok, encoder_attention_mask=mask_pos, video_coords=coords,
                           skip_blocks=skips).float()
                v = v + stg_scale * (v_pos - v_ptb)
                if rescaling_scale != 1.0:
                    factor = v_pos.std(unbiased=False) / v.std(unbiased=False).clamp_min(1e-8)
                    v = v * (rescaling_scale * factor + (1 - rescaling_scale))

            new_tokens = self.scheduler.step_tokens(
                v, t_tok if cond_mask is not None else torch.full((1, n_tok), t_f, device=dev), tokens)
            if cond_mask is not None:
                tokens = torch.where((t_f - 1e-6 < (1.0 - cond_mask))[..., None], new_tokens, tokens)
            else:
                tokens = new_tokens

            if (render_on_step and render_on_step_callback is not None and (i + 1) % render_on_step_interval == 0
                    and i + 1 < len(ts)):
                try:
                    render_on_step_callback(self.decode_latents(
                        unpatchify_tokens(tokens, lat_f, lat_h, lat_w), decode_timestep, decode_noise_scale,
                        tone_map_compression_ratio, seed), i)
                except Exception:
                    logger.exception("preview callback failed")
            if denoise_cb is not None:
                denoise_cb(min((i + 1) / len(ts), 1.0), f"Denoising step {i + 1}/{len(ts)}")

        safe_emit_progress(progress_callback, 0.9, "Denoising complete")
        lats = unpatchify_tokens(tokens, lat_f, lat_h, lat_w)
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return lats
        frames = self.decode_latents(lats, decode_timestep, decode_noise_scale, tone_map_compression_ratio, seed)
        safe_emit_progress(progress_callback, 1.0, "Completed LTX pipeline")
        return frames

    def _load_condition_media(self, item: Dict[str, Any], height: int, width: int) -> np.ndarray:
        """→ [1, 3, T, H, W] float32 in [−1, 1], Lanczos-resized. Takes HWC
        uint8 arrays, file paths or [T, H, W, 3] clips."""
        import cv2

        media = item.get("image") if item.get("image") is not None else item.get("video")
        img = (np.asarray(media) if (not isinstance(media, str) and np.asarray(media).ndim == 4)
               else self.load_image_input(media))
        frames = img[None] if img.ndim == 3 else img  # [T, H, W, 3]
        out = np.stack([cv2.resize(f, (width, height), interpolation=cv2.INTER_LANCZOS4) for f in frames])
        return np.transpose(out.astype(np.float32) / 127.5 - 1.0, (3, 0, 1, 2))[None]

    @torch.inference_mode()
    def decode_latents(self, lats: torch.Tensor, decode_timestep: float = 0.0,
                       decode_noise_scale: Optional[float] = None, tone_map_compression_ratio: float = 0.0,
                       seed: Optional[int] = None) -> List[np.ndarray]:
        z = lats.float()
        timestep = None
        if getattr(self.vae.cfg, "timestep_conditioning", False):
            dns = decode_timestep if decode_noise_scale is None else decode_noise_scale
            fresh = np.random.default_rng(seed if seed is not None else 0).standard_normal(tuple(z.shape))
            z = (1.0 - dns) * z + dns * torch.from_numpy(fresh).float().to(z.device)
            timestep = torch.full((z.shape[0],), float(decode_timestep), dtype=torch.float32, device=z.device)
        z = tone_map_latents(z, tone_map_compression_ratio)
        video = self.vae.decode(z, timestep=timestep, noise_key=jax_random.key(0))
        b, c, t, h, w = video.shape
        return self.tensor_to_frames(video.transpose(1, 2).reshape(b * t, c, h, w))
