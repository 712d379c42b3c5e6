"""SkyReels V2 engines, t2v / i2v / df (port of ``apex_studio_tpu/engine/skyreels.py``).

As the reference's ``engine/skyreels/{t2v,i2v,df}.py``:

- the DiT is Wan's with ``inject_sample_info``: an fps row (0 for 16 fps, 1
  otherwise, t2v.py:367) whose 6·dim projection joins every block's
  modulation; t2v and i2v are Wan's engines with that row threaded into the
  forward (``SkyReelsFPSMixin``)
- **df** (diffusion forcing) generates a long video in one latent tensor: a
  timestep matrix staggers the frames ``ar_step`` rows apart (df.py:13,
  ``generate_timestep_matrix``, host numpy), each row runs the DiT over its
  valid window of ``base_num_frames`` latent frames with per-frame timesteps,
  and only the frames whose level changed are updated (df.py:202); an image
  prefix becomes a fully denoised frame 0 (``num_pre_ready``) that is never
  updated
- each row's update is one per-frame Euler flow-match step on the card, in
  f32: ``x − dt·v`` with each frame's ``dt = σ(k) − σ(k + 1)`` read from its
  step index (``sig_of_idx``), CFG ``v_neg + g·(v − v_neg)`` in f32, the
  update mask keeping the frames that are done
- the prompts are encoded before the DiT loads and the encoder is released
  after, as the port's Wan engines do
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.engine.wan import WanI2VEngine, WanShared, WanT2VEngine, _pixels, _resized
from apex_studio_tpu_torch.engine.fused import cfg_combine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

logger = logging.getLogger("apex.engine.skyreels")


def fps_to_index(fps: int) -> int:
    return 0 if int(fps) == 16 else 1


def generate_timestep_matrix(
    num_frames: int,
    step_template: np.ndarray,
    base_num_frames: int,
    ar_step: int = 5,
    num_pre_ready: int = 0,
    causal_block_size: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[Tuple[int, int]]]:
    """The diffusion-forcing schedule (df.py:13). Returns (step_matrix [R, F],
    step_index [R, F], update_mask [R, F], the valid interval of each row)."""
    num_iterations = len(step_template) + 1
    nfb = num_frames // causal_block_size
    base_nfb = base_num_frames // causal_block_size
    if base_nfb < nfb:
        min_ar_step = len(step_template) / base_nfb
        if ar_step < min_ar_step:
            raise ValueError(f"ar_step must be ≥ {math.ceil(min_ar_step)}")
    template = np.concatenate([[999.0], np.asarray(step_template, np.float64), [0.0]])
    pre_row = np.zeros(nfb, np.int64)
    if num_pre_ready > 0:
        pre_row[: num_pre_ready // causal_block_size] = num_iterations

    step_matrix, step_index, update_mask, valid_interval = [], [], [], []
    while not np.all(pre_row >= (num_iterations - 1)):
        new_row = np.zeros(nfb, np.int64)
        for i in range(nfb):
            if i == 0 or pre_row[i - 1] >= (num_iterations - 1):
                new_row[i] = pre_row[i] + 1
            else:
                new_row[i] = new_row[i - 1] - ar_step
        new_row = np.clip(new_row, 0, num_iterations)
        update_mask.append((new_row != pre_row) & (new_row != num_iterations))
        step_index.append(new_row.copy())
        step_matrix.append(template[new_row])
        pre_row = new_row

    terminal = base_nfb
    for mask in update_mask:
        if terminal < nfb and mask[terminal]:
            terminal += 1
        valid_interval.append((max(terminal - base_nfb, 0), terminal))

    def expand(rows):
        m = np.stack(rows)
        if causal_block_size > 1:
            m = np.repeat(m[:, :, None], causal_block_size, axis=2).reshape(len(rows), -1)
        return m

    vi = [(s * causal_block_size, e * causal_block_size) for s, e in valid_interval]
    return expand(step_matrix), expand(step_index), expand(update_mask), vi


class _WithFps:
    """A DiT called as the Wan engines call theirs, with the request's fps
    row added to every forward."""

    def __init__(self, transformer, fps_index: torch.Tensor):
        self.transformer, self.fps_index, self.dtype = transformer, fps_index, transformer.dtype

    def __call__(self, x, t, context, context_image=None):
        return self.transformer(x, t, context, context_image=context_image, fps_index=self.fps_index)


class SkyReelsFPSMixin(WanShared):
    """Threads the fps row into the Wan engines' forwards (their ``_apply``)."""

    _fps_index: Optional[torch.Tensor] = None

    def _set_fps(self, fps: int) -> None:
        self._fps_index = torch.tensor([fps_to_index(fps)], dtype=torch.long, device=self.device)

    def _apply(self, x, transformer, *cond):
        if getattr(transformer.cfg, "inject_sample_info", False):
            transformer = _WithFps(transformer, self._fps_index)
        return WanShared._apply(x, transformer, *cond)


@register_engine("skyreels", "t2v")
class SkyReelsT2VEngine(SkyReelsFPSMixin, WanT2VEngine):
    def run(self, *args: Any, fps: int = 24, **kwargs: Any):
        self._set_fps(fps)
        return super().run(*args, fps=fps, **kwargs)


@register_engine("skyreels", "i2v")
class SkyReelsI2VEngine(SkyReelsFPSMixin, WanI2VEngine):
    def run(self, *args: Any, fps: int = 24, **kwargs: Any):
        self._set_fps(fps)
        return super().run(*args, fps=fps, **kwargs)


@register_engine("skyreels", "df")
class SkyReelsDFEngine(SkyReelsFPSMixin, WanShared):
    """Diffusion-forcing long-video generation."""

    @torch.inference_mode()
    def run(
        self,
        prompt: Optional[str] = None,
        negative_prompt: Optional[str] = None,
        image: Optional[Any] = None,
        height: int = 480,
        width: int = 832,
        duration: Optional[float] = None,
        base_duration: Optional[float] = None,
        fps: int = 24,
        num_frames: Optional[int] = None,
        base_num_frames: Optional[int] = None,
        num_inference_steps: int = 30,
        guidance_scale: float = 5.0,
        ar_step: int = 5,
        causal_block_size: int = 1,
        overlap_history: Optional[int] = None,
        seed: Optional[int] = None,
        shift: Optional[float] = None,
        return_latents: bool = False,
        render_on_step: bool = False,
        render_on_step_callback: Optional[Callable] = None,
        render_on_step_interval: int = 5,
        progress_callback: Optional[Callable] = None,
        **_: Any,
    ):
        import cv2

        safe_emit_progress(progress_callback, 0.0, "Starting diffusion-forcing pipeline")
        if self.text_encoder is None:
            self.load_component_by_type("text_encoder")
        context = self.encode_prompt(prompt or "")
        use_cfg = guidance_scale > 1.0
        neg_context = self.encode_prompt(negative_prompt or "") if use_cfg else None
        self.maybe_release_text_encoders()
        safe_emit_progress(progress_callback, 0.2, "Prompts ready")
        self.load_components(return_latents=False)
        self._set_fps(fps)

        vae_cfg = self.vae.cfg
        s_scale, t_scale = vae_cfg.spatial_scale, vae_cfg.temporal_scale
        _, ph, pw = self.transformer.cfg.patch_size
        height -= height % (s_scale * ph)
        width -= width % (s_scale * pw)
        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1
        num_frames = max(1, num_frames - (num_frames - 1) % t_scale)
        if base_num_frames is None:
            base_num_frames = int(round(base_duration * fps)) + 1 if base_duration else num_frames

        lat_t = (num_frames - 1) // t_scale + 1
        base_lat_t = min(lat_t, (base_num_frames - 1) // t_scale + 1)
        x = self.get_latents((1, self.transformer.cfg.in_channels, lat_t, height // s_scale, width // s_scale),
                             seed=seed)

        # an input image becomes a fully denoised frame 0
        num_pre_ready = 0
        if image is not None:
            image = self.load_image_input(image)
            z0 = self.encode_video_latents(_pixels(_resized([image], width, height, cv2.INTER_LANCZOS4)))
            x[:, :, : z0.shape[2]] = z0.float()
            num_pre_ready = z0.shape[2]

        ts, _ = self.get_timesteps(self.scheduler, num_inference_steps,
                                   **({"shift": shift} if shift is not None else {}))
        sigmas = np.asarray(self.scheduler.sigmas, np.float64)  # n + 1, ending at 0
        step_matrix, step_index, update_mask, valid_interval = generate_timestep_matrix(
            lat_t, np.asarray(ts, np.float64), base_lat_t, ar_step=ar_step, num_pre_ready=num_pre_ready,
            causal_block_size=causal_block_size)
        safe_emit_progress(progress_callback, 0.3, "Timestep matrix ready")

        # a frame at template index k integrates sigma[k] → sigma[k + 1]
        sig_of_idx = np.concatenate([[1.0], sigmas])  # index 0: the t = 999 row head
        hi = len(sig_of_idx) - 1
        transformer = _WithFps(self.transformer, self._fps_index)
        denoise_cb = make_mapped_progress(progress_callback, 0.3, 0.9)
        n_rows = len(step_matrix)
        for i in range(n_rows):
            s0, s1 = valid_interval[i]
            t_pf = torch.as_tensor(step_matrix[i][None, s0:s1], dtype=torch.float32, device=self.device)
            x_win = x[:, :, s0:s1]
            x_in = x_win.to(transformer.dtype)
            v = transformer(x_in, t_pf, context).float()
            if use_cfg:
                v = cfg_combine(v, transformer(x_in, t_pf, neg_context), guidance_scale)
            idx = step_index[i][s0:s1]
            dt = sig_of_idx[np.clip(idx, 0, hi)] - sig_of_idx[np.clip(idx + 1, 0, hi)]
            dt = torch.as_tensor(dt[None, None, :, None, None], dtype=torch.float32, device=self.device)
            upd = torch.as_tensor(update_mask[i][None, None, s0:s1, None, None], device=self.device)
            x[:, :, s0:s1] = torch.where(upd, x_win.float() - dt * v, x_win)

            if denoise_cb is not None:
                denoise_cb(min((i + 1) / n_rows, 1.0), f"DF row {i + 1}/{n_rows}")
            if (render_on_step and render_on_step_callback is not None
                    and (i + 1) % render_on_step_interval == 0 and i + 1 < n_rows):
                try:
                    render_on_step_callback(self.preview_frames(x, self.decode_latents), i)
                except Exception:
                    logger.exception("preview callback failed")

        safe_emit_progress(progress_callback, 0.9, "Denoising complete")
        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return x
        frames = self.decode_latents(x)
        safe_emit_progress(progress_callback, 1.0, "Completed diffusion-forcing pipeline")
        return frames
