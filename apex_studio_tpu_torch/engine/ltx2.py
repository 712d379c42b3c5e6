"""LTX-2 audio-video engines, port of ``apex_studio_tpu/engine/ltx2.py``.

- ``ti2v``: text → video and audio latents denoised together by the
  dual-stream DiT; an ``image`` replaces the first latent frame by its VAE
  latents blended at ``image_strength`` and holds those tokens at their level
  through per-token timesteps; the stage-2 entry takes ``latents`` (and
  ``audio_latents``) renoised by ``noise_scale``.
- the prompt: with the ``connectors`` helper, all 49 Gemma-3 hidden states are
  packed (``pack_text_embeds``) and refined per stream, and the mask becomes
  all ones (the registers fill the padding); without it both streams read the
  encoder's hidden states. Without a negative prompt the negative context is
  zeros with an all-zero mask, so its text cross-attention rows are fully
  masked and average V (as in JAX).
- guidance (the MultiModalGuider): CFG over [neg | pos] in one forward, STG
  through a pass with the blocks' self-attention skipped, isolated-modality
  guidance through a pass without the AV cross-attention, and the std-ratio
  rescale (population std, ``jnp.std``'s ddof 0).
- Euler steps over the rectified-flow schedule in token space.
- ``upsample``: the ``latent_upsampler`` helper lifts the latents and the run
  repeats at the lifted size over the distilled stage-2 sigmas without guidance.
- decode: the video VAE; ``decode_audio`` turns the audio latents into a
  waveform through the audio VAE and the vocoder, and the run returns
  ``(frames, waveform, sample_rate)`` when the manifest has both.
- ``ic_lora`` / ``keyframe_interpolation``: conditioning images (and, for
  IC-LoRA, a conditioning video) are VAE-encoded and appended as tokens whose
  time coordinate is shifted by ``pixel_frame_index / fps``, noised from the
  host stream ``default_rng(seed + 17)`` by 1 − strength and re-imposed clean
  every step; only the base tokens are decoded.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from apex_studio_tpu_torch.engine.base import BaseEngine, _registry
from apex_studio_tpu_torch.engine.ltx import patchify_tokens, unpatchify_tokens
from apex_studio_tpu_torch.engine.registry import register_engine
from apex_studio_tpu_torch.utils.progress import make_mapped_progress, safe_emit_progress

# the distilled stage-2 sigmas that follow the latent upsampler
STAGE2_SIGMAS = [0.909375, 0.725, 0.421875]


def _std(x: torch.Tensor) -> torch.Tensor:
    return x.std(unbiased=False)


@register_engine("ltx2", "ti2v")
class LTX2TI2VEngine(BaseEngine):
    def _helper(self, name: str, spec, family: str, kind: str = "helper"):
        if name not in self.helpers:
            self.helpers[name] = self._instantiate_family(_registry(kind), spec, family)
        return self.helpers[name]

    def _get_connectors(self):
        """The ``ltx2.connectors`` helper, or None when the manifest has none."""
        spec = self.component_specs.get("connectors")
        return None if spec is None else self._helper("connectors", spec, "ltx2_connectors")

    def _encode_prompt(self, prompt: str, max_length: Optional[int] = None):
        """→ (ctx_video, ctx_audio, mask) on the engine's device, contexts in f32."""
        conn = self._get_connectors()
        if conn is None:
            hidden, mask = self.text_encoder.encode([prompt], max_sequence_length=max_length or 256,
                                                    use_chat_template=False)
            return hidden.float(), hidden.float(), mask

        from apex_studio_tpu_torch.models.ltx2_connectors import pack_text_embeds

        length = max_length or 1024  # a multiple of the 128 registers
        hidden_all, mask = self.text_encoder.encode([prompt], max_sequence_length=length, use_chat_template=False,
                                                    output="hidden_states_all")
        packed = pack_text_embeds(hidden_all, mask)
        with torch.inference_mode():
            ctx_v, ctx_a = conn(packed.to(conn.text_proj_in.dtype), mask.bool())
        return ctx_v.float(), ctx_a.float(), torch.ones_like(mask)

    def _negative(self, negative_prompt, ctx_pos, ctxa_pos, mask_pos):
        if negative_prompt:
            return self._encode_prompt(negative_prompt)
        return torch.zeros_like(ctx_pos), torch.zeros_like(ctxa_pos), torch.zeros_like(mask_pos)

    def _geometry(self, height, width, duration, num_frames, fps):
        s_scale = self.vae.spatial_compression_ratio
        t_scale = self.vae.temporal_compression_ratio
        height -= height % s_scale
        width -= width % s_scale
        if num_frames is None:
            num_frames = int(round((duration or 5.0) * fps)) + 1
        num_frames = max(1, num_frames - (num_frames - 1) % t_scale)
        return height, width, num_frames, s_scale, t_scale

    def _audio_frames(self, num_frames: int, fps: float) -> int:
        """Audio latent frames spanning the clip."""
        cfg = self.transformer.cfg
        per_second = cfg.audio_sampling_rate / cfg.audio_hop_length / cfg.audio_scale_factor
        return max(1, int(math.ceil(num_frames / fps * per_second)))

    def _media(self, image, width: int, height: int) -> np.ndarray:
        """An image input resized (INTER_AREA) to [3, H, W] f32 in [−1, 1]."""
        import cv2

        arr = cv2.resize(self.load_image_input(image), (width, height), interpolation=cv2.INTER_AREA)
        return (arr.astype(np.float32) / 127.5 - 1.0).transpose(2, 0, 1)

    @torch.inference_mode()
    def run(self, prompt: Optional[str] = None, negative_prompt: Optional[str] = None, image: Optional[Any] = None,
            height: int = 512, width: int = 768, duration: Optional[float] = None, num_frames: Optional[int] = None,
            fps: float = 25.0, num_inference_steps: int = 40, guidance_scale: float = 4.0, stg_scale: float = 0.0,
            stg_blocks: Optional[List[int]] = None, modality_scale: float = 1.0, guidance_rescale: float = 0.0,
            seed: Optional[int] = None, timesteps: Optional[List[float]] = None, image_strength: float = 1.0,
            latents: Optional[Any] = None, audio_latents: Optional[Any] = None, noise_scale: float = 1.0,
            upsample: bool = False, return_latents: bool = False, return_audio_latents: bool = False,
            progress_callback: Optional[Callable] = None, offload: bool = True, **_: Any):
        safe_emit_progress(progress_callback, 0.0, "Starting LTX-2 ti2v pipeline")
        self.load_missing("text_encoder", "vae", "transformer", "scheduler")
        safe_emit_progress(progress_callback, 0.05, "Components ready")
        dev = self.device

        height, width, num_frames, s_scale, t_scale = self._geometry(height, width, duration, num_frames, fps)
        lat_f = (num_frames - 1) // t_scale + 1
        lat_h, lat_w = height // s_scale, width // s_scale
        if latents is not None:  # the stage-2 entry: the given grid sets the geometry
            lat_f, lat_h, lat_w = latents.shape[2:]
            num_frames = (lat_f - 1) * t_scale + 1
        cfg_t = self.transformer.cfg
        audio_f = self._audio_frames(num_frames, fps)

        ctx_pos, ctxa_pos, mask_pos = self._encode_prompt(prompt or "")
        ctx_neg, ctxa_neg, mask_neg = self._negative(negative_prompt, ctx_pos, ctxa_pos, mask_pos)
        safe_emit_progress(progress_callback, 0.15, "Prompts ready")

        shape = (1, cfg_t.in_channels, lat_f, lat_h, lat_w)
        lats = self.get_latents(shape, seed=seed)
        a_lats = self.get_latents((1, cfg_t.audio_in_channels, audio_f), seed=None if seed is None else seed + 1)
        if latents is not None:
            # renoise the stage-1 grid to the first stage-2 sigma
            ns = float(noise_scale)
            lats = lats * ns + torch.as_tensor(latents, dtype=torch.float32).to(dev) * (1.0 - ns)
            if audio_latents is not None:
                al = torch.as_tensor(audio_latents, dtype=torch.float32).to(dev)
                a_lats = a_lats[:, :, :al.shape[2]] * ns + al * (1.0 - ns)
        a_tokens = a_lats.transpose(1, 2)  # [1, Sa, C]

        self.scheduler.set_timesteps(num_inference_steps, samples_shape=shape, timesteps=timesteps)
        ts = np.asarray(self.scheduler.timesteps, np.float64)

        # image conditioning: the first latent frame replaced, its tokens held at their level
        cond_mask = None
        if image is not None:
            media = torch.from_numpy(self._media(image, width, height)).to(dev)
            z = self.vae.encode(media[None, :, None]).float()  # [1, C, 1, h, w]
            s = float(image_strength)
            lats = lats.clone()
            lats[:, :, :1] = (1 - s) * lats[:, :, :1] + s * z
            grid = torch.zeros((1, 1, lat_f, lat_h, lat_w), dtype=torch.float32, device=dev)
            grid[:, :, :1] = s
            cond_mask = patchify_tokens(grid)[..., 0]
        init_tokens = patchify_tokens(lats)
        safe_emit_progress(progress_callback, 0.25, "Latents initialized")

        tokens = init_tokens
        n_tok = tokens.shape[1]
        do_cfg = guidance_scale > 1.0
        nb = 2 if do_cfg else 1
        ctx_b = torch.cat([ctx_neg, ctx_pos]) if do_cfg else ctx_pos
        ctxa_b = torch.cat([ctxa_neg, ctxa_pos]) if do_cfg else ctxa_pos
        mask_b = torch.cat([mask_neg, mask_pos]) if do_cfg else mask_pos

        tf = self.transformer
        dt_m = tf.dtype
        ctx_b_m, ctxa_b_m = ctx_b.to(dt_m), ctxa_b.to(dt_m)
        ctx_pos_m, ctxa_pos_m = ctx_pos.to(dt_m), ctxa_pos.to(dt_m)
        vshape = (lat_f, lat_h, lat_w)
        denoise_cb = make_mapped_progress(progress_callback, 0.3, 0.9)

        for i, t in enumerate(ts):
            t_f = float(t)
            if cond_mask is not None:
                t_tok = torch.minimum(torch.full_like(cond_mask, t_f), 1.0 - cond_mask)
            else:
                t_tok = torch.full((1, n_tok), t_f, dtype=torch.float32, device=dev)
            t_tok_b = t_tok.expand(nb, -1)
            t_a_b = torch.full((nb,), t_f, dtype=torch.float32, device=dev)
            tok_m, atok_m = tokens.to(dt_m), a_tokens.to(dt_m)
            v_out, a_out = tf(tok_m.expand(nb, -1, -1), atok_m.expand(nb, -1, -1), t_tok_b, ctx_b_m,
                              video_shape=vshape, fps=float(fps), t_audio=t_a_b, ctx_audio=ctxa_b_m, ctx_mask=mask_b)
            v_cond, a_cond = (v_out[1:2], a_out[1:2]) if do_cfg else (v_out, a_out)
            v, a = v_cond, a_cond
            if do_cfg:
                v = v + (guidance_scale - 1.0) * (v_cond - v_out[:1])
                a = a + (guidance_scale - 1.0) * (a_cond - a_out[:1])
            single = (tok_m, atok_m, t_tok, t_a_b[:1], ctx_pos_m, ctxa_pos_m, mask_pos, vshape, float(fps))
            if stg_scale != 0.0:
                skips = tuple(stg_blocks) if stg_blocks is not None else tuple(range(len(tf.blocks)))
                v_ptb, a_ptb = self._guidance_pass(*single, skip_blocks=skips)
                v = v + stg_scale * (v_cond - v_ptb)
                a = a + stg_scale * (a_cond - a_ptb)
            if modality_scale != 1.0:
                v_mod, a_mod = self._guidance_pass(*single, skip_av_cross=True)
                v = v + (modality_scale - 1.0) * (v_cond - v_mod)
                a = a + (modality_scale - 1.0) * (a_cond - a_mod)
            if guidance_rescale != 0.0:
                # one std ratio over the whole tensor
                v = v * (guidance_rescale * (_std(v_cond) / (_std(v) + 1e-12)) + (1.0 - guidance_rescale))
                a = a * (guidance_rescale * (_std(a_cond) / (_std(a) + 1e-12)) + (1.0 - guidance_rescale))
            step = float((ts[i + 1] if i + 1 < len(ts) else 0.0) - t_f)
            tokens = tokens + step * v.float()
            a_tokens = a_tokens + step * a.float()
            if cond_mask is not None:  # the hard-conditioned tokens stay clean
                tokens = torch.where((cond_mask > 1.0 - 1e-6)[..., None], init_tokens, tokens)
            safe_emit_progress(denoise_cb, (i + 1) / len(ts), f"denoise step {i + 1}/{len(ts)}")

        lats = unpatchify_tokens(tokens, lat_f, lat_h, lat_w)
        audio_lats = a_tokens.transpose(1, 2)

        if upsample:
            up = self._get_upsampler()
            if up is None:
                safe_emit_progress(progress_callback, 0.9, "No latent_upsampler in manifest — skipping stage 2")
            else:
                safe_emit_progress(progress_callback, 0.9, "Upsampling latents (stage-2 prep)")
                lats = self._upsample_latents(lats, up)
                # stage 2: the lifted latents over the distilled sigmas, guidance off
                return self.run(prompt=prompt, negative_prompt=None, height=lats.shape[3] * s_scale,
                                width=lats.shape[4] * s_scale, num_frames=num_frames, fps=fps,
                                num_inference_steps=len(STAGE2_SIGMAS), timesteps=STAGE2_SIGMAS,
                                guidance_scale=1.0, stg_scale=0.0, modality_scale=1.0, guidance_rescale=0.0,
                                seed=seed, latents=lats, audio_latents=audio_lats, noise_scale=STAGE2_SIGMAS[0],
                                upsample=False, return_latents=return_latents,
                                return_audio_latents=return_audio_latents, progress_callback=progress_callback,
                                offload=offload)

        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return (lats, audio_lats) if return_audio_latents else lats
        frames = self.decode_frames(lats)
        if return_audio_latents:
            safe_emit_progress(progress_callback, 1.0, "Completed LTX-2 pipeline")
            return frames, audio_lats
        audio = self.decode_audio(audio_lats)
        safe_emit_progress(progress_callback, 1.0, "Completed LTX-2 pipeline")
        return frames if audio is None else (frames, *audio)

    def decode_frames(self, lats: torch.Tensor) -> List[np.ndarray]:
        video = self.vae.decode(lats.float())
        b, c, t, h, w = video.shape
        return self.tensor_to_frames(video.transpose(1, 2).reshape(b * t, c, h, w))

    def _get_upsampler(self):
        """The ``latent_upsampler`` (or ``upsampler``) helper, or None."""
        spec = self.component_specs.get("latent_upsampler") or self.component_specs.get("upsampler")
        return None if spec is None else self._helper("latent_upsampler", spec, "ltx2_upsampler")

    def _upsample_latents(self, lats: torch.Tensor, up) -> torch.Tensor:
        from apex_studio_tpu_torch.models.ltx2_upsampler import upsample_latents

        return upsample_latents(lats.float(), self.vae, up)

    def _guidance_pass(self, tok, atok, t_tok, t_a, ctx, ctxa, cmask, vshape, fps_, skip_blocks: tuple = (),
                       skip_av_cross: bool = False):
        """One extra forward: STG (self-attention skipped in ``skip_blocks``)
        or the isolated-modality pass (AV cross-attention skipped)."""
        return self.transformer(tok, atok, t_tok, ctx, video_shape=vshape, fps=fps_, t_audio=t_a, ctx_audio=ctxa,
                                ctx_mask=cmask, skip_video_self_attn_blocks=skip_blocks or None,
                                skip_audio_self_attn_blocks=skip_blocks or None, skip_av_cross_attn=skip_av_cross)

    @torch.inference_mode()
    def decode_audio(self, audio_lats: torch.Tensor):
        """Audio latents [B, z·M', Sa] → (waveform [C, N] numpy, sample_rate),
        or None when the manifest has no audio VAE or vocoder."""
        spec, voc_spec = self.component_specs.get("audio_vae"), self.component_specs.get("vocoder")
        if spec is None or voc_spec is None:
            return None
        audio_vae = self._helper("audio_vae", spec, "ltx2_audio_vae", kind="vae")
        vocoder = self._helper("vocoder", voc_spec, "ltx2_vocoder")
        acfg = audio_vae.cfg
        z = audio_vae.unpatchify(audio_lats.transpose(1, 2), acfg.latent_channels,
                                 acfg.mel_bins // acfg.temporal_compression_ratio)
        wav = vocoder(audio_vae.decode(z.float()))
        return wav[0].float().cpu().numpy(), int(vocoder.cfg.output_sampling_rate)


class LTX2KeyframeVideoBase(LTX2TI2VEngine):
    """Keyframe-token-append conditioning: each conditioning image or video
    is VAE-encoded, appended as tokens with time-shifted coordinates and held
    (1 − strength) clean by a per-token denoise mask; only the base tokens
    are decoded."""

    allow_conditioning_video = True

    @torch.inference_mode()
    def run(self, image: Optional[Any] = None, image_strengths: Optional[Any] = None,
            image_pixel_frame_indices: Optional[Any] = None, conditioning_video: Optional[Any] = None,
            conditioning_video_strength: float = 1.0, conditioning_video_pixel_frame_index: int = 0,
            prompt: Optional[str] = None, negative_prompt: Optional[str] = None, height: int = 512, width: int = 768,
            duration: Optional[float] = None, num_frames: Optional[int] = None, fps: float = 25.0,
            num_inference_steps: int = 40, guidance_scale: float = 3.0, seed: Optional[int] = None,
            timesteps: Optional[List[float]] = None, upsample: bool = False, return_latents: bool = False,
            progress_callback: Optional[Callable] = None, **_: Any):
        import cv2

        safe_emit_progress(progress_callback, 0.0, "Starting LTX-2 keyframe pipeline")
        self.load_missing("text_encoder", "vae", "transformer", "scheduler")
        dev = self.device
        height, width, num_frames, s_scale, t_scale = self._geometry(height, width, duration, num_frames, fps)
        lat_f = (num_frames - 1) // t_scale + 1
        lat_h, lat_w = height // s_scale, width // s_scale
        cfg_t = self.transformer.cfg
        audio_f = self._audio_frames(num_frames, fps)

        ctx_pos, ctxa_pos, mask_pos = self._encode_prompt(prompt or "")
        ctx_neg, ctxa_neg, mask_neg = self._negative(negative_prompt, ctx_pos, ctxa_pos, mask_pos)

        # the base tokens: pure noise
        tokens = patchify_tokens(self.get_latents((1, cfg_t.in_channels, lat_f, lat_h, lat_w), seed=seed))
        base_tok = tokens.shape[1]
        clean = tokens
        dmask = torch.ones((1, base_tok), dtype=torch.float32, device=dev)
        coords = self.transformer.video_coords(lat_f, lat_h, lat_w, fps, batch=1)

        conds: List[Any] = []
        if image is not None:
            images = image if isinstance(image, (list, tuple)) else [image]
            strengths = (image_strengths if isinstance(image_strengths, (list, tuple))
                         else [image_strengths if image_strengths is not None else 1.0] * len(images))
            idxs = (image_pixel_frame_indices if isinstance(image_pixel_frame_indices, (list, tuple))
                    else [image_pixel_frame_indices or 0] * len(images))
            for im, s, ix in zip(images, strengths, idxs):
                conds.append((self._media(im, width, height)[None, :, None], float(s if s is not None else 1.0),
                              int(ix or 0)))
        if conditioning_video is not None and self.allow_conditioning_video:
            from apex_studio_tpu_torch.preprocess.base import load_frames

            frames_in = (load_frames(conditioning_video) if isinstance(conditioning_video, str)
                         else list(conditioning_video))
            nf = max(1, len(frames_in) - (len(frames_in) - 1) % t_scale)
            vid = np.stack([cv2.resize(np.asarray(f), (width, height), interpolation=cv2.INTER_AREA)
                            for f in frames_in[:nf]])
            px = (vid.astype(np.float32) / 127.5 - 1.0).transpose(3, 0, 1, 2)[None]
            conds.append((px, float(conditioning_video_strength), int(conditioning_video_pixel_frame_index)))

        rng = np.random.default_rng(0 if seed is None else seed + 17)
        for px, strength, pixel_idx in conds:
            z = self.encode_video_latents(px)  # [1, C, Tc, h, w], disk-cached
            ctoks = patchify_tokens(z.float())
            ccoords = np.array(self.transformer.video_coords(z.shape[2], lat_h, lat_w, fps, batch=1))
            ccoords[:, 0] += float(pixel_idx) / float(fps)  # shifted to the keyframe's time
            d = float(np.clip(1.0 - strength, 0.0, 1.0))
            cnoise = torch.from_numpy(rng.standard_normal(tuple(ctoks.shape)).astype(np.float32)).to(dev)
            tokens = torch.cat([tokens, cnoise * d + ctoks * (1.0 - d)], dim=1)
            clean = torch.cat([clean, ctoks], dim=1)
            dmask = torch.cat([dmask, torch.full((1, ctoks.shape[1]), d, dtype=torch.float32, device=dev)], dim=1)
            coords = np.concatenate([np.asarray(coords), ccoords], axis=2)

        a_tokens = self.get_latents((1, cfg_t.audio_in_channels, audio_f),
                                    seed=None if seed is None else seed + 1).transpose(1, 2)
        self.scheduler.set_timesteps(num_inference_steps, samples_shape=(1, cfg_t.in_channels, lat_f, lat_h, lat_w),
                                     timesteps=timesteps)
        ts = np.asarray(self.scheduler.timesteps, np.float64)

        do_cfg = guidance_scale > 1.0
        nb = 2 if do_cfg else 1
        ctx_b = torch.cat([ctx_neg, ctx_pos]) if do_cfg else ctx_pos
        ctxa_b = torch.cat([ctxa_neg, ctxa_pos]) if do_cfg else ctxa_pos
        mask_b = torch.cat([mask_neg, mask_pos]) if do_cfg else mask_pos
        # the JAX engine hands these coordinates over as an f32 device array, so
        # their RoPE takes the f32 path; so does the port
        coords_b = torch.from_numpy(np.ascontiguousarray(coords, dtype=np.float32)).to(dev).expand(nb, -1, -1)

        tf = self.transformer
        dt_m = tf.dtype
        ctx_b_m, ctxa_b_m = ctx_b.to(dt_m), ctxa_b.to(dt_m)
        vshape = (lat_f, lat_h, lat_w)
        denoise_cb = make_mapped_progress(progress_callback, 0.3, 0.9)
        m = dmask[..., None]
        for i, t in enumerate(ts):
            t_f = float(t)
            # per-token timesteps: masked tokens (denoise mask 0) stay clean
            t_tok = (t_f * dmask).expand(nb, -1)
            t_a_b = torch.full((nb,), t_f, dtype=torch.float32, device=dev)
            v_out, a_out = tf(tokens.to(dt_m).expand(nb, -1, -1), a_tokens.to(dt_m).expand(nb, -1, -1), t_tok,
                              ctx_b_m, video_shape=vshape, fps=float(fps), t_audio=t_a_b, ctx_audio=ctxa_b_m,
                              ctx_mask=mask_b, video_coords=coords_b)
            if do_cfg:
                v = v_out[:1] + guidance_scale * (v_out[1:2] - v_out[:1])
                a = a_out[:1] + guidance_scale * (a_out[1:2] - a_out[:1])
            else:
                v, a = v_out, a_out
            step = float((ts[i + 1] if i + 1 < len(ts) else 0.0) - t_f)
            tokens = tokens + step * v.float()
            a_tokens = a_tokens + step * a.float()
            tokens = tokens * m + clean * (1.0 - m)  # the conditioning re-imposed every step
            safe_emit_progress(denoise_cb, (i + 1) / len(ts), f"denoise step {i + 1}/{len(ts)}")

        lats = unpatchify_tokens(tokens[:, :base_tok], lat_f, lat_h, lat_w)
        if upsample:
            # the appended conditioning tokens are already stripped: the upsampler sees the base grid
            up = self._get_upsampler()
            if up is not None:
                safe_emit_progress(progress_callback, 0.9, "Upsampling latents (stage-2 prep)")
                lats = self._upsample_latents(lats, up)
                return LTX2TI2VEngine.run(self, prompt=prompt, height=lats.shape[3] * s_scale,
                                          width=lats.shape[4] * s_scale, num_frames=num_frames, fps=fps,
                                          num_inference_steps=len(STAGE2_SIGMAS), timesteps=STAGE2_SIGMAS,
                                          guidance_scale=1.0, seed=seed, latents=lats,
                                          audio_latents=a_tokens.transpose(1, 2), noise_scale=STAGE2_SIGMAS[0],
                                          upsample=False, return_latents=return_latents,
                                          progress_callback=progress_callback)
            safe_emit_progress(progress_callback, 0.9, "No latent_upsampler in manifest — skipping stage 2")

        if return_latents:
            safe_emit_progress(progress_callback, 1.0, "Returning latents")
            return lats
        frames = self.decode_frames(lats)
        safe_emit_progress(progress_callback, 1.0, "Completed keyframe pipeline")
        return frames


@register_engine("ltx2", "ic_lora")
class LTX2ICLoraEngine(LTX2KeyframeVideoBase):
    """IC-LoRA: keyframe images and an optional control video as appended keyframe tokens."""


@register_engine("ltx2", "keyframe_interpolation")
class LTX2KeyframeInterpolationEngine(LTX2KeyframeVideoBase):
    """Keyframe interpolation: image keyframes only."""

    allow_conditioning_video = False


@register_engine("ltx2", "multimodal_guidance")
class LTX2MultimodalGuidanceEngine(LTX2TI2VEngine):
    """ti2v with the MultiModalGuider's branches as defaults: CFG, STG and
    isolated-modality guidance."""

    def run(self, *, stg_scale: float = 1.0, modality_scale: float = 1.0, guidance_rescale: float = 0.0,
            **kwargs: Any):
        return super().run(stg_scale=stg_scale, modality_scale=modality_scale, guidance_rescale=guidance_rescale,
                           **kwargs)
