#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (apex_studio_tpu_torch) on one NVIDIA card.

Phases, each printed as one JSON line:
  card       the card's name and power limit, the kernels' build time, and
             what ptxas said of each kernel (registers, spills, warnings)
  kernels    every hand-written kernel against its plain PyTorch version on
             the card, case by case, with the tolerance stated; then what
             three deliberately faulty versions read against that tolerance
  timing     each kernel at the main path's shape: its time (CUDA events,
             warm, median), the plain version's, one PyTorch library call's
             as a yardstick, and the least time the card could take (bound);
             each also as the time per call of 20 queued calls
  reference  a tiny Flux DiT on the card (bf16, kernels) against the same
             weights on the CPU (f32, plain versions)
  residency  the int8 / int4 resident Linear: the int8 product exact against
             a float64 product at Flux's shapes (1 to 4608 rows), W8A8 and
             int4 on the card against the same module on the CPU, the LoRA
             merges into quantized weights against numpy, and one timing line
             per Flux Linear shape (bf16, W8A8 split into its three passes,
             int4) beside its bounds
  checkpoint a Flux DiT at full width (2 + 2 blocks) written in the BFL
             single-file naming and the full Flux VAE in diffusers naming,
             loaded back through the engine's checkpoint branch: strict, every
             parameter bit-equal, forwards equal; then int8 residency applied
             to the loaded DiT and W8A8 held against the dequant path
  main       Flux Dev text-to-image at 1024x1024 through UniversalEngine with
             synthetic int8-resident weights (W8A8) and a rank-16 LoRA on the
             19 double blocks' q/k/v merged into them at load: three requests
             of 2 steps each, the kernels' launch counts read around each
  trace      (only when asked for) one more int8 request under torch.profiler:
             device time by kernel class, by W8A8 pass, and the idle share
  bf16       one request of 2 steps with synthetic bf16 weights
  int4       one request of 2 steps with the DiT packed int4 (encoders int8)
  hyv15      HunyuanVideo 1.5 i2v at 720x1280 from its manifest, full width,
             the requests' DiT at 6 of its 54 blocks (16 launches a CFG
             step), synthetic int8 weights: the kernel at the path's shapes
             (113,457 and 34,257 tokens on query-row subsets, the refiner's 1000
             with a bias) timed beside its bound and the library call; two
             identical 33-frame requests (tiled decode, frames and latents
             equal), one TAE preview, one decode tile against float64, one
             121-frame request, 1 step each, timed; the
             DiT's resident Linears timed by shape, and the step split into
             attention, W8A8 Linears and the rest; then one 33-frame request
             through the t2v manifest's own engine
  zimage     ZImage Turbo t2i at 1024x1024 from its manifest, full width and
             depth, synthetic int8 weights: a 2 + 2-block DiT at full width on
             the card (bf16) against the CPU (f32); three requests of the
             manifest's 9 steps, guidance 0 (34 launches a step, requests 1
             and 3 identical); the resident Linears at ZImage's shapes; one
             bf16 request, one CFG request from zimage.yml (68 launches a
             step) and one control request (51), each of 2 steps
  qwenimage  QwenImage Edit 2509 at 1024x1024 from its manifest, full width,
             the DiT int4-resident (the requests' at 15 of its 60 blocks since
             PR 21): a 2-block DiT and ControlNet at full width on the card
             (bf16) against the CPU (f32); the bench leg's edit request ("make
             the sky purple", 2 of its 8 steps, true CFG off) three times (15
             launches a step, requests 1 and 3 identical, the repeated prompt
             a disk-cache hit); one Wan VAE decode against float64; the
             resident Linears at QwenImage's shapes and the int4 step split;
             edit_plus with two condition images, t2i with true CFG (30 a
             step), the ControlNet at scales 1 and 0 (20 a step) and one bf16
             edit, each of 2 steps
  wan        Wan 2.2 A14B from its three manifests, full width, the requests'
             experts at 3 of their 40 blocks, both 14B experts int4-resident
             (UMT5-XXL int8): a 2-block DiT at
             full width on the card (bf16) against the CPU (f32); the fused
             UniPC step against the host step over 30 steps; the bench leg's
             t2v request at one 480x832 frame three times (3 of its 30 steps, CFG 4,
             one expert: 40 launches a step, requests 1 and 3 identical, the
             repeated prompt a disk-cache hit); t2v at 81 frames (2 steps at
             shift 3, the expert switch at boundary 0.875) with one decode tile
             against float64; the resident Linears at Wan's shapes and the int4
             step split; the t2i manifest's 1024x1024 request (3 steps, both
             experts, the step split the boundary implies); i2v at 81 frames
             (2 steps, the 36-channel DiT, the VAE encode at T = 81); one bf16 t2i
             request (2 steps, no Linear quantized); the point mask and its
             tracking on eight 480x832 frames
  wan_edit   the Wan editing engines from their manifests at 480x832, full
             width, the requests' DiTs cut to 3 of their 40 blocks (a VACE
             hint at 0), the 14B DiTs int4-resident (UMT5-XXL int8, CLIP
             ViT-H bf16), with the published configs the manifests lack
             written into the run's home: 2-block VACE, Fun and causal DiTs
             at full width and the CLIP vision tower on the card against the
             CPU; VACE (Wan 2.1 14B) at 81 frames with a point-masked control
             video and one reference image (34,320 tokens, 1 CFG step, 96
             launches a step), seeds 0, 0, 1 (1 and 2 identical, the
             reference frame dropped before the decode); Wan 2.1 i2v with
             the CLIP branch at 81 frames (120 launches a step); fflf, inp and
             v2v on the A14B experts at 33 frames (3 steps, the switch at
             0.875), fun_vace, phantom (two subject references) and
             fun_control at 33 frames (1 step); SVI as two 33-frame segments
             (1 step each)
  wan_causal the Self-Forcing manifest (1.3B causal DiT bf16, 4 of its 30
             blocks) at its defaults: 81 frames as 7 blocks of 3 latent
             frames, 4 steps and a commit each (30 launches a forward, each
             block against the whole
             32,760-row cache with a [1, Sk] bias); seeds 0, 0, 1, then a
             local window with a sink and an image pre-fill; the cache read
             before every block holds exactly the committed blocks
  server     the port's engine server (create_app on the card, 127.0.0.1, an
             ephemeral port) over HTTP and WS: ZImage Turbo requests at the
             manifest's defaults (1024², 9 steps, int8) through /engine/run,
             read to complete with 2 previews and fetched over /files (1 and
             3 identical and equal to the zimage phase's frame, 3 served by
             the pooled engine, 306 launches each), one cancelled at its
             first step message, then /mask/create, RIFE through
             /postprocessor/frame-interpolate, /system/* and the CLI
             (start / status / stop) in a subprocess
  flux_edit  Flux 1's editing engines from their manifests at 1024x1024, full
             width and depth, synthetic int8 weights, 2 steps each (57
             launches a step): Kontext with a seeded reference image (8704
             tokens), seeds 0, 0, 1 (1 and 2 identical, 3 not); Fill with an
             image and a mask (the 384-channel DiT, its config written where
             the manifest names it); Control with a control image (128
             channels); DreamOmni2 with two square references (12,800 tokens)
             from a manifest derived from Kontext's
  flux2      FLUX.2 Dev from its manifests at 1024x1024 and its published
             widths, the 32B DiT int4 and Mistral-Small 3.2 int8 (their text
             and VAE configs written where the manifests name them): a 1 + 1
             block DiT and a 2-layer Mistral at full width on the card (bf16)
             against the CPU (f32); t2i of 2 steps, (A, 0), (B, 1), (A, 0) (56
             launches a step, 1 and 3 identical); a VAE decode against
             float64; edit with one reference image (8704 tokens); the
             resident Linears at FLUX.2's shapes and the int4 step split;
             Turbo at 4 of its 8 steps with a rank-16 LoRA written at the manifest's
             source; the control DiT (60 launches a step) with a control
             image, an inpaint image and a mask
  hyv        HunyuanVideo (the original) from its t2v and i2v manifests at
             720x1280 and the family defaults' widths (20 + 40 blocks, 24
             heads of 128, llava-llama-3-8B, CLIP-L), synthetic int8 weights:
             the kernel at the path's shapes (the joint attention over 32,656
             and 75,856 tokens and the refiner's 256, each with the text key
             bias); a 1 + 1-block DiT, plain and token_replace, against f32
             and a VAE decode against float64; t2v at 33 frames twice (one
             seed, frames bit-identical), at 81 frames (the decode in tiles),
             i2v token_replace at 33 frames (the I2V config written; the first
             latent frame pinned); 1 step each, the requests' DiT 1 + 3 of
             its 20 + 40 blocks (6 launches a forward); the W8A8 Linears at
             the 81-frame shapes and the step split
  humo       HuMo 17B from its manifest at the WanHuMoConfig widths (the
             requests' DiT cut to 3 of its 40 blocks), the DiT int4 and
             UMT5-XXL int8, a 13-layer wav2vec2 of base widths (configs
             written), a seeded 16 kHz WAV: the kernel at the path's
             shapes (self over 39,000 and 14,040 tokens, text cross over 512,
             the per-frame audio cross-attention of 25 and 9 frames against 16
             audio tokens); a 2-block DiT against f32; TIA at the manifest's
             defaults (97 frames, one reference image, a negative prompt: 3
             forwards a step, the negative branch switching at step_change),
             then TA at 33 frames twice (bit-identical); 2 steps (TA 1), 3
             launches a block
  s2v        Wan 2.2 S2V from its manifest at the published widths (its
             transformer and wav2vec2-large configs written; the DiT int4,
             UMT5-XXL int8), a seeded 10 s WAV: the kernel at the path's shapes
             (self over 35,074 tokens, text cross, the audio injector over 5
             keys, wav2vec2-large's f32 attention over 499 frames); the
             2-block DiT against f32; one 480x832 request of two 80-frame
             chunks with a pose video and CFG (the second chunk's motion
             buffer re-encoded from the first's frames), then two identical
             32-frame requests seeded with the image; 1 step, the requests'
             DiT 2 of its 40 blocks (5 launches a forward: the injector of
             the kept blocks) and the encoder's 24 a request
  multitalk  Wan 2.1 MultiTalk from its manifest (the Wan2.1-I2V-14B-480P,
             CLIP ViT-H and chinese-wav2vec2-base configs written; DiT int4,
             CLIP bf16): the kernel at the path's shapes (self over 32,760,
             text and CLIP cross, the L-RoPE audio cross over two speakers'
             64 tokens, the encoder's f32 attention); the 2-block DiT with two
             speakers against f32; 81 frames with two speakers and a negative
             prompt (3 forwards a step), then two identical one-speaker
             33-frame requests; 1 step, the requests' DiT 2 of its 40 blocks
             (8 launches a forward)
  avatar     HunyuanVideo Avatar from its manifest at the family defaults'
             widths, synthetic int8 weights: the kernel at the path's shapes
             (the joint attention over 35,072 tokens and the refiner, each
             with the text bias); the 1 + 1-block DiT with the audio adapter
             against f32; the manifest's defaults (512x512, 125 frames, one
             window of 33 latent frames) with a negative prompt and zero
             Whisper features (no encoder files), then two identical 33-frame
             requests in windows of 9 latent frames; 1 step, the requests'
             DiT 5 + 10 of its 20 + 40 blocks (17 launches a forward)
  prompt_extension
             PromptExtender on the synthetic int8 Qwen3-4B, greedy, 32 new
             tokens (36 launches a token); each decode step's logits against
             the plain attention route from the same caches, and the cached
             decode against a padded full recompute
  rife       rife_v4 (default RIFEConfig, seeded f32 weights) over the 33
             frames the hyv15 phase decoded (seeded 720x1280 frames without
             it): 65 frames, one against the CPU; the cv2 frame_interpolation
             once
  sam2       SAM2 at Hiera-B+ widths (sam2.1_hiera_b+.yaml) at 1024²: the
             kernel at the path's shapes (head dim 56 windows, the global
             q-pool launches, the decoder's 32 and 16; Hiera-L's 72 and
             T/S's 96); a seeded checkpoint in the published layout named by
             APEX_SAM2_PATH; the mask logits with the kernel against the
             plain attention on the card; two identical /mask/create
             requests through the port's server (31 launches each,
             mask_backend "sam2"); sam2_track_video on a SAM2VideoModel of
             the same widths over 10 frames (31 launches a frame)
  preprocess /preprocessor/list and /preprocessor/run (canny on a clip, Depth
             Anything V2 vitl on an image) through the port's server;
             depth_anything_v2 (vitl, 518) and openpose (368) twice each on
             seeded checkpoints at the published names; Depth Anything vits
             and OpenPose f32 on the card against the CPU
  preprocess_nets
             the line, edge, normal and LeReS depth preprocessors (HED,
             PiDiNet, TEED, Lineart, Lineart Anime, the anime scribble,
             Manga Line, M-LSD, NormalBAE, DSINE, LeReS) on seeded
             checkpoints at their published widths and file names: each of
             the 13 manifest names twice on a 720x1280 image through
             run_preprocessor (bit-identical, the JAX output's shape and
             dtype, seconds and peak memory); hed on an 8-frame 480x832 clip
             and dsine on the image through /preprocessor/run; the 11 nets'
             f32 forwards on the card against the CPU; no flash launch
  preprocess_rest
             background removal, anime segmentation, optical flow, Metric3D
             and DensePose on seeded checkpoints at their published widths,
             names and containers (u2net, u2netp, Annotators/UNet.pth, the
             Lightning isnetis.ckpt, gmflow-scale1/2-mixdata.pth, Metric3D
             small) and a scripted DensePose stand-in calling the shim's nms
             and roi_align on the card over 1000 proposals: rembg,
             anime_face_segment, metric3d (depth, normal) and densepose
             twice each on a 720x1280 image, optical_flow / unimatch /
             ptlflow on an 8-frame 480x832 clip at scale1 and scale2;
             optical_flow and metric3d through /preprocessor/run; the nets'
             f32 forwards against the CPU; Metric3D giant2 at full width on
             the 616x1064 crop; cosmos.guardrail over 33 frames with SigLIP
             so400m and its MAP head (bf16 against f32); no flash launch
  skyreels   SkyReels V2 from its three manifests (df, t2v, i2v) at the DF
             14B transformer config (Wan 2.1 14B widths with the fps
             embedding; the DiT int4, UMT5-XXL int8): the kernel at the
             path's new shapes (self over 10,200, 6120 and 2040 tokens, the
             window's text cross); a 2-block DiT with per-frame timesteps
             against f32; df at 544x960 and CFG 6.0, 33 frames in windows of
             17, 2 steps, ar_step 1 (10 rows: the requests' DiT 3 of its 40
             blocks) twice
             (bit-identical) and 17 frames with an image prefix (the prefix
             latent unchanged); t2v of one frame at 24 and 16 fps (the frames
             differ); i2v of 9 frames on the 36-channel twin of the config
  wan_5b     Wan 2.2 TI2V-5B t2v and Lucy Edit at the published 5B widths and
             full depth (dim 3072, 24 heads of 128, FFN 14,336, 30 blocks),
             bf16 as the manifests say, on the Wan 2.2 VAE (z 48, 16x, patch
             2, residual; its config written where both manifests name a
             VAE): the kernel at TI2V's default 704x1280 x 121 frames (27,280
             tokens, 24 heads) and Lucy's 81 frames (8190); t2v at 704x1280,
             17 frames, 1 step, CFG 5, twice with one seed (bit-identical)
             and once with another; Lucy at 480x832 on a 17-frame source and
             on its negative (the frames differ); 60 launches a forward
  wan_more   the 14B engines from their manifests (ReCam, ATI, SCAIL, HoloCine
             on the config its engine implies, Apex-FramePack, Animate, Lynx,
             Lynx-lite) at full width, the DiTs int4 at 3 of their 40 blocks,
             UMT5-XXL int8, CLIP ViT-H and Lynx's resampler unquantized, one
             home for all (the shared prompts' encodes read from the disk
             cache): the kernel at the new shapes (ReCam's 65,520, Animate's
             75,600 and its face cross, Lynx's IP cross and f32 perceiver,
             SCAIL's 42,510 and its two cross, FramePack's longest 81-frame
             window) and HoloCine's biased plain route timed; 2-block DiTs of
             ReCam, FramePack, Animate, Lynx and SCAIL at full width against
             f32; 1 step at 480x832 and 17 frames: two cameras, a trajectory
             against none (the painted condition against the CPU's), two pose
             videos, two shot splits (one twice, bit-identical), FramePack
             over 45 frames (three sections, 1x / 2x / 4x future context),
             Animate at 720x1280 over a 45-frame segment (the VAE encode in
             time chunks), two chained 17-frame segments twice
             (bit-identical) and replace mode, Lynx at ip_scale 1 and 0 and
             Lynx-lite; the frames differ where the conditioning does
  image_rest the other image families from their manifests (Chroma, Ovis-Image,
             FIBO, HiDream-I1 t2i and edit, HunyuanImage 2.1 and its
             distilled manifest) at their default sizes (1024², HunyuanImage
             2048²), full width (Chroma, Ovis and HunyuanImage 2.1 at a
             quarter to a third of their depth since PR 21), synthetic bf16
             weights (the configs the repository lacks written into one
             home): the kernel
             at their shapes (Chroma's text key padding, FIBO's mask and its
             dual blocks' 0/1 bias, HiDream's 20 heads, HunyuanImage's 28
             heads and its refiner); 1 + 1-block DiTs at full width against
             f32 and the 32x VAE against float64; each family's request with
             seeds 0, 0, 1 (1 and 2 bit-identical, 3 not), 1 step, CFG (FIBO
             on a JSON prompt, HunyuanImage with APG), a HiDream edit from a
             seeded image, the distilled HunyuanImage once
  video_rest the video families on the ported VAEs and encoders, from their
             manifests at published widths, synthetic bf16 weights (the
             configs the repository lacks written into each family's one
             home): the kernel at their shapes (LongCat's self over 7800 tokens
             at 32 heads, the i2v conditioning frame alone and its noise against
             every key, the KV-cache launch, the masked UMT5 cross, refine's
             720p self; Cosmos' 17,600 tokens at 16 heads and its T5 cross;
             Kandinsky 5's 28 heads of 64: self, text blocks, cross); the DiTs
             at full width (2 blocks; Kandinsky 1 + 1) against f32; LongCat's
             seven types at 480x832 over 17 frames, the DiT at LONGCAT_LAYERS
             of its 48 blocks, 1 step, CFG-zero*: t2v (seeds 0, 0, 1), i2v,
             vc with the KV cache, continuation, long_video with one segment,
             interactive with two sentences, and refine at 720x1280; Cosmos
             Predict2 2B i2v (seeds 0, 0, 1) and v2v at 704x1280 over 17
             frames at COSMOS_LAYERS of 28 layers; Kandinsky 5 Lite t2v
             (seeds 0, 0, 1) and i2v on the visual_cond twin at 512x768 over
             17 frames, 2 + KANDINSKY5_VISUAL_BLOCKS of its 2 + 32 blocks
  hunyuanimage3
             HunyuanImage 3.0 from its manifest at the published widths: the
             80B MoE backbone int4 on the card (the fit check's reckoning at
             bf16, int8 and int4), the DC-AE VAE in f32, the byte-level
             tokenizer: the kernel at the image span's 4096 queries against
             all 4225 keys and at the 129-token causal prefix; a 1 + 1-layer
             backbone int4 against f32 and the VAE against float64; one forward
             at all 32 layers at 1024² (its launches, its _w4 share, the peak);
             then t2i at 1024² with the backbone cut to HY3_LAYERS layers, CFG
             7.5, 2 steps, seeds 0, 0, 1
  cogvideox  CogVideoX 5B from its three manifests and control and inp twins at
             full width (48 heads of 64) in bf16, T5-XXL, the VAE in f32: the
             kernel at the joint launch over 17 and 49 frames; a 2-block DiT
             against f32 and the VAE against float64; 480x720 over 17 frames,
             the DiTs at COG_LAYERS of their 42 layers (since PR 21), 2 steps,
             CFG 6 with dynamic CFG: t2v (seeds 0, 0, 1), v2v at strength 0.8,
             i2v, control, inp
  mochi      Mochi-1 t2v from its manifest at full width in bf16, T5-XXL, the
             VAE in f32: the kernel at the joint launch over 24,106 tokens (24
             heads of 128) and the pooler's query over 257 keys; a 1 + 1-block
             DiT against f32 and the VAE against float64; one forward at all
             48 blocks; then 480x848 over 85 frames with the DiT cut to
             MOCHI_LAYERS blocks, 2 steps, CFG 4.5, seeds 0, 0, 1
  ltx        LTX-Video x2v from its manifest at full width and depth (28
             layers, 32 heads of 64) in bf16, T5-XXL, the VAE in f32: the
             kernel at the self-attention over 7410 tokens and the cross
             launch against 128 text rows; a 2-block DiT (with and without
             an STG skip) against f32 and the VAE against float64; 480x832
             over 145 frames, 2 steps, CFG 3 with STG: t2v (seeds 0, 0, 1),
             i2v, an extension of a 17-frame clip
  ltx2       LTX-2 from its manifest at full width in bf16 (Gemma-3 12B and
             the connectors bf16, the audio VAE and vocoder f32): the kernel
             at its seven launch shapes and its fully masked text rows; a
             2-block DiT against f32, the VAE against float64; one CFG forward
             at all 48 blocks over 6144 + 121 tokens; at 4 blocks, 2 steps,
             CFG 4: t2v at 512x768 over 121 frames (seeds 0, 0, 1; frames and
             a 24 kHz waveform), i2v, multimodal guidance, IC-LoRA and
             keyframe interpolation at 17 frames; the latent upsampler in
             f32 against the CPU
  preprocess_pose
             the last preprocessors: the transformers delegates at published
             widths written with save_pretrained (DPT-Large, ZoeDepth
             NYU-KITTI, Depth Anything large, SegFormer-B4, OneFormer Swin-T)
             twice each at the manifests' defaults on a 720x1280 image, midas
             and oneformer through /preprocessor/run; NLF-L from a seeded
             nlf_l_multi.safetensors against the CPU and its estimator twice;
             dwpose, pose2d, face2d, animalpose and dwpose_nlf on scripted
             cv2.dnn nets; the gated stubs; /preprocessor/list; no flash
             launch
The kernels phase holds the kernel at every shape of the table in PERF.md:
Flux's, the tile edges, biases and causal cases, ZImage's S = 4224 and 4096
at 30 heads and its 128-token caption block, and Qwen3's one-row decode
against Sk = 300 with a [1, Sk] bias and a ragged Sk = 437 with a [2, Sk] bias,
QwenImage's joint lengths at 24 heads (the edit request's, a ragged 8256,
edit_plus's and t2i's), and Wan's at 40 heads (self-attention over 1560, 4096
and 32,760 tokens, and each one's cross-attention over 512 text rows), and
the editing paths' (VACE's 34,320 tokens, the CLIP image cross-attention over
257 and 514 keys, the Self-Forcing block of 4680 queries against 32,760 cache
rows with a [1, Sk] bias at its first and last block and with a window and a
sink), and the Flux editing paths' (FLUX.2 at 48 heads over 4608 and 8704
tokens, Kontext over 8704 and DreamOmni2 over 12,800 at 24); the timing phase
times each beside its bound and the library call. The hyv, humo, s2v,
multitalk, avatar, skyreels, wan_5b, wan_more, image_rest, video_rest, hunyuanimage3, cogvideox and sam2
phases hold and time the
kernel at their own shapes (``path_kernel_rows``); the kernels phase also holds it at head dims
16, 32, 56, 72 and 96 (ragged, with a bias, on fused-qkv views in bf16 and
f32).
Then a ``wall`` line, a ``kernels`` line, the card and, last,
``{"ok": true, "device": {...}}``.

The CPU halves of the card-vs-CPU checks run on a worker thread beside the
card; each phase waits for its own before its time is read. Any failed check
exits non-zero before the last line. Run from the root of a
checkout: ``python3 chip_smoke.py`` (``--phases kernels,timing`` for a short run;
add ``trace`` to the default list for the profile).
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import math
import os
import shutil
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
MANIFEST = REPO / "manifests" / "image" / "flux-dev-text-to-image.yml"
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# Kernel against its plain version, bf16 on unit-normal inputs. Both limits
# scale with the output: at Flux's shape a typical |out| is about 0.02, so a
# flat limit such as 3e-2 would pass a kernel that dropped a whole key tile.
MAX_ERR_OF_MAX_REF = 2e-2  # max|Δ| ≤ 2e-2·max|ref|, about 2.5 bf16 ulps of the largest output
REL_L2_TOL = 1e-2          # ‖Δ‖₂ ≤ 1e-2·‖ref‖₂
FLUX_SHAPE = dict(b=1, s=4096 + 512, h=24, d=128)
STEPS = 2
SIZE = 1024
BLOCKS = 19 + 38
DEFAULT_PHASES = ("kernels,timing,reference,residency,checkpoint,main,bf16,int4,hyv15,zimage,server,"
                  "qwenimage,wan,wan_edit,wan_causal,flux_edit,flux2,hyv,humo,s2v,multitalk,avatar,prompt_extension,"
                  "skyreels,wan_5b,wan_more,image_rest,video_rest,hunyuanimage3,cogvideox,mochi,ltx,ltx2,magi,flashvsr,"
                  "rife,sam2,"
                  "preprocess,"
                  "preprocess_nets,preprocess_rest,"
                  "preprocess_pose")
LORA_RANK, LORA_SCALE, LORA_BLOCKS = 16, 0.8, 19
# W8A8 against the same arithmetic elsewhere (f32 compute): x / sx on a rounding
# tie may fall one int8 step apart. int4 and dequant in f32: summation order.
# A bf16 compute dtype on the card against f32 on the CPU adds bf16's 8 bits.
W8A8_REL_L2, F32_REL_L2, BF16_REL_L2 = 2e-3, 1e-4, 1e-2
# W8A8 against the dequant path through 2 + 2 Flux blocks in bf16: twice the 3%
# the JAX package's gate allows through 1 + 1 blocks in f32, since activation
# quantization adds about 1% a matmul and the error grows with depth (weight
# quantization alone reads 3% against the unquantized bf16 model here).
W8A8_VS_DEQUANT = 6e-2
PROMPT_A = "A cinematic photograph of a lighthouse on a rocky coast at golden hour"
PROMPT_B = "An oil painting of a red fox asleep in fresh snow under pine trees"
HYV15_MANIFEST = REPO / "manifests" / "video" / "hunyuanvideo-1.5-i2v.yml"
# 720x1280: latents 45x80 a frame, 9 frames at 33 and 31 at 121; context 729
# SigLIP + 128 byT5 + 1000 Qwen2.5-VL tokens
HYV15_CONTEXT_TOKENS = 729 + 128 + 1000
HYV15_TOKENS = {33: 9 * 45 * 80 + HYV15_CONTEXT_TOKENS, 121: 31 * 45 * 80 + HYV15_CONTEXT_TOKENS}
# one step a request: a cut of depth that keeps the whole script inside its limit
HYV15_MLLM_TOKENS, HYV15_HEADS, HYV15_STEPS = 1000, 16, 1
# the 121-frame request runs one step: its seconds per step are that step's
# (a cut of depth that keeps the whole script inside its time limit)
HYV15_LONG_STEPS = 1
HYV15_SIZE, HYV15_FRAMES, HYV15_SCALES = (720, 1280), (33, 33, 121), (4, 16)  # VAE time, space
# the requests' DiT has 6 of its published 54 blocks (a cut of depth that keeps
# the whole script inside its limit; the kernel rows at the 121-frame shape stay)
HYV15_LAYERS = 6
HYV15_LAUNCHES_PER_STEP = 2 * (HYV15_LAYERS + 2)  # CFG: two forwards of the blocks' joint + 2 refiner attentions
# rows, in, out and calls a CFG step of the DiT's resident Linears at 121 frames
# (111,600 image rows, 1,857 context rows, adaLN on one row): 8, 2, 2 and 4 a block
HYV15_LINEAR_CALLS = {(111600, 2048, 2048): 8 * HYV15_LAYERS, (111600, 2048, 8192): 2 * HYV15_LAYERS,
                      (111600, 8192, 2048): 2 * HYV15_LAYERS, (1857, 2048, 2048): 8 * HYV15_LAYERS,
                      (1857, 2048, 8192): 2 * HYV15_LAYERS, (1857, 8192, 2048): 2 * HYV15_LAYERS,
                      (1, 2048, 12288): 4 * HYV15_LAYERS}
HYV15_PROMPT = 'A lighthouse keeper walks along the pier at dusk, a sign reads "NORTH LIGHT"'
HYV15_T2V_MANIFEST = REPO / "manifests" / "video" / "hunyuanvideo-1.5-t2v.yml"
ZIMAGE_MANIFEST = REPO / "manifests" / "image" / "zimage-turbo.yml"
ZIMAGE_CFG_MANIFEST = REPO / "manifests" / "image" / "zimage.yml"
ZIMAGE_CONTROL_MANIFEST = REPO / "manifests" / "image" / "zimage-turbo-control.yml"
# 1024x1024: 128x128 latents, 64x64 = 4096 image tokens of 30 heads of 128; the
# prompts below fill a 128-token caption bucket (byte-level tokens, chat template)
ZIMAGE_TOKENS, ZIMAGE_HEADS, ZIMAGE_STEPS = 4096, 30, 9
# flash launches a forward: 2 noise refiner + 2 context refiner + 30 layers;
# the control branch adds its 2 refiner and 15 layer blocks
ZIMAGE_LAUNCHES, ZIMAGE_CONTROL_LAUNCHES = 2 + 2 + 30, 2 + 2 + 30 + 2 + 15
# rows, in, out and calls a step of ZImage's resident Linears at 1024px: the 30
# main layers' q/k/v/out, FFN in (w1, w3) and out over 4096 + 128 tokens, and
# the one-row adaLN of the 30 layers and the 2 noise refiner blocks
ZIMAGE_LINEAR_CALLS = {(4224, 3840, 3840): 120, (4224, 3840, 10240): 60, (4224, 10240, 3840): 30,
                       (1, 256, 15360): 32}
QWEN3_HEADS, QWEN3_LAYERS, EXTEND_TOKENS = 32, 36, 32
# Qwen3-4B's logits on the kernel against the plain attention route from the
# same caches, and its cached decode against a padded recompute: bf16
# activations and W8A8 Linears through 36 layers, where a one-ulp change of
# an attention output may move an activation across an int8 rounding step
QWEN3_REL_L2 = 3e-2
# RIFE on the card against the same weights on the CPU, both f32 (no TF32):
# the interpolated frame in [0, 1] within a quarter of a uint8 step, and the
# uint8 frames at most one level apart
RIFE_MAX_ABS, RIFE_FRAMES, RIFE_SIZE = 1e-3, 33, (720, 1280)
QWENIMAGE_EDIT_MANIFEST = REPO / "manifests" / "image" / "qwenimage-edit-2509.yml"
QWENIMAGE_MANIFEST = REPO / "manifests" / "image" / "qwenimage.yml"
# 1024x1024: 128x128 latents packed 2x2 into 4096 tokens of 24 heads of 128;
# 60 DiT blocks and 5 ControlNet blocks, one joint launch each
QWENIMAGE_TOKENS, QWENIMAGE_HEADS, QWENIMAGE_CN_LAYERS = 4096, 24, 5
# the requests' DiT: 15 of the 60 blocks (a cut of depth, PR 21); the kernel rows stay at the full shapes
QWENIMAGE_REQUEST_LAYERS = 15
# the bench leg's edit request runs 2 of its 8 steps: a cut that keeps the
# whole script inside its limit
QWENIMAGE_EDIT_PROMPT, QWENIMAGE_EDIT_STEPS = "make the sky purple", 2
# rows, in, out and calls a forward of the edit request's resident Linears: the
# image stream (4096 noise + 4096 condition rows) q/k/v/out, MLP in and out, and
# the two 6·d modulations on one row (the text stream's q/k/v/out are added at
# its bucket's rows)
QWENIMAGE_LINEAR_CALLS = {(8192, 3072, 3072): 4 * QWENIMAGE_REQUEST_LAYERS,
                          (8192, 3072, 12288): QWENIMAGE_REQUEST_LAYERS,
                          (8192, 12288, 3072): QWENIMAGE_REQUEST_LAYERS,
                          (1, 3072, 18432): 2 * QWENIMAGE_REQUEST_LAYERS}
WAN_T2V_MANIFEST = REPO / "manifests" / "video" / "wan-2.2-a14b-text-to-video.yml"
WAN_T2I_MANIFEST = REPO / "manifests" / "image" / "wan-2.2-a14b-text-to-image.yml"
WAN_I2V_MANIFEST = REPO / "manifests" / "video" / "wan2.2-a14b-image-to-video.yml"
# 40 heads of 128, 40 blocks an expert, 512 UMT5 rows; tokens (patch 1x2x2 over
# 8x-downscaled latents, 4x in time): one 480x832 frame 1x30x52, a 1024² image
# 1x64x64, 81 frames at 480x832 21x30x52
WAN_HEADS, WAN_LAYERS, WAN_TEXT_TOKENS = 40, 40, 512
# the bench leg's and the t2i request's steps in this run: 3 of their 30, a
# cut that keeps the whole script inside its
# time limit (the seconds per step and every check are read as at 30; the
# t2i schedule at shift 5 still crosses the expert boundary: t = 999, 909 |
# 714)
# the 81-frame t2v and i2v requests: 2 steps at shift 3 (t = 999 | 750), one
# step an expert across the boundary at 0.875, where the manifests' shift 12
# needs 3 (999, 959 | 856) (a cut of steps)
WAN_CLIP_STEPS, WAN_CLIP_SHIFT = 2, 3.0
# the wan phase's experts have 3 of the published 40 blocks (a cut of depth
# that keeps the whole script inside its limit; the 2-block full-width check
# and the kernel rows at Wan's shapes stay)
WAN_REQUEST_LAYERS = 3
WAN_SMOKE_STEPS = 3
WAN_TOKENS = {"frame": 1560, "t2i": 4096, "clip": 32760}
# the bench leg's prompts (bench_e2e.py PROMPT, NEG)
WAN_PROMPT = ("A cinematic photograph of a lighthouse on a rocky coast at golden "
              "hour, crashing waves, volumetric light, highly detailed")
WAN_NEG = "blurry, low quality, watermark"
# rows, in, out and calls a forward of the DiT's resident Linears at the bench
# leg's 1560 tokens: self-attention q/k/v/out and cross-attention q/out, the FFN
# in and out; the cross-attention K/V and the text embedder's second Linear over
# the 512 text rows, its first from 4096; time_proj on one row
WAN_LINEAR_CALLS = {(1560, 5120, 5120): 6 * WAN_REQUEST_LAYERS, (1560, 5120, 13824): WAN_REQUEST_LAYERS,
                    (1560, 13824, 5120): WAN_REQUEST_LAYERS, (512, 5120, 5120): 2 * WAN_REQUEST_LAYERS + 1,
                    (512, 4096, 5120): 1, (1, 5120, 30720): 1}
# the same at the 81-frame clip's 32,760 tokens
WAN_CLIP_LINEAR_CALLS = {(32760, 5120, 5120): 6 * WAN_REQUEST_LAYERS, (32760, 5120, 13824): WAN_REQUEST_LAYERS,
                         (32760, 13824, 5120): WAN_REQUEST_LAYERS, (512, 5120, 5120): 2 * WAN_REQUEST_LAYERS + 1,
                         (512, 4096, 5120): 1, (1, 5120, 30720): 1}
# the fused UniPC step against the host step, both f32 on the same velocities:
# the same linear combination summed in another order, a few f32 ulps a step
WAN_UNIPC_REL_L2 = 1e-5
# the point mask's IoU with the drawn disk on every tracked frame
WAN_MASK_IOU = 0.9
# google/umt5-xxl config.json (the Wan manifests' text encoder)
UMT5_XXL = {"model_type": "umt5", "d_model": 4096, "d_ff": 10240, "d_kv": 64, "num_heads": 64,
            "num_layers": 24, "vocab_size": 256384, "relative_attention_num_buckets": 32,
            "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6,
            "feed_forward_proj": "gated-gelu"}
# Wan-AI/Wan2.2-I2V-A14B-Diffusers transformer/config.json (both experts)
WAN_I2V_TRANSFORMER = {"_class_name": "WanTransformer3DModel", "patch_size": [1, 2, 2],
                       "num_attention_heads": 40, "attention_head_dim": 128, "in_channels": 36,
                       "out_channels": 16, "text_dim": 4096, "freq_dim": 256, "ffn_dim": 13824,
                       "num_layers": 40, "cross_attn_norm": True, "qk_norm": "rms_norm_across_heads",
                       "eps": 1e-6, "image_dim": None, "added_kv_proj_dim": None, "rope_max_seq_len": 1024,
                       "pos_embed_seq_len": None}
WAN21_I2V_MANIFEST = REPO / "manifests" / "video" / "wan-2.1-14b-image-to-video-480p.yml"
WAN_VACE_MANIFEST = REPO / "manifests" / "video" / "wan-2.1-14b-vace.yml"
WAN_FFLF_MANIFEST = REPO / "manifests" / "video" / "wan2.2-a14b-first-frame-last-frame.yml"
WAN_INP_MANIFEST = REPO / "manifests" / "video" / "wan2.2-a14b-video-inpaint.yml"
WAN_V2V_MANIFEST = REPO / "manifests" / "video" / "wan2.2-a14b-video-to-video.yml"
WAN_FUN_VACE_MANIFEST = REPO / "manifests" / "video" / "wan2.2-fun-a14b-vace.yml"
WAN_PHANTOM_MANIFEST = REPO / "manifests" / "video" / "wan-2.1-14b-phantom.yml"
WAN_FUN_CONTROL_MANIFEST = REPO / "manifests" / "video" / "wan-2.2-fun-a14b-control.yml"
WAN_SVI_MANIFEST = REPO / "manifests" / "video" / "wan2.2-a14b-stable-video-infinity.yml"
WAN_CAUSAL_MANIFEST = REPO / "manifests" / "video" / "wan-causal-self-forcing.yml"
# VACE at 81 frames plus one reference frame: 22 latent frames of 1560 tokens;
# a Self-Forcing block: 3 latent frames; 257 CLIP tokens (16 x 16 patches + class)
WAN_EDIT_TOKENS = {"vace": 22 * 1560, "causal_block": 3 * 1560}
# the Self-Forcing requests' DiT has 4 of its published 30 blocks (a cut of
# depth that keeps the whole script inside its limit; the 2-block
# full-width check stays)
VACE_LAYERS, CAUSAL_LAYERS, CAUSAL_HEADS, CLIP_TOKENS = 8, 4, 12, 257
# CLIP ViT-H in f32 on the card (TF32 off) against the CPU through 31 layers:
# the same sums in another order. In bf16, the manifests' precision, its
# penultimate states read 1.0% from f32 on the card: twice that is the limit
# (bf16's 8 bits through 31 layers, above the 2-block DiTs' BF16_REL_L2).
CLIP_F32_REL_L2, CLIP_BF16_REL_L2 = 1e-3, 2e-2
_WAN14B = {"_class_name": "WanTransformer3DModel", "patch_size": [1, 2, 2], "num_attention_heads": 40,
           "attention_head_dim": 128, "in_channels": 16, "out_channels": 16, "text_dim": 4096, "freq_dim": 256,
           "ffn_dim": 13824, "num_layers": 40, "cross_attn_norm": True, "qk_norm": "rms_norm_across_heads",
           "eps": 1e-6, "image_dim": None, "added_kv_proj_dim": None, "rope_max_seq_len": 1024}
# Wan-AI/Wan2.1-I2V-14B-480P-Diffusers transformer/config.json
WAN21_I2V_TRANSFORMER = dict(_WAN14B, in_channels=36, image_dim=1280, added_kv_proj_dim=5120)
# Wan-AI/Wan2.1-VACE-14B-diffusers transformer/config.json (the Fun-VACE manifest's too)
WAN_VACE_TRANSFORMER = dict(_WAN14B, _class_name="WanVACETransformer3DModel", vace_layers=list(range(0, 40, 5)),
                            vace_in_channels=96)
# the Fun-Control manifest names the T2V experts (16 channels); the engine packs
# 16 noise + 16 control-video channels (ROADMAP Queue 3)
WAN_FUN_CONTROL_TRANSFORMER = dict(_WAN14B, in_channels=32)
# gdhe17/Self-Forcing (Wan-AI/Wan2.1-T2V-1.3B's DiT): dim 1536, 30 layers
SELF_FORCING_TRANSFORMER = dict(_WAN14B, num_attention_heads=12, ffn_dim=8960, num_layers=30)
# the Wan editing requests' 14B DiTs have 3 of the published 40 blocks (a
# cut of depth that keeps the whole script inside its limit; the 2-block
# full-width checks stay); VACE keeps a hint every fifth block (the first)
EDIT_LAYERS = 3
EDIT_VACE_LAYERS = len(range(0, EDIT_LAYERS, 5))


def edit_depth(cfg: dict) -> dict:
    """A published DiT config at the editing requests' depth."""
    cut = dict(cfg, num_layers=EDIT_LAYERS)
    if "vace_layers" in cfg:
        cut["vace_layers"] = list(range(0, EDIT_LAYERS, 5))
    return cut


# Wan-AI/Wan2.1-I2V-14B-480P-Diffusers image_encoder/config.json (CLIP ViT-H/14)
CLIP_VISION_H = {"_class_name": "CLIPVisionModelWithProjection", "hidden_size": 1280, "intermediate_size": 5120,
                 "num_hidden_layers": 32, "num_attention_heads": 16, "image_size": 224, "patch_size": 14,
                 "hidden_act": "gelu", "layer_norm_eps": 1e-5, "projection_dim": 1024}
# google/byt5-small config.json (the manifest's glyph encoder)
BYT5_SMALL = {"model_type": "t5", "d_model": 1472, "d_ff": 3584, "d_kv": 64, "num_heads": 6,
              "num_layers": 12, "vocab_size": 384, "relative_attention_num_buckets": 32,
              "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6,
              "feed_forward_proj": "gated-gelu"}

HYV_T2V_MANIFEST = REPO / "manifests" / "video" / "hunyuanvideo-t2v.yml"
HYV_I2V_MANIFEST = REPO / "manifests" / "video" / "hunyuanvideo-i2v.yml"
# HunyuanVideo at 720x1280: 45 x 80 image tokens a latent frame (patch 2)
# and 256 llava-llama-3 text slots after the template's crop; a forward makes
# 20 + 40 joint launches and the token refiner's 2
# one step a request: a cut of depth that keeps the whole script inside its
# limit
HYV_HEADS, HYV_TEXT_TOKENS, HYV_STEPS, HYV_SIZE = 24, 256, 1, (720, 1280)
HYV_TOKENS = {33: 9 * 45 * 80 + HYV_TEXT_TOKENS, 81: 21 * 45 * 80 + HYV_TEXT_TOKENS}
# the Avatar requests' DiT has 5 + 10 of its 20 + 40 blocks (a cut of depth
# that keeps the whole script inside its limit; its 10 audio adapters stay,
# those after the kept dual blocks 1 and 3 run; the 1 + 1-block check stays)
AVATAR_DUAL, AVATAR_SINGLE = 5, 10
HYV_LAUNCHES_PER_FORWARD = AVATAR_DUAL + AVATAR_SINGLE + 2
# The HunyuanVideo 1 + 1-block DiT's bf16 forward against f32 at its full
# width with the synthetic weights read 0.94-1.014% on an H100 (plain and
# token_replace); on the CPU the port's bf16 forward reads 0.98% and the JAX
# module's own 1.24% from the same f32 forward (tests/torch_bf16_width.py).
# The limit sits just above the JAX module's own rounding.
HYV_BF16_REL_L2 = 1.3e-2
# the kernel cases' text bias keeps a 60-token prompt (the published
# tokenizer's; the byte-level one fills all 256 slots with the template)
HYV_TEXT_KEPT = 60
HYV_PROMPT = "A red fox trots across a snowy meadow at sunrise, its breath visible in the cold air"
# hunyuanvideo-community/HunyuanVideo-I2V transformer/config.json: the
# family's widths with the first-frame token replacement
HYV_I2V_TRANSFORMER = {"_class_name": "HunyuanVideoTransformer3DModel", "in_channels": 16, "out_channels": 16,
                       "num_attention_heads": 24, "attention_head_dim": 128, "num_layers": 20,
                       "num_single_layers": 40, "num_refiner_layers": 2, "mlp_ratio": 4.0, "patch_size": 2,
                       "patch_size_t": 1, "guidance_embeds": True, "text_embed_dim": 4096,
                       "pooled_projection_dim": 768, "rope_theta": 256.0, "rope_axes_dim": [16, 56, 56],
                       "image_condition_type": "token_replace"}
# (rows, in, out): W8A8 Linear calls a forward at 81 frames, the dual blocks'
# 75,600-row image stream reckoned at the single blocks' 75,856 rows
# the hyv requests' DiT has 1 + 3 of the published 20 + 40 blocks (a cut of
# depth that keeps the whole script inside its limit; the 1 + 1-block
# full-width check stays)
HYV_DUAL, HYV_SINGLE = 1, 3
HYV_T2V_TRANSFORMER = dict(HYV_I2V_TRANSFORMER, num_layers=HYV_DUAL, num_single_layers=HYV_SINGLE,
                           image_condition_type=None)
HYV_REQUEST_LAUNCHES = HYV_DUAL + HYV_SINGLE + 2
HYV_LINEAR_CALLS = {(75856, 3072, 3072): 4 * HYV_DUAL + 3 * HYV_SINGLE, (75856, 3072, 12288): HYV_DUAL + HYV_SINGLE,
                    (75856, 12288, 3072): HYV_DUAL, (75856, 15360, 3072): HYV_SINGLE, (256, 3072, 3072): 4 * HYV_DUAL,
                    (256, 3072, 12288): HYV_DUAL, (256, 12288, 3072): HYV_DUAL}
HUMO_MANIFEST = REPO / "manifests" / "video" / "humo-17b.yml"
# HuMo at 480x832: 1560 tokens a latent frame; 97 frames are 25 latent frames
# (the last one the reference's), 33 are 9; 16 audio tokens a latent frame;
# a forward makes 3 launches a block (self, text and audio cross-attention)
HUMO_TOKENS = {97: 25 * 1560, 33: 9 * 1560}
# the requests' DiT has 20 of the published 40 blocks (a cut of depth that
# keeps the whole script inside its limit; the full-width check runs on 2
# blocks)
HUMO_LAYERS = 3  # of the published 40: a cut of depth
HUMO_TRANSFORMER = {"num_layers": HUMO_LAYERS}
HUMO_AUDIO_TOKENS, HUMO_STEPS, HUMO_LAUNCHES_PER_FORWARD = 16, 2, 3 * HUMO_LAYERS
# the TA pair runs one step (TIA keeps two to cross step_change): a cut of depth
HUMO_TA_STEPS = 1
# facebook/wav2vec2-base widths (768, 12 heads, the group-norm extractor)
# with 13 layers: the engine stacks the hidden states after the embeddings,
# one a layer, and the DiT's windows take 13 (WanHuMoConfig.audio_blocks)
HUMO_WAV2VEC2 = {"model_type": "wav2vec2", "hidden_size": 768, "num_hidden_layers": 13, "num_attention_heads": 12,
                 "intermediate_size": 3072, "conv_dim": [512] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
                 "conv_stride": [5, 2, 2, 2, 2, 2, 2], "feat_extract_norm": "group", "do_stable_layer_norm": False,
                 "num_conv_pos_embeddings": 128, "num_conv_pos_embedding_groups": 16, "layer_norm_eps": 1e-5}
WAN_S2V_MANIFEST = REPO / "manifests" / "video" / "wan2.2-s2v-14b.yml"
WAN_MULTITALK_MANIFEST = REPO / "manifests" / "video" / "wan-2.1-14b-multitalk.yml"
HYV_AVATAR_MANIFEST = REPO / "manifests" / "video" / "hunyuanvideo-avatar.yml"
# Wan-AI/Wan2.2-S2V-14B, wan/configs/wan_s2v_14B.py of the Wan2.2 repository:
# the 14B Wan widths, wav2vec2-large's 1024-wide states (25 with the
# embeddings), audio injected after 12 blocks, the FramePack motioner, the
# zero-timestep condition tokens, 16 pose channels. The WanS2VConfig defaults
# (audio_dim 1280, 8 inject layers, no FramePack) meet no published encoder
# (ROADMAP Queue 3).
WAN_S2V_TRANSFORMER = {"_class_name": "WanS2VTransformer3DModel", "patch_size": [1, 2, 2],
                       "num_attention_heads": 40, "attention_head_dim": 128, "in_channels": 16,
                       "out_channels": 16, "text_dim": 4096, "freq_dim": 256, "ffn_dim": 13824, "num_layers": 40,
                       "cross_attn_norm": True, "eps": 1e-6, "audio_dim": 1024, "num_wav2vec_layers": 25,
                       "audio_inject_layers": [0, 4, 8, 12, 16, 20, 24, 27, 30, 33, 36, 39], "enable_adain": True,
                       "adain_mode": "attn_norm", "pose_dim": 16, "enable_framepack": True,
                       "framepack_drop_mode": "padd", "zero_timestep": True, "num_audio_token": 4}
# jonatasgrosman/wav2vec2-large-xlsr-53-english config.json (the S2V
# repository's audio encoder): 24 layers of 1024, 16 heads, the layer-norm
# feature extractor with the stable layer norm
WAV2VEC2_LARGE = {"model_type": "wav2vec2", "hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16,
                  "intermediate_size": 4096, "conv_dim": [512] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
                  "conv_stride": [5, 2, 2, 2, 2, 2, 2], "feat_extract_norm": "layer", "do_stable_layer_norm": True,
                  "num_conv_pos_embeddings": 128, "num_conv_pos_embedding_groups": 16, "layer_norm_eps": 1e-5}
# TencentGameMate/chinese-wav2vec2-base config.json (MultiTalk's audio
# encoder): 12 layers of 768, the group-norm extractor; the DiT stacks its 12
# states after the embeddings (WanMultiTalkConfig.audio_blocks)
WAV2VEC2_BASE = dict(HUMO_WAV2VEC2, num_hidden_layers=12)
# S2V at 480x832, 80 frames a chunk: 20 latent frames of 1560 noise tokens,
# the reference's 1560 and FramePack's 1560 + 390 + 4 x 7 x 13 motion tokens
# (the 4x bucket's 8 x 8 patch cropped from 60 x 104); the first chunk drops
# the motion (32,760); 4 audio tokens a frame and a padding token
S2V_FRAMES = 20
S2V_TOKENS = {"chunk": S2V_FRAMES * 1560 + 1560 + 1560 + 390 + 4 * 7 * 13, "first_chunk": (S2V_FRAMES + 1) * 1560}
# the S2V and MultiTalk requests' DiTs have 2 of the published 40 blocks (a cut
# of depth that keeps the whole script inside its limit; the
# 2-block full-width checks stay): S2V keeps the audio injectors of the
# blocks it keeps (0)
AUDIO_VIDEO_LAYERS = 2
S2V_REQUEST_TRANSFORMER = dict(WAN_S2V_TRANSFORMER, num_layers=AUDIO_VIDEO_LAYERS, audio_inject_layers=[
    i for i in WAN_S2V_TRANSFORMER["audio_inject_layers"] if i < AUDIO_VIDEO_LAYERS])
S2V_AUDIO_TOKENS, S2V_INJECT_LAYERS = 4 + 1, len(S2V_REQUEST_TRANSFORMER["audio_inject_layers"])
# a forward: self and text cross-attention in each block, the audio injector's after 5 of them
S2V_LAUNCHES_PER_FORWARD = 2 * AUDIO_VIDEO_LAYERS + S2V_INJECT_LAYERS
# the 10 s clip's wav2vec2 frames (50 Hz) behind the two 80-frame chunks at 16 fps
S2V_AUDIO_SECONDS, S2V_W2V_FRAMES = 10.0, 499
# MultiTalk at 480x832 and 81 frames: 21 latent frames of 1560 tokens; 32 audio
# tokens a speaker and frame; 257 CLIP tokens; a forward makes self, text,
# CLIP and audio cross-attention launches in each of the 40 blocks
MULTITALK_TOKENS, MULTITALK_AUDIO_TOKENS = 21 * 1560, 2 * 32
MULTITALK_LAUNCHES_PER_FORWARD = 4 * AUDIO_VIDEO_LAYERS
MULTITALK_REQUEST_TRANSFORMER = dict(WAN21_I2V_TRANSFORMER, num_layers=AUDIO_VIDEO_LAYERS)
# 3.2 s of each speaker's voice: 80 video frames at 25 fps, the wav2vec2 states resampled to them
MULTITALK_AUDIO_SECONDS, MULTITALK_W2V_FRAMES = 3.2, 80
# the Avatar at 512x512: one window of 33 latent frames of 32 x 32 tokens, the
# reference frame's 1024 in front and the 256 text slots; a forward makes the
# HunyuanVideo DiT's launches (HYV_LAUNCHES_PER_FORWARD)
AVATAR_TOKENS = 1024 + 33 * 1024 + HYV_TEXT_TOKENS
AUDIO_VIDEO_STEPS = 1
# SkyReels V2 (Skywork/SkyReels-V2-DF-14B-540P transformer/config.json): Wan 2.1
# 14B's widths with the fps embedding; the three manifests name this DF
# config, whose 16 input channels the i2v engine's 20 condition channels do
# not fit (ROADMAP Queue 3): the i2v request's home gets the 36-channel twin
SKYREELS_MANIFESTS = {kind: REPO / "manifests" / "video" / f"skyreels-v2-{kind}-14b.yml"
                      for kind in ("df", "t2v", "i2v")}
SKYREELS_TRANSFORMER = dict(_WAN14B, _class_name="SkyReelsTransformer3DModel", inject_sample_info=True)
SKYREELS_I2V_TRANSFORMER = dict(SKYREELS_TRANSFORMER, in_channels=36)
# 544x960: latents 68x120, 34x60 = 2040 tokens a latent frame; diffusion
# forcing's window of base_num_frames 17 (5 latent frames), 9-frame i2v
SKYREELS_FRAME_TOKENS = 34 * 60
SKYREELS_TOKENS = {"df_window": 5 * SKYREELS_FRAME_TOKENS, "i2v": 3 * SKYREELS_FRAME_TOKENS,
                   "t2v": SKYREELS_FRAME_TOKENS}
# df at the manifest's 544x960 and CFG 6.0: 33 frames (9 latent) in windows of
# 17 (5 latent), 2 steps, ar_step 1: 10 rows of 2 forwards (the manifest's
# ar_step 5 makes 18 rows of the same clip), 40 self + 40 text-cross launches each
SKYREELS_DF = dict(height=544, width=960, num_frames=33, base_num_frames=17, num_inference_steps=2, ar_step=1,
                   guidance_scale=6.0, fps=24)
# the requests' DiT has 3 of the published 40 blocks (a cut of depth that
# keeps the whole script inside its limit; the 2-block full-width check stays)
SKYREELS_LAYERS = 3
SKYREELS_DF_ROWS, SKYREELS_LAUNCHES_PER_FORWARD = 10, 2 * SKYREELS_LAYERS
# the image-prefix request: 17 frames, the window the whole clip, its first
# latent frame done from the start: 5 rows
SKYREELS_PREFIX_FRAMES, SKYREELS_PREFIX_ROWS = 17, 5
# facebookresearch/sam2, sam2/configs/sam2.1/sam2.1_hiera_b+.yaml (the default
# MASK_MODEL, sam2_base_plus): Hiera-B+ (embed 112, 2 heads doubling at each
# stage: head dim 56 throughout), stages 2-3-16-3, windows 8-4-14-7, global
# attention at blocks 12, 16 and 20, 1024² at patch stride 4; the 256-wide FPN
# and two-way mask decoder (8 heads, MLP 2048, 3 multimask outputs + 1)
SAM2_BASE_PLUS = {"embed_dim": 112, "num_heads": 2, "stages": [2, 3, 16, 3], "window_specs": [8, 4, 14, 7],
                  "global_att_blocks": [12, 16, 20], "img_size": 1024, "d_model": 256, "decoder_depth": 2,
                  "decoder_heads": 8, "decoder_mlp_dim": 2048, "num_multimask_outputs": 3}
# one launch a Hiera block, three a two-way block, the final token→image one
SAM2_LAUNCHES = sum(SAM2_BASE_PLUS["stages"]) + 3 * SAM2_BASE_PLUS["decoder_depth"] + 1
SAM2_TRACK_FRAMES = 10
# The mask logits with the kernel against the plain attention on the card
# (both f32 models): the kernel rounds q/k/v and P to bf16. The same rounding
# on the CPU at Hiera-B+ widths and 512² (tests/torch_sam2_bf16.py) reads
# 0.09% for the JAX module with bf16-rounded q/k/v against f32 and 0.21% for
# the port's plain bf16 route (P rounded too); the limit is about five times
# the larger, for 1024²'s longer key sets and the smoke run's weights.
SAM2_LOGITS_REL_L2 = 1e-2


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


_EMIT_LOCK = threading.Lock()


def emit(obj) -> None:
    line = json.dumps(obj)
    with _EMIT_LOCK:  # the CPU references emit from their worker thread
        print(line, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def make_tokenizer():
    """Byte-level BPE tokenizer built in code (the manifests' tokenizer files
    are not vendored; the token values do not change the work done)."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {chr(c): c for c in range(256)}
    vocab.update({f"<{i}>": 256 + i for i in range(64)})
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[], unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    return tok


def agreement(out, ref) -> dict:
    """How far ``out`` is from ``ref``, read against the limits above."""
    import torch

    d, r = out.float() - ref.float(), ref.float()
    max_err, max_ref = d.abs().max().item(), r.abs().max().item()
    rel_l2 = (torch.linalg.vector_norm(d) / torch.linalg.vector_norm(r)).item()
    return {"max_abs_err": max_err, "max_abs_ref": max_ref, "rel_l2": rel_l2,
            "tol": {"max_abs_err": MAX_ERR_OF_MAX_REF * max_ref, "rel_l2": REL_L2_TOL},
            "within": max_err <= MAX_ERR_OF_MAX_REF * max_ref and rel_l2 <= REL_L2_TOL}


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` single-call CUDA-event timings after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, calls: int = 20, warmup: int = 3) -> float:
    """Time per call of ``calls`` calls queued between one pair of CUDA events:
    the card's time alone, as in the denoise loop, where launches queue ahead
    of the card. ``time_ms`` also counts the host's work before each launch."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


# -- kernels ---------------------------------------------------------------------------


def qkv(b, sq, sk, h, d, seed):
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    mk = lambda s: torch.randn(b, s, h, d, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    return mk(sq), mk(sk), mk(sk)


def phase_kernels():
    import torch

    from apex_studio_tpu_torch.ops.attention import _prep_bias
    from apex_studio_tpu_torch.ops.attention.flash import flash_attention, flash_attention_reference

    cases = []

    def run_case(name, q, k, v, bias=None, causal=False, reference=None):
        out = flash_attention(q, k, v, bias=bias, is_causal=causal)
        torch.cuda.synchronize()
        ref = (reference(q, k, v) if reference is not None
               else flash_attention_reference(q, k, v, bias=bias, is_causal=causal))
        agree = agreement(out, ref)
        finite = bool(torch.isfinite(out.float()).all())
        cases.append({"case": name, "shape": list(q.shape), "sk": k.shape[1], "causal": causal,
                      "bias": bias is not None, **agree, "finite": finite,
                      "ok": finite and agree["within"]})
        return agree["max_abs_err"], ref

    s = FLUX_SHAPE
    q, k, v = qkv(s["b"], s["s"], s["s"], s["h"], s["d"], 0)
    flux_err, flux_ref = run_case("flux_1024px", q, k, v)
    # What three faults of a kernel would read against the limits at Flux's
    # shape: the last 64-key tile dropped; exp2 taken without log2 e (the
    # softmax at ln 2 of its scale); and query rows 64-127 of every 128-row
    # tile computed with the first 128-key tile replaced by the second (what a
    # consumer warpgroup that read a stale stage would give). Each must fall
    # outside them.
    stale_k, stale_v = k.clone(), v.clone()
    stale_k[:, :128], stale_v[:, :128] = k[:, 128:256], v[:, 128:256]
    upper = (torch.arange(s["s"], device="cuda") % 128) >= 64
    stale = flux_ref.clone()
    stale[:, upper] = flash_attention_reference(q[:, upper], stale_k, stale_v)
    probes = {
        "dropped_last_key_tile": flash_attention_reference(q, k[:, :-64], v[:, :-64]),
        "softmax_scale_times_ln2": flash_attention_reference(q, k, v, scale=s["d"] ** -0.5 * math.log(2)),
        "stale_tile_in_second_warpgroup": stale,
    }
    probes = {name: agreement(wrong, flux_ref) for name, wrong in probes.items()}
    emit({"phase": "tolerance_probes", "shape": list(q.shape), "probes": probes})
    check(not any(p["within"] for p in probes.values()),
          f"the kernel tolerance cannot see a faulty kernel: {probes}")
    del q, k, v, flux_ref, stale, stale_k, stale_v
    run_case("ragged_sq72_sk200", *qkv(2, 72, 200, 4, 128, 1))
    q, k, v = qkv(2, 96, 160, 4, 128, 2)
    lengths = torch.tensor([50, 0], device="cuda")  # batch 1: every key masked
    mask = torch.arange(160, device="cuda")[None, :] < lengths[:, None]
    run_case("key_padding_bias_row_fully_masked", q, k, v, bias=_prep_bias(None, mask))
    run_case("causal_s384_d64", *qkv(1, 384, 384, 4, 64, 3), causal=True)
    # The edges of the 128 x 128 tiles and of the two 64-row warpgroups.
    run_case("ragged_sq129_sk257", *qkv(1, 129, 257, 4, 128, 4))
    run_case("sq40_sk1", *qkv(2, 40, 1, 3, 128, 5))
    run_case("sk128_exact", *qkv(1, 200, 128, 4, 128, 6))
    run_case("sk129", *qkv(1, 200, 129, 4, 128, 7))
    run_case("ragged_sq129_sk257_d64", *qkv(2, 129, 257, 3, 64, 8))
    run_case("causal_s200_d128", *qkv(2, 200, 200, 3, 128, 9), causal=True)
    run_case("causal_s384_d128", *qkv(1, 384, 384, 4, 128, 10), causal=True)
    q, k, v = qkv(2, 150, 300, 4, 128, 11)
    shared = _prep_bias(None, torch.arange(300, device="cuda")[None, :] < 211)  # [1,1,1,Sk]
    run_case("bias_1_by_sk_batch_stride_0", q, k, v, bias=shared)
    g = torch.Generator("cuda").manual_seed(12)
    fused = torch.randn(2, 257, 3, 4, 128, generator=g, device="cuda").to(torch.bfloat16)
    run_case("views_of_fused_projection", fused[:, :, 0], fused[:, :, 1], fused[:, :, 2])
    # The first 128-key tile wholly masked by the bias: the running max starts
    # at -1e30 log2 e and must recover on the second tile.
    q, k, v = qkv(1, 130, 300, 4, 128, 13)
    late = _prep_bias(None, torch.arange(300, device="cuda")[None, :] >= 128)
    run_case("first_key_tile_bias_masked", q, k, v, bias=late)
    # ZImage (30 heads) and Qwen3's one-row decode (32 heads over the cache)
    for name, q, k, v, bias in zimage_kernel_inputs():
        run_case(name, q, k, v, bias=bias)
        del q, k, v
    # QwenImage (24 heads) at its joint lengths, ragged ones among them; the
    # plain version in query-row chunks
    for name, q, k, v, _ in qwenimage_kernel_inputs():
        run_case(name, q, k, v, reference=plain_in_row_chunks)
        del q, k, v
        release()
    # Wan (40 heads) self- and cross-attention at its three lengths
    for name, q, k, v, _ in wan_kernel_inputs():
        run_case(name, q, k, v, reference=lambda *a: plain_in_row_chunks(*a, rows=1024))
        del q, k, v
        release()
    # the Wan editing and causal paths' new shapes
    wan_edit_kernel_cases(run_case)
    # head dims other than 64 and 128 (SAM2's Hiera 56, Hiera-L's 72, Hiera-T/S's
    # 96, its decoder's 32 and 16): a ragged Sk across a tile edge, with and
    # without a [B, Sk] bias, and the non-contiguous views of a fused qkv
    # projection, bf16 and (as Hiera gives them) f32
    for d in (16, 32, 56, 72, 96):
        q, k, v = qkv(2, 130, 257, 4, d, 60 + d)
        run_case(f"d{d}_ragged_sq130_sk257", q, k, v)
        keep = torch.arange(257, device="cuda")[None, :] < torch.tensor([200, 77], device="cuda")[:, None]
        run_case(f"d{d}_ragged_sq130_sk257_bias_b2", q, k, v, bias=_prep_bias(None, keep))
        fused = torch.randn(2, 257, 3, 4, d, generator=g, device="cuda")
        fused_bf16 = fused.to(torch.bfloat16)
        run_case(f"d{d}_views_of_fused_projection", fused_bf16[:, :, 0], fused_bf16[:, :, 1], fused_bf16[:, :, 2])
        run_case(f"d{d}_views_of_fused_projection_f32", fused[:, :, 0], fused[:, :, 1], fused[:, :, 2])
    del q, k, v, fused, fused_bf16
    # the Flux editing and FLUX.2 joint lengths (24 and 48 heads), the plain
    # version in query-row chunks
    for name, q, k, v, _ in flux_edit_kernel_inputs():
        run_case(name, q, k, v, reference=plain_in_row_chunks)
        del q, k, v
        release()
    emit({"phase": "kernels", "cases": cases})
    bad = [c["case"] for c in cases if not c["ok"]]
    check(not bad, f"flash kernel disagrees with its plain version: {bad}")
    return flux_err, {c["case"]: c["max_abs_err"] for c in cases}


def zimage_kernel_inputs():
    """(case, q, k, v, bias) at the shapes the ZImage path gives the kernel:
    its main layers over 4096 image + 128 caption tokens, the noise refiner
    over 4096, the context refiner over a 128-token caption bucket (30 heads
    of 128, unmasked), and Qwen3's decode step: one query row of 32 heads over
    the KV cache with the valid prefix as a key-padding bias, at Sk = 300 and
    at a ragged Sk with a [B, Sk] bias."""
    import torch

    from apex_studio_tpu_torch.ops.attention import _prep_bias

    def prefix(sk, lengths):
        return _prep_bias(None, torch.arange(sk, device="cuda")[None, :] < torch.tensor(
            lengths, device="cuda")[:, None])

    yield ("zimage_layers_s4224_h30", *qkv(1, ZIMAGE_TOKENS + 128, ZIMAGE_TOKENS + 128, ZIMAGE_HEADS, 128, 30),
           None)
    yield ("zimage_noise_refiner_s4096_h30", *qkv(1, ZIMAGE_TOKENS, ZIMAGE_TOKENS, ZIMAGE_HEADS, 128, 31), None)
    yield ("zimage_caption_s128_h30", *qkv(1, 128, 128, ZIMAGE_HEADS, 128, 32), None)
    yield ("qwen3_decode_sq1_sk300_bias", *qkv(1, 1, 300, QWEN3_HEADS, 128, 33), prefix(300, [292]))
    yield ("qwen3_decode_sq1_sk437_bias_b2", *qkv(2, 1, 437, QWEN3_HEADS, 128, 34), prefix(437, [400, 437]))


def attention_bound(q, k, bias):
    """The least time attention over these inputs needs: the larger of
    4·H·Sq·D flops per (batch row, key) at the bf16 peak, and q and o, the
    bias and each batch row's K/V rows moved once at the memory rate. A key
    whose bias is the -1e30 mask (exp of it is 0) does no work and need not
    be read, so only the keys each batch row keeps count. D is the real head
    dim, the work the Pallas kernel does. Returns the bound, what binds it,
    flops, bytes, the keys counted, the bound over every key as launched, and
    that bound with the products at the kernel template's padded head dim
    (64 or 128; the padded columns are zeros in shared memory, not bytes
    moved)."""
    from apex_studio_tpu_torch.ops.attention.flash import padded_head_dim

    b, sq, h, d = q.shape
    sk = k.shape[1]
    kept = float(b * sk) if bias is None else float(
        (bias.reshape(bias.shape[0], -1) > -1e29).sum().item() * (b // bias.shape[0]))
    bias_bytes = bias.numel() * 4 if bias is not None else 0

    def bound(keys, d_ops=d):
        flops = 4.0 * h * sq * d_ops * keys
        # q read and o written once, each kept key's K and V rows read once
        nbytes = (2 * b * sq + 2 * keys) * h * d * q.element_size() + bias_bytes
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops, nbytes

    bound_ms, bound_by, flops, nbytes = bound(kept)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes, "keys_kept": kept,
            "bound_ms_as_launched": bound(float(b * sk))[0],
            "bound_ms_as_launched_padded": bound(float(b * sk), padded_head_dim(d))[0]}


# the keys of a timing row that the final kernels line carries
ROW_KEYS = ("case", "shape", "sk", "bias", "ms", "queued_ms", "plain_ms", "plain_rows", "bound_ms", "bound_by",
            "keys_kept", "bound_ms_as_launched", "bound_ms_as_launched_padded", "library_ms", "library_queued_ms")


def timing_row(case, q, k, v, bias=None, plain_rows=None, path=None) -> dict:
    """The kernel at one shape timed (single and queued) beside its plain
    version over its first ``plain_rows`` query rows (by default all, in
    1024-row chunks, or the first 128 above 2³³ score elements; 0 for none),
    ``scaled_dot_product_attention`` (the bias as its mask) and its bound;
    emitted and returned."""
    import torch.nn.functional as F

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    b, sq, h, _ = q.shape
    sk = k.shape[1]
    bias = None if bias is None else bias.reshape(bias.shape[0], -1)
    huge, big = sq * sk * h > 1 << 33, sq * sk > 1 << 22
    plain_rows = (128 if huge else sq) if plain_rows is None else plain_rows
    # a huge call takes 30-190 ms: 3 timed after 1 warm-up
    reps = 3 if huge else 10 if big else 25
    calls = 3 if huge else 20
    warm = 1 if huge else 3
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = library_mask(bias)
    kernel_ms = time_ms(lambda: flash_attention(q, k, v, bias=bias), reps=reps, warmup=warm)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), reps=reps, warmup=warm)
    plain_ms = (time_ms(lambda: plain_in_row_chunks(q[:, :plain_rows], k, v, rows=1024, bias=bias),
                        reps=3 if big else reps, warmup=1) if plain_rows else None)
    work = attention_bound(q, k, bias)
    row = {"phase": "timing", "path": path, "kernel": "flash_attention", "case": case, "shape": list(q.shape),
           "sk": sk, "bias": bias is not None, "ms": kernel_ms,
           "queued_ms": queued_ms(lambda: flash_attention(q, k, v, bias=bias), calls=calls, warmup=warm),
           "plain_ms": plain_ms, "plain_rows": plain_rows, "library_ms": library_ms,
           "library_queued_ms": queued_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                                          calls=calls, warmup=warm),
           "library_call": "torch.nn.functional.scaled_dot_product_attention", **work,
           "of_bound": work["bound_ms"] / kernel_ms, "vs_library": kernel_ms / library_ms,
           "tflops_achieved": work["flops"] / kernel_ms / 1e9, "blocks": -(-sq // 128) * b * h}
    row["queued_of_bound"] = work["bound_ms"] / row["queued_ms"]
    emit(row)
    return row


def timing_rows(inputs, path=None) -> list:
    """``timing_row`` at each of ``inputs``' shapes ((case, q, k, v, bias))."""
    rows = []
    for name, q, k, v, bias in inputs:
        rows.append(timing_row(name, q, k, v, bias, path=path))
        del q, k, v, bias
        release()
    return rows


def library_mask(bias):
    """A [B|1, Sk] additive bias as the library call's attn_mask: bf16
    [B, 1, 1, Sk] with rows 16-byte aligned."""
    import torch

    if bias is None:
        return None
    b, sk = bias.shape[0], bias.shape[-1]
    mask = torch.zeros(b, 1, 1, sk + (-sk) % 8, device="cuda", dtype=torch.bfloat16)[..., :sk]
    mask.copy_(bias.reshape(b, 1, 1, sk))
    return mask


def phase_timing():
    """Two rows at Flux's query length: the main path's shape against the plain
    version and the library call, and a ragged Sk with a [1, Sk] bias (tail and
    bias paths paid) against the library call alone; then the ZImage, Qwen3
    decode, QwenImage, Wan, Wan editing and Flux editing rows. Returns the
    first row and the later rows."""
    from itertools import chain

    import torch

    s = FLUX_SHAPE
    q, k, v = qkv(s["b"], s["s"], s["s"], s["h"], s["d"], 0)
    flux_row = timing_row("flux_1024px", q, k, v)
    sk = 4500
    bias = torch.zeros(1, sk, device="cuda")
    bias[:, 4400:] = -1e30  # the last 100 keys are padding
    timing_row(f"flux_ragged_sk{sk}_bias", q, k[:, :sk], v[:, :sk], bias, plain_rows=0)
    del q, k, v
    release()
    return flux_row, timing_rows(chain(zimage_kernel_inputs(), qwenimage_kernel_inputs(), wan_kernel_inputs(),
                                       wan_edit_kernel_inputs(), flux_edit_kernel_inputs()))


# -- tiny reference ----------------------------------------------------------------------


def phase_reference():
    """The tiny Flux DiT on the card in bf16 (flash kernel) against the same
    weights on the CPU in f32 (plain version)."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.transformers.flux import FluxConfig, FluxTransformer2DModel

    cfg = FluxConfig(in_channels=16, out_channels=16, num_layers=2, num_single_layers=2,
                     attention_head_dim=128, num_attention_heads=2, joint_attention_dim=64,
                     pooled_projection_dim=32, axes_dims_rope=(16, 56, 56))
    cpu = materialize_random(lambda: FluxTransformer2DModel(cfg, dtype=torch.float32),
                             torch.device("cpu"), seed=7, std=0.1)
    gpu = materialize_random(lambda: FluxTransformer2DModel(cfg, dtype=torch.bfloat16),
                             torch.device("cuda"), seed=7, std=0.1)
    gpu.load_state_dict(cpu.state_dict())  # cast to each parameter's dtype
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 64, 16)).astype(np.float32))
    txt = torch.from_numpy(rng.normal(size=(1, 20, 64)).astype(np.float32))
    pooled = torch.from_numpy(rng.normal(size=(1, 32)).astype(np.float32))
    t, g = torch.tensor([0.7]), torch.tensor([3.5])
    with torch.inference_mode():
        ref = cpu(x, txt, pooled, t, g, grid_hw=(8, 8))
        out = gpu(*(a.cuda() for a in (x, txt, pooled, t, g)), grid_hw=(8, 8)).float().cpu()
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    tol = 5e-2  # bf16 weights and activations through 4 blocks against f32
    emit({"phase": "reference", "model": "flux tiny (2+2 blocks, 2 heads of 128)",
          "max_rel_err": rel, "tol": tol, "finite": bool(torch.isfinite(out).all())})
    check(bool(torch.isfinite(out).all()) and rel <= tol,
          f"tiny Flux on the card disagrees with the CPU: {rel}")


# -- int8 / int4 residency ---------------------------------------------------------------


# rows, in, out: Flux Dev's resident Linear shapes at 1024px (image stream 4096
# rows, text stream 512, joined 4608 in the single blocks, adaLN on 1 row)
LINEAR_SHAPES = [
    (4608, 3072, 3072), (4608, 3072, 12288), (4608, 15360, 3072),
    (4096, 3072, 3072), (4096, 3072, 12288), (4096, 12288, 3072),
    (512, 3072, 3072), (512, 3072, 12288), (512, 12288, 3072),
    (1, 3072, 18432), (1, 3072, 9216), (1, 3072, 3072),
]


def resident_linear(k, n, bits, dtype, seed, device="cuda"):
    """A ``Linear`` built on ``meta`` and filled on ``device``; ``bits`` 8 or 4
    makes its weight resident whatever its size, ``None`` leaves it ``dtype``."""
    import torch

    from apex_studio_tpu_torch.models.layers import Linear
    from apex_studio_tpu_torch.quantize.residency import materialize_random_int4, materialize_random_int8

    with torch.device("meta"):
        lin = Linear(k, n, dtype=dtype)
    fill = materialize_random_int4 if bits == 4 else materialize_random_int8
    fill(lin, device=device, seed=seed, min_numel=1 if bits else 1 << 62)
    return lin.eval().requires_grad_(False)


def residency_exact():
    """(i) ``int_mm`` (``torch._int_mm`` behind the row padding) against the
    same product in float64, where every partial sum is an integer below 2**53
    and so exact. Also that the ``[out, in]`` weight goes in as a view: the
    memory one call adds beyond its s32 result stays far below the weight's
    size."""
    import torch

    from apex_studio_tpu_torch.models.layers import int_mm

    g = torch.Generator("cuda").manual_seed(0)
    cases = []
    for k in (3072, 15360):
        for n in (3072, 18432):
            w = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
            w64 = w.double()
            for m in (1, 16, 17, 512, 4608):
                a = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
                int_mm(a, w)  # the library's workspace, if it takes one, is taken here
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                out = int_mm(a, w)
                torch.cuda.synchronize()
                added = torch.cuda.max_memory_allocated() - before
                exact = (out.dtype == torch.int32 and tuple(out.shape) == (m, n)
                         and torch.equal(out.double(), a.double() @ w64.t()))
                beyond_output = added - 4 * max(m, 32 if m <= 16 else m) * n  # the s32 result, padded rows too
                cases.append({"m": m, "k": k, "n": n, "exact": bool(exact), "bytes_added": added,
                              "bytes_beyond_output": beyond_output, "weight_bytes": w.numel(),
                              "weight_copied": beyond_output >= w.numel() // 2})
                del out
            del w, w64
    emit({"phase": "residency", "check": "int_mm_exact", "reference": "float64 product", "cases": cases})
    check(all(c["exact"] for c in cases),
          f"int_mm is not exact at {[(c['m'], c['k'], c['n']) for c in cases if not c['exact']]}")
    check(not any(c["weight_copied"] for c in cases), "int_mm copies the weight")


def residency_against_cpu():
    """(ii) W8A8 and int4 Linears on the card against the same weights on the
    CPU in f32, at one row, 64 rows and a 3-D input."""
    import torch

    from apex_studio_tpu_torch.quantize.residency import apply_int4_residency, apply_int8_residency

    cases = []
    for bits in (8, 4):
        for shape, k, n in (((1,), 3072, 18432), ((64,), 3072, 3072), ((2, 40), 12288, 3072)):
            cpu = resident_linear(k, n, None, torch.float32, seed=bits + k, device="cpu")
            (apply_int4_residency if bits == 4 else apply_int8_residency)(cpu, min_numel=1)
            g = torch.Generator().manual_seed(n)
            x = torch.randn(*shape, k, generator=g).to(torch.bfloat16)
            with torch.inference_mode():
                ref = cpu(x.float())
            for dtype, tol in ((torch.float32, W8A8_REL_L2 if bits == 8 else F32_REL_L2),
                               (torch.bfloat16, BF16_REL_L2)):
                card = resident_linear(k, n, None, dtype, seed=0)
                card.set_quantized(cpu.weight.cuda(), cpu.weight_scale.cuda(), bits)
                card.bias.data.copy_(cpu.bias)
                with torch.inference_mode():
                    out = card(x.cuda())
                torch.cuda.synchronize()
                rel = rel_l2(out.cpu(), ref)
                cases.append({"bits": bits, "x": [*shape, k], "out": n, "compute": str(dtype)[6:],
                              "rel_l2": rel, "tol": tol, "max_abs_err": (out.cpu().float() - ref).abs().max().item(),
                              "ok": out.dtype == dtype and tuple(out.shape) == (*shape, n) and rel <= tol})
    emit({"phase": "residency", "check": "linear_card_vs_cpu_f32", "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    check(not bad, f"resident Linear on the card disagrees with the CPU: {bad}")


def residency_merges():
    """(iii) ``_merge8`` / ``_merge4`` on the card against the same arithmetic
    in numpy: scales to 1e-6 relative, values equal in 99.9% of entries and
    never more than one step apart."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.lora.manager import _merge4, _merge8

    rng = np.random.default_rng(0)
    n, k = 3072, 3072
    d = (rng.normal(size=(n, LORA_RANK)).astype(np.float32) * 0.01) @ (
        rng.normal(size=(LORA_RANK, k)).astype(np.float32) * 0.01) * np.float32(LORA_SCALE)
    s8 = np.full(n, 0.02 / np.sqrt(k) / 127, np.float32)
    q8 = rng.integers(-127, 128, size=(n, k), dtype=np.int8)
    packed = rng.integers(0, 256, size=(n // 2, k), dtype=np.uint8)
    s4 = np.full(n, 0.02 / np.sqrt(k) / 7, np.float32)

    def requantize(w, qmax, lo):
        absmax = np.abs(w).max(axis=1)
        new_s = np.where(absmax == 0, 1.0, absmax / np.float32(qmax)).astype(np.float32)
        return np.clip(np.rint(w / new_s[:, None]), lo, qmax).astype(np.int16), new_s

    ref8, ref_s8 = requantize(q8.astype(np.float32) * s8[:, None] + d, 127, -127)
    planes = np.concatenate([(packed & 0xF).astype(np.int8) - 8, (packed >> 4).astype(np.int8) - 8])
    ref4, ref_s4 = requantize(planes.astype(np.float32) * s4[:, None] + d, 7, -8)

    cuda = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    new8, new_s8 = _merge8(cuda(q8), cuda(s8), cuda(d))
    new4, new_s4 = _merge4(cuda(packed), cuda(s4), cuda(d))
    torch.cuda.synchronize()
    got4 = torch.cat([(new4 & 0xF).to(torch.int16) - 8, (new4 >> 4).to(torch.int16) - 8]).cpu().numpy()
    rows = []
    for name, got, ref, got_s, ref_s in (("merge8", new8.cpu().numpy().astype(np.int16), ref8, new_s8, ref_s8),
                                         ("merge4", got4, ref4, new_s4, ref_s4)):
        scale_err = float(np.abs(got_s.cpu().numpy() / ref_s - 1).max())
        equal, worst = float((got == ref).mean()), int(np.abs(got - ref).max())
        rows.append({"merge": name, "shape": [n, k], "equal_share": equal, "max_step_diff": worst,
                     "scale_rel_err": scale_err, "ok": equal >= 0.999 and worst <= 1 and scale_err <= 1e-6})
    emit({"phase": "residency", "check": "lora_merge_card_vs_numpy", "cases": rows})
    check(all(r["ok"] for r in rows), f"quantized LoRA merge disagrees with numpy: {rows}")


def residency_timing(shapes=LINEAR_SHAPES, phase="residency"):
    """(iv) One line per Linear shape (Flux's unless ``shapes`` says other):
    bf16 ``F.linear``, W8A8 whole and by pass, int4. Each is the time per call
    of 20 queued calls; the weight rotates through enough copies to exceed the
    50 MB L2, as in the model, where every call has its own weight."""
    import torch

    from apex_studio_tpu_torch.models.layers import int_mm, quantize_rows, rescale

    def rotating(mods, fn):
        turn = [0]

        def call():
            turn[0] += 1
            return fn(mods[turn[0] % len(mods)])
        return call

    rows = []
    for m, k, n in shapes:
        copies = min(8, max(2, -(-100_000_000 // (k * n))))
        plain, w8, w4 = ([resident_linear(k, n, bits, torch.bfloat16, seed=i) for i in range(copies)]
                         for bits in (None, 8, 4))
        g = torch.Generator("cuda").manual_seed(m)
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        with torch.inference_mode():
            xq, sx = quantize_rows(x)
            acc = int_mm(xq, w8[0].weight)
            t = {
                "bf16_ms": queued_ms(rotating(plain, lambda lin: lin(x))),
                "w8a8_ms": queued_ms(rotating(w8, lambda lin: lin(x))),
                "w8a8_quantize_ms": queued_ms(lambda: quantize_rows(x)),
                "w8a8_int_mm_ms": queued_ms(rotating(w8, lambda lin: int_mm(xq, lin.weight))),
                "w8a8_rescale_ms": queued_ms(lambda: rescale(acc, sx, w8[0].weight_scale, torch.bfloat16)),
                "w4_ms": queued_ms(rotating(w4, lambda lin: lin(x))),
            }
        ops = 2.0 * m * k * n
        io = 2 * m * k + 2 * m * n + 2 * n  # x in, y out, bias: bf16
        bounds = {}
        for name, peak, weight_bytes in (("bf16", PEAK_BF16_FLOPS, 2 * k * n),
                                         ("int8", PEAK_INT8_OPS, k * n + 4 * n),
                                         ("int4", PEAK_BF16_FLOPS, k * n // 2 + 4 * n)):
            t_ops, t_bytes = ops / peak * 1e3, (io + weight_bytes) / PEAK_BYTES * 1e3
            bounds[f"{name}_bound_ms"] = max(t_ops, t_bytes)
            bounds[f"{name}_bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        row = {"phase": phase, "check": "linear_timing", "rows": m, "in": k, "out": n,
               "weight_copies": copies, **t, **bounds,
               "int8_tops_achieved": ops / t["w8a8_int_mm_ms"] / 1e9,
               "bf16_tflops_achieved": ops / t["bf16_ms"] / 1e9}
        emit(row)
        rows.append(row)
        del plain, w8, w4, x, xq, sx, acc
        release()
    return rows


def phase_residency():
    residency_exact()
    release()
    residency_against_cpu()
    residency_merges()
    release()
    return residency_timing()


# -- checkpoints -------------------------------------------------------------------------


def phase_checkpoint(home: Path):
    """Write a Flux DiT (full width, 2 double + 2 single blocks, bf16) in the
    BFL single-file naming and the full Flux VAE (f32) in diffusers naming,
    then load both through the engine's checkpoint branch."""
    import torch
    import yaml

    from apex_studio_tpu_torch.engine import UniversalEngine
    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.loaders.export import flux_bfl_state_dict, published_state_dict
    from apex_studio_tpu_torch.loaders.safetensors_io import safetensors_keys, save_safetensors
    from apex_studio_tpu_torch.models.transformers.flux import FluxConfig, FluxTransformer2DModel
    from apex_studio_tpu_torch.models.vaes.autoencoder_kl import AutoencoderKL, AutoencoderKLConfig
    from apex_studio_tpu_torch.quantize.residency import apply_int8_residency

    root = home / "checkpoint"
    root.mkdir()
    depth = {"num_layers": 2, "num_single_layers": 2}
    dit = materialize_random(lambda: FluxTransformer2DModel(FluxConfig(**depth), dtype=torch.bfloat16),
                             torch.device("cuda"), seed=11)
    vae = materialize_random(lambda: AutoencoderKL(AutoencoderKLConfig(), dtype=torch.float32),
                             torch.device("cuda"), seed=12)
    t0 = time.perf_counter()
    save_safetensors(root / "flux1-dev.safetensors", flux_bfl_state_dict(dit.state_dict()))
    save_safetensors(root / "vae.safetensors", published_state_dict("autoencoder_kl", vae.state_dict()))
    write_s = time.perf_counter() - t0
    keys = safetensors_keys(root / "flux1-dev.safetensors")
    check("model.diffusion_model.double_blocks.0.img_attn.qkv.weight" in keys
          and "model.diffusion_model.single_blocks.1.linear1.weight" in keys,
          "the DiT checkpoint is not in the BFL single-file naming")

    doc = yaml.safe_load(MANIFEST.read_text())
    for comp in doc["spec"]["components"]:
        if comp["type"] == "transformer":
            comp.pop("config_path", None)
            comp.update(config=dict(depth), model_path=str(root / "flux1-dev.safetensors"))
        elif comp["type"] == "vae":
            comp.pop("config_path", None)
            comp.update(config={"latent_channels": 16}, precision="fp32",
                        model_path=str(root / "vae.safetensors"))
    (root / "manifest.yml").write_text(yaml.safe_dump(doc))

    os.environ.pop("APEX_SYNTHETIC_WEIGHTS", None)  # the checkpoint branch
    os.environ["APEX_HOME_DIR"] = str(root)
    engine = UniversalEngine(root / "manifest.yml", device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.load_component_by_type("transformer")  # strict: raises on a missing or unexpected key
    engine.load_component_by_type("vae")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    def same_state(loaded, source, name):
        got, want = loaded.state_dict(), source.state_dict()
        check(sorted(got) == sorted(want), f"{name}: loaded keys differ from the written module's")
        wrong = [k for k in want if got[k].dtype != want[k].dtype or got[k].device != want[k].device
                 or not torch.equal(got[k], want[k])]
        check(not wrong, f"{name}: parameters differ after loading: {wrong[:5]}")
        return len(want), sum(t.numel() for t in want.values())

    n_dit, params_dit = same_state(engine.transformer, dit, "DiT")
    n_vae, params_vae = same_state(engine.vae, vae, "VAE")

    g = torch.Generator("cuda").manual_seed(3)
    rand = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    args = (rand(1, 4096, 64), rand(1, 512, 4096), rand(1, 768),
            torch.tensor([0.7], device="cuda"), torch.tensor([3.5], device="cuda"))
    z = rand(1, 16, 32, 32)
    with torch.inference_mode():
        direct = dit(*args, grid_hw=(64, 64))
        loaded = engine.transformer(*args, grid_hw=(64, 64))
        vae_same = torch.equal(engine.vae.decode(z), vae.decode(z))
        dit_same = torch.equal(loaded, direct)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resident = apply_int8_residency(engine.transformer)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        w8a8 = engine.transformer(*args, grid_hw=(64, 64))
        os.environ["APEX_INT8_COMPUTE"] = "0"
        try:
            dequant = engine.transformer(*args, grid_hw=(64, 64))
        finally:
            del os.environ["APEX_INT8_COMPUTE"]
    torch.cuda.synchronize()
    row = {"phase": "checkpoint", "dit_tensors": n_dit, "dit_parameters": params_dit,
           "vae_tensors": n_vae, "vae_parameters": params_vae, "file_keys": len(keys),
           "file_gib": (root / "flux1-dev.safetensors").stat().st_size / 2**30,
           "seconds_write": write_s, "seconds_load": load_s, "parameters_bit_equal": True,
           "dit_forward_equal": dit_same, "vae_decode_equal": vae_same,
           "int8_resident_weights": resident, "seconds_int8_residency": quantize_s,
           "finite": bool(torch.isfinite(w8a8.float()).all()),
           "w8a8_vs_dequant_rel_l2": rel_l2(w8a8, dequant), "tol": W8A8_VS_DEQUANT,
           "w8a8_vs_bf16_rel_l2": rel_l2(w8a8, direct), "dequant_vs_bf16_rel_l2": rel_l2(dequant, direct)}
    emit(row)
    check(dit_same, "the loaded DiT's forward differs from the written module's")
    check(vae_same, "the loaded VAE's decode differs from the written module's")
    check(resident > 0 and row["finite"], "int8 residency of the loaded DiT failed")
    check(row["w8a8_vs_dequant_rel_l2"] <= W8A8_VS_DEQUANT,
          f"W8A8 is {row['w8a8_vs_dequant_rel_l2']} from the dequant path")
    shutil.rmtree(root, ignore_errors=True)
    del engine, dit, vae, direct, loaded, w8a8, dequant
    release()


# -- main path ---------------------------------------------------------------------------


def rel_l2(out, ref) -> float:
    import torch

    return (torch.linalg.vector_norm(out.float() - ref.float())
            / torch.linalg.vector_norm(ref.float())).item()


def release() -> None:
    """Hand the memory of what the caller has dropped back to the card."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def write_flux_lora(path: Path) -> int:
    """A rank-16 PEFT-named LoRA on q/k/v of the 19 double blocks (57
    adapters), seeded; returns the adapter count."""
    import numpy as np

    from apex_studio_tpu_torch.loaders.safetensors_io import save_safetensors

    rng = np.random.default_rng(0)
    sd = {}
    for i in range(LORA_BLOCKS):
        for proj in ("to_q", "to_k", "to_v"):
            base = f"transformer_blocks.{i}.attn.{proj}"
            sd[f"{base}.lora_A.weight"] = rng.normal(size=(LORA_RANK, 3072)).astype(np.float32) * 0.01
            sd[f"{base}.lora_B.weight"] = rng.normal(size=(3072, LORA_RANK)).astype(np.float32) * 0.01
    save_safetensors(path, sd)
    return len(sd) // 2


def drive(label: str, weights: str, requests, steps: int, home: Path, lora: Path = None,
          tally_request: int = None):
    """Requests through ``UniversalEngine`` with synthetic ``weights``
    (``bf16`` / ``int8`` / ``int4``), each with the kernels' launch counts set
    to 0 before and read after. ``lora`` goes in as a request LoRA and is
    merged when the transformer loads. Request ``tally_request`` (1-based)
    counts the transformer's Linear calls by shape through forward hooks."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine import UniversalEngine
    from apex_studio_tpu_torch.models.layers import Linear
    from apex_studio_tpu_torch.ops.attention.flash import flash_attention
    from apex_studio_tpu_torch.quantize.residency import count_resident

    os.environ["APEX_SYNTHETIC_WEIGHTS"] = weights
    os.environ["APEX_HOME_DIR"] = str(home / label)  # its own T5 disk cache
    selected = {"loras": [{"source": str(lora), "scale": LORA_SCALE}]} if lora else None
    engine = UniversalEngine(MANIFEST, device="cuda", selected_components=selected)
    tok = make_tokenizer()
    for spec in engine.component_specs.values():
        if spec.get("type") == "text_encoder":
            spec["tokenizer"] = tok

    # Observe the latents the engine hands to the VAE (finite check) without
    # changing the path: the VAE loads first, as the engine's run would load it.
    engine.load_component_by_type("vae")
    decode = engine.vae.decode
    latents_finite = []

    def observed_decode(z):
        latents_finite.append(bool(torch.isfinite(z).all()))
        return decode(z)

    engine.vae.decode = observed_decode

    apply_loras, lora_seconds = engine._apply_loras, []

    def timed_apply_loras(model, family):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        apply_loras(model, family)
        torch.cuda.synchronize()
        lora_seconds.append(time.perf_counter() - t0)

    engine._apply_loras = timed_apply_loras

    results, frames_out = [], []
    for i, (prompt, seed) in enumerate(requests):
        stamps = {}

        def progress(p, message, *_a, **_k):
            torch.cuda.synchronize()
            stamps.setdefault(message, time.perf_counter())

        tally, hooks = {}, []
        if tally_request == i + 1 and engine.transformer is not None:
            def count(mod, args, out):
                x = args[0]
                mode = "bf16" if mod.weight_scale is None else f"int{mod.weight_bits}"
                key = (x.numel() // x.shape[-1], x.shape[-1], out.shape[-1], mode)
                tally[key] = tally.get(key, 0) + 1

            hooks = [m.register_forward_hook(count) for m in engine.transformer.modules()
                     if isinstance(m, Linear)]
        latents_finite.clear()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        frames = engine.run(prompt=prompt, height=SIZE, width=SIZE, num_inference_steps=steps,
                            guidance_scale=3.5, seed=seed, progress_callback=progress)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = flash_attention.launches
        for h in hooks:
            h.remove()

        step_t = [stamps[f"Denoising step {j}/{steps}"] for j in range(1, steps + 1)]
        per_step = [b - a for a, b in zip([stamps["Timesteps computed"]] + step_t[:-1], step_t)]
        row = {
            "phase": label, "weights": weights, "request": i + 1, "prompt": prompt[:40], "seed": seed,
            "seconds_total": total,
            "seconds_encode": stamps["Encoded prompts"] - stamps["Encoding prompts"],
            "seconds_load_transformer": stamps["Initialized latent noise"] - stamps["Encoded prompts"],
            "seconds_per_step": per_step,
            "seconds_decode": stamps["Completed t2i pipeline"] - stamps["Denoising complete"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "flash_launches": launches, "flash_launches_expected": BLOCKS * steps,
            "frames": [list(f.shape) for f in frames], "latents_finite": latents_finite,
            "card": torch.cuda.get_device_name(0),
        }
        if hooks:
            row["linear_hooks_on"] = True  # this request's step times carry the hooks' host cost
            row["linear_calls_per_step"] = [
                {"rows": m, "in": k, "out": n, "weights": mode, "calls": c / steps}
                for (m, k, n, mode), c in sorted(tally.items(), key=lambda kv: -kv[1])]
        if i == 0:
            row["resident_weights"] = count_resident(engine.transformer)
            row["seconds_lora_merge"] = sum(lora_seconds)
            row["loras"] = [{"scale": r["scale"], "applied": r["applied"], "skipped": len(r["skipped"])}
                            for r in engine.lora_results]
        emit(row)
        check(len(frames) == 1 and frames[0].shape == (SIZE, SIZE, 3) and frames[0].dtype == np.uint8,
              f"{label} request {i + 1}: bad frames {row['frames']}")
        check(latents_finite == [True], f"{label} request {i + 1}: latents not finite")
        check(launches == BLOCKS * steps,
              f"{label} request {i + 1}: flash launched {launches} times, expected {BLOCKS * steps}")
        results.append(row)
        frames_out.append(frames[0])
    return results, frames_out, engine


def phase_main(home: Path):
    """The main path: int8-resident weights computed W8A8, a rank-16 LoRA
    merged into them at load, three requests."""
    import numpy as np

    lora = home / "style_rank16.safetensors"
    adapters = write_flux_lora(lora)
    rows, frames, engine = drive("main", "int8", [(PROMPT_A, 0), (PROMPT_B, 1), (PROMPT_A, 0)],
                                 STEPS, home, lora=lora, tally_request=2)
    first = rows[0]
    check(first["loras"] == [{"scale": LORA_SCALE, "applied": adapters, "skipped": 0}] and adapters == 57,
          f"LoRA merge: {first['loras']}, expected {adapters} applied and 0 skipped")
    check(first["resident_weights"] > 0, "no weight of the transformer is int8-resident")
    quantized_calls = sum(c["calls"] for c in rows[1]["linear_calls_per_step"] if c["weights"] == "int8")
    check(quantized_calls > 0, "the main path ran no int8 Linear")
    same = bool(np.array_equal(frames[0], frames[2]))
    differ = not np.array_equal(frames[0], frames[1])
    emit({"phase": "main", "requests_1_3_identical": same, "requests_1_2_differ": differ,
          "int8_linear_calls_per_step": quantized_calls})
    check(same, "requests 1 and 3 (same prompt and seed) differ")
    check(differ, "requests 1 and 2 (other prompt and seed) are identical")
    return rows, engine


def kernel_class(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return "flash_attention"
    if any(tag in name.lower() for tag in ("gemm", "xmma", "nvjet", "cutlass", "wgmma")):
        return "gemm"
    if name.startswith(("Memcpy", "Memset")):
        return "memcpy_memset"
    return "other"


W8A8_PASSES = ("quantize_rows", "int_mm", "rescale")


def phase_trace(engine):
    """One more request on the main path's engine (prompt A, seed 0: T5 from
    the disk cache, latents returned, no decode) under torch.profiler: device
    time by kernel class, by W8A8 pass (each pass of models/layers.py runs
    inside a named profiler range for the length of this phase, and a kernel
    that starts inside a range counts for that pass), the top kernels, and the
    device's idle share between its first and last kernel."""
    import functools

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from apex_studio_tpu_torch.models import layers

    def ranged(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with record_function(f"w8a8.{name}"):
                return fn(*args, **kwargs)
        return call

    passes = {name: getattr(layers, name) for name in W8A8_PASSES}
    try:
        for name, fn in passes.items():
            setattr(layers, name, ranged(name, fn))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.run(prompt=PROMPT_A, height=SIZE, width=SIZE, num_inference_steps=STEPS,
                       guidance_scale=3.5, seed=0, return_latents=True)
            torch.cuda.synchronize()
    finally:
        for name, fn in passes.items():
            setattr(layers, name, fn)
    device = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    # a named range shows on the device too, from its first kernel to its last
    ranges = sorted((start, end, name) for name, start, end in device if name.startswith("w8a8."))
    spans = [d for d in device if not d[0].startswith("w8a8.")]
    if not spans:
        emit({"phase": "trace", "result": "not measured: the profiler recorded no device kernel"})
        return
    starts = [r[0] for r in ranges]
    by_class, by_name = {}, {}
    for name, start, end in spans:
        c = kernel_class(name)
        i = bisect.bisect_right(starts, start + 0.5) - 1  # timestamps are microseconds
        if i >= 0 and start < ranges[i][1] + 0.5:
            c = ranges[i][2]  # launched by a W8A8 pass, whatever the kernel
        by_class[c] = by_class.get(c, 0.0) + (end - start)
        n, total = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, total + (end - start))
    busy, last = 0.0, None  # union of kernel intervals (us)
    for _, start, end in sorted(spans, key=lambda x: x[1]):
        if last is None or start >= last:
            busy += end - start
            last = end
        elif end > last:
            busy += end - last
            last = end
    window = max(e for _, _, e in spans) - min(s for _, s, _ in spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:14]
    emit({"phase": "trace", "weights": os.environ.get("APEX_SYNTHETIC_WEIGHTS"),
          "window_ms": window / 1e3, "busy_ms": busy / 1e3,
          "idle_share": 1.0 - busy / window, "kernels": len(spans),
          "w8a8_ranges_on_device": len(ranges),
          "ms_by_class": {c: t / 1e3 for c, t in sorted(by_class.items())},
          "share_of_busy": {c: t / busy for c, t in sorted(by_class.items())},
          "top_kernels": [{"name": n[:90], "calls": c, "ms": t / 1e3} for n, (c, t) in top]})


# -- HunyuanVideo 1.5 i2v ------------------------------------------------------------------


def hyv15_kernel_inputs():
    """(case, q, k, v, bias) at the HunyuanVideo 1.5 path's three shapes, 16
    heads of 128: the joint attention at 121 and 33 frames (unmasked) and the
    token refiner's over the 1000 Qwen2.5-VL slots with its text mask as a
    [1, Sk] bias (612 kept). ``path_kernel_rows`` holds the joint lengths on
    query-row subsets: the plain version's f32 scores at 113,457 tokens would
    take 824 GB."""
    for i, (name, s, kept) in enumerate((("hyv15_joint_121f", HYV15_TOKENS[121], None),
                                         ("hyv15_joint_33f", HYV15_TOKENS[33], None),
                                         ("hyv15_refiner", HYV15_MLLM_TOKENS, 612))):
        yield (name, *qkv(1, s, s, HYV15_HEADS, 128, 20 + i),
               None if kept is None else text_bias(s, s, kept))


def write_byt5_config(home: Path, manifest: Path = HYV15_MANIFEST) -> None:
    """byT5-small's published config.json where the manifest's glyph encoder
    names it (components/<config_path>); the other components' family
    defaults are their published configs."""
    import yaml

    doc = yaml.safe_load(manifest.read_text())
    spec = next(c for c in doc["spec"]["components"] if c.get("name") == "text_encoder_2")
    path = home / "components" / spec["config_path"]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(BYT5_SMALL))


def phase_hyv15(home: Path):
    """HunyuanVideo 1.5 i2v through ``UniversalEngine`` from its manifest at
    full width, ``HYV15_LAYERS`` of its 54 blocks, synthetic int8 weights: two identical 33-frame
    requests decoded through the tiled path, one preview through the TAE,
    then one request at 121 frames (latents returned)."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine import UniversalEngine
    from apex_studio_tpu_torch.models.layers import Linear
    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    kernel_rows, kernel_err = path_kernel_rows("hyv15", hyv15_kernel_inputs())
    label = "hyv15"
    os.environ["APEX_SYNTHETIC_WEIGHTS"] = "int8"
    os.environ["APEX_HOME_DIR"] = str(home / label)
    write_byt5_config(home / label)
    write_manifest_config(home / label, HYV15_MANIFEST, "transformer", {"num_layers": HYV15_LAYERS})
    engine = UniversalEngine(HYV15_MANIFEST, device="cuda")
    tok = make_tokenizer()
    for spec in engine.component_specs.values():
        if spec.get("type") == "text_encoder":
            spec["tokenizer"] = tok
    (height, width), (t_scale, s_scale) = HYV15_SIZE, HYV15_SCALES
    image = np.random.default_rng(0).integers(0, 256, size=(height, width, 3), dtype=np.uint8)

    decoded = []
    decode = engine.decode_latents

    def observed_decode(z):
        decoded.append(z.detach().clone())
        return decode(z)

    engine.decode_latents = observed_decode

    rows, frames_by_request = [], []
    for i, frames_n in enumerate(HYV15_FRAMES):
        steps_n = HYV15_LONG_STEPS if i == 2 else HYV15_STEPS
        stamps, peaks, tally, hooks = {}, {}, {}, []
        last = [None]

        def progress(p, message, *_a, **_k):
            torch.cuda.synchronize()
            now = time.perf_counter()
            stamps.setdefault(message, now)
            if last[0] is not None:  # the peak of the stage that ends here
                peaks[last[0]] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            last[0] = message
            if message == "Components ready" and i == 2:
                def count(mod, args, out):
                    mode = "bf16" if mod.weight_scale is None else f"int{mod.weight_bits}"
                    key = (args[0].numel() // args[0].shape[-1], args[0].shape[-1], out.shape[-1], mode)
                    tally[key] = tally.get(key, 0) + 1
                hooks.extend(m.register_forward_hook(count) for m in engine.transformer.modules()
                             if isinstance(m, Linear))

        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        out = engine.run(prompt=HYV15_PROMPT, negative_prompt="", image=image, height=height, width=width,
                         num_frames=frames_n, num_inference_steps=steps_n, guidance_scale=6.0,
                         seed=42, progress_callback=progress, return_latents=i == 2)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = flash_attention.launches
        for h in hooks:
            h.remove()
        steps = [stamps[f"Denoising step {j}/{steps_n}"] for j in range(1, steps_n + 1)]
        per_step = [b - a for a, b in zip([stamps["Timesteps computed; starting denoise"]] + steps[:-1], steps)]
        grid = [(frames_n - 1) // t_scale + 1, height // s_scale, width // s_scale]
        row = {
            "phase": label, "weights": "int8", "request": i + 1, "frames_requested": frames_n,
            "latent_grid": grid, "tokens": math.prod(grid) + HYV15_CONTEXT_TOKENS,
            "seconds_total": total,
            "seconds_encode_mllm": stamps["Encoded mllm prompts"] - stamps["Starting pipeline"],
            "seconds_load": stamps["Components ready"] - stamps["Encoded mllm prompts"],
            "seconds_conditioning": stamps["Initialized latent noise"] - stamps["Components ready"],
            "seconds_denoise": stamps["Denoising complete"] - stamps["Timesteps computed; starting denoise"],
            "seconds_per_step": per_step,
            "peak_gib_by_stage": peaks, "peak_gib": max(peaks.values()),
            "flash_launches": launches, "flash_launches_expected": HYV15_LAUNCHES_PER_STEP * steps_n,
            "card": torch.cuda.get_device_name(0),
        }
        if i == 2:
            check(tuple(out.shape) == (1, engine.transformer.cfg.out_channels, *grid)
                  and bool(torch.isfinite(out).all()),
                  f"hyv15 request {i + 1}: latents {tuple(out.shape)} not finite or misshapen")
            median = statistics.median(per_step[1:]) if len(per_step) > 1 else per_step[0]
            row.update({"median_seconds_per_step_after_the_first": median,
                        "seconds_per_frame_at_50_steps": median * 50 / frames_n,
                        "linear_hooks_on": True,
                        "linear_calls_per_step_by_weights": {
                            mode: sum(c for (_, _, _, m), c in tally.items() if m == mode) / steps_n
                            for mode in sorted({k[3] for k in tally})},
                        "linear_calls_per_step": [
                            {"rows": m, "in": k, "out": n, "weights": mode, "calls": c / steps_n}
                            for (m, k, n, mode), c in sorted(tally.items(), key=lambda kv: -kv[1])]})
        else:
            row.update({"seconds_decode": stamps["Completed pipeline"] - stamps["Denoising complete"],
                        "frames": len(out), "frame_shape": list(out[0].shape), "frame_dtype": str(out[0].dtype),
                        "latents_finite": bool(torch.isfinite(decoded[-1]).all())})
            check(len(out) == frames_n and all(f.shape == (height, width, 3) and f.dtype == np.uint8 for f in out),
                  f"hyv15 request {i + 1}: {len(out)} frames of {out[0].shape}, expected {frames_n} of "
                  f"{height}x{width}x3")
            check(row["latents_finite"], f"hyv15 request {i + 1}: latents not finite")
            frames_by_request.append(out)
        emit(row)
        check(launches == HYV15_LAUNCHES_PER_STEP * steps_n,
              f"hyv15 request {i + 1}: flash launched {launches} times, expected "
              f"{HYV15_LAUNCHES_PER_STEP * steps_n}")
        if i == 1:
            same_latents = torch.equal(decoded[0], decoded[1])
            same_frames = all(np.array_equal(a, b) for a, b in zip(*frames_by_request))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            preview = engine.preview_frames(decoded[1])
            torch.cuda.synchronize()
            emit({"phase": label, "requests_1_2_identical_latents": same_latents,
                  "requests_1_2_identical_frames": same_frames, "preview_through": type(
                      engine._get_preview_vae()).__name__, "preview_frames": len(preview),
                  "preview_frame_shape": list(preview[0].shape), "seconds_preview": time.perf_counter() - t0})
            check(same_latents and same_frames, "hyv15 requests 1 and 2 (same image, prompt, seed) differ")
            vae_tile_precision(engine.vae, decoded[1][..., :8, :8].contiguous())
            check(type(engine._get_preview_vae()).__name__ == "TAEVAE" and len(preview) == frames_n,
                  f"hyv15 preview: {len(preview)} frames, expected {frames_n}")
            del frames_by_request[:], preview
        rows.append(row)
    del engine, out, decoded, decode  # the bound method holds the engine
    release()
    t2v_row, t2v_frames = hyv15_t2v_request(home)
    release()
    linear_rows = residency_timing(list(HYV15_LINEAR_CALLS), phase=label)
    step = rows[2]["median_seconds_per_step_after_the_first"]
    joint = next(r for r in kernel_rows if r["case"] == "hyv15_joint_121f")
    refiner = next(r for r in kernel_rows if r["case"] == "hyv15_refiner")
    attention_s = (2 * HYV15_LAYERS * joint["queued_ms"] + 2 * 2 * refiner["queued_ms"]) / 1e3
    linear_s = sum(HYV15_LINEAR_CALLS[(r["rows"], r["in"], r["out"])] * r["w8a8_ms"] for r in linear_rows) / 1e3
    emit({"phase": label, "step_breakdown_121_frames": {
        "seconds_per_step": step, "attention_seconds": attention_s, "w8a8_linear_seconds": linear_s,
        "other_seconds": step - attention_s - linear_s, "attention_share": attention_s / step,
        "w8a8_linear_share": linear_s / step,
        "reckoning": "queued kernel ms x 108 joint + 4 refiner calls; queued W8A8 ms x calls by shape"}})
    return rows + [t2v_row], kernel_rows, kernel_err, t2v_frames


def hyv15_t2v_request(home: Path):
    """One 33-frame 720x1280 request through the t2v manifest's own engine
    (synthetic int8 weights, CFG 6.0, ``HYV15_STEPS``), decoded; its frames go on
    to the rife phase."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine import UniversalEngine
    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    label, frames_n, (height, width) = "hyv15_t2v", HYV15_FRAMES[0], HYV15_SIZE
    os.environ["APEX_SYNTHETIC_WEIGHTS"] = "int8"
    os.environ["APEX_HOME_DIR"] = str(home / label)
    write_byt5_config(home / label, HYV15_T2V_MANIFEST)
    write_manifest_config(home / label, HYV15_T2V_MANIFEST, "transformer", {"num_layers": HYV15_LAYERS})
    engine = UniversalEngine(HYV15_T2V_MANIFEST, device="cuda")
    tok = make_tokenizer()
    for spec in engine.component_specs.values():
        if spec.get("type") == "text_encoder":
            spec["tokenizer"] = tok
    stamps, peaks, last = {}, {}, [None]

    def progress(p, message, *_a, **_k):
        torch.cuda.synchronize()
        stamps.setdefault(message, time.perf_counter())
        if last[0] is not None:  # the peak of the stage that ends here
            peaks[last[0]] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        last[0] = message

    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    frames = engine.run(prompt=HYV15_PROMPT, negative_prompt="", height=height, width=width,
                        num_frames=frames_n, num_inference_steps=HYV15_STEPS, guidance_scale=6.0, seed=42,
                        progress_callback=progress)
    torch.cuda.synchronize()
    total, launches = time.perf_counter() - t0, flash_attention.launches
    steps = [stamps[f"Denoising step {j}/{HYV15_STEPS}"] for j in range(1, HYV15_STEPS + 1)]
    row = {"phase": "hyv15", "request": "t2v", "manifest": HYV15_T2V_MANIFEST.name, "weights": "int8",
           "frames_requested": frames_n, "seconds_total": total,
           "seconds_encode_mllm": stamps["Encoded mllm prompts"] - stamps["Starting pipeline"],
           "seconds_load": stamps["Components ready"] - stamps["Encoded mllm prompts"],
           "seconds_denoise": stamps["Denoising complete"] - stamps["Timesteps computed; starting denoise"],
           "seconds_per_step": [b - a for a, b in zip(
               [stamps["Timesteps computed; starting denoise"]] + steps[:-1], steps)],
           "seconds_decode": stamps["Completed pipeline"] - stamps["Denoising complete"],
           "peak_gib_by_stage": peaks, "peak_gib": max(peaks.values()), "frames": len(frames),
           "frame_shape": list(frames[0].shape), "flash_launches": launches,
           "flash_launches_expected": HYV15_LAUNCHES_PER_STEP * HYV15_STEPS}
    emit(row)
    check(len(frames) == frames_n and all(f.shape == (height, width, 3) and f.dtype == np.uint8 for f in frames),
          f"hyv15 t2v: {len(frames)} frames of {frames[0].shape}, expected {frames_n} of {height}x{width}x3")
    check(launches == HYV15_LAUNCHES_PER_STEP * HYV15_STEPS,
          f"hyv15 t2v: flash launched {launches} times, expected {HYV15_LAUNCHES_PER_STEP * HYV15_STEPS}")
    del engine
    return row, frames


def vae_tile_precision(vae, z_denoised) -> dict:
    """One 8x8-latent tile of the tiled decode on the card as the engine runs
    it (timed), against the same VAE in float64 (its norms and attention
    upcast to f32 by design). The engine builds the VAE in the manifest's
    component dtype, which both packages resolve to bf16 here (the manifest
    declares fp32 per weight variant): bf16 keeps 8 mantissa bits, so the
    tile is held to 2e-2 relative through its some forty convolutions. Held
    on seeded normal latents; the request's denoised latents are read beside
    them. The tile's convolution FLOP are counted from the shapes the
    convolutions see."""
    import copy

    import torch

    from apex_studio_tpu_torch.models.vaes.hunyuanvideo15_vae import CausalConv3dRep

    g = torch.Generator("cuda").manual_seed(6)
    tiles = {"seeded_normal": torch.randn(z_denoised.shape, generator=g, device="cuda"),
             "denoised": z_denoised}
    flops = [0]

    def count(mod, args, out):
        flops[0] += 2 * out.numel() * mod.weight[0].numel()

    convs = [m for m in vae.modules() if isinstance(m, CausalConv3dRep)]
    row = {"phase": "hyv15", "check": "vae_tile_vs_float64", "tile_latents": list(z_denoised.shape),
           "compute_dtype": str(convs[0].dtype), "parameter_dtype": str(convs[0].weight.dtype), "tol": 2e-2}
    with torch.inference_mode():
        hooks = [m.register_forward_hook(count) for m in convs]
        outs = {name: vae.decode(z) for name, z in tiles.items()}
        for h in hooks:
            h.remove()
        row["conv_flops"] = flops[0] // len(tiles)
        for name, z in tiles.items():
            ms = time_ms(lambda: vae.decode(z), reps=3, warmup=1)
            row[name] = {"tile_ms": ms, "conv_tflops_reckoned": row["conv_flops"] / ms / 1e9}
        vae64 = copy.deepcopy(vae).double()
        for m in vae64.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
        for name, z in tiles.items():
            row[name]["rel_l2_vs_float64"] = rel_l2(outs[name].double(), vae64.decode(z.double()))
    del vae64, outs
    release()
    emit(row)
    check(row["seeded_normal"]["rel_l2_vs_float64"] <= 2e-2,
          f"the VAE's decode is {row['seeded_normal']['rel_l2_vs_float64']} from float64")
    return row


# -- ZImage Turbo ---------------------------------------------------------------------------


def zimage_reference():
    """A ZImage DiT at full width (dim 3840, 30 heads of 128) with 2 + 2
    refiner blocks and 2 layers, on the card in bf16 (flash kernel) against
    the same weights on the CPU in f32 (plain version), within BF16_REL_L2.
    15 x 17 latent patches give 255 image tokens, so the pad token runs too."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.models.transformers.zimage import ZImageConfig, ZImageTransformer2DModel

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 16, 1, 30, 34)).astype(np.float32))
    cap = torch.from_numpy(rng.normal(size=(1, 64, 2560)).astype(np.float32))
    card_vs_cpu("zimage dim 3840, 30 heads, 2 + 2 refiner blocks, 2 layers",
                lambda dt: ZImageTransformer2DModel(ZImageConfig(n_layers=2, n_refiner_layers=2), dtype=dt),
                lambda m, *a: m(*a), (x, torch.tensor([0.6]), cap, torch.arange(64)[None] < 50), BF16_REL_L2, 21,
                phase="zimage", image_tokens=255, caption_bucket=64)


def zimage_drive(label, manifest, weights, requests, steps, home, launches_per_step, **run_kw):
    """Requests through ``UniversalEngine`` on a ZImage manifest at 1024x1024
    with synthetic ``weights``, each with the kernel's launch count set to 0
    before and read after; ``requests`` are (prompt, seed) pairs. Returns the
    rows, the frames and the engine."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine import UniversalEngine
    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    os.environ["APEX_SYNTHETIC_WEIGHTS"] = weights
    os.environ["APEX_HOME_DIR"] = str(home / label)
    engine = UniversalEngine(manifest, device="cuda")
    engine._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
    engine.load_component_by_type("vae")
    decode, latents_finite = engine.vae.decode, []

    def observed_decode(z):
        latents_finite.append(bool(torch.isfinite(z).all()))
        return decode(z)

    engine.vae.decode = observed_decode
    rows, frames_out = [], []
    for i, (prompt, seed) in enumerate(requests):
        stamps, peaks, last = {}, {}, [None]

        def progress(p, message, *_a, **_k):
            torch.cuda.synchronize()
            stamps.setdefault(message, time.perf_counter())
            if last[0] is not None:  # the peak of the stage that ends here
                peaks[last[0]] = max(peaks.get(last[0], 0.0), torch.cuda.max_memory_allocated() / 2**30)
            torch.cuda.reset_peak_memory_stats()
            last[0] = message

        latents_finite.clear()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        frames = engine.run(prompt=prompt, height=SIZE, width=SIZE, num_inference_steps=steps, seed=seed,
                            progress_callback=progress, **run_kw)
        torch.cuda.synchronize()
        total, launches = time.perf_counter() - t0, flash_attention.launches
        step_t = [stamps[f"Denoising step {j}/{steps}"] for j in range(1, steps + 1)]
        start = stamps["Timesteps computed; starting denoise"]
        per_step = [b - a for a, b in zip([start] + step_t[:-1], step_t)]
        row = {
            "phase": label, "manifest": manifest.name, "weights": weights, "request": i + 1,
            "prompt": prompt[:40], "seed": seed, "steps": steps, "seconds_total": total,
            "seconds_before_pipeline": stamps["Starting text-to-image pipeline"] - t0,
            "seconds_load": stamps["Components ready"] - stamps["Starting text-to-image pipeline"],
            "seconds_encode": stamps["Prompts ready"] - stamps["Components ready"],
            "seconds_denoise": stamps["Denoising complete"] - start,
            "seconds_per_step": per_step,
            "median_seconds_per_step_after_the_first": statistics.median(per_step[1:] or per_step),
            "seconds_decode": stamps["Completed text-to-image pipeline"] - stamps["Denoising complete"],
            "peak_gib_by_stage": peaks, "peak_gib": max(peaks.values()),
            "flash_launches": launches, "flash_launches_per_step": launches / steps,
            "flash_launches_expected": launches_per_step * steps,
            "frames": [list(f.shape) for f in frames], "latents_finite": latents_finite,
        }
        emit(row)
        check(len(frames) == 1 and frames[0].shape == (SIZE, SIZE, 3) and frames[0].dtype == np.uint8,
              f"{label} request {i + 1}: bad frames {row['frames']}")
        check(latents_finite == [True], f"{label} request {i + 1}: latents not finite")
        check(launches == launches_per_step * steps,
              f"{label} request {i + 1}: flash launched {launches} times, expected {launches_per_step * steps}")
        rows.append(row)
        frames_out.append(frames[0])
    return rows, frames_out, engine


def phase_zimage(home: Path, kernel_rows=()):
    """ZImage Turbo text-to-image at 1024x1024 from its manifest, full width
    and depth: the 2 + 2-block card-vs-CPU check; three requests of the
    manifest's 9 steps with synthetic int8 weights (requests 1 and 3 the same
    prompt and seed; request 1's frame is returned for the server phase); the resident Linears at ZImage's shapes; then one bf16
    request, one CFG request (zimage.yml: guidance 4, norm clamp, truncation)
    and one control request, each of 2 steps. With the timing phase's
    ``kernel_rows`` it also splits the int8 step into attention, the main
    layers' W8A8 Linears and the rest."""
    import numpy as np
    import yaml

    zimage_reference()
    run = yaml.safe_load(ZIMAGE_MANIFEST.read_text())["spec"]["defaults"]["run"]
    check(run["num_inference_steps"] == ZIMAGE_STEPS and run["guidance_scale"] == 0.0
          and run["height"] == run["width"] == SIZE, f"the manifest's defaults changed: {run}")
    paths = {}
    rows, frames, engine = zimage_drive("zimage", ZIMAGE_MANIFEST, "int8",
                                        [(PROMPT_A, 0), (PROMPT_B, 1), (PROMPT_A, 0)], ZIMAGE_STEPS, home,
                                        ZIMAGE_LAUNCHES, guidance_scale=0.0)
    paths["zimage"] = rows
    from apex_studio_tpu_torch.quantize.residency import count_resident

    same, differ = bool(np.array_equal(frames[0], frames[2])), not np.array_equal(frames[0], frames[1])
    emit({"phase": "zimage", "requests_1_3_identical": same, "requests_1_2_differ": differ,
          "resident_weights": count_resident(engine.transformer),
          "median_seconds_per_step_after_the_first": statistics.median(
              t for r in rows for t in r["seconds_per_step"][1:])})
    check(same, "zimage requests 1 and 3 (same prompt and seed) differ")
    check(differ, "zimage requests 1 and 2 (other prompt and seed) are identical")
    check(count_resident(engine.transformer) > 0, "no weight of the ZImage DiT is int8-resident")
    first_frame = frames[0]
    del engine, frames
    release()
    linear_rows = residency_timing(list(ZIMAGE_LINEAR_CALLS), phase="zimage")
    if kernel_rows:
        step = statistics.median(t for r in rows for t in r["seconds_per_step"][1:])
        queued = {r["case"]: r["queued_ms"] for r in kernel_rows}
        attention_s = (30 * queued["zimage_layers_s4224_h30"] + 2 * queued["zimage_noise_refiner_s4096_h30"]
                       + 2 * queued["zimage_caption_s128_h30"]) / 1e3
        by = {key: sum(ZIMAGE_LINEAR_CALLS[(r["rows"], r["in"], r["out"])] * r[key] for r in linear_rows) / 1e3
              for key in ("w8a8_ms", "bf16_ms")}
        emit({"phase": "zimage", "step_breakdown_int8": {
            "seconds_per_step": step, "attention_seconds": attention_s,
            "w8a8_linear_seconds_main_layers": by["w8a8_ms"], "bf16_linear_seconds_same_calls": by["bf16_ms"],
            "other_seconds": step - attention_s - by["w8a8_ms"], "attention_share": attention_s / step,
            "w8a8_linear_share": by["w8a8_ms"] / step,
            "reckoning": "queued kernel ms x (30 at 4224 + 2 at 4096 + 2 at 128 tokens); queued ms x calls "
                         "of the main layers' Linears and the adaLN rows; other = the rest, the refiners' "
                         "Linears with it"}})
    paths["zimage_bf16"] = zimage_drive("zimage_bf16", ZIMAGE_MANIFEST, "bf16", [(PROMPT_A, 0)], 2, home,
                                        ZIMAGE_LAUNCHES, guidance_scale=0.0)[0]
    release()
    # a 2-step schedule at 4096 tokens ends at t_model 0.9968: a truncation
    # below that would drop CFG from the second step
    paths["zimage_cfg"] = zimage_drive("zimage_cfg", ZIMAGE_CFG_MANIFEST, "int8", [(PROMPT_B, 2)], 2, home,
                                       2 * ZIMAGE_LAUNCHES, guidance_scale=4.0, negative_prompt="",
                                       cfg_normalization=1.0, cfg_truncation=0.999)[0]
    release()
    rng = np.random.default_rng(3)
    control = cv2_smooth(rng, (SIZE, SIZE))
    inpaint = cv2_smooth(rng, (SIZE, SIZE))
    mask = np.zeros((SIZE, SIZE, 3), np.uint8)
    mask[256:768, 192:832] = 255
    paths["zimage_control"] = zimage_drive(
        "zimage_control", ZIMAGE_CONTROL_MANIFEST, "int8", [(PROMPT_A, 4)], 2, home, ZIMAGE_CONTROL_LAUNCHES,
        guidance_scale=0.0, control_image=control, image=inpaint, mask_image=mask, control_context_scale=0.75)[0]
    release()
    return paths, linear_rows, first_frame


def cv2_smooth(rng, size):
    """A seeded smooth RGB uint8 image: random 32x32 colours upscaled."""
    import cv2

    small = rng.integers(0, 256, size=(32, 32, 3)).astype("uint8")
    return cv2.resize(small, (size[1], size[0]), interpolation=cv2.INTER_CUBIC)


# -- QwenImage Edit 2509 ----------------------------------------------------------------------


def qwenimage_bucket(prompt: str, system: str) -> int:
    """The text bucket ``encode_prompt`` gives ``prompt`` with the byte-level
    tokenizer: the real tokens after the template prefix, rounded up to 32."""
    from apex_studio_tpu_torch.engine.qwenimage import DROP_IDX

    text = (f"<|im_start|>system\n{system}<|im_end|>\n"
            f"<|im_start|>user\n{prompt}<|im_end|>\n<|im_start|>assistant\n")
    true_len = min(len(make_tokenizer().encode(text, add_special_tokens=False).ids), 1024 + DROP_IDX)
    return -(-max(1, true_len - DROP_IDX) // 32) * 32


def qwenimage_lengths() -> dict:
    """The joint sequence lengths of the QwenImage requests of this script:
    [text ‖ noise ‖ condition images], 4096 tokens an image at 1024x1024."""
    from apex_studio_tpu_torch.engine.qwenimage import EDIT_SYSTEM_MESSAGE, SYSTEM_MESSAGE

    edit = qwenimage_bucket(QWENIMAGE_EDIT_PROMPT, EDIT_SYSTEM_MESSAGE)
    return {"edit_bucket": edit, "edit": edit + 2 * QWENIMAGE_TOKENS, "edit_plus": edit + 3 * QWENIMAGE_TOKENS,
            "t2i": qwenimage_bucket(PROMPT_A, SYSTEM_MESSAGE) + QWENIMAGE_TOKENS}


def qwenimage_kernel_inputs():
    """(case, q, k, v, bias) at the shapes the QwenImage path gives the kernel
    (24 heads of 128, unmasked): the edit request's own length, a ragged 8256
    (4096 + 4096 + a 64-token bucket), edit_plus with two condition images and
    the t2i request's length."""
    lengths = qwenimage_lengths()
    cases = {f"qwenimage_edit_s{lengths['edit']}_h24": lengths["edit"], "qwenimage_ragged_s8256_h24": 8256,
             f"qwenimage_edit_plus_s{lengths['edit_plus']}_h24": lengths["edit_plus"],
             f"qwenimage_t2i_s{lengths['t2i']}_h24": lengths["t2i"]}
    seen = set()
    for i, (name, s) in enumerate(cases.items()):
        if s not in seen:
            seen.add(s)
            yield (name, *qkv(1, s, s, QWENIMAGE_HEADS, 128, 40 + i), None)


def plain_in_row_chunks(q, k, v, rows: int = 2048, bias=None):
    """The plain version over query-row chunks (each row is independent of the
    others, so this is the whole plain output at a bounded score size)."""
    import torch

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention_reference

    return torch.cat([flash_attention_reference(q[:, i:i + rows], k, v, bias=bias)
                      for i in range(0, q.shape[1], rows)], dim=1)


def qwenimage_reference():
    """A QwenImage DiT at full width (24 heads of 128, text 3584) with 2 blocks
    and a 2-block ControlNet, on the card in bf16 (flash kernel) against the
    same weights on the CPU in f32 (plain version), within BF16_REL_L2: an
    edit-shaped forward (a 12 x 14 grid, one condition grid, a 64-token text
    bucket of which 50 rows are real) and a ControlNet-guided one."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.models.transformers import qwenimage

    dit_cpu, dit = bf16_card_and_f32_cpu(lambda dt: qwenimage.QwenImageTransformer2DModel(
        qwenimage.QwenImageConfig(num_layers=2), dtype=dt), 22)
    cn_cpu, cn = bf16_card_and_f32_cpu(lambda dt: qwenimage.QwenImageControlNetModel(
        qwenimage.QwenImageControlNetConfig(num_layers=2), dtype=dt), 23)
    rng = np.random.default_rng(0)
    grid = (12, 14)
    n = grid[0] * grid[1]
    x = torch.from_numpy(rng.normal(size=(1, 2 * n, 64)).astype(np.float32))
    txt = torch.from_numpy(rng.normal(size=(1, 64, 3584)).astype(np.float32))
    txt[:, 50:] = 0.0
    t = torch.tensor([0.6])
    results = {}
    with torch.inference_mode():
        for name, fn in (
                ("edit", lambda m, c, dev: m(x.to(dev), txt.to(dev), t.to(dev), grid_hw=grid,
                                             extra_segments=(grid,))),
                ("controlnet", lambda m, c, dev: m(x[:, :n].to(dev), txt.to(dev), t.to(dev), grid_hw=grid,
                                                   controlnet_block_samples=c(
                                                       x[:, :n].to(dev), x[:, n:].to(dev), txt.to(dev),
                                                       t.to(dev), grid_hw=grid, conditioning_scale=0.8)))):
            ref = fn(dit_cpu, cn_cpu, "cpu")
            out = fn(dit, cn, "cuda").float().cpu()
            results[name] = {"rel_l2": rel_l2(out, ref), "max_abs_err": (out - ref).abs().max().item(),
                             "max_abs_ref": ref.abs().max().item(), "finite": bool(torch.isfinite(out).all())}
    emit({"phase": "qwenimage", "check": "card_bf16_vs_cpu_f32",
          "model": "qwenimage dim 3072, 24 heads, 2 blocks + a 2-block ControlNet",
          "parameters": sum(p.numel() for p in dit_cpu.parameters()) + sum(p.numel() for p in cn_cpu.parameters()),
          "image_tokens": 2 * n, "text_bucket": 64, "tol_rel_l2": BF16_REL_L2, **results})
    for name, r in results.items():
        check(r["finite"] and r["rel_l2"] <= BF16_REL_L2,
              f"the QwenImage {name} forward on the card is {r['rel_l2']} from the CPU (limit {BF16_REL_L2})")
    del dit_cpu, dit, cn_cpu, cn
    release()


def vae_decode_vs_float64(vae, z) -> dict:
    """One decode of ``z`` through a Wan VAE on the card as the engine builds
    it (bf16 compute, f32 parameters), timed, against the same VAE in float64
    (its norms and attention upcast to f32 by design): relative L2."""
    import copy

    import torch

    with torch.inference_mode():
        out = vae.decode(z)
        ms = time_ms(lambda: vae.decode(z), reps=3, warmup=1)
        vae64 = copy.deepcopy(vae).double()
        for m in vae64.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
        rel = rel_l2(out.double(), vae64.decode(z.double()))
    row = {"latent": list(z.shape), "pixels": list(out.shape), "compute_dtype": str(out.dtype), "decode_ms": ms,
           "rel_l2_vs_float64": rel}
    del vae64, out
    release()
    return row


def qwenimage_vae_precision(vae) -> dict:
    """One decode of a seeded 32 x 32 latent through the engine's Wan VAE on
    the card against float64, within 2e-2 relative L2."""
    import torch

    g = torch.Generator("cuda").manual_seed(7)
    z = torch.randn(1, vae.cfg.z_dim, 1, 32, 32, generator=g, device="cuda")
    row = {"phase": "qwenimage", "check": "vae_decode_vs_float64", **vae_decode_vs_float64(vae, z), "tol": 2e-2}
    emit(row)
    rel = row["rel_l2_vs_float64"]
    check(rel <= 2e-2, f"the Wan VAE's decode is {rel} from float64")
    return row


def write_qwenimage_controlnet_manifest(home: Path) -> Path:
    """qwenimage.yml with a ``controlnet`` transformer component at the
    family's full width and default 5 layers (no config: synthetic mode builds
    the family defaults), typed ``controlnet``."""
    import yaml

    doc = yaml.safe_load(QWENIMAGE_MANIFEST.read_text())
    doc["metadata"]["id"] = "qwenimage-controlnet-smoke"
    doc["spec"]["model_type"] = "controlnet"
    doc["spec"]["components"].append({"type": "transformer", "name": "controlnet", "label": "ControlNet",
                                      "base": "qwenimage.controlnet"})
    path = home / "qwenimage-controlnet.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


def qwenimage_drive(label, manifest, model_type, weights, requests, steps, home, launches_per_step):
    """Requests (run keyword dicts) through ``UniversalEngine`` on a QwenImage
    manifest at 1024x1024 with synthetic ``weights``, each with the kernel's
    launch count set to 0 before and read after; stages timed from the
    engine's progress messages (synchronised), the condition encode from a
    wrapper around it, peaks by stage. Returns the rows, the frames and the
    engine."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine import UniversalEngine
    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    os.environ["APEX_SYNTHETIC_WEIGHTS"] = weights
    os.environ["APEX_HOME_DIR"] = str(home / label)
    write_manifest_config(home / label, manifest, "transformer", {"num_layers": QWENIMAGE_REQUEST_LAYERS})
    engine = UniversalEngine(manifest, model_type=model_type, device="cuda")
    engine._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
    encode_image, decode = engine.encode_image_latents, engine._decode_frames
    cond_seconds, latents_finite = [], []

    def timed_encode_image(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode_image(*a, **k)
        torch.cuda.synchronize()
        cond_seconds.append(time.perf_counter() - t0)
        return out

    def observed_decode(packed, *a):
        latents_finite.append(bool(torch.isfinite(packed).all()))
        return decode(packed, *a)

    engine.encode_image_latents, engine._decode_frames = timed_encode_image, observed_decode
    instantiate, built = engine._instantiate_family, []

    def counted_instantiate(registry, spec, family):
        built.append(spec.get("name") or spec.get("type"))
        return instantiate(registry, spec, family)

    engine._instantiate_family = counted_instantiate
    start_msg = {"edit": "Starting edit pipeline", "edit_plus": "Starting edit pipeline",
                 "t2i": "Starting t2i pipeline", "controlnet": "Starting controlnet pipeline"}[model_type]
    done_msg = start_msg.replace("Starting", "Completed")
    rows, frames_out = [], []
    for i, kw in enumerate(requests):
        stamps, peaks, last = {}, {}, [None]

        def progress(p, message, *_a, **_k):
            torch.cuda.synchronize()
            stamps.setdefault(message, time.perf_counter())
            if last[0] is not None:  # the peak of the stage that ends here
                peaks[last[0]] = max(peaks.get(last[0], 0.0), torch.cuda.max_memory_allocated() / 2**30)
            torch.cuda.reset_peak_memory_stats()
            last[0] = message

        cond_seconds.clear()
        latents_finite.clear()
        built.clear()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        frames = engine.run(height=SIZE, width=SIZE, num_inference_steps=steps, progress_callback=progress, **kw)
        torch.cuda.synchronize()
        total, launches = time.perf_counter() - t0, flash_attention.launches
        step_t = [stamps[f"Denoising step {j}/{steps}"] for j in range(1, steps + 1)]
        start = stamps.get("Timesteps computed", stamps[start_msg])
        per_step = [b - a for a, b in zip([start] + step_t[:-1], step_t)]
        row = {
            "phase": label, "manifest": manifest.name, "model_type": model_type, "weights": weights,
            "request": i + 1, "prompt": kw.get("prompt", "")[:40], "seed": kw.get("seed"), "steps": steps,
            "condition_images": len(kw["image"]) if isinstance(kw.get("image"), list) else int("image" in kw),
            "seconds_total": total, "seconds_per_step": per_step,
            "median_seconds_per_step_after_the_first": statistics.median(per_step[1:] or per_step),
            "seconds_condition_encode": sum(cond_seconds),
            "seconds_decode": stamps[done_msg] - stamps[f"Denoising step {steps}/{steps}"],
            "peak_gib_by_stage": peaks, "peak_gib": max(peaks.values()),
            "flash_launches": launches, "flash_launches_per_step": launches / steps,
            "flash_launches_expected": launches_per_step * steps,
            "components_built": list(built),
            "frames": [list(f.shape) for f in frames], "latents_finite": latents_finite,
        }
        if "Prompts ready" in stamps:
            row["seconds_encode"] = stamps["Prompts ready"] - stamps[start_msg]
            row["peak_gib_encoder_resident"] = peaks[start_msg]
            row["peak_gib_after_release"] = max(v for k, v in peaks.items() if k != start_msg)
        if "Timesteps computed" in stamps:
            row["seconds_denoise"] = step_t[-1] - stamps["Timesteps computed"]
        emit(row)
        check(len(frames) == 1 and frames[0].shape == (SIZE, SIZE, 3) and frames[0].dtype == np.uint8,
              f"{label} request {i + 1}: bad frames {row['frames']}")
        check(latents_finite == [True], f"{label} request {i + 1}: latents not finite")
        check(launches == launches_per_step * steps,
              f"{label} request {i + 1}: flash launched {launches} times, expected {launches_per_step * steps}")
        rows.append(row)
        frames_out.append(frames[0])
    return rows, frames_out, engine


def phase_qwenimage(home: Path, kernel_rows=()):
    """QwenImage Edit 2509 at 1024x1024 from its manifest, full width, the
    requests' DiT at QWENIMAGE_REQUEST_LAYERS of its 60 blocks, int4-resident
    (encoder and VAE int8 / bf16): the 2-block
    card-vs-CPU check; the bench leg's edit request three times (4 of its 8
    steps, true_cfg_scale 1.0; request 2 with another seed); the Wan VAE against
    float64; the resident Linears at QwenImage's shapes and the step split;
    then edit_plus with two condition images, t2i with true CFG, the
    ControlNet at scales 1 and 0, and a bf16 edit, each of 2 steps."""
    import numpy as np

    from apex_studio_tpu_torch.quantize.residency import count_resident

    qwenimage_reference()
    lengths = qwenimage_lengths()
    rng = np.random.default_rng(5)
    source, second, control = (cv2_smooth(rng, (SIZE, SIZE)) for _ in range(3))
    edit = dict(image=source, prompt=QWENIMAGE_EDIT_PROMPT, true_cfg_scale=1.0)
    paths = {}
    rows, frames, engine = qwenimage_drive(
        "qwenimage_edit", QWENIMAGE_EDIT_MANIFEST, "edit", "int4",
        [dict(edit, seed=0), dict(edit, seed=1), dict(edit, seed=0)], QWENIMAGE_EDIT_STEPS, home,
        QWENIMAGE_REQUEST_LAYERS)
    paths["qwenimage_edit"] = rows
    bucket = engine.encode_prompt(QWENIMAGE_EDIT_PROMPT).shape[1]  # a disk-cache hit
    same, differ = bool(np.array_equal(frames[0], frames[2])), not np.array_equal(frames[0], frames[1])
    int4_step = statistics.median(t for r in rows for t in r["seconds_per_step"][1:])
    emit({"phase": "qwenimage", "requests_1_3_identical": same, "requests_1_2_differ": differ,
          "text_bucket": bucket, "joint_tokens": 2 * QWENIMAGE_TOKENS + bucket,
          "second_encode_cache_hit": "text_encoder" not in rows[1]["components_built"],
          "resident_weights": count_resident(engine.transformer),
          "median_seconds_per_step_after_the_first": int4_step,
          "seconds_per_request": [r["seconds_total"] for r in rows]})
    check(same, "qwenimage edit requests 1 and 3 (same inputs and seed) differ")
    check(differ, "qwenimage edit requests 1 and 2 (other seed) are identical")
    check(bucket == lengths["edit_bucket"], f"text bucket {bucket}, the kernel cases assumed {lengths['edit_bucket']}")
    check(not any(r["components_built"] for r in rows[1:]),
          f"a repeated request built components again: {[r['components_built'] for r in rows[1:]]}")
    check(count_resident(engine.transformer) > 0, "no weight of the QwenImage DiT is resident")
    qwenimage_vae_precision(engine.vae)
    del engine, frames
    release()
    calls = {**QWENIMAGE_LINEAR_CALLS, (bucket, 3072, 3072): 4 * QWENIMAGE_REQUEST_LAYERS}
    linear_rows = residency_timing(list(calls), phase="qwenimage")
    if kernel_rows:
        queued = {r["case"]: r["queued_ms"] for r in kernel_rows}
        attention_s = QWENIMAGE_REQUEST_LAYERS * queued[f"qwenimage_edit_s{lengths['edit']}_h24"] / 1e3
        by = {key: sum(calls[(r["rows"], r["in"], r["out"])] * r[key] for r in linear_rows) / 1e3
              for key in ("w4_ms", "bf16_ms")}
        emit({"phase": "qwenimage", "step_breakdown_int4": {
            "seconds_per_step": int4_step, "attention_seconds": attention_s,
            "w4_linear_seconds": by["w4_ms"], "bf16_linear_seconds_same_calls": by["bf16_ms"],
            "other_seconds": int4_step - attention_s - by["w4_ms"], "attention_share": attention_s / int4_step,
            "w4_linear_share": by["w4_ms"] / int4_step,
            "reckoning": f"queued kernel ms x {QWENIMAGE_REQUEST_LAYERS} at the edit length; queued ms x calls of "
                         "the image stream's "
                         "Linears (8192 rows), the text stream's q/k/v/out (bucket rows) and the modulation "
                         "rows; other = the rest, the text stream's MLPs with it"}})
    paths["qwenimage_edit_plus"] = qwenimage_drive(
        "qwenimage_edit_plus", QWENIMAGE_EDIT_MANIFEST, "edit_plus", "int4",
        [dict(edit, image=[source, second], seed=0)], 2, home, QWENIMAGE_REQUEST_LAYERS)[0]
    release()
    paths["qwenimage_t2i_cfg"] = qwenimage_drive(
        "qwenimage_t2i_cfg", QWENIMAGE_MANIFEST, "t2i", "int4",
        [dict(prompt=PROMPT_A, negative_prompt="blurry, low quality", true_cfg_scale=4.0, seed=2)], 2, home,
        2 * QWENIMAGE_REQUEST_LAYERS)[0]
    release()
    cn_run = dict(prompt=PROMPT_B, control_image=control, true_cfg_scale=1.0, seed=3)
    cn_rows, cn_frames = qwenimage_drive(
        "qwenimage_controlnet", write_qwenimage_controlnet_manifest(home), "controlnet", "int4",
        [dict(cn_run, controlnet_conditioning_scale=1.0), dict(cn_run, controlnet_conditioning_scale=0.0)], 2,
        home, QWENIMAGE_REQUEST_LAYERS + QWENIMAGE_CN_LAYERS)[:2]  # the engine is dropped here
    paths["qwenimage_controlnet"] = cn_rows
    steered = not np.array_equal(cn_frames[0], cn_frames[1])
    emit({"phase": "qwenimage", "controlnet_scale_1_vs_0_frames_differ": steered})
    check(steered, "the ControlNet at scale 1 gives the frame of scale 0")
    del cn_frames
    release()
    # The 41 GB bf16 DiT fits the card, but the memory fallback's gate reads
    # the free memory after the DiT is resident (as the JAX gate does), so at
    # over 3/7 of the card it would make the DiT int8: a user who wants bf16
    # turns the fallback off, and so does this request.
    saved = os.environ.get("APEX_MEMORY_FALLBACK")
    os.environ["APEX_MEMORY_FALLBACK"] = "off"
    try:
        paths["qwenimage_edit_bf16"], _frames, engine = qwenimage_drive(
            "qwenimage_edit_bf16", QWENIMAGE_EDIT_MANIFEST, "edit", "bf16", [dict(edit, seed=0)], 2, home,
            QWENIMAGE_REQUEST_LAYERS)
    finally:
        if saved is None:
            del os.environ["APEX_MEMORY_FALLBACK"]
        else:
            os.environ["APEX_MEMORY_FALLBACK"] = saved
    resident = count_resident(engine.transformer)
    del engine, _frames
    check(resident == 0, f"the bf16 request's DiT holds {resident} resident weights")
    emit({"phase": "qwenimage", "step_int4_vs_bf16": {
        "int4_seconds_per_step": int4_step,
        "bf16_seconds_per_step": paths["qwenimage_edit_bf16"][0]["seconds_per_step"][-1],
        "bf16_peak_gib": paths["qwenimage_edit_bf16"][0]["peak_gib"], "int4_peak_gib": rows[0]["peak_gib"]}})
    release()
    return paths, linear_rows


# -- Wan 2.2 A14B ------------------------------------------------------------------------------


def wan_kernel_inputs():
    """(case, q, k, v, bias) at the shapes the Wan path gives the kernel (40
    heads of 128, unmasked): self-attention over a 480x832 frame (1560
    tokens), a 1024² image (4096) and an 81-frame 480x832 clip (32,760), and
    each one's cross-attention over the 512 UMT5 rows."""
    for i, (kind, s) in enumerate(WAN_TOKENS.items()):
        yield (f"wan_self_{kind}_s{s}_h40", *qkv(1, s, s, WAN_HEADS, 128, 60 + 2 * i), None)
        yield (f"wan_cross_{kind}_sq{s}_sk{WAN_TEXT_TOKENS}_h40",
               *qkv(1, s, WAN_TEXT_TOKENS, WAN_HEADS, 128, 61 + 2 * i), None)


def wan_reference():
    """A Wan DiT at full width (dim 5120, 40 heads of 128, FFN 13824, text
    4096) with 2 blocks, on the card in bf16 (flash kernel) against the same
    weights on the CPU in f32 (plain version), within BF16_REL_L2: one
    480x832 frame (1560 tokens) over 512 text rows of which 40 are real."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.models.transformers.wan import WanConfig, WanTransformer3DModel

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 16, 1, 60, 104)).astype(np.float32))
    ctx = torch.from_numpy(rng.normal(size=(1, WAN_TEXT_TOKENS, 4096)).astype(np.float32))
    ctx[:, 40:] = 0.0  # zeroed padding, as encode_prompt hands it over
    card_vs_cpu("wan dim 5120, 40 heads, FFN 13824, 2 blocks",
                lambda dt: WanTransformer3DModel(WanConfig(num_layers=2), dtype=dt), lambda m, *a: m(*a),
                (x, torch.tensor([731.0]), ctx), BF16_REL_L2, 24, phase="wan", tokens=WAN_TOKENS["frame"],
                text_rows=WAN_TEXT_TOKENS)


def wan_unipc_check():
    """The fused UniPC step (engine/fused.py) against the host
    ``scheduler.step`` over the t2i manifest's 30-step schedule (shift 5) on
    the card, on the same seeded velocities at the 1024² latent shape: every
    step's latents within WAN_UNIPC_REL_L2 of the host step's, both in f32."""
    import torch

    from apex_studio_tpu_torch.engine.fused import build_unipc_step, init_unipc_carry
    from apex_studio_tpu_torch.schedulers.unipc import FlowUniPCMultistepScheduler

    host, fused = (FlowUniPCMultistepScheduler(shift=5.0) for _ in range(2))
    for s in (host, fused):
        s.set_timesteps(30)
    g = torch.Generator("cuda").manual_seed(8)
    shape = (1, 16, 1, 128, 128)
    x_host = torch.randn(shape, generator=g, device="cuda")
    x_fused = x_host.clone()
    hist, last = init_unipc_carry(x_fused, fused.solver_order)
    step = build_unipc_step(lambda x, v: v, fused.solver_order)
    worst = 0.0
    with torch.inference_mode():
        for t, p in zip(host.timesteps, fused.fused_plan()):
            v = torch.randn(shape, generator=g, device="cuda")
            (x_host,) = host.step(v, float(t), x_host)
            x_fused = step(x_fused, hist, last, p["sigma"], p["use_corrector"], p["corr_w"], p["pred_w"], v)
            worst = max(worst, rel_l2(x_fused, x_host))
    row = {"phase": "wan", "check": "fused_unipc_vs_host_step", "steps": 30, "shift": 5.0, "latent": list(shape),
           "max_rel_l2": worst, "tol_rel_l2": WAN_UNIPC_REL_L2, "finite": bool(torch.isfinite(x_fused).all())}
    emit(row)
    check(row["finite"] and worst <= WAN_UNIPC_REL_L2,
          f"the fused UniPC step is {worst} from the host step (limit {WAN_UNIPC_REL_L2})")


def write_wan_configs(home: Path, i2v: bool = False, layers: int = None) -> None:
    """UMT5-XXL's published ``config.json`` where the Wan manifests name it
    (without it T5Config's defaults build T5-XXL: a shared relative bias and
    a 32,128-token vocabulary); with ``i2v``, the A14B I2V transformer's (36
    input channels) where the i2v manifest names both experts' configs; with
    ``layers``, the experts' configs (T2V's or I2V's) at that depth."""
    root = home / "components" / "Wan-AI" / "Wan2.2-T2V-A14B-Diffusers"
    files = {"text_encoder": UMT5_XXL}
    if i2v or layers:
        cfg = dict(WAN_I2V_TRANSFORMER if i2v else _WAN14B, num_layers=layers or WAN_LAYERS)
        files.update({"transformer": cfg, "transformer_2": cfg})
    for sub, cfg in files.items():
        (root / sub).mkdir(parents=True, exist_ok=True)
        (root / sub / "config.json").write_text(json.dumps(cfg))


def wan_engine(label, manifest, model_type, home, layers=None):
    """A Wan engine on the card with the byte-level tokenizer, its own
    ``APEX_HOME_DIR`` and the configs above, observed: the components each
    request builds, each expert's forwards and the latents each decode gets
    (``engine.wan_smoke``, ``observe``)."""
    from apex_studio_tpu_torch.engine import UniversalEngine

    os.environ["APEX_HOME_DIR"] = str(home / label)
    write_wan_configs(home / label, i2v=model_type == "i2v", layers=layers)
    engine = UniversalEngine(manifest, model_type=model_type, device="cuda")
    engine._spec_for_type("text_encoder")["tokenizer"] = make_tokenizer()
    return observe(engine)


def observe(engine):
    """``engine`` observed for ``edit_drive``: the components each request
    builds, each transformer's forwards and the latents each decode gets
    (``engine.wan_smoke``)."""
    import torch

    seen = engine.wan_smoke = {"built": [], "forwards": {}, "decoded": []}
    instantiate, load_transformer, decode = engine._instantiate_family, engine._load_transformer, engine.decode_latents

    def counted_instantiate(registry, spec, family):
        seen["built"].append(spec.get("name") or spec.get("type"))
        return instantiate(registry, spec, family)

    def counted_load_transformer(spec):
        model = load_transformer(spec)
        name = spec.get("name") or "transformer"
        model.register_forward_pre_hook(
            lambda *_: seen["forwards"].__setitem__(name, seen["forwards"].get(name, 0) + 1))
        return model

    def observed_decode(z):
        seen["decoded"].append(z.detach().clone())
        return decode(z)

    engine._instantiate_family, engine._load_transformer = counted_instantiate, counted_load_transformer
    engine.decode_latents = observed_decode
    torch.cuda.synchronize()
    return engine


def wan_expected_forwards(engine, kw) -> dict:
    """Each expert's forwards the request implies: the primary expert while
    t ≥ boundary_ratio·1000 (all steps without a boundary), ``transformer_2``
    after; two a step under CFG (the expert's guidance above 1; the engines
    encode an empty negative prompt when none is given, as in JAX)."""
    steps, boundary = kw["num_inference_steps"], kw.get("boundary_ratio")
    low = sum(1 for t in engine.scheduler.timesteps if boundary is not None and float(t) < boundary * 1000)
    g = kw.get("guidance_scale", 5.0)
    g2 = kw.get("guidance_scale_2") if kw.get("guidance_scale_2") is not None else g
    want = {"transformer": (steps - low) * (1 + (g > 1.0))}
    if low:
        want["transformer_2"] = low * (1 + (g > 1.0 and g2 > 1.0))
    return want


def wan_drive(label, engine, model_type, weights, requests):
    """Requests (run keyword dicts) through a ``wan_engine`` with synthetic
    ``weights``, each with the kernel's launch count set to 0 before and read
    after; stages timed from the engine's progress messages (synchronised),
    peaks by stage, each expert's forwards counted against what the
    scheduler's timesteps and the boundary imply. Returns rows and frames."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    os.environ["APEX_SYNTHETIC_WEIGHTS"] = weights
    os.environ["APEX_HOME_DIR"] = str(Path(engine.components_root).parent)
    seen = engine.wan_smoke
    start_msg = "Starting i2v pipeline" if model_type == "i2v" else "Starting pipeline"
    rows, frames_out = [], []
    for i, kw in enumerate(requests):
        steps = kw["num_inference_steps"]
        stamps, peaks, last = {}, {}, [None]

        def progress(p, message, *_a, **_k):
            torch.cuda.synchronize()
            stamps.setdefault(message, time.perf_counter())
            if last[0] is not None:  # the peak of the stage that ends here
                peaks[last[0]] = max(peaks.get(last[0], 0.0), torch.cuda.max_memory_allocated() / 2**30)
            torch.cuda.reset_peak_memory_stats()
            last[0] = message

        for v in seen.values():
            v.clear()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        frames = engine.run(progress_callback=progress, **kw)
        torch.cuda.synchronize()
        total, launches = time.perf_counter() - t0, flash_attention.launches
        want_forwards = wan_expected_forwards(engine, kw)
        want_launches = 2 * len(engine.transformer.blocks) * sum(want_forwards.values())
        step_t = [stamps[f"Denoising step {j}/{steps}"] for j in range(1, steps + 1)]
        start = stamps.get("Timesteps computed; starting denoise", stamps.get("Initialized latent noise"))
        per_step = [b - a for a, b in zip([start] + step_t[:-1], step_t)]
        z = seen["decoded"][-1]
        row = {
            "phase": label, "model_type": model_type, "weights": weights, "request": i + 1,
            "prompt": kw.get("prompt", "")[:40], "seed": kw.get("seed"), "steps": steps,
            "frames_requested": kw.get("num_frames", 1), "size": [kw["height"], kw["width"]],
            "latent_grid": list(z.shape[2:]), "tokens": math.prod(z.shape[2:]) // 4,
            "timesteps": [float(t) for t in engine.scheduler.timesteps], "boundary_ratio": kw.get("boundary_ratio"),
            "forwards_by_expert": dict(seen["forwards"]), "forwards_expected": want_forwards,
            "seconds_total": total, "seconds_per_step": per_step,
            "median_seconds_per_step_after_the_first": statistics.median(per_step[1:] or per_step),
            "seconds_decode": stamps["Completed pipeline"] - stamps["Denoising complete"],
            "peak_gib_by_stage": peaks, "peak_gib": max(peaks.values()),
            "flash_launches": launches, "flash_launches_per_step": launches / steps,
            "flash_launches_expected": want_launches, "components_built": list(seen["built"]),
            "frames": len(frames), "frame_shape": list(frames[0].shape),
            "latents_finite": bool(torch.isfinite(z).all()),
        }
        if "Prompts ready" in stamps:
            row["seconds_encode"] = stamps["Prompts ready"] - stamps[start_msg]
            row["seconds_load"] = stamps["Components ready"] - stamps["Prompts ready"]
        if "Image conditioning ready" in stamps:
            row["seconds_load_encode_and_condition"] = stamps["Image conditioning ready"] - stamps[start_msg]
        emit(row)
        n_frames = kw.get("num_frames", 1)
        check(len(frames) == n_frames and all(f.shape == (kw["height"], kw["width"], 3) and f.dtype == np.uint8
                                              for f in frames),
              f"{label} request {i + 1}: {len(frames)} frames of {frames[0].shape}, expected {n_frames}")
        check(row["latents_finite"], f"{label} request {i + 1}: latents not finite")
        check(row["forwards_by_expert"] == want_forwards,
              f"{label} request {i + 1}: expert forwards {row['forwards_by_expert']}, expected {want_forwards}")
        check(launches == want_launches,
              f"{label} request {i + 1}: flash launched {launches} times, expected {want_launches}")
        rows.append(row)
        frames_out.append(frames)
    return rows, frames_out


def wan_step_breakdown(kind, step_s, calls, linear_rows, kernel_rows) -> dict:
    """A CFG step of ``step_s`` seconds at the ``kind`` token count split
    into attention (queued kernel ms x the self and cross launches), the
    ``_w4`` Linears (queued ms x two forwards' ``calls`` by shape) and the
    rest (by difference)."""
    s = WAN_TOKENS[kind]
    queued = {r["case"]: r["queued_ms"] for r in kernel_rows}
    attention_s = 2 * WAN_REQUEST_LAYERS * (queued[f"wan_self_{kind}_s{s}_h40"]
                                    + queued[f"wan_cross_{kind}_sq{s}_sk{WAN_TEXT_TOKENS}_h40"]) / 1e3
    by = {key: 2 * sum(calls.get((r["rows"], r["in"], r["out"]), 0) * r[key] for r in linear_rows) / 1e3
          for key in ("w4_ms", "bf16_ms")}
    return {"tokens": s, "seconds_per_step": step_s, "attention_seconds": attention_s,
            "w4_linear_seconds": by["w4_ms"], "bf16_linear_seconds_same_calls": by["bf16_ms"],
            "other_seconds": step_s - attention_s - by["w4_ms"], "attention_share": attention_s / step_s,
            "w4_linear_share": by["w4_ms"] / step_s,
            "reckoning": f"a CFG step at {s} tokens: queued kernel ms x {2 * WAN_REQUEST_LAYERS} self + "
                         f"{2 * WAN_REQUEST_LAYERS} cross launches; queued "
                         f"ms x calls of the blocks' Linears ({s} rows), the cross-attention K/V and the text "
                         "embedder (512 rows) and time_proj (1 row); other = the rest"}


def wan_point_mask() -> dict:
    """The bench leg's preprocessing: ``mask_from_points`` on the first of
    eight seeded 480x832 frames (a disk moving 12 px a frame over dark noise),
    then ``track_mask`` forward; host work (numpy and OpenCV), as in the JAX
    package. Every mask's IoU with its drawn disk at least WAN_MASK_IOU."""
    import numpy as np

    from apex_studio_tpu_torch.mask import mask_from_points, track_mask

    rng = np.random.default_rng(0)
    frames, disks = [], []
    yy, xx = np.mgrid[:480, :832]
    for i in range(8):
        img = rng.integers(0, 30, (480, 832, 3)).astype(np.uint8)
        disk = (yy - 240) ** 2 + (xx - 200 - 12 * i) ** 2 <= 60 ** 2
        img[disk] = [200, 80, 80]
        frames.append(img)
        disks.append(disk)
    t0 = time.perf_counter()
    m0 = mask_from_points(frames[0], [{"x": 200, "y": 240}])
    masks = track_mask(frames, m0, 0, "forward")
    seconds = time.perf_counter() - t0
    ious = [float((masks[i].astype(bool) & disks[i]).sum() / (masks[i].astype(bool) | disks[i]).sum())
            for i in range(8)]
    row = {"phase": "wan", "check": "point_mask", "frames": len(masks), "size": [480, 832],
           "seconds_mask_and_track": seconds, "iou": ious, "tol_iou": WAN_MASK_IOU}
    emit(row)
    check(len(masks) == 8 and min(ious) >= WAN_MASK_IOU, f"point mask IoU {ious} (limit {WAN_MASK_IOU})")
    return row


def phase_wan(home: Path, kernel_rows=()):
    """Wan 2.2 A14B from its three manifests, full width, ``WAN_REQUEST_LAYERS``
    of the experts' 40 blocks, both 14B
    experts int4-resident unless a request says otherwise (UMT5-XXL int8, the
    Wan VAE bf16): the 2-block card-vs-CPU check and the fused UniPC step; the
    bench leg's request three times (t2v at one 480x832 frame, 3 of its 30 steps, one
    expert); t2v at 81 frames (2 steps at shift 3, the expert switch) with
    one decode tile against float64; the resident Linears at Wan's shapes and
    the int4 step split; the t2i manifest's 1024² request (3 steps, the
    expert switch); i2v at 81 frames (2 steps at shift 3); one bf16 t2i
    request (2 steps); the point mask."""
    import numpy as np

    from apex_studio_tpu_torch.quantize.residency import count_resident

    wan_reference()
    wan_unipc_check()
    paths = {}
    leg = dict(prompt=WAN_PROMPT, negative_prompt=WAN_NEG, height=480, width=832, num_frames=1,
               num_inference_steps=WAN_SMOKE_STEPS, guidance_scale=4.0, boundary_ratio=None)
    engine = wan_engine("wan_t2v", WAN_T2V_MANIFEST, "t2v", home, WAN_REQUEST_LAYERS)
    rows, frames = wan_drive("wan_t2v", engine, "t2v", "int4",
                             [dict(leg, seed=0), dict(leg, seed=1), dict(leg, seed=0)])
    paths["wan_t2v_frame"] = rows
    same = bool(np.array_equal(frames[0][0], frames[2][0]))
    differ = not np.array_equal(frames[0][0], frames[1][0])
    int4_step = statistics.median(t for r in rows for t in r["seconds_per_step"][1:])
    emit({"phase": "wan", "requests_1_3_identical": same, "requests_1_2_differ": differ,
          "second_encode_cache_hit": "text_encoder" not in rows[1]["components_built"],
          "resident_weights": count_resident(engine.transformer), "tokens": rows[0]["tokens"],
          "median_seconds_per_step_after_the_first": int4_step,
          "seconds_per_request": [r["seconds_total"] for r in rows]})
    check(same, "wan requests 1 and 3 (same prompt and seed) differ")
    check(differ, "wan requests 1 and 2 (other seed) are identical")
    check(not any(r["components_built"] for r in rows[1:]),
          f"a repeated request built components again: {[r['components_built'] for r in rows[1:]]}")
    check(rows[0]["flash_launches_per_step"] == 4 * WAN_REQUEST_LAYERS,
          f"a CFG step did not make {4 * WAN_REQUEST_LAYERS} launches")
    check(rows[0]["tokens"] == WAN_TOKENS["frame"], f"the bench leg's frame gave {rows[0]['tokens']} tokens")
    check(count_resident(engine.transformer) > 0, "no weight of the Wan DiT is resident")
    # t2v at 81 frames on the same engine, with the manifest's expert switch
    clip_kw = dict(leg, num_frames=81, num_inference_steps=WAN_CLIP_STEPS, shift=WAN_CLIP_SHIFT, boundary_ratio=0.875,
                   guidance_scale_2=3.0, seed=0)
    paths["wan_t2v_81_frames"], _ = wan_drive("wan_t2v", engine, "t2v", "int4", [clip_kw])
    z = engine.wan_smoke["decoded"][-1]
    check(paths["wan_t2v_81_frames"][0]["tokens"] == WAN_TOKENS["clip"], "the 81-frame clip's tokens")
    tile = {"phase": "wan", "check": "vae_tile_vs_float64", "tol": 2e-2,
            "seeded_normal": vae_decode_vs_float64(engine.vae, torch_randn_like(z[..., :32, :32], 9)),
            "denoised": vae_decode_vs_float64(engine.vae, z[..., :32, :32].contiguous())}
    emit(tile)
    check(tile["seeded_normal"]["rel_l2_vs_float64"] <= 2e-2,
          f"the Wan VAE's tile decode is {tile['seeded_normal']['rel_l2_vs_float64']} from float64")
    del engine, frames, _, z
    release()
    linear_rows = residency_timing(sorted(set(WAN_LINEAR_CALLS) | set(WAN_CLIP_LINEAR_CALLS)), phase="wan")
    if kernel_rows:
        clip_step = paths["wan_t2v_81_frames"][0]["median_seconds_per_step_after_the_first"]
        for name, kind, calls, step_s in (("step_breakdown_int4", "frame", WAN_LINEAR_CALLS, int4_step),
                                          ("step_breakdown_int4_81_frames", "clip", WAN_CLIP_LINEAR_CALLS, clip_step)):
            emit({"phase": "wan", name: wan_step_breakdown(kind, step_s, calls, linear_rows, kernel_rows)})
    t2i_kw = dict(prompt=PROMPT_A, negative_prompt=WAN_NEG, height=1024, width=1024,
                  num_inference_steps=WAN_SMOKE_STEPS,
                  guidance_scale=4.0, guidance_scale_2=3.0, boundary_ratio=0.875, seed=0)
    engine = wan_engine("wan_t2i", WAN_T2I_MANIFEST, "t2i", home, WAN_REQUEST_LAYERS)
    paths["wan_t2i"], _ = wan_drive("wan_t2i", engine, "t2i", "int4", [t2i_kw])
    check(paths["wan_t2i"][0]["tokens"] == WAN_TOKENS["t2i"], "the t2i request's tokens")
    del engine, _
    release()
    i2v_kw = dict(clip_kw, image=cv2_smooth(np.random.default_rng(6), (480, 832)), prompt=PROMPT_B)
    engine = wan_engine("wan_i2v", WAN_I2V_MANIFEST, "i2v", home, WAN_REQUEST_LAYERS)
    paths["wan_i2v_81_frames"], _ = wan_drive("wan_i2v", engine, "i2v", "int4", [i2v_kw])
    check(engine.transformer.cfg.in_channels == 36,
          f"the i2v DiT takes {engine.transformer.cfg.in_channels} channels, expected 36")
    del engine, _
    release()
    # Both experts in bf16 (57 GB) fit the card, but the memory fallback's gate
    # reads the free memory after each expert is resident (as the JAX gate
    # does) and would make the second one int8: this request turns it off.
    saved = os.environ.get("APEX_MEMORY_FALLBACK")
    os.environ["APEX_MEMORY_FALLBACK"] = "off"
    try:
        engine = wan_engine("wan_t2i_bf16", WAN_T2I_MANIFEST, "t2i", home, WAN_REQUEST_LAYERS)
        # 2 steps at shift 5 (t = 999 | 833): both experts
        paths["wan_t2i_bf16"], _ = wan_drive("wan_t2i_bf16", engine, "t2i", "bf16",
                                             [dict(t2i_kw, num_inference_steps=2)])
    finally:
        if saved is None:
            del os.environ["APEX_MEMORY_FALLBACK"]
        else:
            os.environ["APEX_MEMORY_FALLBACK"] = saved
    resident = count_resident(engine.transformer) + count_resident(engine.transformer_2)
    emit({"phase": "wan", "t2i_int4_vs_bf16": {
        "int4_seconds_per_step": paths["wan_t2i"][0]["median_seconds_per_step_after_the_first"],
        "bf16_seconds_per_step": paths["wan_t2i_bf16"][0]["median_seconds_per_step_after_the_first"],
        "int4_peak_gib": paths["wan_t2i"][0]["peak_gib"], "bf16_peak_gib": paths["wan_t2i_bf16"][0]["peak_gib"],
        "bf16_resident_weights": resident}})
    check(resident == 0, f"the bf16 request's experts hold {resident} resident weights")
    del engine, _
    release()
    wan_point_mask()
    return paths, linear_rows


# -- Wan editing and long video ----------------------------------------------------------------


def wan_edit_kernel_inputs():
    """(case, q, k, v, bias) at the shapes the editing and causal paths give
    the kernel that no earlier path did: VACE's self- and cross-attention over
    81 frames plus a reference frame (34,320 tokens, 40 heads); Wan 2.1 i2v's
    image cross-attention over 257 CLIP tokens and first–last frame's over
    514 (at 32,760 queries); the Self-Forcing block of 3 latent frames (4680
    queries, 12 heads) against the whole 81-frame cache (32,760 keys) with a
    [1, Sk] validity bias, at the first block, the last, and a local window
    of 6 frames plus a 1-frame sink (whole key tiles masked), and its
    cross-attention over the 512 text rows."""
    import torch

    from apex_studio_tpu_torch.models.transformers.wan import WanCausalTransformer3DModel
    from apex_studio_tpu_torch.ops.attention import _prep_bias

    s, frame, blk = WAN_EDIT_TOKENS["vace"], WAN_TOKENS["frame"], WAN_EDIT_TOKENS["causal_block"]
    yield (f"wan_vace_self_s{s}_h40", *qkv(1, s, s, WAN_HEADS, 128, 70), None)
    yield (f"wan_vace_cross_sq{s}_sk{WAN_TEXT_TOKENS}_h40", *qkv(1, s, WAN_TEXT_TOKENS, WAN_HEADS, 128, 71), None)
    clip = WAN_TOKENS["clip"]
    yield (f"wan21_image_cross_sq{clip}_sk{CLIP_TOKENS}_h40", *qkv(1, clip, CLIP_TOKENS, WAN_HEADS, 128, 72), None)
    yield (f"wan_fflf_image_cross_sq{clip}_sk{2 * CLIP_TOKENS}_h40",
           *qkv(1, clip, 2 * CLIP_TOKENS, WAN_HEADS, 128, 73), None)
    masks = {"first_block": dict(cache_pos=0), "last_block": dict(cache_pos=clip - blk),
             "window6_sink1": dict(cache_pos=clip - blk, local_tokens=6 * frame, sink_tokens=frame)}
    for i, (name, kw) in enumerate(masks.items()):
        mask = WanCausalTransformer3DModel.causal_mask(1, clip, n_new=blk, device="cuda", **kw)
        yield (f"wan_causal_{name}_sq{blk}_sk{clip}_bias_h{CAUSAL_HEADS}",
               *qkv(1, blk, clip, CAUSAL_HEADS, 128, 74 + i), _prep_bias(None, mask).reshape(1, clip))
    yield (f"wan_causal_cross_sq{blk}_sk{WAN_TEXT_TOKENS}_h{CAUSAL_HEADS}",
           *qkv(1, blk, WAN_TEXT_TOKENS, CAUSAL_HEADS, 128, 77), None)


def wan_edit_kernel_cases(run_case):
    """The kernel at every ``wan_edit_kernel_inputs`` shape against its plain
    version in 1024-row chunks; a biased case also against the plain version
    over its valid keys alone (masked keys, whole tiles of them included,
    must count for nothing)."""
    import torch

    for name, q, k, v, bias in wan_edit_kernel_inputs():
        _, ref = run_case(name, q, k, v, bias=bias,
                          reference=lambda q, k, v, b=bias: plain_in_row_chunks(q, k, v, rows=1024, bias=b))
        if bias is not None:
            keep = bias[0] == 0
            run_case(f"{name}_vs_valid_keys_only", q, k, v, bias=bias,
                     reference=lambda q, k, v, m=keep: plain_in_row_chunks(q, k[:, m], v[:, m], rows=1024))
        del q, k, v, ref
        release()


def bf16_card_and_f32_cpu(build, seed):
    """``build(dtype)`` twice from one seed: in f32 on the CPU and in bf16 on
    the card, both holding the same (bf16-representable) weights."""
    import torch

    from apex_studio_tpu_torch.engine.base import materialize_random

    f32 = materialize_random(lambda: build(torch.float32), torch.device("cuda"), seed=seed)
    with torch.no_grad():
        for prm in f32.parameters():
            prm.copy_(prm.to(torch.bfloat16).float())
    card = materialize_random(lambda: build(torch.bfloat16), torch.device("cuda"), seed=0)
    card.load_state_dict(f32.state_dict())
    return f32.to("cpu"), card


def card_vs_cpu(label, build, forward, inputs, tol, seed, phase="wan_edit", **extra):
    """``forward(model, *inputs)`` on ``bf16_card_and_f32_cpu(build, seed)``:
    relative L2 of the card's output against the CPU's, within ``tol``. The
    card's forward runs here; the CPU's, the comparison and its check run on
    the worker thread (``in_background``) while the card goes on."""
    import torch

    cpu, card = bf16_card_and_f32_cpu(build, seed)
    with torch.inference_mode():
        out = forward(card, *(x.cuda() if isinstance(x, torch.Tensor) else x for x in inputs)).float().cpu()
    del card
    release()

    def compare():
        with torch.inference_mode():
            t0 = time.perf_counter()
            ref = forward(cpu, *inputs)
            cpu_s = time.perf_counter() - t0
        row = {"phase": phase, "check": "card_bf16_vs_cpu_f32", "model": label,
               "parameters": sum(p.numel() for p in cpu.parameters()), **extra, "rel_l2": rel_l2(out, ref),
               "max_abs_err": (out - ref).abs().max().item(), "max_abs_ref": ref.abs().max().item(),
               "finite": bool(torch.isfinite(out).all()), "tol_rel_l2": tol, "cpu_seconds": cpu_s}
        emit(row)
        check(row["finite"] and row["rel_l2"] <= tol,
              f"{label} on the card is {row['rel_l2']} from the CPU (limit {tol})")

    in_background(compare)


_BACKGROUND = {"pool": None, "pending": []}


def in_background(compare) -> None:
    """Run ``compare`` (a CPU reference forward, its comparison with the
    card's output and its ``check``) on one worker thread, so that the CPU's
    f32 forwards overlap the card's work; ``finish_background_checks``
    collects the results."""
    from concurrent.futures import ThreadPoolExecutor

    if _BACKGROUND["pool"] is None:
        _BACKGROUND["pool"] = ThreadPoolExecutor(max_workers=1, thread_name_prefix="cpu-reference")
    _BACKGROUND["pending"].append(_BACKGROUND["pool"].submit(compare))


def finish_background_checks() -> None:
    """Wait for every CPU reference in flight; re-raise the first failure
    (``CheckFailed`` or any error of the worker)."""
    pending, _BACKGROUND["pending"] = _BACKGROUND["pending"], []
    for future in pending:
        future.result()


def wan_edit_reference():
    """The new DiT variants at full width with 2 blocks, card (bf16, kernel)
    against CPU (f32, plain version) within BF16_REL_L2: VACE (dim 5120, both
    blocks hinted, a 96-channel control), Fun (a one-frame subject reference
    appended), causal (dim 1536, 12 heads: a one-frame block at the second
    frame of a 3-frame cache with a local window and sink); over half a
    480x832 frame (15 x 52 latent pixels, 390 tokens a frame) and 512 text
    rows of which 40 are real; and the CLIP ViT-H vision tower at 224 px,
    card in f32 against the CPU within CLIP_F32_REL_L2, its bf16 forward's
    distance reported."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
    from apex_studio_tpu_torch.models.transformers import wan

    rng = np.random.default_rng(1)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    ctx = tensor(1, WAN_TEXT_TOKENS, 4096)
    ctx[:, 40:] = 0.0
    t = torch.tensor([731.0])
    x = tensor(1, 16, 1, 30, 104)
    card_vs_cpu("wan.vace dim 5120, 2 blocks + 2 VACE blocks",
                lambda dt: wan.WanVACETransformer3DModel(wan.WanConfig(num_layers=2, vace_layers=(0, 1)), dtype=dt),
                lambda m, x, t, c, ctl: m(x, t, c, control=ctl), (x, t, ctx, tensor(1, 96, 1, 30, 104)),
                BF16_REL_L2, 25)
    card_vs_cpu("wan.fun dim 5120, 2 blocks, one subject-reference frame",
                lambda dt: wan.WanFunTransformer3DModel(wan.WanConfig(num_layers=2), dtype=dt),
                lambda m, x, t, c, r: m(x, t, c, subject_ref=r), (x, t, ctx, tensor(1, 16, 1, 30, 104)),
                BF16_REL_L2, 26)
    causal_cfg = wan.WanConfig.from_dict({**SELF_FORCING_TRANSFORMER, "num_layers": 2})

    def causal_forward(m, x, tt, c):
        kc, vc = m.init_cache(1, 3 * 390)
        for cache, seed in ((kc, 3), (vc, 4)):  # earlier frames' keys and values, bf16-representable
            cache.copy_(torch.randn(cache.shape, generator=torch.Generator().manual_seed(seed)).to(torch.bfloat16))
        rope = m.causal_rope_tables(1, 1, 15, 52, device=x.device)
        out, _ = m.forward_causal(x, tt, c, kc, vc, 390, *rope, local_tokens=390, sink_tokens=195)
        return out

    card_vs_cpu("wan.causal dim 1536, 12 heads, 2 blocks, a block against its cache",
                lambda dt: wan.WanCausalTransformer3DModel(causal_cfg, dtype=dt), causal_forward,
                (x, torch.full((1, 1), 731.0), ctx), BF16_REL_L2, 27)
    # CLIP vision: f32 on both sides (its plain route computes in f32 there), then bf16 reported
    cfg = CLIPVisionConfig.from_dict(CLIP_VISION_H)
    f32 = materialize_random(lambda: CLIPVisionEncoder(cfg, dtype=torch.float32), torch.device("cuda"), seed=28)
    px = tensor(1, 3, 224, 224)
    with torch.inference_mode():
        card = f32(px.cuda()).cpu()
        bf16 = materialize_random(lambda: CLIPVisionEncoder(cfg, dtype=torch.bfloat16), torch.device("cuda"), seed=0)
        bf16.load_state_dict(f32.state_dict())
        card_bf16 = bf16(px.cuda()).float().cpu()
        t0 = time.perf_counter()
        ref = f32.to("cpu")(px)
        cpu_s = time.perf_counter() - t0
    row = {"phase": "wan_edit", "check": "clip_vision_card_vs_cpu", "model": "CLIP ViT-H/14 vision, 32 layers",
           "tokens": list(ref.shape), "rel_l2_f32": rel_l2(card, ref), "tol_rel_l2_f32": CLIP_F32_REL_L2,
           "rel_l2_bf16_vs_cpu_f32": rel_l2(card_bf16, ref), "tol_rel_l2_bf16": CLIP_BF16_REL_L2,
           "finite": bool(torch.isfinite(card_bf16).all()), "cpu_seconds": cpu_s}
    emit(row)
    check(tuple(ref.shape) == (1, CLIP_TOKENS, 1280) and row["finite"] and row["rel_l2_f32"] <= CLIP_F32_REL_L2
          and row["rel_l2_bf16_vs_cpu_f32"] <= CLIP_BF16_REL_L2, f"CLIP vision on the card: {row}")
    del f32, bf16
    release()


def write_component_configs(home: Path, manifest: Path, configs=None) -> None:
    """UMT5-XXL's ``config.json`` where ``manifest``'s text encoder names it,
    and each ``configs`` entry (component name or type → config) where that
    component's ``config_path`` points, under ``home``'s components."""
    import yaml

    doc = yaml.safe_load(manifest.read_text())
    for comp in doc["spec"]["components"]:
        cfg = (configs or {}).get(comp.get("name") or comp["type"], UMT5_XXL if comp["type"] == "text_encoder"
                                  else None)
        if cfg is not None and comp.get("config_path"):
            path = home / "components" / comp["config_path"]
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(cfg))


def edit_engine(label, manifest, model_type, home, weights, configs=None, weights_by_component=None):
    """A Wan engine as ``wan_engine`` builds it, with ``configs`` written
    (``write_component_configs``), synthetic ``weights`` except where
    ``weights_by_component`` (component name or type) says otherwise, and
    observed as there (``engine.wan_smoke``)."""
    os.environ["APEX_SYNTHETIC_WEIGHTS"] = weights
    write_component_configs(home / label, manifest, configs)
    engine = wan_engine(label, manifest, model_type, home)
    instantiate = engine._instantiate_family

    def per_component(registry, spec, family):
        os.environ["APEX_SYNTHETIC_WEIGHTS"] = (weights_by_component or {}).get(
            spec.get("name") or spec.get("type"), (weights_by_component or {}).get(spec.get("type"), weights))
        try:
            return instantiate(registry, spec, family)
        finally:
            os.environ["APEX_SYNTHETIC_WEIGHTS"] = weights

    engine._instantiate_family = per_component
    return engine


_STEP = re.compile(r"(?:(?:Denoising|Causal) step|DF row) (\d+)/(\d+)")


def edit_drive(label, engine, kw, launches_per_forward, expected_forwards, frames_expected, latent_t_expected,
               extra_launches=0):
    """One request through ``engine``: the kernel's launch count set to 0
    before and read after (``launches_per_forward`` a forward and
    ``extra_launches`` a request outside them expected), every progress
    message stamped (synchronised), per-step seconds, the decode's seconds
    and latent frames (``latent_t_expected``: each decode's, or a list in
    decode order), peak GiB, the frames' count and size checked. Returns
    (row, frames)."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    os.environ["APEX_HOME_DIR"] = str(Path(engine.components_root).parent)
    seen = engine.wan_smoke
    stamps, steps = [], []

    def progress(p, message, *_a, **_k):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stamps.append((message, now))
        if _STEP.fullmatch(message):
            steps.append(now)

    for v in seen.values():
        v.clear()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    frames = engine.run(progress_callback=progress, **kw)
    torch.cuda.synchronize()
    total, launches = time.perf_counter() - t0, flash_attention.launches
    first = dict(reversed(stamps))  # each message's first time
    start = stamps[0][1]
    denoise_end = next((t for m, t in stamps if m in ("Denoising complete", "Causal generation complete")), None)
    # the first step counts from the last message before it (the conditioning's end)
    before = max((t for m, t in stamps if t < steps[0] and not _STEP.fullmatch(m)), default=start)
    per_step = [b - a for a, b in zip([before] + steps[:-1], steps)]
    n_forwards = sum(seen["forwards"].values()) if seen["forwards"] else None
    row = {
        "phase": label, "model_type": engine.model_type, "request": {k: v for k, v in kw.items()
                                                                      if isinstance(v, (int, float, str))},
        "timesteps": [float(t) for t in engine.scheduler.timesteps],
        "seconds_total": total, "seconds_per_step": per_step,
        "median_seconds_per_step_after_the_first": statistics.median(per_step[1:] or per_step),
        "seconds_before_denoise": before - start,
        "stages": {m: t - start for m, t in first.items() if not _STEP.fullmatch(m)},
        "seconds_decode": (first.get("Completed pipeline", first.get("Completed causal pipeline", first.get(
            "Completed diffusion-forcing pipeline", start))) - denoise_end if denoise_end else None),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "forwards_by_expert": dict(seen["forwards"]), "forwards_expected": expected_forwards,
        "flash_launches": launches,
        "flash_launches_expected": launches_per_forward * sum(expected_forwards.values()) + extra_launches,
        "components_built": list(seen["built"]),
        "decoded_latents": [list(z.shape) for z in seen["decoded"]],
        "frames": len(frames), "frame_shape": list(frames[0].shape),
        "latents_finite": all(bool(torch.isfinite(z).all()) for z in seen["decoded"]),
    }
    emit(row)
    check(len(frames) == frames_expected and all(f.shape == (kw["height"], kw["width"], 3) and f.dtype == np.uint8
                                                  for f in frames),
          f"{label}: {len(frames)} frames of {frames[0].shape}, expected {frames_expected}")
    check(row["latents_finite"], f"{label}: latents not finite")
    want_t = (list(latent_t_expected) if isinstance(latent_t_expected, (list, tuple))
              else [latent_t_expected] * len(row["decoded_latents"]))
    check([z[2] for z in row["decoded_latents"]] == want_t,
          f"{label}: decoded latent frames {row['decoded_latents']}, expected {latent_t_expected}")
    check(n_forwards is None or row["forwards_by_expert"] == expected_forwards,
          f"{label}: forwards {row['forwards_by_expert']}, expected {expected_forwards}")
    check(launches == row["flash_launches_expected"],
          f"{label}: flash launched {launches} times, expected {row['flash_launches_expected']}")
    return row, frames


def a14b_forwards(engine, timesteps, kw) -> dict:
    """Each expert's forwards over ``timesteps``: the primary while t ≥
    boundary_ratio·1000, ``transformer_2`` after, two a step under CFG."""
    boundary = kw.get("boundary_ratio")
    low = sum(1 for t in timesteps if boundary is not None and float(t) < boundary * 1000)
    g = kw.get("guidance_scale", 5.0)
    g2 = kw.get("guidance_scale_2") if kw.get("guidance_scale_2") is not None else g
    want = {"transformer": (len(timesteps) - low) * (1 + (g > 1.0))}
    if low:
        want["transformer_2"] = low * (1 + (g > 1.0 and g2 > 1.0))
    return want


def wan_edit_media(frames: int, seed: int):
    """``frames`` seeded 480x832 frames of a disk moving 6 px a frame over a
    smooth background, and the point mask of the disk on the first frame
    tracked over the first 8 (``mask/segment.py``, as the ``wan`` phase runs
    it), as 0/255 RGB frames."""
    import numpy as np

    from apex_studio_tpu_torch.mask import mask_from_points, track_mask

    rng = np.random.default_rng(seed)
    background = cv2_smooth(rng, (480, 832))
    yy, xx = np.mgrid[:480, :832]
    video = []
    for i in range(frames):
        img = background.copy()
        img[(yy - 240) ** 2 + (xx - 300 - 6 * i) ** 2 <= 70 ** 2] = [200, 80, 80]
        video.append(img)
    m0 = mask_from_points(video[0], [{"x": 300, "y": 240}])
    tracked = track_mask(video[:8], m0, 0, "forward")
    masks = [np.repeat((np.asarray(tracked[i]) > 0).astype(np.uint8)[..., None] * 255, 3, axis=-1) for i in range(8)]
    check(all(m.shape == (480, 832, 3) and m.any() for m in masks), "the tracked point mask is empty")
    return video, masks


def step_breakdown(phase, name, step_s, launches, kernel_rows, w4_calls=None, linear_rows=()) -> dict:
    """A step of ``step_s`` seconds split into attention (queued kernel ms x
    ``launches``, {case: launches a step}), the ``_w4`` Linears (queued ms x
    ``w4_calls`` by shape, when given) and the rest."""
    queued = {r["case"]: r["queued_ms"] for r in kernel_rows}
    attention_s = sum(queued[case] * n for case, n in launches.items()) / 1e3
    row = {"phase": phase, "step_breakdown": name, "seconds_per_step": step_s, "attention_seconds": attention_s,
           "attention_share": attention_s / step_s, "launches": launches}
    if w4_calls:
        by = {key: sum(w4_calls[(r["rows"], r["in"], r["out"])] * r[key] for r in linear_rows) / 1e3
              for key in ("w4_ms", "bf16_ms")}
        row.update(w4_linear_seconds=by["w4_ms"], w4_linear_share=by["w4_ms"] / step_s,
                   bf16_linear_seconds_same_calls=by["bf16_ms"])
    row["other_seconds"] = step_s - attention_s - row.get("w4_linear_seconds", 0.0)
    row["reckoning"] = ("queued kernel ms x launches; queued _w4 ms x calls by shape where given; other = the "
                        "rest (norms, modulation, RoPE, the bf16 and smaller Linears, the step update)")
    emit(row)
    return row


def phase_wan_edit(home: Path, kernel_rows=()):
    """The Wan editing engines from their manifests at 480x832, full width
    (the requests' DiTs ``EDIT_LAYERS`` of their 40 blocks), the 14B DiTs
    int4-resident (UMT5-XXL int8, CLIP ViT-H bf16): the
    variants' card-vs-CPU checks; VACE (Wan 2.1 14B) at 81 frames with a
    masked control video and a reference image, one CFG step each, seeds 0,
    0 and 1; Wan 2.1 i2v with CLIP at 81 frames (1 step); then at 33 frames
    fflf, inp (a point mask), v2v at strength 0.7 (the A14B experts, 3 steps
    so that the switch at 0.875 falls inside), fun_vace, phantom with two
    subject references and fun_control (1 step each); SVI as two segments of
    33 frames (1 step each)."""
    import numpy as np
    import torch

    paths = {}
    wan_edit_reference()
    video, masks = wan_edit_media(81, 7)
    ref_image = cv2_smooth(np.random.default_rng(8), (480, 832))
    # -- VACE, the headline request
    vace_kw = dict(prompt=WAN_PROMPT, negative_prompt=WAN_NEG, video=video, mask=masks, reference_images=[ref_image],
                   height=480, width=832, num_frames=81, num_inference_steps=2, guidance_scale=5.0)
    engine = edit_engine("wan_vace", WAN_VACE_MANIFEST, "vace", home, "int4",
                         {"transformer": edit_depth(WAN_VACE_TRANSFORMER)})
    rows, frames = [], []
    # one step each: a cut of depth that keeps the script inside its limit
    for seed, steps in ((0, 1), (0, 1), (1, 1)):
        row, f = edit_drive("wan_vace", engine, dict(vace_kw, seed=seed, num_inference_steps=steps),
                            2 * EDIT_LAYERS + 2 * EDIT_VACE_LAYERS, {"transformer": 2 * steps}, 81, 21)
        rows.append(row)
        frames.append(f)
    same = all(np.array_equal(a, b) for a, b in zip(frames[0], frames[1]))
    differ = not np.array_equal(frames[0][40], frames[2][40])
    emit({"phase": "wan_vace", "requests_1_2_identical": same, "requests_1_3_differ": differ,
          "tokens": WAN_EDIT_TOKENS["vace"], "vace_layers": list(engine.transformer.cfg.vace_layers),
          "median_seconds_per_step_after_the_first": statistics.median(t for r in rows for t in r["seconds_per_step"]),
          "seconds_per_request": [r["seconds_total"] for r in rows]})
    check(same, "VACE requests 1 and 2 (same inputs and seed) differ")
    check(differ, "VACE requests 1 and 3 (other seed) are identical")
    check(engine.transformer.cfg.vace_layers == tuple(range(0, EDIT_LAYERS, 5)), "VACE layers")
    paths["wan_vace_81_frames"] = rows
    del engine, frames
    release()
    # -- Wan 2.1 i2v with the CLIP image branch
    # one step: a cut of depth
    clip_kw = dict(prompt=PROMPT_B, negative_prompt=WAN_NEG, image=ref_image, height=480, width=832, num_frames=81,
                   num_inference_steps=1, guidance_scale=5.0, seed=0)
    engine = edit_engine("wan21_i2v", WAN21_I2V_MANIFEST, "i2v", home, "int4",
                         {"transformer": edit_depth(WAN21_I2V_TRANSFORMER), "image_encoder": CLIP_VISION_H},
                         {"helper": "bf16"})
    row, _ = edit_drive("wan21_i2v", engine, clip_kw, 3 * EDIT_LAYERS, {"transformer": 2}, 81, 21)
    check(engine.transformer.cfg.image_dim == 1280 and engine.transformer.cfg.in_channels == 36, "Wan 2.1 I2V DiT")
    clip = engine.helpers["image_encoder"]
    check(clip.dtype == torch.bfloat16 and len(clip.layers) == 32, "the CLIP image encoder")
    paths["wan21_i2v_81_frames"] = [row]
    del engine, clip
    release()
    if kernel_rows:
        vs, clip_s, frame = WAN_EDIT_TOKENS["vace"], WAN_TOKENS["clip"], 2 * EDIT_LAYERS
        vace_step = statistics.median(r["seconds_per_step"][-1] for r in paths["wan_vace_81_frames"])
        step_breakdown("wan_edit", "vace_cfg_step_81_frames_plus_1_reference", vace_step,
                            {f"wan_vace_self_s{vs}_h40": 2 * (EDIT_LAYERS + EDIT_VACE_LAYERS),
                             f"wan_vace_cross_sq{vs}_sk{WAN_TEXT_TOKENS}_h40": 2 * (EDIT_LAYERS + EDIT_VACE_LAYERS)},
                            kernel_rows)
        step_breakdown("wan_edit", "wan21_i2v_cfg_step_81_frames", row["seconds_per_step"][-1],
                            {f"wan_self_clip_s{clip_s}_h40": frame,
                             f"wan_cross_clip_sq{clip_s}_sk{WAN_TEXT_TOKENS}_h40": frame,
                             f"wan21_image_cross_sq{clip_s}_sk{CLIP_TOKENS}_h40": frame}, kernel_rows)
    # -- the A14B i2v-derived engines and v2v at 33 frames
    short, short_masks = video[:33], masks
    a14b = dict(prompt=PROMPT_A, negative_prompt=WAN_NEG, height=480, width=832, num_frames=33,
                num_inference_steps=3, guidance_scale=4.0, guidance_scale_2=3.0, boundary_ratio=0.875, seed=0)
    i2v_configs = {"transformer": edit_depth(WAN_I2V_TRANSFORMER), "transformer_2": edit_depth(WAN_I2V_TRANSFORMER)}
    t2v_configs = {"transformer": edit_depth(_WAN14B), "transformer_2": edit_depth(_WAN14B)}
    for label, manifest, mt, configs, extra in (
            ("wan_fflf", WAN_FFLF_MANIFEST, "fflf", i2v_configs, dict(image=short[0], last_image=short[-1])),
            ("wan_inp", WAN_INP_MANIFEST, "inp", i2v_configs, dict(video=short, mask=short_masks[0][..., 0])),
            ("wan_v2v", WAN_V2V_MANIFEST, "v2v", t2v_configs,
             dict(video=short, strength=0.7, num_inference_steps=4))):
        engine = edit_engine(label, manifest, mt, home, "int4", configs)
        kw = dict(a14b, **extra)
        engine.load_component_by_type("scheduler")
        engine.scheduler.set_timesteps(kw["num_inference_steps"])
        ts = engine.scheduler.timesteps
        if mt == "v2v":
            ts = ts[min(int(round(len(ts) * (1.0 - kw["strength"]))), len(ts) - 1):]
        row, _ = edit_drive(label, engine, kw, 2 * EDIT_LAYERS, a14b_forwards(engine, ts, kw), 33, 9)
        if mt != "v2v":
            check(engine.transformer.cfg.in_channels == 36, f"{label}: the DiT takes 36 channels")
        paths[f"{label}_33_frames"] = [row]
        del engine
        release()
    # -- the one-DiT host-stepped engines at 33 frames
    # one step each: a cut of depth
    two = dict(prompt=PROMPT_A, negative_prompt=WAN_NEG, height=480, width=832, num_frames=33,
               num_inference_steps=1, guidance_scale=5.0, seed=0)
    subject = [ref_image, cv2_smooth(np.random.default_rng(9), (480, 832))]
    for label, manifest, mt, configs, extra, per_forward, lat_t in (
            ("wan_fun_vace", WAN_FUN_VACE_MANIFEST, "fun_vace", {"transformer": edit_depth(WAN_VACE_TRANSFORMER)},
             dict(start_image=short[0], end_image=short[-1], subject_ref_images=[ref_image]),
             2 * EDIT_LAYERS + 2 * EDIT_VACE_LAYERS, 9),
            ("wan_phantom", WAN_PHANTOM_MANIFEST, "phantom", {"transformer": edit_depth(_WAN14B)},
             dict(subject_reference_images=subject),
             2 * EDIT_LAYERS, 9),
            ("wan_fun_control", WAN_FUN_CONTROL_MANIFEST, "fun_control",
             {"transformer": edit_depth(WAN_FUN_CONTROL_TRANSFORMER)},
             dict(control_video=short, ref_image=ref_image), 2 * EDIT_LAYERS, 9)):
        engine = edit_engine(label, manifest, mt, home, "int4", configs)
        row, _ = edit_drive(label, engine, dict(two, **extra), per_forward, {"transformer": 2}, 33, lat_t)
        paths[f"{label}_33_frames"] = [row]
        del engine
        release()
    # -- Stable Video Infinity: two segments of 33 frames
    svi_kw = dict(clip_kw, num_frames=33 + 33 - 4, num_frames_per_segment=33, num_overlap_frames=4,
                  num_motion_frame=4, prompts=[PROMPT_B, PROMPT_A], num_inference_steps=1)
    engine = edit_engine("wan_svi", WAN_SVI_MANIFEST, "svi", home, "int4",
                         {"transformer": edit_depth(WAN21_I2V_TRANSFORMER), "image_encoder": CLIP_VISION_H},
                         {"helper": "bf16"})
    row, _ = edit_drive("wan_svi", engine, svi_kw, 3 * EDIT_LAYERS, {"transformer": 4}, 62, 9)
    check(len(engine.wan_smoke["decoded"]) == 2, "SVI decoded other than two segments")
    paths["wan_svi_2_segments"] = [row]
    del engine
    release()
    return paths


def phase_wan_causal(home: Path, kernel_rows=()):
    """The Self-Forcing manifest (Wan 2.1 1.3B causal DiT in bf16 at its
    widths, ``CAUSAL_LAYERS`` of its 30 blocks; its FlowMatchScheduler,
    UMT5-XXL int8) at its defaults: 480x832, 81 frames
    (21 latent frames, 7 blocks of 3 frames, 4 steps each, one commit a
    block), twice with seed 0 and once with seed 1; once with a local window
    of 6 latent frames and a 1-frame sink; once with an image pre-fill. The
    cache is read around every forward: before a block's first step it holds
    exactly the blocks committed so far."""
    import numpy as np
    import torch

    engine = edit_engine("wan_causal", WAN_CAUSAL_MANIFEST, "causal", home, "int8",
                         {"transformer": dict(SELF_FORCING_TRANSFORMER, num_layers=CAUSAL_LAYERS)},
                         {"transformer": "bf16"})
    engine.load_components(return_latents=False)
    tf = engine.transformer
    check(tf.dtype == torch.bfloat16 and len(tf.blocks) == CAUSAL_LAYERS
          and tf.cfg.num_attention_heads == CAUSAL_HEADS, "the Self-Forcing DiT")
    filled = []
    forward_causal = tf.forward_causal

    def observed(x, t, ctx, kc, vc, cache_pos, *a, **k):
        rows_before = int((kc[0, 0].abs().amax(dim=(-1, -2)) > 0).sum())
        out = forward_causal(x, t, ctx, kc, vc, cache_pos, *a, **k)
        filled.append((int(cache_pos), x.shape[2], rows_before, int((kc[-1, 0].abs().amax(dim=(-1, -2)) > 0).sum())))
        return out

    tf.forward_causal = observed
    # the attention calls by kind: a block against the whole cache has a bias
    # and S_max keys (the kernel's own counter counts every launch)
    from apex_studio_tpu_torch.ops.attention import attention_registry

    flash = attention_registry.get("flash")
    against_cache = []

    def classified(q, k, v, bias=None, **kw):
        if bias is not None:
            against_cache.append(k.shape[1])
        return flash(q, k, v, bias=bias, **kw)

    attention_registry._entries["flash"] = classified
    base = dict(prompt=WAN_PROMPT, height=480, width=832, num_frames=81, num_inference_steps=4,
                num_frame_per_block=3)
    frame = WAN_TOKENS["frame"]
    rows, outs = [], []
    for label, extra, n_input in (("default", dict(seed=0), 0), ("default", dict(seed=0), 0),
                                  ("default", dict(seed=1), 0),
                                  ("window6_sink1", dict(seed=0, local_attn_size=6, sink_size=1), 0),
                                  ("image_prefill", dict(seed=0, image=cv2_smooth(np.random.default_rng(10),
                                                                                  (480, 832))), 1)):
        filled.clear()
        against_cache.clear()
        blocks, steps = 7, 4
        forwards = blocks * (steps + 1) + (1 if n_input else 0)
        row, frames = edit_drive("wan_causal", engine, dict(base, **extra), 2 * CAUSAL_LAYERS,
                                 {"transformer": forwards}, 81 + 4 * n_input, 21 + n_input)
        # before each block's first step: the blocks committed so far (and the pre-fill)
        committed = [n_input * frame + b * 3 * frame for b in range(blocks)]
        firsts = [filled[(1 if n_input else 0) + b * (steps + 1)] for b in range(blocks)]
        cache_ok = ([f[2] for f in firsts] == committed and all(f[0] == c for f, c in zip(firsts, committed))
                    and filled[-1][3] == (n_input + 21) * frame)
        check(len(filled) == forwards, f"causal ({label}): {len(filled)} forwards, expected {forwards}")
        s_max = (21 + n_input) * frame
        check(len(against_cache) == CAUSAL_LAYERS * forwards and set(against_cache) == {s_max},
              f"causal ({label}): {len(against_cache)} launches against the cache (keys {set(against_cache)}), "
              f"expected {CAUSAL_LAYERS} a forward over {s_max}")
        row.update(variant=label, forwards=len(filled), launches_against_cache=len(against_cache),
                   cache_rows_before_each_block=[f[2] for f in firsts],
                   cache_rows_committed_expected=committed, cache_ok=cache_ok,
                   s_max=tuple(engine.kv_cache[0].shape)[2])
        emit({"phase": "wan_causal", "variant": label, "forwards": len(filled),
              "launches_against_cache": len(against_cache), "launches": row["flash_launches"],
              "cache_rows_before_each_block": row["cache_rows_before_each_block"], "cache_ok": cache_ok,
              "s_max": row["s_max"]})
        check(cache_ok, f"the causal cache ({label}) does not hold the committed blocks: {filled}")
        check(row["s_max"] == (21 + n_input) * frame, f"causal S_max {row['s_max']}")
        rows.append(row)
        outs.append(frames)
    same = all(np.array_equal(a, b) for a, b in zip(outs[0], outs[1]))
    differ = not np.array_equal(outs[0][40], outs[2][40])
    window_differs = not np.array_equal(outs[0][80], outs[3][80])
    emit({"phase": "wan_causal", "requests_1_2_identical": same, "requests_1_3_differ": differ,
          "window_changes_the_late_frames": window_differs})
    check(same and differ, f"causal determinism: same {same}, differ {differ}")
    check(window_differs, "the local window changed nothing")
    tf.forward_causal = forward_causal
    attention_registry._entries["flash"] = flash
    if kernel_rows:
        blk, clip = WAN_EDIT_TOKENS["causal_block"], WAN_TOKENS["clip"]
        # a step is one forward; 4 of the 5 forwards of a block are steps
        step = statistics.median(t for r in rows[:3] for t in r["seconds_per_step"])
        step_breakdown("wan_causal", "causal_denoise_step_one_forward", step,
                            {f"wan_causal_last_block_sq{blk}_sk{clip}_bias_h{CAUSAL_HEADS}": CAUSAL_LAYERS,
                             f"wan_causal_cross_sq{blk}_sk{WAN_TEXT_TOKENS}_h{CAUSAL_HEADS}": CAUSAL_LAYERS},
                            kernel_rows)
    del engine, tf
    release()
    return {"wan_causal_81_frames": rows}


# -- Flux editing and FLUX.2 ---------------------------------------------------------------------


FLUX_KONTEXT_MANIFEST = REPO / "manifests" / "image" / "flux-dev-kontext.yml"
FLUX_FILL_MANIFEST = REPO / "manifests" / "image" / "flux-dev-fill.yml"
FLUX_CONTROL_MANIFEST = REPO / "manifests" / "image" / "flux-dev-control.yml"
FLUX2_MANIFEST = REPO / "manifests" / "image" / "flux2-dev.yml"
FLUX2_TURBO_MANIFEST = REPO / "manifests" / "image" / "flux2-dev-turbo.yml"
# t2i at 2 steps and Turbo at 4 of its 8: cuts of steps that keep the whole
# script inside its limit
FLUX2_STEPS, FLUX2_TURBO_STEPS = 2, 4
# black-forest-labs/FLUX.1-Fill-dev and FLUX.1-Canny-dev transformer/config.json: Flux Dev's widths, 384
# input channels (noise 64 + masked-image latents 64 + 8x8 mask bits packed 2x2, 256) and 128 (noise +
# control-image latents)
_FLUX_DEV = {"_class_name": "FluxTransformer2DModel", "patch_size": 1, "out_channels": 64, "num_layers": 19,
             "num_single_layers": 38, "attention_head_dim": 128, "num_attention_heads": 24,
             "joint_attention_dim": 4096, "pooled_projection_dim": 768, "guidance_embeds": True,
             "axes_dims_rope": [16, 56, 56]}
FLUX_FILL_TRANSFORMER = dict(_FLUX_DEV, in_channels=384)
FLUX_CANNY_TRANSFORMER = dict(_FLUX_DEV, in_channels=128)
# joint lengths at 1024²: 512 T5 / Mistral rows + 4096 noise tokens + 4096 for each reference image
# (DreamOmni2's two square references both take the 1024x1024 bucket)
FLUX_EDIT_TOKENS = {"kontext": 512 + 2 * 4096, "dreamomni2": 512 + 3 * 4096}
FLUX2_TOKENS = {"t2i": 512 + 4096, "edit": 512 + 2 * 4096}
FLUX2_HEADS, FLUX2_LAYERS, FLUX2_CONTROL_BLOCKS = 48, 8 + 48, 4
# mistralai/Mistral-Small-3.2-24B-Instruct-2506's text_config (FLUX.2-dev's text_encoder), written flat:
# neither package unnests a text_config; stack_layers (10, 20, 30) come from the manifest
MISTRAL_SMALL_32 = {"model_type": "mistral", "vocab_size": 131072, "hidden_size": 5120, "intermediate_size": 32768,
                    "num_hidden_layers": 40, "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
                    "rms_norm_eps": 1e-5, "rope_theta": 1e9, "max_position_embeddings": 131072}
# black-forest-labs/FLUX.2-dev vae/config.json (AutoencoderKLFlux2): AutoencoderKL's widths with 32 latent
# channels and quant convs, the packed latents (2x2 x 32 = 128 channels) normalized by BatchNorm running
# statistics in place of a scaling and shift factor
FLUX2_VAE = {"_class_name": "AutoencoderKLFlux2", "latent_channels": 32, "block_out_channels": [128, 256, 512, 512],
             "layers_per_block": 2, "norm_num_groups": 32, "use_quant_conv": True, "use_post_quant_conv": True,
             "packed_batch_norm": True, "batch_norm_eps": 1e-4, "patch_size": [2, 2], "scaling_factor": 1.0,
             "shift_factor": None}
# rows, in, out and calls a forward of the FLUX.2 DiT's resident Linears at t2i's 4096 image and 512 text
# rows: the 8 dual blocks' q/k/v/out and SwiGLU in and out per stream, the 48 single blocks' fused in- and
# out-projections over 4608 rows, the context embedder, the shared modulations on one row
FLUX2_LINEAR_CALLS = {(4096, 6144, 6144): 32, (4096, 6144, 36864): 8, (4096, 18432, 6144): 8,
                      (512, 6144, 6144): 32, (512, 6144, 36864): 8, (512, 18432, 6144): 8,
                      (4608, 6144, 55296): 48, (4608, 24576, 6144): 48, (512, 15360, 6144): 1,
                      (1, 6144, 36864): 2, (1, 6144, 18432): 1}
FLUX2_LORA_RANK = 16
# The FLUX.2 DiT's bf16 forward on the card against f32 on the CPU (1 + 1 blocks,
# synthetic weights): its distance grows with the width under the synthetic
# recipe's normal(0, 0.02) weights (the 12- and 24-head rows of the same
# check hold BF16_REL_L2); at the published 48 heads it read 1.30% on an
# H100, so the limit there is 2%. On the CPU with such weights the port's
# bf16 forward reads 1.30% and the JAX module's own 1.46% from the same f32
# forward (tests/torch_bf16_width.py): the rounding of these weights, not a
# port fault.
FLUX2_BF16_REL_L2 = 2e-2


def flux_edit_kernel_inputs():
    """(case, q, k, v, bias) at the joint lengths the Flux editing and FLUX.2
    paths give the kernel at 1024² (unmasked): FLUX.2 t2i and edit with one
    reference at 48 heads of 128, Kontext and DreamOmni2 with two references
    at 24."""
    cases = [(f"flux2_t2i_s{FLUX2_TOKENS['t2i']}_h48", FLUX2_TOKENS["t2i"], FLUX2_HEADS),
             (f"flux2_edit_s{FLUX2_TOKENS['edit']}_h48", FLUX2_TOKENS["edit"], FLUX2_HEADS),
             (f"flux_kontext_s{FLUX_EDIT_TOKENS['kontext']}_h24", FLUX_EDIT_TOKENS["kontext"], 24),
             (f"flux_dreamomni2_s{FLUX_EDIT_TOKENS['dreamomni2']}_h24", FLUX_EDIT_TOKENS["dreamomni2"], 24)]
    for i, (name, s, h) in enumerate(cases):
        yield (name, *qkv(1, s, s, h, 128, 90 + i), None)


def write_manifest_config(root: Path, manifest: Path, ctype: str, cfg: dict) -> None:
    """``cfg`` as the config.json that ``manifest``'s ``ctype`` component
    names (``config_path``), under ``root``'s components."""
    import yaml

    comp = next(c for c in yaml.safe_load(manifest.read_text())["spec"]["components"] if c["type"] == ctype)
    path = root / "components" / comp["config_path"]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(cfg))


def derived_manifest(home: Path, source: Path, model_type: str, transformer_base: str = None) -> Path:
    """``source`` with another ``model_type`` (and transformer base), written into ``home``."""
    import yaml

    doc = yaml.safe_load(source.read_text())
    doc["metadata"]["id"] = f"{doc['metadata']['id']}-{model_type}-smoke"
    doc["spec"]["model_type"] = model_type
    if transformer_base:
        next(c for c in doc["spec"]["components"] if c["type"] == "transformer")["base"] = transformer_base
    path = home / f"{source.stem}-{model_type}.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


def image_engine(label, manifest, model_type, home, weights, configs=()):
    """``UniversalEngine`` on the card over ``manifest`` with synthetic
    ``weights``, its own home (``configs``: (component type, config) written
    where the manifest names them), the byte-level tokenizer in every text
    encoder, and the memory fallback's gate read at the transformer's load
    (``engine.gate``)."""
    from apex_studio_tpu_torch.engine import UniversalEngine
    from apex_studio_tpu_torch.utils.memory import should_stream

    os.environ["APEX_SYNTHETIC_WEIGHTS"] = weights
    os.environ["APEX_HOME_DIR"] = str(home / label)
    for ctype, cfg in configs:
        write_manifest_config(home / label, manifest, ctype, cfg)
    engine = UniversalEngine(manifest, model_type=model_type, device="cuda")
    tok = make_tokenizer()
    for spec in engine.component_specs.values():
        if spec.get("type") == "text_encoder":
            spec["tokenizer"] = tok
    fallback, engine.gate = engine._apply_memory_fallback, []

    def observed_fallback(model, spec):
        engine.gate.append(should_stream(model, device=engine.device))
        return fallback(model, spec)

    engine._apply_memory_fallback = observed_fallback
    return engine


def image_drive(label, engine, requests, steps, launches_per_step):
    """Requests (run keyword dicts) through ``engine`` at 1024², each with the
    kernel's launch count set to 0 before and read after: every progress
    message stamped (synchronised) with the peak GiB of the stage it ends,
    seconds per step (the first from the message before it), the latents
    handed to the decode checked finite, the frame checked. Returns (rows,
    frames)."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    decode, latents_finite = engine._decode_frames, []

    def observed_decode(tokens, *a):
        latents_finite.append(bool(torch.isfinite(tokens).all()))
        return decode(tokens, *a)

    engine._decode_frames = observed_decode
    rows, frames_out = [], []
    for i, kw in enumerate(requests):
        stamps, peaks = [], {}

        def progress(p, message, *_a, **_k):
            torch.cuda.synchronize()
            stamps.append((message, time.perf_counter()))
            stage = "denoise" if _STEP.fullmatch(message) else message
            peaks[stage] = max(peaks.get(stage, 0.0), torch.cuda.max_memory_allocated() / 2**30)
            torch.cuda.reset_peak_memory_stats()

        latents_finite.clear()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        frames = engine.run(height=SIZE, width=SIZE, num_inference_steps=steps, progress_callback=progress, **kw)
        torch.cuda.synchronize()
        total, launches = time.perf_counter() - t0, flash_attention.launches
        step_t = [t for m, t in stamps if _STEP.fullmatch(m)]
        before = max(t for m, t in stamps if t < step_t[0] and not _STEP.fullmatch(m))
        per_step = [b - a for a, b in zip([before] + step_t[:-1], step_t)]
        row = {
            "phase": label, "model_type": engine.model_type, "request": i + 1,
            "inputs": {k: (v if isinstance(v, (int, float, str)) else f"{len(v)} images" if isinstance(v, list)
                           else list(np.shape(v))) for k, v in kw.items()},
            "steps": steps, "seconds_total": total, "seconds_per_step": per_step,
            "median_seconds_per_step_after_the_first": statistics.median(per_step[1:] or per_step),
            "stages": {m: t - t0 for m, t in dict(reversed(stamps)).items() if not _STEP.fullmatch(m)},
            "peak_gib_by_stage": peaks, "peak_gib": max(peaks.values()),
            "flash_launches": launches, "flash_launches_per_step": launches / steps,
            "flash_launches_expected": launches_per_step * steps,
            "frames": [list(f.shape) for f in frames], "latents_finite": latents_finite,
        }
        emit(row)
        check(len(frames) == 1 and frames[0].shape == (SIZE, SIZE, 3) and frames[0].dtype == np.uint8,
              f"{label} request {i + 1}: bad frames {row['frames']}")
        check(latents_finite == [True], f"{label} request {i + 1}: latents not finite")
        check(launches == launches_per_step * steps,
              f"{label} request {i + 1}: flash launched {launches} times, expected {launches_per_step * steps}")
        rows.append(row)
        frames_out.append(frames[0])
    return rows, frames_out


def phase_flux_edit(home: Path, kernel_rows=()):
    """Flux 1's editing engines from their manifests at 1024x1024, full width
    and depth, synthetic int8 weights (W8A8), 2 steps a request, 57 launches a
    step: Kontext with a seeded reference image, seeds 0, 0, 1 (1 and 2
    identical, 3 not; S = 8704); Fill with an image and a mask (a 384-channel
    DiT); Control with a control image (128 channels); DreamOmni2 with two
    square references at the 1024² bucket (S = 12,800), from a manifest
    derived from Kontext's."""
    import numpy as np

    rng = np.random.default_rng(11)
    source, second, control = (cv2_smooth(rng, (SIZE, SIZE)) for _ in range(3))
    mask = np.zeros((SIZE, SIZE), np.uint8)
    mask[256:768, 320:704] = 255
    paths = {}
    engine = image_engine("flux_kontext", FLUX_KONTEXT_MANIFEST, "kontext", home, "int8")
    kw = dict(prompt=PROMPT_B, image=source, guidance_scale=2.5)
    rows, frames = image_drive("flux_kontext", engine, [dict(kw, seed=0), dict(kw, seed=0), dict(kw, seed=1)], 2,
                               BLOCKS)
    same, differ = bool(np.array_equal(frames[0], frames[1])), not np.array_equal(frames[0], frames[2])
    emit({"phase": "flux_kontext", "requests_1_2_identical": same, "requests_1_3_differ": differ,
          "joint_tokens": FLUX_EDIT_TOKENS["kontext"], "memory_fallback_gate": engine.gate})
    check(same, "Kontext requests 1 and 2 (same inputs and seed) differ")
    check(differ, "Kontext requests 1 and 3 (other seed) are identical")
    paths["flux_kontext"] = rows
    del engine, frames
    release()
    for label, manifest, model_type, cfg, extra in (
            ("flux_fill", FLUX_FILL_MANIFEST, "fill", FLUX_FILL_TRANSFORMER, dict(image=source, mask_image=mask)),
            ("flux_control", FLUX_CONTROL_MANIFEST, "control", FLUX_CANNY_TRANSFORMER, dict(control_image=control))):
        engine = image_engine(label, manifest, model_type, home, "int8", [("transformer", cfg)])
        paths[label] = image_drive(label, engine, [dict(prompt=PROMPT_A, seed=2, **extra)], 2, BLOCKS)[0]
        check(engine.transformer.cfg.in_channels == cfg["in_channels"], f"{label}: the DiT's input channels")
        del engine
        release()
    engine = image_engine("flux_dreamomni2", derived_manifest(home, FLUX_KONTEXT_MANIFEST, "dreamomni2"),
                          "dreamomni2", home, "int8")
    paths["flux_dreamomni2"] = image_drive("flux_dreamomni2", engine, [dict(
        prompt="the fox from the first image in the room of the second", image_list=[source, second], seed=3)],
        2, BLOCKS)[0]
    del engine
    release()
    if kernel_rows:
        for name, model_type in (("kontext", "flux_kontext"), ("dreamomni2", "flux_dreamomni2")):
            s = FLUX_EDIT_TOKENS[name]
            step_breakdown("flux_edit", f"{name}_int8_step_s{s}", statistics.median(
                t for r in paths[model_type] for t in r["seconds_per_step"][1:]),
                {f"flux_{name}_s{s}_h24": BLOCKS}, kernel_rows)
    return paths


def flux2_reference():
    """The FLUX.2 DiT with 1 dual and 1 single block at 12, 24 and its full
    48 heads of 128 (the 15360-wide context), and Mistral-Small 3.2's text
    tower at full width with 2 layers (stacked at 1 and 2), each on the card
    in bf16 (the kernel; the encoder's masked attention on the plain route)
    against the same weights on the CPU in f32: the DiT over an 8 x 8 grid,
    one 4 x 4 reference grid and 64 text rows, within BF16_REL_L2 up to 24
    heads and FLUX2_BF16_REL_L2 at 48; the encoder over 64 tokens of which
    40 are real, within BF16_REL_L2."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.models.text_encoders import llama
    from apex_studio_tpu_torch.models.transformers import flux2

    rng = np.random.default_rng(13)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    inputs = (tensor(1, 64, 128), tensor(1, 64, 15360), torch.tensor([0.6]), torch.tensor([4.0]),
              tensor(1, 16, 128))
    for heads, tol in ((12, BF16_REL_L2), (24, BF16_REL_L2), (FLUX2_HEADS, FLUX2_BF16_REL_L2)):
        card_vs_cpu(f"flux2.base {heads} heads of 128, 1 + 1 blocks, one reference grid",
                    lambda dt, h=heads: flux2.Flux2Transformer2DModel(
                        flux2.Flux2Config(num_layers=1, num_single_layers=1, num_attention_heads=h), dtype=dt),
                    lambda m, x, s, t, g, c: m(x, s, t, g, grid_hw=(8, 8), cond_tokens=c, cond_grids=((4, 4),)),
                    inputs, tol, 31, phase="flux2")
    ids = torch.from_numpy(rng.integers(0, 131072, size=(1, 64)))
    mask = (torch.arange(64) < 40)[None].to(torch.int32)
    cfg = llama.LlamaConfig.from_dict({**MISTRAL_SMALL_32, "num_hidden_layers": 2, "stack_layers": [1, 2]})
    card_vs_cpu("Mistral-Small 3.2 text tower, 2 layers, stacked at 1 and 2",
                lambda dt: llama.LlamaTextEncoder(cfg, dtype=dt), lambda m, i, k: m(i, attention_mask=k),
                (ids, mask), BF16_REL_L2, 32, phase="flux2")


def write_flux2_lora(path: Path) -> int:
    """A rank-16 LoRA in the published PEFT naming (diffusers' module names
    under ``transformer.``), seeded, bf16: the 8 dual blocks' eight attention
    projections and the 48 single blocks' fused in- and out-projections.
    Returns the adapter count."""
    import torch

    from apex_studio_tpu_torch.loaders.safetensors_io import save_safetensors

    d, inner = 6144, 18432
    shapes = {f"transformer_blocks.{i}.attn.{p}": (d, d) for i in range(8)
              for p in ("to_q", "to_k", "to_v", "to_out.0", "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out")}
    for i in range(48):
        shapes[f"single_transformer_blocks.{i}.attn.to_qkv_mlp_proj"] = (d, 3 * d + 2 * inner)
        shapes[f"single_transformer_blocks.{i}.attn.to_out"] = (d + inner, d)
    g, sd = torch.Generator().manual_seed(0), {}
    for module, (n_in, n_out) in shapes.items():
        sd[f"transformer.{module}.lora_A.weight"] = (0.01 * torch.randn(FLUX2_LORA_RANK, n_in, generator=g)).bfloat16()
        sd[f"transformer.{module}.lora_B.weight"] = (0.01 * torch.randn(n_out, FLUX2_LORA_RANK, generator=g)).bfloat16()
    path.parent.mkdir(parents=True, exist_ok=True)
    save_safetensors(path, sd)
    return len(shapes)


def phase_flux2(home: Path, kernel_rows=()):
    """FLUX.2 Dev from its manifests at 1024x1024, its published widths (the
    Flux2Config defaults: 8 + 48 blocks, 48 heads of 128), the 32B DiT
    int4-resident and Mistral-Small 3.2 int8, both resident through the run,
    with the text tower's and the VAE's configs written where the manifests
    name them: the 2-block card-vs-CPU checks; t2i of 2 steps, (A, 0), (B, 1),
    (A, 0) (56 launches a step, 1 and 3 identical, 2 not); one VAE decode
    against float64; edit with one 1024² reference image (2 steps, S = 8704);
    the resident Linears at FLUX.2's shapes and the step split; Turbo at 4
    of its 8 steps with a rank-16 LoRA written at the manifest's LoRA source; the
    control DiT (4 chain blocks, 60 launches a step) with a control image,
    an inpaint image and a mask (2 steps)."""
    import numpy as np
    import torch

    import yaml

    from apex_studio_tpu_torch.quantize.residency import count_resident
    from apex_studio_tpu_torch.utils.defaults import get_lora_path
    from apex_studio_tpu_torch.utils.memory import params_nbytes

    flux2_reference()
    rng = np.random.default_rng(12)
    reference, control, inpaint = (cv2_smooth(rng, (SIZE, SIZE)) for _ in range(3))
    configs = [("text_encoder", MISTRAL_SMALL_32), ("vae", FLUX2_VAE)]
    paths = {}
    engine = image_engine("flux2_t2i", FLUX2_MANIFEST, "ti2i", home, "int4", configs)
    rows, frames = image_drive("flux2_t2i", engine, [dict(prompt=PROMPT_A, seed=0), dict(prompt=PROMPT_B, seed=1),
                                                     dict(prompt=PROMPT_A, seed=0)], FLUX2_STEPS, FLUX2_LAYERS)
    tf, te = engine.transformer, engine.text_encoder.model
    bits = {m.weight_bits for m in tf.modules() if getattr(m, "weight_scale", None) is not None}
    same, differ = bool(np.array_equal(frames[0], frames[2])), not np.array_equal(frames[0], frames[1])
    emit({"phase": "flux2", "requests_1_3_identical": same, "requests_1_2_differ": differ,
          "resident_weights": count_resident(tf), "resident_bits": sorted(bits),
          "encoder_resident_weights": count_resident(te), "encoder_stack_layers": list(te.cfg.stack_layers),
          "memory_fallback_gate": engine.gate, "vae_latent_channels": engine.vae.cfg.latent_channels,
          "dit_gib": params_nbytes(tf) / 2**30, "encoder_gib": params_nbytes(te) / 2**30})
    check(same, "FLUX.2 t2i requests 1 and 3 (same prompt and seed) differ")
    check(differ, "FLUX.2 t2i requests 1 and 2 (other prompt and seed) are identical")
    check(bits == {4} and count_resident(tf) > 0, f"the FLUX.2 DiT's resident bits {bits}")
    check(engine.gate == [False], f"the memory fallback's gate fired: {engine.gate}")
    check(te.cfg.hidden_size == 5120 and te.cfg.stack_layers == (10, 20, 30), "the Mistral tower's config")
    check(engine.vae.cfg.packed_batch_norm and engine.vae.cfg.latent_channels == 32, "the FLUX.2 VAE's config")
    g = torch.Generator("cuda").manual_seed(14)
    z = torch.randn(1, 32, SIZE // 8, SIZE // 8, generator=g, device="cuda")
    vae_row = {"phase": "flux2", "check": "vae_decode_vs_float64", **vae_decode_vs_float64(engine.vae, z),
               "tol": 2e-2}
    emit(vae_row)
    check(vae_row["rel_l2_vs_float64"] <= 2e-2, f"the FLUX.2 VAE's decode is {vae_row['rel_l2_vs_float64']} "
                                                "from float64")
    paths["flux2_t2i"] = rows
    paths["flux2_edit"] = image_drive("flux2_edit", engine, [dict(prompt=QWENIMAGE_EDIT_PROMPT, images=[reference],
                                                                  seed=0)], 2, FLUX2_LAYERS)[0]
    del engine, tf, te, frames
    release()
    linear_rows = residency_timing(list(FLUX2_LINEAR_CALLS), phase="flux2")
    if kernel_rows:
        t2i_step = statistics.median(t for r in rows for t in r["seconds_per_step"][1:])
        step_breakdown("flux2", f"t2i_int4_step_s{FLUX2_TOKENS['t2i']}", t2i_step,
                            {f"flux2_t2i_s{FLUX2_TOKENS['t2i']}_h48": FLUX2_LAYERS}, kernel_rows,
                            FLUX2_LINEAR_CALLS, linear_rows)
        step_breakdown("flux2", f"edit_int4_step_s{FLUX2_TOKENS['edit']}",
                            paths["flux2_edit"][0]["seconds_per_step"][-1],
                            {f"flux2_edit_s{FLUX2_TOKENS['edit']}_h48": FLUX2_LAYERS}, kernel_rows)
    # Turbo: the manifest's LoRA source, written where the engine resolves it
    os.environ["APEX_HOME_DIR"] = str(home / "flux2_turbo")
    source = yaml.safe_load(FLUX2_TURBO_MANIFEST.read_text())["spec"]["loras"][0]["source"]
    adapters = write_flux2_lora(get_lora_path() / source)
    engine = image_engine("flux2_turbo", FLUX2_TURBO_MANIFEST, "ti2i", home, "int4", configs)
    paths["flux2_turbo"] = image_drive("flux2_turbo", engine, [dict(prompt=PROMPT_B, seed=4)], FLUX2_TURBO_STEPS,
                                       FLUX2_LAYERS)[0]
    merged = [(r["scale"], r["applied"], len(r["skipped"])) for r in engine.lora_results]
    emit({"phase": "flux2_turbo", "lora_rank": FLUX2_LORA_RANK, "loras": merged, "adapters_written": adapters})
    check(merged == [(1.0, adapters, 0)], f"Turbo LoRA merge: {merged}, expected {adapters} applied")
    del engine
    release()
    engine = image_engine("flux2_control", derived_manifest(home, FLUX2_MANIFEST, "control", "flux2.control"),
                          "control", home, "int4", configs)
    mask = np.zeros((SIZE, SIZE), np.uint8)
    mask[:, SIZE // 2:] = 255
    paths["flux2_control"] = image_drive("flux2_control", engine, [dict(
        prompt=PROMPT_A, control_image=control, inpaint_image=inpaint, mask_image=mask, seed=5)], 2,
        FLUX2_LAYERS + FLUX2_CONTROL_BLOCKS)[0]
    cfg = engine.transformer.cfg
    check(cfg.control_in_dim == 260 and tuple(cfg.control_layers) == (0, 2, 4, 6), "the control DiT's config")
    del engine
    release()
    return paths, linear_rows


# -- HunyuanVideo and HuMo ------------------------------------------------------------------


def dit_bits(tf) -> list:
    """The bit widths of a DiT's quantized Linears."""
    return sorted({m.weight_bits for m in tf.modules() if getattr(m, "weight_scale", None) is not None})


def path_kernel_rows(label, inputs):
    """The kernel at a path's shapes (``inputs``: (case, q, k, v, [B|1, Sk]
    bias or None)) against its plain version: whole where its f32 scores
    take at most 4 GB, else on three 128-row subsets over all keys (the first
    tile, the last and ragged one, one across an interior tile edge); a
    masked case (a bias of 0 and -1e30 only, one mask for every batch row)
    also against the plain version over its kept keys alone.
    Each shape timed (``timing_row``) with the plain version over its first
    128 rows where the scores cannot be held. Returns (timing rows, the
    largest max|Δ|)."""
    import torch

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention, flash_attention_reference

    rows, cases = [], []
    for name, q, k, v, bias in inputs:
        b, s, h, _ = q.shape
        whole = b * h * s * k.shape[1] * 4 <= 4 << 30
        out = flash_attention(q, k, v, bias=bias)
        torch.cuda.synchronize()
        tail = s % 128 or 128
        subsets = ({"all_rows": slice(0, s)} if whole else
                   {"first_tile": slice(0, 128), "last_tile": slice(s - tail, s),
                    "interior_tile_edge": slice(s // 256 * 128 - 64, s // 256 * 128 + 64)})
        refs = {"": lambda sl: flash_attention_reference(q[:, sl], k, v, bias=bias)}
        if (bias is not None and bool(((bias == 0) | (bias <= -1e29)).all())  # a key mask, not a key bias,
                and bool((bias == bias[:1]).all())):  # one mask for every batch row
            keep = bias.reshape(-1, k.shape[1])[0] > -1e29
            refs["_vs_kept_keys_only"] = lambda sl: flash_attention_reference(q[:, sl], k[:, keep], v[:, keep])
        for suffix, reference in refs.items():
            for part, sl in subsets.items():
                agree = agreement(out[:, sl], reference(sl))
                finite = bool(torch.isfinite(out[:, sl].float()).all())
                cases.append({"case": f"{name}_{part}{suffix}", "shape": list(q.shape), "sk": k.shape[1],
                              "rows": [sl.start, sl.stop], "bias": bias is not None, **agree, "finite": finite,
                              "ok": finite and agree["within"]})
        del out
        rows.append(timing_row(name, q, k, v, bias, plain_rows=s if whole else 128, path=label))
        del q, k, v, bias
        release()
    emit({"phase": "kernels", "path": label, "cases": cases})
    bad = [c["case"] for c in cases if not c["ok"]]
    check(not bad, f"flash kernel disagrees with its plain version at the {label} shapes: {bad}")
    return rows, max(c["max_abs_err"] for c in cases)


def text_bias(s: int, text_slots: int, kept: int):
    """[1, s] key bias over [image | text]: every image key and the first
    ``kept`` of the ``text_slots`` text keys kept, the rest -1e30."""
    import torch

    bias = torch.zeros(1, s, device="cuda")
    bias[:, s - text_slots + kept:] = -1e30
    return bias


def hyv_kernel_inputs():
    """(case, q, k, v, bias) at the HunyuanVideo path's shapes, 24 heads of
    128: the joint attention over [image | 256 text slots] at 33 and 81
    frames of 720x1280 (32,656 and 75,856 tokens) and the token refiner over
    the 256 slots, each with the text key padding as a [1, S] bias keeping a
    ``HYV_TEXT_KEPT``-token prompt."""
    for i, (name, s) in enumerate((("hyv_joint_33f", HYV_TOKENS[33]), ("hyv_joint_81f", HYV_TOKENS[81]),
                                   ("hyv_refiner", HYV_TEXT_TOKENS))):
        yield (f"{name}_s{s}_bias_h{HYV_HEADS}", *qkv(1, s, s, HYV_HEADS, 128, 110 + i),
               text_bias(s, HYV_TEXT_TOKENS, HYV_TEXT_KEPT))


def humo_kernel_inputs():
    """(case, q, k, v, bias) at the HuMo path's shapes, 40 heads of 128: the
    self-attention at 97 frames of 480x832 (25 latent frames, the last one the
    reference's: 39,000 tokens) and at 33 frames (14,040), the text
    cross-attention over the 512 UMT5 rows, and the per-frame audio
    cross-attention: each latent frame's 1560 tokens against its 16 audio
    tokens, the frames as the batch (25 at 97 frames, 9 at 33); and the
    audio encoder's f32 self-attention, 12 heads of 64, over its features
    resampled to one a video frame (97 and 33)."""
    s97, s33 = HUMO_TOKENS[97], HUMO_TOKENS[33]
    yield (f"humo_self_s{s97}_h40", *qkv(1, s97, s97, WAN_HEADS, 128, 120), None)
    yield (f"humo_self_s{s33}_h40", *qkv(1, s33, s33, WAN_HEADS, 128, 121), None)
    yield (f"humo_text_cross_sq{s97}_sk{WAN_TEXT_TOKENS}_h40", *qkv(1, s97, WAN_TEXT_TOKENS, WAN_HEADS, 128, 122),
           None)
    for n, seed in ((s97 // WAN_TOKENS["frame"], 123), (s33 // WAN_TOKENS["frame"], 124)):
        yield (f"humo_audio_cross_b{n}_sq{WAN_TOKENS['frame']}_sk{HUMO_AUDIO_TOKENS}_h40",
               *qkv(n, WAN_TOKENS["frame"], HUMO_AUDIO_TOKENS, WAN_HEADS, 128, seed), None)
    heads = HUMO_WAV2VEC2["num_attention_heads"]
    d = HUMO_WAV2VEC2["hidden_size"] // heads
    for frames, seed in ((97, 125), (33, 126)):
        yield (f"humo_wav2vec2_s{frames}_h{heads}_d{d}_f32",
               *(x.float() for x in qkv(1, frames, frames, heads, d, seed)), None)


def hyv_reference():
    """The HunyuanVideo DiT at full width (24 heads of 128, text 4096) with 1
    dual and 1 single block, plain and token_replace, on the card in bf16
    (the kernel) against the same weights on the CPU in f32 (the plain
    version), over 2 latent frames of 16 x 16 (128 image tokens) and 64 text
    rows of which 40 are real, within HYV_BF16_REL_L2."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.models.transformers import hunyuanvideo as hv

    rng = np.random.default_rng(15)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    mask = (torch.arange(64) < 40)[None].to(torch.int32)
    inputs = (tensor(1, 16, 2, 16, 16), torch.tensor([700.0]), tensor(1, 64, 4096), mask, tensor(1, 768),
              torch.tensor([6000.0]))
    for ctype in (None, "token_replace"):
        card_vs_cpu(f"hunyuanvideo.base 24 heads of 128, 1 + 1 blocks, image_condition_type {ctype}",
                    lambda dt, c=ctype: hv.HunyuanVideoTransformer3DModel(hv.HunyuanVideoConfig(
                        num_layers=1, num_single_layers=1, image_condition_type=c), dtype=dt),
                    lambda m, x, t, txt, k, p, g: m(x, t, txt, k, pooled=p, guidance=g), inputs, HYV_BF16_REL_L2,
                    33, phase="hyv")


def hyv_vae_precision(vae) -> None:
    """A decode of a seeded 3 x 16 x 16 latent through the engine's VAE on
    the card against float64 (within 2e-2 relative L2) twice: as it runs at
    that size, and with the chunk sizes lowered so that every chunked branch
    of the 720p decodes runs in bf16 on the card (convs in output-frame
    chunks, half-precision group norms in frame chunks, the mid attention in
    200-row chunks that cross frame edges). Each branch's use is counted
    over the check's decodes (the timed ones and the float64 one too)."""
    import torch

    from apex_studio_tpu_torch.models.vaes import hunyuanvideo_vae as hv

    g = torch.Generator("cuda").manual_seed(16)
    z = torch.randn(1, 16, 3, 16, 16, generator=g, device="cuda")
    lowered = {"CONV_CHUNK_ELEMENTS": 1 << 23, "GROUP_NORM_CHUNK_ELEMENTS": 1 << 20, "MID_ATTENTION_ROWS": 200}
    for label, sizes in (("as_run", {}), ("chunks_lowered", lowered)):
        saved = {name: getattr(hv, name) for name in sizes}
        branches = {"conv_chunks": 0, "group_norm_chunked": 0, "mid_attention_chunks": 0}

        def padded(mod, x, p0, p1):
            # the whole call pads once from frame 0; the chunked path pads each chunk's frames
            branches["conv_chunks"] += p0 > 0
            return padded_whole(mod, x, p0, p1)

        def norm_hook(mod, args):
            x = args[0]
            if x.dtype in (torch.bfloat16, torch.float16) and x.numel() > hv.GROUP_NORM_CHUNK_ELEMENTS:
                branches["group_norm_chunked"] += 1

        def attention_hook(mod, args):
            s = args[0].shape[2] * args[0].shape[3] * args[0].shape[4]
            branches["mid_attention_chunks"] += -(-s // hv.MID_ATTENTION_ROWS)

        hooks = [m.register_forward_pre_hook(hook) for m in vae.modules()
                 for cls, hook in ((hv.GroupNormCh, norm_hook), (hv.HVMidAttention, attention_hook))
                 if isinstance(m, cls)]
        padded_whole, hv.CausalConv3d._padded = hv.CausalConv3d._padded, padded
        try:
            for name, value in sizes.items():
                setattr(hv, name, value)
            row = vae_decode_vs_float64(vae, z)
        finally:
            hv.CausalConv3d._padded = padded_whole
            for h in hooks:
                h.remove()
            for name, value in saved.items():
                setattr(hv, name, value)
        row = {"phase": "hyv", "check": f"vae_decode_vs_float64_{label}", **row, "tol": 2e-2, "sizes": sizes,
               "branch_calls": branches}
        emit(row)
        check(row["rel_l2_vs_float64"] <= 2e-2,
              f"the HunyuanVideo VAE's decode ({label}) is {row['rel_l2_vs_float64']} from float64")
        if sizes:
            check(all(branches.values()), f"a chunked branch of the HunyuanVideo VAE did not run: {branches}")


def hyv_engine(label, manifest, model_type, home, transformer=None):
    """A HunyuanVideo engine on the card as ``image_engine`` builds it, with
    synthetic int8 weights (as the HunyuanVideo 1.5 phase) and the
    ``transformer`` config written where the manifest names it; observed
    (``observe``) and with each decode's choice of whole or tiled read
    (``engine.decoded_whole``)."""
    configs = [("transformer", transformer)] if transformer else []
    engine = image_engine(label, manifest, model_type, home, "int8", configs)
    whole, engine.decoded_whole = engine._decode_whole, []

    def observed_whole(z):
        engine.decoded_whole.append(whole(z))
        return engine.decoded_whole[-1]

    engine._decode_whole = observed_whole
    return observe(engine)


def phase_hyv(home: Path):
    """HunyuanVideo (the original) from its t2v and i2v manifests at
    720x1280 and the family defaults' widths (20 + 40 blocks, 24 heads of
    128; llava-llama-3-8B and CLIP-L; the VAE), synthetic int8 weights: the
    kernel at the path's shapes; the 1 + 1-block DiT and a VAE decode against
    f32 / float64; t2v at 33 frames twice with one seed (bit-identical), i2v
    token_replace at 33 frames from a seeded image (the first latent frame
    pinned to the image latent), both decoded whole; t2v at 81 frames
    (75,856 tokens), decoded in tiles; 1 step each, the requests' DiT at
    ``HYV_DUAL`` + ``HYV_SINGLE`` of its blocks (6 launches a forward); the
    resident Linears at the 81-frame shapes and the step split."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.quantize.residency import count_resident

    kernel_rows, kernel_err = path_kernel_rows("hyv", hyv_kernel_inputs())
    hyv_reference()
    (height, width), paths = HYV_SIZE, {}
    base = dict(prompt=HYV_PROMPT, height=height, width=width, num_inference_steps=HYV_STEPS, guidance_scale=6.0)
    engine = hyv_engine("hyv_t2v", HYV_T2V_MANIFEST, "t2v", home, HYV_T2V_TRANSFORMER)
    rows, latents = [], []
    for _ in range(2):  # edit_drive clears the decoded latents before each request
        rows.append(edit_drive("hyv", engine, dict(base, num_frames=33, seed=42), HYV_REQUEST_LAUNCHES,
                               {"transformer": HYV_STEPS}, 33, 9))
        latents.append(engine.wan_smoke["decoded"][-1])
    tf, vae = engine.transformer, engine.vae
    same = bool(torch.equal(*latents)) and bool(np.array_equal(np.stack(rows[0][1]), np.stack(rows[1][1])))
    emit({"phase": "hyv", "requests_1_2_identical_latents_and_frames": same, "resident_weights": count_resident(tf),
          "dit_parameters": sum(p.numel() for p in tf.parameters()), "decoded_whole": engine.decoded_whole,
          "vae_compute_dtype": str(vae.decoder.conv_in.dtype)})
    check(same, "HunyuanVideo t2v requests 1 and 2 (same prompt and seed) differ")
    check(engine.decoded_whole == [True, True], f"the 33-frame decodes were not whole: {engine.decoded_whole}")
    check(tf.cfg.dim == 3072 and len(tf.single_transformer_blocks) == HYV_SINGLE and count_resident(tf) > 0,
          "the HunyuanVideo DiT's widths or residency")
    hyv_vae_precision(vae)
    long_row, frames = edit_drive("hyv_81f", engine, dict(base, num_frames=81, seed=7), HYV_REQUEST_LAUNCHES,
                                  {"transformer": HYV_STEPS}, 81, 21)
    tiled = engine.decoded_whole[-1] is False
    emit({"phase": "hyv_81f", "decode": "tiled" if tiled else "whole", "tokens": HYV_TOKENS[81]})
    check(tiled, "the 81-frame decode did not take the tiled path")
    paths["hyv_t2v"], paths["hyv_t2v_81_frames"] = [r for r, _ in rows], [long_row]
    del engine, tf, vae, frames, rows
    release()

    image = cv2_smooth(np.random.default_rng(17), HYV_SIZE)
    engine = hyv_engine("hyv_i2v", HYV_I2V_MANIFEST, "i2v", home,
                        dict(HYV_I2V_TRANSFORMER, num_layers=HYV_DUAL, num_single_layers=HYV_SINGLE))
    i2v_row, frames = edit_drive("hyv_i2v", engine, dict(base, num_frames=33, seed=42, image=image),
                                 HYV_REQUEST_LAUNCHES, {"transformer": HYV_STEPS}, 33, 9)
    px, _ = engine._image_pixels(image, height, width)
    first = engine.encode_video_latents(px[None, :, None]).float()
    pinned = bool(torch.equal(engine.wan_smoke["decoded"][-1][:, :, :1], first))
    emit({"phase": "hyv_i2v", "image_condition_type": engine.transformer.cfg.image_condition_type,
          "first_latent_frame_pinned": pinned, "decoded_whole": engine.decoded_whole})
    check(engine.transformer.cfg.image_condition_type == "token_replace" and pinned,
          "i2v token_replace: the first latent frame is not the image latent")
    check(engine.decoded_whole == [True], f"the i2v decode was not whole: {engine.decoded_whole}")
    paths["hyv_i2v"] = [i2v_row]
    del engine, frames
    release()

    linear_rows = residency_timing(list(HYV_LINEAR_CALLS), phase="hyv")
    step = long_row["median_seconds_per_step_after_the_first"]
    queued = {r["case"]: r["queued_ms"] for r in kernel_rows}
    attention_s = ((HYV_DUAL + HYV_SINGLE) * queued[f"hyv_joint_81f_s{HYV_TOKENS[81]}_bias_h24"]
                   + 2 * queued[f"hyv_refiner_s{HYV_TEXT_TOKENS}_bias_h24"]) / 1e3
    linear_s = sum(HYV_LINEAR_CALLS[(r["rows"], r["in"], r["out"])] * r["w8a8_ms"] for r in linear_rows) / 1e3
    emit({"phase": "hyv", "step_breakdown_81_frames": {
        "seconds_per_step": step, "attention_seconds": attention_s, "w8a8_linear_seconds": linear_s,
        "other_seconds": step - attention_s - linear_s, "attention_share": attention_s / step,
        "w8a8_linear_share": linear_s / step,
        "reckoning": f"queued kernel ms x {HYV_DUAL + HYV_SINGLE} joint + 2 refiner launches; queued W8A8 ms x "
                     "calls by shape (the dual blocks' 75,600-row image stream at the single blocks' 75,856 rows)"}})
    return paths, kernel_rows, kernel_err


def write_humo_audio(path: Path, seconds: float, seed: int) -> None:
    """A seeded 16 kHz mono 16-bit WAV: a voice-like sum of harmonics under a
    syllable envelope, with noise."""
    import wave

    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    f0 = 140.0 + 20.0 * np.sin(2 * np.pi * 0.7 * t)
    voice = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / 16000.0) / k for k in range(1, 6))
    wav = 0.3 * voice * (0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * t)) + 0.02 * rng.standard_normal(t.size)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes())


def humo_reference():
    """The HuMo DiT at full width (dim 5120, 40 heads, the audio projection)
    with 2 blocks on the card in bf16 against the same weights on the CPU in
    f32, over 2 latent frames of half a 480x832 frame (390 tokens each), their
    audio windows, a 20-channel condition and 512 text rows of which 40 are
    real, within BF16_REL_L2."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.models.transformers import wan_humo

    rng = np.random.default_rng(18)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    ctx = tensor(1, WAN_TEXT_TOKENS, 4096)
    ctx[:, 40:] = 0.0
    card_vs_cpu("wan.humo dim 5120, 2 blocks, audio windows of 8 x 13 x 768",
                lambda dt: wan_humo.HumoWanTransformerModel(wan_humo.WanHuMoConfig(num_layers=2), dtype=dt),
                lambda m, x, t, c, a, y: m(x, t, c, a, y),
                (tensor(1, 16, 2, 30, 52), torch.tensor([731.0]), ctx, tensor(1, 2, 8, 13, 768),
                 tensor(1, 20, 2, 30, 52)), BF16_REL_L2, 34, phase="humo")


def phase_humo(home: Path):
    """HuMo 17B from its manifest at the WanHuMoConfig widths (dim 5120, 40
    heads; the requests' DiT ``HUMO_LAYERS`` of the published 40 blocks), the
    DiT int4-resident and UMT5-XXL int8 (Wan's
    residency), UMT5-XXL's and a 13-layer Wav2Vec2-base-wide audio encoder's
    configs written where the manifest names them: the kernel at the path's
    shapes; the 2-block DiT against f32; one TIA request at the manifest's
    defaults (480x832, 97 frames, one reference image, a negative prompt: the
    negative branch image-conditioned at the first step and null at the
    second, 2 steps), then two TA requests at 33 frames with one seed
    (bit-identical, 1 step each); 3 launches a block and the audio
    encoder's 13 a request;
    a seeded 16 kHz waveform written as a WAV file."""
    import numpy as np
    import torch

    kernel_rows, kernel_err = path_kernel_rows("humo", humo_kernel_inputs())
    humo_reference()
    engine = edit_engine("humo", HUMO_MANIFEST, "humo", home, "int4",
                         {"audio_encoder": HUMO_WAV2VEC2, "transformer": HUMO_TRANSFORMER})
    wav = home / "humo" / "voice.wav"
    write_humo_audio(wav, 4.0, 19)
    reference = cv2_smooth(np.random.default_rng(20), (480, 832))
    base = dict(prompt=WAN_PROMPT, audio=str(wav), num_inference_steps=HUMO_STEPS)
    tia_row, _ = edit_drive("humo_tia", engine, dict(base, image=reference, negative_prompt=WAN_NEG, seed=0,
                                                     height=480, width=832),
                            HUMO_LAUNCHES_PER_FORWARD, {"transformer": 3 * HUMO_STEPS}, 93, 24,
                            HUMO_WAV2VEC2["num_hidden_layers"])
    ta, latents = [], []
    for _ in range(2):
        ta.append(edit_drive("humo_ta", engine, dict(base, num_frames=33, seed=1, height=480, width=832,
                                                     num_inference_steps=HUMO_TA_STEPS),
                             HUMO_LAUNCHES_PER_FORWARD, {"transformer": 2 * HUMO_TA_STEPS}, 33, 9,
                             HUMO_WAV2VEC2["num_hidden_layers"]))
        latents.append(engine.wan_smoke["decoded"][-1])
    tf = engine.transformer
    bits = set(dit_bits(tf))
    same = bool(torch.equal(*latents)) and bool(np.array_equal(np.stack(ta[0][1]), np.stack(ta[1][1])))
    emit({"phase": "humo", "requests_ta_identical_latents_and_frames": same, "dit_bits": sorted(bits),
          "timesteps": tia_row["timesteps"], "dit_parameters": sum(p.numel() for p in tf.parameters()),
          "audio_encoder_layers": engine.helpers["audio_encoder"].cfg.num_hidden_layers})
    check(same, "HuMo TA requests (same audio, prompt and seed) differ")
    check(bits == {4} and tf.cfg.dim == 5120 and len(tf.blocks) == HUMO_LAYERS,
          f"the HuMo DiT's widths, depth or bits {bits}")
    check(tia_row["timesteps"][0] > 980 > tia_row["timesteps"][1], "the 2-step schedule does not cross step_change")
    del engine, tf
    release()
    return {"humo_tia": [tia_row], "humo_ta": [r for r, _ in ta]}, kernel_rows, kernel_err


# -- the audio-driven video engines: Wan S2V, MultiTalk, HunyuanVideo Avatar ---------------------


def s2v_kernel_inputs():
    """(case, q, k, v, bias) at the S2V path's shapes, 40 heads of 128: the
    self-attention over a chunk with its motion tokens (35,074; the first
    chunk's 32,760 is Wan's 81-frame shape), its text cross-attention over
    the 512 UMT5 rows, the audio injector (each of the 20 latent frames' 1560
    tokens against its 4 audio tokens and the padding token, the frames as
    the batch), and wav2vec2-large's f32 self-attention, 16 heads of 64, over
    the 10 s clip's 499 frames."""
    s, f = S2V_TOKENS["chunk"], S2V_FRAMES
    yield (f"s2v_self_s{s}_h40", *qkv(1, s, s, WAN_HEADS, 128, 130), None)
    yield (f"s2v_text_cross_sq{s}_sk{WAN_TEXT_TOKENS}_h40", *qkv(1, s, WAN_TEXT_TOKENS, WAN_HEADS, 128, 131), None)
    yield (f"s2v_audio_injector_b{f}_sq{WAN_TOKENS['frame']}_sk{S2V_AUDIO_TOKENS}_h40",
           *qkv(f, WAN_TOKENS["frame"], S2V_AUDIO_TOKENS, WAN_HEADS, 128, 132), None)
    heads = WAV2VEC2_LARGE["num_attention_heads"]
    d = WAV2VEC2_LARGE["hidden_size"] // heads
    yield (f"s2v_wav2vec2_s{S2V_W2V_FRAMES}_h{heads}_d{d}_f32",
           *(x.float() for x in qkv(1, S2V_W2V_FRAMES, S2V_W2V_FRAMES, heads, d, 133)), None)


def multitalk_kernel_inputs():
    """(case, q, k, v, bias) at the MultiTalk path's shapes, 40 heads of 128:
    self-attention over 81 frames (32,760 tokens, Wan's shape), the text
    cross-attention over 512 rows and the CLIP one over 257, the per-frame
    audio cross-attention (21 frames of 1560 tokens against two speakers' 32
    tokens each, q and k rotated by L-RoPE: queries in the speakers' bands,
    keys at the bands' centres), and the base wav2vec2's f32 self-attention
    (12 heads of 64) over the 80 video frames of a speaker's 3.2 s."""
    import torch

    from apex_studio_tpu_torch.models.transformers.wan_multitalk import rope_1d_pairs

    s, frame = MULTITALK_TOKENS, WAN_TOKENS["frame"]
    yield (f"multitalk_self_s{s}_h40", *qkv(1, s, s, WAN_HEADS, 128, 140), None)
    yield (f"multitalk_text_cross_sq{s}_sk{WAN_TEXT_TOKENS}_h40", *qkv(1, s, WAN_TEXT_TOKENS, WAN_HEADS, 128, 141),
           None)
    yield (f"multitalk_clip_cross_sq{s}_sk{CLIP_TOKENS}_h40", *qkv(1, s, CLIP_TOKENS, WAN_HEADS, 128, 142), None)
    q, k, v = qkv(s // frame, frame, MULTITALK_AUDIO_TOKENS, WAN_HEADS, 128, 143)
    g = torch.Generator("cuda").manual_seed(144)
    pos_q = torch.where(torch.rand(frame, generator=g, device="cuda") < 0.5,
                        4.0 * torch.rand(frame, generator=g, device="cuda"),
                        20.0 + 4.0 * torch.rand(frame, generator=g, device="cuda"))
    half = MULTITALK_AUDIO_TOKENS // 2
    pos_k = torch.tensor([2.0] * half + [22.0] * half, device="cuda")
    yield (f"multitalk_audio_cross_lrope_b{s // frame}_sq{frame}_sk{MULTITALK_AUDIO_TOKENS}_h40",
           rope_1d_pairs(q, pos_q, 128), rope_1d_pairs(k, pos_k, 128), v, None)
    heads = WAV2VEC2_BASE["num_attention_heads"]
    d = WAV2VEC2_BASE["hidden_size"] // heads
    yield (f"multitalk_wav2vec2_s{MULTITALK_W2V_FRAMES}_h{heads}_d{d}_f32",
           *(x.float() for x in qkv(1, MULTITALK_W2V_FRAMES, MULTITALK_W2V_FRAMES, heads, d, 145)), None)


def avatar_kernel_inputs():
    """(case, q, k, v, bias) at the Avatar path's shapes, 24 heads of 128: the
    joint attention over [reference | 33 latent frames | 256 text slots] at
    512x512 (35,072 tokens) and the token refiner over the 256 slots, each
    with the text key padding as a [1, S] bias keeping a
    ``HYV_TEXT_KEPT``-token prompt."""
    for i, (name, s) in enumerate((("avatar_joint", AVATAR_TOKENS), ("avatar_refiner", HYV_TEXT_TOKENS))):
        yield (f"{name}_s{s}_bias_h{HYV_HEADS}", *qkv(1, s, s, HYV_HEADS, 128, 150 + i),
               text_bias(s, HYV_TEXT_TOKENS, HYV_TEXT_KEPT))


def _reference_tensors(seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    ctx = tensor(1, WAN_TEXT_TOKENS, 4096)
    ctx[:, 40:] = 0.0
    return tensor, ctx, torch.tensor([731.0])


def s2v_reference():
    """The S2V DiT at full width with the published audio widths, FramePack
    and 2 blocks, the injector after both, on the card in bf16 (the kernel)
    against the same weights on the CPU in f32 (the plain version), within
    BF16_REL_L2: 2 latent frames of half a 480x832 frame, 19 motion frames
    (FramePack's 2x and 4x patches cropped from 30 x 52), a pose, the 25
    wav2vec2-large states and 512 text rows of which 40 are real."""
    from apex_studio_tpu_torch.models.transformers import wan_s2v

    tensor, ctx, t = _reference_tensors(35)
    cfg = {k: v for k, v in WAN_S2V_TRANSFORMER.items() if not k.startswith("_")}
    cfg.update(num_layers=2, audio_inject_layers=[0, 1])
    # 8 audio columns after the 73 motion ones: ceil(ceil(81 / 2) / 2) = 21 = 19 motion + 2 video frames
    card_vs_cpu("wan.s2v dim 5120, 2 blocks, the injector after both, FramePack",
                lambda dt: wan_s2v.WanS2VTransformer3DModel(wan_s2v.WanS2VConfig.from_dict(cfg), dtype=dt),
                lambda m, x, tt, c, mot, a, img, pose: m(x, tt, c, mot, a, img, pose_latents=pose,
                                                         motion_frames=(73, 19)),
                (tensor(1, 16, 2, 30, 52), t, ctx, tensor(1, 16, 19, 30, 52), tensor(1, 25, 1024, 8),
                 tensor(1, 16, 1, 30, 52), tensor(1, 16, 2, 30, 52)), BF16_REL_L2, 36, phase="s2v")


def multitalk_reference():
    """The MultiTalk DiT at full width (36 channels, the CLIP branch) with 2
    blocks, card bf16 against CPU f32 within BF16_REL_L2, with two speakers
    (L-RoPE through ``ref_attn_maps``) over 2 latent frames of half a
    480x832 frame."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.models.transformers import wan_multitalk as mt

    tensor, ctx, t = _reference_tensors(37)
    masks = np.zeros((3, 390), np.float32)
    masks[0, :195], masks[1, 195:], masks[2, ::7] = 1.0, 1.0, 1.0
    card_vs_cpu("wan.multitalk dim 5120, 2 blocks, CLIP branch, two speakers",
                lambda dt: mt.WanMultiTalkTransformer3DModel(mt.WanMultiTalkConfig(
                    num_layers=2, added_kv_proj_dim=5120), dtype=dt),
                lambda m, x, tt, c, img, a, mk: m(x, tt, c, img, a, mk),
                (tensor(1, 36, 2, 30, 52), t, ctx, tensor(1, CLIP_TOKENS, 1280), tensor(2, 5, 5, 12, 768),
                 torch.from_numpy(masks)), BF16_REL_L2, 38, phase="multitalk")


def avatar_reference():
    """The Avatar DiT at HunyuanVideo 13B's widths with 1 + 1 blocks and the
    audio adapter after the dual block, card bf16 against CPU f32 within
    HYV_BF16_REL_L2 (HunyuanVideo's own), over 2 latent frames of 16 x 16,
    a face mask, 5 Whisper windows and 64 text rows of which 40 are real."""
    import torch

    from apex_studio_tpu_torch.models.transformers import hunyuanvideo_avatar as av

    tensor, _, t = _reference_tensors(39)
    mask = (torch.arange(64) < 40)[None].to(torch.int32)
    face = torch.zeros(1, 1, 1, 32, 32)
    face[..., 8:24, 6:26] = 1.0

    def forward(m, x, tt, txt, k, p, r, a, fm):
        dev = x.device
        return m(x, tt, txt, k, pooled=p, ref_latents=r, audio=a, face_mask=fm,
                 motion_exp=torch.full((1, 4), 30.0, device=dev), motion_pose=torch.full((1, 4), 25.0, device=dev),
                 fps=torch.full((1,), 25.0, device=dev))

    card_vs_cpu("hunyuanvideo.avatar 24 heads of 128, 1 + 1 blocks, the audio adapter",
                lambda dt: av.HunyuanAvatarVideoModel(av.HunyuanAvatarConfig(
                    num_layers=1, num_single_layers=1, double_stream_list=(0,)), dtype=dt), forward,
                (tensor(1, 16, 2, 32, 32), t, tensor(1, 64, 4096), mask, tensor(1, 768), tensor(1, 16, 2, 32, 32),
                 tensor(1, 5, 10, 5, 384), face), HYV_BF16_REL_L2, 40, phase="avatar")


def observe_decodes(engine):
    """``observe(engine)`` for an engine that decodes through
    ``decode_video_tensor`` (S2V, MultiTalk): each decode's latents recorded."""
    seen = observe(engine).wan_smoke
    decode = engine.decode_video_tensor

    def observed(z, *a):
        seen["decoded"].append(z.detach().clone())
        return decode(z, *a)

    engine.decode_video_tensor = observed
    return engine


def identical_pair(label, engine, kw, launches_per_forward, forwards, frames_expected, latent_t, extra=0):
    """``kw`` twice through ``edit_drive``: both requests' decoded latents
    and frames bit-identical. Returns the two rows."""
    import numpy as np
    import torch

    rows, latents = [], []
    for _ in range(2):
        rows.append(edit_drive(label, engine, kw, launches_per_forward, forwards, frames_expected, latent_t, extra))
        latents.append(list(engine.wan_smoke["decoded"]))
    same = (all(torch.equal(a, b) for a, b in zip(*latents))
            and bool(np.array_equal(np.stack(rows[0][1]), np.stack(rows[1][1]))))
    emit({"phase": label, "requests_identical_latents_and_frames": same})
    check(same, f"{label}: two requests with the same inputs and seed differ")
    return [r for r, _ in rows]


def phase_s2v(home: Path):
    """Wan 2.2 S2V from its manifest at the published widths (its transformer
    and wav2vec2-large configs written; the DiT int4, UMT5-XXL int8): the
    kernel at the path's shapes; the 2-block DiT against f32; one request at
    480x832 of two 80-frame chunks from a 10 s seeded WAV, a reference image
    and a 16-frame pose video (reverse-padded to 160), a negative prompt (2
    forwards a step), 1 step a chunk: the first chunk's motion dropped, the
    second's motion buffer re-encoded from the first's last 73 frames; then
    two identical 32-frame requests of one chunk seeded with the image
    (``init_first_frame``), without CFG; the requests' DiT
    ``AUDIO_VIDEO_LAYERS`` of its 40 blocks."""
    import numpy as np

    kernel_rows, kernel_err = path_kernel_rows("s2v", s2v_kernel_inputs())
    s2v_reference()
    engine = observe_decodes(edit_engine("s2v", WAN_S2V_MANIFEST, "s2v", home, "int4",
                                         {"transformer": S2V_REQUEST_TRANSFORMER, "audio_encoder": WAV2VEC2_LARGE}))
    wav = home / "s2v" / "voice.wav"
    write_humo_audio(wav, S2V_AUDIO_SECONDS, 39)
    rng = np.random.default_rng(40)
    image, pose = cv2_smooth(rng, (480, 832)), [cv2_smooth(rng, (480, 832)) for _ in range(16)]
    base = dict(prompt=WAN_PROMPT, audio=str(wav), image=image, height=480, width=832,
                num_inference_steps=AUDIO_VIDEO_STEPS, seed=0)
    w2v = WAV2VEC2_LARGE["num_hidden_layers"]
    # chunk 1 decodes [condition ‖ 20 latent frames] and drops 3 frames, chunk 2 [19 motion ‖ 20]
    main_row, _ = edit_drive("s2v", engine, dict(base, negative_prompt=WAN_NEG, guidance_scale=4.5,
                                                 num_frames_per_chunk=80, num_chunks=2, pose_video=pose),
                             S2V_LAUNCHES_PER_FORWARD, {"transformer": 2 * 2 * AUDIO_VIDEO_STEPS}, 80 - 3 + 80,
                             [1 + 20, 19 + 20], w2v)
    pair = identical_pair("s2v_pair", engine, dict(base, guidance_scale=1.0, num_frames_per_chunk=32,
                                                   num_chunks=1, init_first_frame=True),
                          S2V_LAUNCHES_PER_FORWARD, {"transformer": AUDIO_VIDEO_STEPS}, 32, 19 + 8, w2v)
    tf = engine.transformer
    emit({"phase": "s2v", "dit_bits": dit_bits(tf), "dit_parameters": sum(p.numel() for p in tf.parameters()),
          "framepack": tf.frame_packer is not None, "inject_layers": sorted(tf.audio_inject_map),
          "tokens": S2V_TOKENS, "audio_encoder_layers": engine.helpers["audio_encoder"].cfg.num_hidden_layers})
    check(dit_bits(tf) == [4] and tf.cfg.dim == 5120 and len(tf.blocks) == AUDIO_VIDEO_LAYERS
          and tf.frame_packer is not None and len(tf.injector) == S2V_INJECT_LAYERS,
          "the S2V DiT's widths, bits or audio layers")
    del engine, tf
    release()
    return {"s2v": [main_row], "s2v_pair": pair}, kernel_rows, kernel_err


def phase_multitalk(home: Path):
    """Wan 2.1 MultiTalk from its manifest at the published widths (the
    Wan2.1-I2V-14B-480P transformer, CLIP ViT-H and chinese-wav2vec2-base
    configs written; the DiT int4, UMT5-XXL int8, CLIP bf16): the kernel at
    the path's shapes; one request at 480x832 and 81 frames with two
    speakers' seeded 3.2 s voices (L-RoPE routing over the chunked
    ``ref_attn_maps``) and a negative prompt (3 forwards a step), 1 step;
    then two identical one-speaker requests of 33 frames (2 forwards a step);
    the requests' DiT ``AUDIO_VIDEO_LAYERS`` of its 40 blocks."""
    import numpy as np

    kernel_rows, kernel_err = path_kernel_rows("multitalk", multitalk_kernel_inputs())
    multitalk_reference()
    engine = observe_decodes(edit_engine("multitalk", WAN_MULTITALK_MANIFEST, "multitalk", home, "int4",
                                         {"transformer": MULTITALK_REQUEST_TRANSFORMER, "image_encoder": CLIP_VISION_H,
                                          "audio_encoder": WAV2VEC2_BASE}, {"helper": "bf16"}))
    voices = [home / "multitalk" / f"voice_{i}.wav" for i in (1, 2)]
    for i, path in enumerate(voices):
        write_humo_audio(path, MULTITALK_AUDIO_SECONDS, 41 + i)
    image = cv2_smooth(np.random.default_rng(43), (480, 832))
    base = dict(prompt=WAN_PROMPT, image=image, height=480, width=832, num_inference_steps=AUDIO_VIDEO_STEPS,
                guidance_scale=5.0, audio_guidance_scale=4.0, seed=0)
    w2v = WAV2VEC2_BASE["num_hidden_layers"]
    main_row, _ = edit_drive("multitalk", engine, dict(base, person_1_audio=str(voices[0]),
                                                       person_2_audio=str(voices[1]), negative_prompt=WAN_NEG,
                                                       num_frames=81),
                             MULTITALK_LAUNCHES_PER_FORWARD, {"transformer": 3 * AUDIO_VIDEO_STEPS},
                             int(MULTITALK_AUDIO_SECONDS * 25), 21, 2 * w2v)
    pair = identical_pair("multitalk_pair", engine, dict(base, audio=str(voices[0]), num_frames=33,
                                                         max_num_frames=33),
                          MULTITALK_LAUNCHES_PER_FORWARD, {"transformer": 2 * AUDIO_VIDEO_STEPS}, 33, 9, w2v)
    tf = engine.transformer
    emit({"phase": "multitalk", "dit_bits": dit_bits(tf), "dit_parameters": sum(p.numel() for p in tf.parameters()),
          "in_channels": tf.cfg.in_channels, "added_kv_proj_dim": tf.cfg.added_kv_proj_dim,
          "clip_dtype": str(engine.helpers["image_encoder"].dtype)})
    check(dit_bits(tf) == [4] and tf.cfg.dim == 5120 and len(tf.blocks) == AUDIO_VIDEO_LAYERS
          and tf.cfg.in_channels == 36
          and tf.cfg.added_kv_proj_dim == 5120, "the MultiTalk DiT's widths or bits")
    del engine, tf
    release()
    return {"multitalk": [main_row], "multitalk_pair": pair}, kernel_rows, kernel_err


def phase_avatar(home: Path):
    """HunyuanVideo Avatar from its manifest at the HunyuanAvatarConfig
    defaults (HunyuanVideo 13B's widths, the Whisper-tiny feature geometry;
    synthetic int8 weights as the hyv phase): the kernel at the path's
    shapes; one request at the manifest's defaults (512x512, 5 s at 25 fps:
    125 frames, one window of 33 latent frames) with a seeded WAV, whose
    Whisper features are zeros (the manifest's encoder has no files), and a
    negative prompt (2 forwards a step), 2 steps; then two identical 33-frame
    requests in windows of 9 latent frames."""
    import numpy as np

    kernel_rows, kernel_err = path_kernel_rows("avatar", avatar_kernel_inputs())
    avatar_reference()
    engine = hyv_engine("avatar", HYV_AVATAR_MANIFEST, "avatar", home,
                        {"num_layers": AVATAR_DUAL, "num_single_layers": AVATAR_SINGLE})
    wav = home / "avatar" / "voice.wav"
    wav.parent.mkdir(parents=True, exist_ok=True)
    write_humo_audio(wav, 5.0, 44)
    image = cv2_smooth(np.random.default_rng(45), (512, 512))
    base = dict(prompt=HYV_PROMPT, image=image, audio=str(wav), num_inference_steps=AUDIO_VIDEO_STEPS, seed=0,
                height=512, width=512)
    main_row, _ = edit_drive("avatar", engine, dict(base, negative_prompt="blurry, static"),
                             HYV_LAUNCHES_PER_FORWARD, {"transformer": 2 * AUDIO_VIDEO_STEPS}, 125, 32)
    pair = identical_pair("avatar_pair", engine, dict(base, num_frames=33, frame_per_batch=9),
                          HYV_LAUNCHES_PER_FORWARD, {"transformer": AUDIO_VIDEO_STEPS}, 33, 9)
    tf = engine.transformer
    zero = engine.audio_features(str(wav), 125)
    emit({"phase": "avatar", "dit_bits": dit_bits(tf), "dit_parameters": sum(p.numel() for p in tf.parameters()),
          "whisper_files": str(engine.whisper_files()), "audio_features": list(zero.shape),
          "audio_features_zero": not zero.any(), "decoded_whole": engine.decoded_whole})
    check(dit_bits(tf) == [8] and tf.cfg.dim == 3072 and len(tf.single_transformer_blocks) == AVATAR_SINGLE
          and len(tf.audio_adapter_blocks) == 10, "the Avatar DiT's widths or bits")
    check(engine.whisper_files() is None and not zero.any(), "the Avatar's audio features without Whisper files")
    del engine, tf
    release()
    return {"avatar": [main_row], "avatar_pair": pair}, kernel_rows, kernel_err


# -- SkyReels V2 -------------------------------------------------------------------------------


def skyreels_kernel_inputs():
    """(case, q, k, v, None) at the SkyReels path's new shapes (40 heads of
    128, unmasked): self-attention over the df window (10,200 tokens), the
    9-frame i2v clip (6120) and one t2v frame (2040), and the window's text
    cross-attention over the 512 UMT5 rows."""
    for i, (kind, s) in enumerate(SKYREELS_TOKENS.items()):
        yield (f"skyreels_self_{kind}_s{s}_h40", *qkv(1, s, s, WAN_HEADS, 128, 130 + i), None)
    s = SKYREELS_TOKENS["df_window"]
    yield (f"skyreels_cross_df_window_sq{s}_sk{WAN_TEXT_TOKENS}_h40",
           *qkv(1, s, WAN_TEXT_TOKENS, WAN_HEADS, 128, 133), None)


def skyreels_reference():
    """The SkyReels DiT at full width (Wan 2.1 14B's, the fps embedding) with
    2 blocks on the card in bf16 (flash kernel) against the same weights on
    the CPU in f32: two latent frames of 17x30 tokens at per-frame timesteps
    (999, 500) with the 24-fps row, within BF16_REL_L2."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.models.transformers.wan import WanConfig, WanTransformer3DModel

    rng = np.random.default_rng(134)
    x = torch.from_numpy(rng.normal(size=(1, 16, 2, 34, 60)).astype(np.float32))
    ctx = torch.from_numpy(rng.normal(size=(1, WAN_TEXT_TOKENS, 4096)).astype(np.float32))
    ctx[:, 40:] = 0.0
    cfg = WanConfig.from_dict(dict(SKYREELS_TRANSFORMER, num_layers=2))
    card_vs_cpu("skyreels dim 5120, fps embedding, per-frame timesteps, 2 blocks",
                lambda dt: WanTransformer3DModel(cfg, dtype=dt),
                lambda m, x_, t_, c_, f_: m(x_, t_, c_, fps_index=f_),
                (x, torch.tensor([[999.0, 500.0]]), ctx, torch.tensor([1])), BF16_REL_L2, 135, phase="skyreels",
                tokens=2 * 17 * 30)


def skyreels_engine(kind, home, transformer_cfg):
    """A SkyReels engine from its manifest (``SKYREELS_MANIFESTS``), observed
    as the Wan editing engines are (``edit_engine``): the DiT int4, UMT5-XXL
    int8, the configs the manifest names written into the request's home."""
    return edit_engine(f"skyreels_{kind}", SKYREELS_MANIFESTS[kind], kind, home, "int4",
                       {"transformer": dict(transformer_cfg, num_layers=SKYREELS_LAYERS)})


def phase_skyreels(home: Path):
    """SkyReels V2 from its three manifests at the published widths (the DF
    14B transformer config written; the DiT int4, UMT5-XXL int8, the Wan
    VAE): the kernel at the path's new shapes; the 2-block DiT against f32;
    df at 544x960 and CFG 6.0, 33 frames in windows of 17 (10 rows, 20
    forwards, 200 launches at the requests' 5 blocks), twice with one seed (bit-identical), then 17
    frames once with an image prefix (its latent frame is the image's
    encode, never updated; 5 rows); t2v of one frame, 2 steps, at 24 and at 16 fps (the outputs
    differ); i2v of 9 frames, 1 step, on the 36-channel twin of the config."""
    import numpy as np
    import torch

    kernel_rows, kernel_err = path_kernel_rows("skyreels", skyreels_kernel_inputs())
    skyreels_reference()
    paths = {}
    engine = skyreels_engine("df", home, SKYREELS_TRANSFORMER)
    df = dict(SKYREELS_DF, prompt=WAN_PROMPT, negative_prompt=WAN_NEG, seed=0)
    forwards = {"transformer": 2 * SKYREELS_DF_ROWS}
    paths["skyreels_df"] = identical_pair("skyreels_df", engine, df, SKYREELS_LAUNCHES_PER_FORWARD, forwards, 33, 9)
    image = cv2_smooth(np.random.default_rng(136), (544, 960))
    row, _ = edit_drive("skyreels_df_prefix", engine,
                        dict(df, image=image, seed=1, num_frames=SKYREELS_PREFIX_FRAMES),
                        SKYREELS_LAUNCHES_PER_FORWARD, {"transformer": 2 * SKYREELS_PREFIX_ROWS},
                        SKYREELS_PREFIX_FRAMES, 5)
    paths["skyreels_df_prefix"] = [row]
    import cv2

    from apex_studio_tpu_torch.engine.wan import _pixels, _resized

    z = engine.wan_smoke["decoded"][-1]
    z0 = engine.encode_video_latents(_pixels(_resized([image], 960, 544, cv2.INTER_LANCZOS4)))
    tf = engine.transformer
    prefix = {"phase": "skyreels", "prefix_frame_is_the_image_latent": bool(torch.equal(z[:, :, :1], z0.float())),
              "dit_bits": dit_bits(tf), "dit_parameters": sum(p.numel() for p in tf.parameters()),
              "inject_sample_info": tf.cfg.inject_sample_info, "window_tokens": SKYREELS_TOKENS["df_window"]}
    emit(prefix)
    check(prefix["prefix_frame_is_the_image_latent"], "the df prefix frame is not the image's latent")
    check(dit_bits(tf) == [4] and tf.cfg.dim == 5120 and len(tf.blocks) == SKYREELS_LAYERS and tf.cfg.inject_sample_info,
          "the SkyReels DiT's widths, depth or bits")
    del engine, tf, z, z0
    release()

    engine = skyreels_engine("t2v", home, SKYREELS_TRANSFORMER)
    t2v = dict(prompt=WAN_PROMPT, negative_prompt=WAN_NEG, height=544, width=960, num_frames=1,
               num_inference_steps=2, guidance_scale=6.0, seed=0)
    rows, frames = [], []
    for fps in (24, 16):
        row, out = edit_drive("skyreels_t2v", engine, dict(t2v, fps=fps), SKYREELS_LAUNCHES_PER_FORWARD,
                              {"transformer": 4}, 1, 1)
        rows.append(row)
        frames.append(out[0])
    paths["skyreels_t2v"] = rows
    differ = not np.array_equal(frames[0], frames[1])
    emit({"phase": "skyreels", "t2v_fps_24_and_16_differ": differ})
    check(differ, "the t2v frames at 24 and 16 fps are identical: the fps row is not applied")
    del engine
    release()

    engine = skyreels_engine("i2v", home, SKYREELS_I2V_TRANSFORMER)
    row, _ = edit_drive("skyreels_i2v", engine, dict(t2v, image=image, num_frames=9, num_inference_steps=1, fps=24),
                        SKYREELS_LAUNCHES_PER_FORWARD, {"transformer": 2}, 9, 3)
    paths["skyreels_i2v"] = [row]
    check(engine.transformer.cfg.in_channels == 36, "the i2v DiT's input channels")
    del engine
    release()
    return paths, kernel_rows, kernel_err


# -- the rest of the Wan family: TI2V-5B, Lucy, ReCam, ATI, HoloCine, FramePack, Animate, Lynx, SCAIL ------------


WAN_5B_MANIFEST = REPO / "manifests" / "video" / "wan2.2-ti2v-5b.yml"
LUCY_MANIFEST = REPO / "manifests" / "video" / "lucy-edit-dev.yml"
WAN_MORE_MANIFESTS = {t: REPO / "manifests" / "video" / f for t, f in (
    ("recam", "wan-2.1-14b-recam.yml"), ("ati", "wan-2.1-14b-ati.yml"), ("scail", "wan-2.1-14b-scail.yml"),
    ("holocine", "wan-holocine.yml"), ("apex_framepack", "wan-apex-framepack.yml"),
    ("animate", "wan2.2-animate-14b.yml"), ("lynx", "wan-lynx-14b.yml"), ("lynx_lite", "wan-lynx-lite-14b.yml"))}
# Wan-AI/Wan2.2-TI2V-5B-Diffusers transformer/config.json: dim 3072 (24 heads of
# 128), FFN 14,336, 30 blocks, 48 latent channels in and out
WAN_5B_TRANSFORMER = dict(_WAN14B, num_attention_heads=24, in_channels=48, out_channels=48, ffn_dim=14336,
                          num_layers=30)
# decart-ai/Lucy-Edit-Dev transformer/config.json: the 5B DiT on 48 noise + 48 source channels
LUCY_TRANSFORMER = dict(WAN_5B_TRANSFORMER, in_channels=96)
# Wan-AI/Wan2.2-TI2V-5B-Diffusers vae/config.json without its 48 latent means and
# stds (the latents are then not normalised, which random weights do not need);
# neither package reads decoder_base_dim: both build the decoder at base_dim
# (ROADMAP Queue 3)
WAN22_VAE = {"_class_name": "AutoencoderKLWan", "base_dim": 160, "decoder_base_dim": 256, "z_dim": 48,
             "dim_mult": [1, 2, 4, 4], "num_res_blocks": 2, "attn_scales": [], "temperal_downsample": [False, True, True],
             "dropout": 0.0, "is_residual": True, "in_channels": 12, "out_channels": 12, "patch_size": 2,
             "scale_factor_spatial": 16, "scale_factor_temporal": 4}
# Wan-AI/Wan2.2-Animate-14B-Diffusers transformer/config.json: the Wan 2.1 I2V
# widths with the motion encoder (512² faces, style 512, motion 20), the face
# encoder (4 heads of 1024) and a face adapter after every 5th block
WAN_ANIMATE_TRANSFORMER = dict(WAN21_I2V_TRANSFORMER, _class_name="WanAnimateTransformer3DModel",
                               motion_encoder_size=512, motion_style_dim=512, motion_dim=20, motion_encoder_dim=512,
                               face_encoder_hidden_dim=1024, face_encoder_num_heads=4, inject_face_latents_blocks=5)
# ByteDance/lynx resampler/config.json: a perceiver of depth 8, 16 heads of 64, 8
# queries, ArcFace's 512 in, 2048 out
LYNX_RESAMPLER = {"dim": 1024, "depth": 8, "dim_head": 64, "heads": 16, "num_queries": 8, "embedding_dim": 512,
                  "output_dim": 2048, "ff_mult": 4}
LYNX_IP_TOKENS = 8 + 16  # the resampled identity tokens and the registers
# tokens: TI2V-5B at its default 704x1280 x 121 frames (16x VAE, patch 2: 22 x 40
# a latent frame) and 17 frames; Lucy at 480x832 x 81 (15 x 26); the 14B DiTs at
# 480x832 (30 x 52 = 1560 a latent frame); Animate at 720x1280 (45 x 80 = 3600)
WAN_MORE_TOKENS = {"wan5b_121": 31 * 880, "wan5b_17": 5 * 880, "lucy_81": 21 * 390, "recam_81": 2 * 21 * 1560,
                   "animate_77": 21 * 3600, "scail_81": 1560 + 21 * 1560 + 21 * 390, "clip81": 21 * 1560}
WAN_5B_STEPS, WAN_MORE_STEPS = 1, 1  # of 50 and 20-50: cuts of steps
WAN_MORE_FRAMES = 17
ANIMATE_720P_FRAMES = 45  # of the manifest's 77-frame segment: a cut of clip length
# flash launches a forward of the requests' DiTs (EDIT_LAYERS blocks; 30 for the
# 5B): self + text cross a block, + the CLIP image cross (ATI, SCAIL, Animate),
# + the IP cross (Lynx), + Animate's face adapter at block 0; HoloCine's
# cross-attention carries a per-query bias and takes the plain route
WAN_MORE_LAUNCHES = {"wan5b": 2 * 30, "recam": 2 * EDIT_LAYERS, "ati": 3 * EDIT_LAYERS, "scail": 3 * EDIT_LAYERS,
                     "holocine": EDIT_LAYERS, "apex_framepack": 2 * EDIT_LAYERS,
                     "animate": 3 * EDIT_LAYERS + len(range(0, EDIT_LAYERS, 5)), "lynx": 3 * EDIT_LAYERS}


def framepack_window_tokens(lat_f: int, lat_h: int, lat_w: int) -> int:
    """The longest FramePack sequence (a section and its packed past and
    future context) over a clip of ``lat_f`` latent frames."""
    import numpy as np

    from apex_studio_tpu_torch.models.transformers.wan_framepack import FramepackSchedule, WanFramepackConfig

    cfg = WanFramepackConfig()
    kernels = {str(f): k for f, k in cfg.framepack_compressors}
    sched, done, longest = FramepackSchedule(cfg.num_indices, cfg.context_buckets), np.zeros(lat_f, bool), 0
    while not done.all():
        past, future, target = sched.get_inference_inputs(lat_f, done)
        parts = [(len(target), 1)] + ([(len(past), 1)] if past is not None else [])
        parts += [(len(i), f) for i, f in sched.split_future(future)] if future is not None else []
        n = 0
        for frames, f in parts:
            kt, kh, kw = kernels[str(f)]
            n += -(-frames // kt) * -(-lat_h // kh) * -(-lat_w // kw)
        longest = max(longest, n)
        done[target] = True
    return longest


def wan_more_kernel_inputs():
    """(case, q, k, v, None) at the new launch shapes: TI2V-5B's self- and
    text cross-attention at 24 heads (its default 121 frames) and Lucy's
    81-frame self-attention; ReCam's joint clip, Animate's 720p segment and
    its face cross (the 21 latent frames as the batch, 5 face keys), Lynx's
    IP cross (8 + 16 keys) and its f32 perceiver (16 heads of 64, 8 queries
    over 1 + 8 keys), SCAIL's three streams with its CLIP and text cross, and
    FramePack's longest 81-frame window, at 40 heads."""
    t = WAN_MORE_TOKENS
    fp = framepack_window_tokens(21, 60, 104)
    yield ("wan5b_self_s%d_h24" % t["wan5b_121"], *qkv(1, t["wan5b_121"], t["wan5b_121"], 24, 128, 170), None)
    yield ("wan5b_cross_sq%d_sk%d_h24" % (t["wan5b_121"], WAN_TEXT_TOKENS),
           *qkv(1, t["wan5b_121"], WAN_TEXT_TOKENS, 24, 128, 171), None)
    yield ("lucy_self_s%d_h24" % t["lucy_81"], *qkv(1, t["lucy_81"], t["lucy_81"], 24, 128, 172), None)
    yield ("recam_self_s%d_h40" % t["recam_81"], *qkv(1, t["recam_81"], t["recam_81"], WAN_HEADS, 128, 173), None)
    yield ("animate_self_s%d_h40" % t["animate_77"], *qkv(1, t["animate_77"], t["animate_77"], WAN_HEADS, 128, 174),
           None)
    yield ("animate_face_cross_b21_sq3600_sk5_h40", *qkv(21, 3600, 5, WAN_HEADS, 128, 175), None)
    yield ("lynx_ip_cross_sq%d_sk%d_h40" % (t["clip81"], LYNX_IP_TOKENS),
           *qkv(1, t["clip81"], LYNX_IP_TOKENS, WAN_HEADS, 128, 176), None)
    q, k, v = qkv(1, 8, 9, 16, 64, 177)
    yield ("lynx_resampler_f32_sq8_sk9_h16_d64", q.float(), k.float(), v.float(), None)
    yield ("scail_self_s%d_h40" % t["scail_81"], *qkv(1, t["scail_81"], t["scail_81"], WAN_HEADS, 128, 178), None)
    yield ("scail_clip_cross_sq%d_sk%d_h40" % (t["scail_81"], CLIP_TOKENS),
           *qkv(1, t["scail_81"], CLIP_TOKENS, WAN_HEADS, 128, 179), None)
    yield ("scail_text_cross_sq%d_sk%d_h40" % (t["scail_81"], WAN_TEXT_TOKENS),
           *qkv(1, t["scail_81"], WAN_TEXT_TOKENS, WAN_HEADS, 128, 180), None)
    yield ("framepack_window_s%d_h40" % fp, *qkv(1, fp, fp, WAN_HEADS, 128, 181), None)


def holocine_plain_timing() -> dict:
    """HoloCine's text cross-attention under its per-query shot bias at 81
    frames (32,760 queries, 512 keys, 40 heads) on the plain route in
    ``BIAS_ROWS`` chunks, as the DiT runs it, against
    ``scaled_dot_product_attention`` with the bias as its mask; the bound is
    the kernel's (no kernel launches here)."""
    import torch
    import torch.nn.functional as F

    from apex_studio_tpu_torch.models.transformers.wan import BIAS_ROWS, biased_attention

    s = WAN_TOKENS["clip"]
    q, k, v = qkv(1, s, WAN_TEXT_TOKENS, WAN_HEADS, 128, 182)
    shot = torch.arange(s, device="cuda") >= s // 2  # two shots: the second half of the clip
    cols = torch.arange(WAN_TEXT_TOKENS, device="cuda")
    allow = (cols < 40) | ((cols >= 40) & (cols < 80) & ~shot[:, None]) | ((cols >= 80) & (cols < 120) & shot[:, None])
    allow |= cols >= 120  # the padding stays attendable
    bias = torch.where(allow, 0.0, -1e4)[None, None].float()
    out = biased_attention(q, k, v, bias)
    ref = flash_reference_rows(q, k, v, bias)
    agree = agreement(out[:, :128], ref)
    mask = bias.to(torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    row = {"phase": "timing", "path": "wan_more", "case": "holocine_cross_bias_plain_sq%d_sk%d_h40" % (
        s, WAN_TEXT_TOKENS), "route": f"plain, {BIAS_ROWS}-row chunks",
        "plain_ms": time_ms(lambda: biased_attention(q, k, v, bias), reps=5, warmup=1),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), reps=5),
        **attention_bound(q, k, None), "first_128_rows_vs_f32": agree}
    emit(row)
    check(agree["within"], f"HoloCine's biased plain route disagrees with the f32 reference: {agree}")
    return row


def flash_reference_rows(q, k, v, bias, rows: int = 128):
    """f32 softmax attention of the first ``rows`` queries under a per-query
    bias [1, 1, S, Sk]."""
    import torch

    s = torch.einsum("bqhd,bkhd->bhqk", q[:, :rows].float(), k.float()) * q.shape[-1] ** -0.5
    p = torch.softmax(s + bias[:, :, :rows].float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def wan_more_reference():
    """The new DiTs at full width with 2 blocks, card (bf16, kernel) against
    CPU (f32, plain versions) within BF16_REL_L2, over a 16 x 32 latent grid
    (128 tokens a frame) and 512 text rows of which 40 are real: ReCam (a
    target and a source frame, one camera pose), FramePack (one section frame
    after two past anchors), Animate (the reference slot and one frame, one
    512² face, a pose frame, 257 CLIP tokens), Lynx (8 + 16 identity keys)
    and SCAIL (reference, video and half-size pose streams)."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.models.transformers import wan, wan_animate, wan_framepack, wan_lynx, wan_scail

    rng = np.random.default_rng(183)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    ctx = tensor(1, WAN_TEXT_TOKENS, 4096)
    ctx[:, 40:] = 0.0
    t = torch.tensor([731.0])
    two = dict(num_layers=2)
    card_vs_cpu("wan.recam dim 5120, 2 blocks, target + source frame", lambda dt: wan.WanRecamTransformer3DModel(
        wan.WanConfig.from_dict(dict(_WAN14B, **two)), dtype=dt),
        lambda m, x, t_, c, cam: m(x, t_, c, cam_emb=cam), (tensor(1, 16, 2, 16, 32), t, ctx, tensor(1, 1, 12)),
        BF16_REL_L2, 184, phase="wan_more")
    card_vs_cpu("wan.apex_framepack dim 5120, 2 blocks, a section frame after the anchors",
                lambda dt: wan_framepack.WanApexFramepackTransformer3DModel(
                    wan_framepack.WanFramepackConfig.from_dict(dict(_WAN14B, **two)), dtype=dt),
                lambda m, x, t_, c, lat: m(x, t_, c, latent_context=[(lat, np.array([0, 1]), 1)],
                                           indices=np.array([2])),
                (tensor(1, 16, 1, 16, 32), t, ctx, tensor(1, 16, 2, 16, 32)), BF16_REL_L2, 185, phase="wan_more")
    face = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 1, 512, 512)).astype(np.float32))
    card_vs_cpu("wan.animate dim 5120, 2 blocks, a face adapter, one 512² face",
                lambda dt: wan_animate.WanAnimateTransformer3DModel(
                    wan_animate.WanAnimateConfig.from_dict(dict(WAN_ANIMATE_TRANSFORMER, **two)), dtype=dt),
                lambda m, x, t_, c, clip, pose, f: m(x, t_, c, clip, pose, f),
                (tensor(1, 36, 2, 16, 32), t, ctx, tensor(1, CLIP_TOKENS, 1280), tensor(1, 16, 1, 16, 32), face),
                BF16_REL_L2, 186, phase="wan_more")
    card_vs_cpu("wan.lynx dim 5120, 2 blocks, 8 + 16 identity keys", lambda dt: wan_lynx.WanLynxTransformer3DModel(
        wan_lynx.WanLynxConfig.from_dict(dict(_WAN14B, **two)), dtype=dt),
        lambda m, x, t_, c, ip: m(x, t_, c, ip_tokens=ip, ip_scale=1.0),
        (tensor(1, 16, 2, 16, 32), t, ctx, tensor(1, 8, 2048)), BF16_REL_L2, 187, phase="wan_more")
    card_vs_cpu("wan.scail dim 5120, 2 blocks, reference + video + pose", lambda dt: wan_scail.SCAILModel(
        wan_scail.WanScailConfig.from_dict(dict(WAN21_I2V_TRANSFORMER, **two)), dtype=dt),
        lambda m, x, t_, c, pose, ref, clip: m(x, t_, c, pose, ref, clip),
        (tensor(1, 16, 2, 16, 32), t, ctx, tensor(1, 16, 2, 8, 16), tensor(1, 16, 1, 16, 32),
         tensor(1, CLIP_TOKENS, 1280)), BF16_REL_L2, 188, phase="wan_more")


def wan_5b_requests(home: Path):
    """TI2V-5B t2v and Lucy Edit at the published 5B widths and full depth
    (30 blocks), bf16 as the manifests say (UMT5-XXL too), the Wan 2.2 VAE
    (z 48, 16x, patch 2, residual) written where both manifests name a VAE:
    t2v at 704x1280, 17 frames, 1 step, CFG 5, twice with one seed
    (bit-identical) and once with another (different); Lucy at 480x832 on a
    17-frame source and on its negative (different frames)."""
    import numpy as np

    paths = {}
    engine = edit_engine("wan_5b", WAN_5B_MANIFEST, "t2v", home, "bf16",
                         {"transformer": WAN_5B_TRANSFORMER, "vae": WAN22_VAE})
    kw = dict(prompt=WAN_PROMPT, negative_prompt=WAN_NEG, height=704, width=1280, num_frames=WAN_MORE_FRAMES,
              num_inference_steps=WAN_5B_STEPS, guidance_scale=5.0, seed=0)
    forwards = {"transformer": 2 * WAN_5B_STEPS}
    rows = identical_pair("wan_5b_t2v", engine, kw, WAN_MORE_LAUNCHES["wan5b"], forwards, WAN_MORE_FRAMES, 5)
    row, other = edit_drive("wan_5b_t2v", engine, dict(kw, seed=1), WAN_MORE_LAUNCHES["wan5b"], forwards,
                            WAN_MORE_FRAMES, 5)
    first = engine.wan_smoke["decoded"][-1]
    tf, vae = engine.transformer, engine.vae
    facts = {"phase": "wan_5b", "dit_dim": tf.cfg.dim, "dit_blocks": len(tf.blocks), "heads": tf.cfg.num_attention_heads,
             "in_channels": tf.cfg.in_channels, "dit_parameters": sum(p.numel() for p in tf.parameters()),
             "dit_dtype": str(tf.dtype), "dit_bits": dit_bits(tf), "vae_z": vae.cfg.z_dim,
             "vae_spatial_scale": vae.cfg.spatial_scale, "vae_patch_size": vae.cfg.patch_size,
             "latents": list(first.shape), "tokens": WAN_MORE_TOKENS["wan5b_17"]}
    emit(facts)
    check(tf.cfg.dim == 3072 and len(tf.blocks) == 30 and tf.cfg.num_attention_heads == 24 and not dit_bits(tf)
          and tf.cfg.in_channels == 48 and vae.cfg.z_dim == 48 and vae.cfg.spatial_scale == 16,
          f"the TI2V-5B DiT's or VAE's widths: {facts}")
    paths["wan_5b_t2v_704x1280"] = rows + [row]
    del engine, tf, vae, first
    release()

    engine = edit_engine("lucy", LUCY_MANIFEST, "edit", home, "bf16",
                         {"transformer": LUCY_TRANSFORMER, "vae": WAN22_VAE})
    src, _ = disk_clip(WAN_MORE_FRAMES, seed=190)
    lucy_kw = dict(prompt="make the sky purple", negative_prompt=WAN_NEG, height=480, width=832,
                   num_frames=WAN_MORE_FRAMES, num_inference_steps=WAN_5B_STEPS, guidance_scale=5.0, seed=0)
    rows, frames = [], []
    for video in (src, [255 - f for f in src]):
        row, out = edit_drive("lucy_edit", engine, dict(lucy_kw, video=video), WAN_MORE_LAUNCHES["wan5b"], forwards,
                              WAN_MORE_FRAMES, 5)
        rows.append(row)
        frames.append(out)
    differ = not np.array_equal(frames[0][8], frames[1][8])
    emit({"phase": "wan_5b", "lucy_sources_differ_frames_differ": differ,
          "lucy_in_channels": engine.transformer.cfg.in_channels, "tokens": 5 * 390})
    check(differ, "Lucy's frames do not change with its source video")
    check(engine.transformer.cfg.in_channels == 96 and engine.vae.cfg.z_dim == 48, "Lucy's DiT or VAE")
    paths["lucy_edit_480x832"] = rows
    del engine, frames
    release()
    return paths


def phase_wan_5b(home: Path):
    """TI2V-5B and Lucy: the kernel at their shapes (part of
    ``wan_more_kernel_inputs``), then ``wan_5b_requests``."""
    rows, err = path_kernel_rows("wan_5b", (c for c in wan_more_kernel_inputs()
                                            if c[0].startswith(("wan5b", "lucy"))))
    return wan_5b_requests(home), rows, err


def write_wan_more_manifests(root: Path) -> dict:
    """HoloCine's manifest as its engine implies it (the ``wan.holocine`` DiT
    on the T2V 14B config: its repository manifest names the Wan 2.1 I2V
    config, which the engine cannot feed) and Lynx-lite's at the requests'
    depth (its inline config replaces the config file, so the cut goes
    there); the others as they are."""
    import yaml

    out = dict(WAN_MORE_MANIFESTS)
    doc = yaml.safe_load(WAN_MORE_MANIFESTS["holocine"].read_text())
    tf = next(c for c in doc["spec"]["components"] if c["type"] == "transformer")
    tf["base"], tf["config_path"] = "wan.holocine", "Wan-AI/Wan2.1-T2V-14B-Diffusers/transformer/config.json"
    out["holocine"] = root / "wan-holocine-t2v.yml"
    out["holocine"].write_text(yaml.safe_dump(doc))
    doc = yaml.safe_load(WAN_MORE_MANIFESTS["lynx_lite"].read_text())
    tf = next(c for c in doc["spec"]["components"] if c["type"] == "transformer")
    tf["config"] = dict(tf["config"], num_layers=EDIT_LAYERS)
    out["lynx_lite"] = root / "wan-lynx-lite-cut.yml"
    out["lynx_lite"].write_text(yaml.safe_dump(doc))
    return out


def wan_more_engine(model_type: str, home: Path, manifests: dict):
    """A ``wan_more`` engine: every one under one home (the UMT5-XXL encodes
    of the shared prompts are built once and then read from the disk cache),
    the DiTs int4 at ``EDIT_LAYERS`` blocks, UMT5-XXL int8, the helpers (CLIP
    ViT-H, Lynx's resampler) unquantized."""
    configs = {"transformer": edit_depth({"ati": WAN21_I2V_TRANSFORMER, "scail": WAN21_I2V_TRANSFORMER,
                                          "animate": WAN_ANIMATE_TRANSFORMER}.get(model_type, _WAN14B)),
               "image_encoder": CLIP_VISION_H, "resampler": LYNX_RESAMPLER}
    return edit_engine("wan_more", manifests[model_type], model_type, home, "int4", configs, {"helper": "bf16"})


def differ_pair(label, engine, kws, launches, forwards, frames_expected, latent_t, what, extra=0):
    """Requests ``kws`` through ``edit_drive``: the first two's middle frames
    must differ (``what`` the conditioning that differs). Returns the rows."""
    import numpy as np

    rows, frames = [], []
    for kw in kws:
        row, out = edit_drive(label, engine, kw, launches, forwards, frames_expected, latent_t, extra)
        rows.append(row)
        frames.append(out[len(out) // 2])
    differ = not np.array_equal(frames[0], frames[1])
    emit({"phase": label, f"{what}_differ_frames_differ": differ})
    check(differ, f"{label}: the frames do not change with {what}")
    return rows


def wan_more_requests(home: Path):
    """The 14B engines from their manifests at full width (dim 5120, 40
    heads, FFN 13,824), the DiTs int4 at 3 of their 40 blocks, 1 step with
    CFG 5 at 480x832 and 17 frames unless said: ReCam under two cameras, ATI
    with a trajectory and without (the painted condition against the CPU's
    ``patch_motion``), SCAIL with two pose videos, HoloCine twice with one
    shot split (bit-identical) and once with another, FramePack over 45
    frames (three sections, the last with 1x, 2x and 4x future context),
    Animate at the manifest's 720x1280 over ANIMATE_720P_FRAMES frames of one
    segment (the VAE encode in time chunks), then two
    17-frame segments chained (twice, bit-identical) and replace mode once
    (guidance 1, its default), Lynx at ip_scale 1 and 0, Lynx-lite once."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.models.trajectory import patch_motion, prepare_tracks

    paths = {}
    root = home / "wan_more"
    root.mkdir(parents=True, exist_ok=True)
    manifests = write_wan_more_manifests(root)
    base = dict(prompt=WAN_PROMPT, negative_prompt=WAN_NEG, height=480, width=832, num_frames=WAN_MORE_FRAMES,
                num_inference_steps=WAN_MORE_STEPS, guidance_scale=5.0, seed=0)
    cfg_fwd = {"transformer": 2 * WAN_MORE_STEPS}
    clip, _ = disk_clip(WAN_MORE_FRAMES, seed=191)
    L = WAN_MORE_LAUNCHES

    engine = wan_more_engine("recam", home, manifests)
    paths["wan_recam"] = differ_pair("wan_recam", engine, [dict(base, video=clip, camera=c) for c in ("orbit", "pan_left")],
                                     L["recam"], cfg_fwd, WAN_MORE_FRAMES, 5, "the camera")
    check(len(engine.transformer.blocks) == EDIT_LAYERS and engine.transformer.cfg.dim == 5120
          and dit_bits(engine.transformer) == [4], "the ReCam DiT's widths, depth or bits")
    del engine
    release()

    engine = wan_more_engine("ati", home, manifests)
    rng = np.random.default_rng(192)
    tracks = np.concatenate([rng.uniform(0, 8 * 480, size=(WAN_MORE_FRAMES, 6, 2)),
                             np.full((WAN_MORE_FRAMES, 6, 1), 8.0)], -1).astype(np.float32)
    ati = dict(base, image=clip[0])
    paths["wan_ati"] = differ_pair("wan_ati", engine, [dict(ati, trajectory=tracks), ati], L["ati"], cfg_fwd,
                                   WAN_MORE_FRAMES, 5, "the trajectory")
    plain = engine.build_condition(clip[0], WAN_MORE_FRAMES, 480, 832)
    engine._pending_trajectory = tracks
    try:
        painted = engine.build_condition(clip[0], WAN_MORE_FRAMES, 480, 832).float().cpu()
    finally:
        engine._pending_trajectory = None
    cpu = patch_motion(torch.from_numpy(prepare_tracks(tracks, 832, 480)), plain[0].float().cpu(), vae_divide=(4, 16))
    row = {"phase": "wan_more", "check": "ati_painted_condition_vs_cpu", "rel_l2": rel_l2(painted[0], cpu),
           "tol_rel_l2": 1e-5, "painted_mask_mean": float(painted[0, 0, 1:].mean())}
    emit(row)
    check(row["rel_l2"] <= 1e-5, f"ATI's painted condition on the card is {row['rel_l2']} from the CPU's")
    del engine, plain, painted, cpu
    release()

    engine = wan_more_engine("scail", home, manifests)
    other, _ = disk_clip(WAN_MORE_FRAMES, seed=193)
    scail = dict(base, image=clip[0])
    paths["wan_scail"] = differ_pair("wan_scail", engine, [dict(scail, pose_video=p) for p in (clip, other)],
                                     L["scail"], cfg_fwd, WAN_MORE_FRAMES, 5, "the pose video")
    del engine
    release()

    engine = wan_more_engine("holocine", home, manifests)
    holo = dict(base, prompt="a quiet harbour at dawn", shot_captions=["fishing boats leave the pier",
                                                                      "a gull lands on a mooring post"])
    rows, frames = [], []
    for kw in (holo, holo, dict(holo, shot_cut_frames=[4])):
        row, out = edit_drive("wan_holocine", engine, kw, L["holocine"], cfg_fwd, WAN_MORE_FRAMES, 5)
        rows.append(row)
        frames.append(np.stack(out))
    same, differ = bool(np.array_equal(frames[0], frames[1])), not np.array_equal(frames[0], frames[2])
    emit({"phase": "wan_holocine", "requests_identical_frames": same, "the_shot_split_differ_frames_differ": differ})
    check(same, "wan_holocine: two requests with the same inputs and seed differ")
    check(differ, "wan_holocine: the frames do not change with the shot split")
    paths["wan_holocine"] = rows
    check(engine.transformer.shot_embedding.shape[0] == 20, "HoloCine's shot table")
    del engine
    release()

    from apex_studio_tpu_torch.models.transformers.wan_framepack import FramepackSchedule, WanFramepackConfig

    engine = wan_more_engine("apex_framepack", home, manifests)
    fp_cfg = WanFramepackConfig()
    sections = FramepackSchedule(fp_cfg.num_indices, fp_cfg.context_buckets).num_sections(12)
    row, _ = edit_drive("wan_framepack", engine, dict(base, num_frames=45, guidance_scale=5.0), L["apex_framepack"],
                        {"transformer": 2 * WAN_MORE_STEPS * sections}, 45, 12)
    check(sections == 3, f"FramePack's plan over 12 latent frames has {sections} sections")
    paths["wan_framepack_45_frames"] = [row]
    del engine
    release()

    engine = wan_more_engine("animate", home, manifests)
    decode = engine.decode_video_tensor

    def observed(z, *a):
        engine.wan_smoke["decoded"].append(z.detach().clone())
        return decode(z, *a)

    engine.decode_video_tensor = observed
    # 45 of the segment's 77 frames: a cut of clip length that keeps the chunked VAE encode
    pose, _ = disk_clip(ANIMATE_720P_FRAMES, 720, 1280, seed=194)
    faces, _ = disk_clip(ANIMATE_720P_FRAMES, 512, 512, seed=195)
    ref_image = cv2_smooth(np.random.default_rng(196), (720, 1280))
    full = dict(image=ref_image, pose_video=pose, face_video=faces, prompt=WAN_PROMPT, height=720, width=1280,
                segment_frame_length=ANIMATE_720P_FRAMES, num_inference_steps=WAN_MORE_STEPS, guidance_scale=1.0,
                seed=0)
    row, _ = edit_drive("wan_animate_720p", engine, full, L["animate"], {"transformer": WAN_MORE_STEPS},
                        ANIMATE_720P_FRAMES, (ANIMATE_720P_FRAMES - 1) // 4 + 1)
    paths[f"wan_animate_720p_{ANIMATE_720P_FRAMES}_frames"] = [row]
    del pose, faces
    short_pose, _ = disk_clip(33, seed=197)
    short_faces, _ = disk_clip(33, 512, 512, seed=198)
    short = dict(full, image=clip[0], pose_video=short_pose, face_video=short_faces, height=480, width=832,
                 segment_frame_length=17)
    paths["wan_animate_two_segments"] = identical_pair("wan_animate_two_segments", engine, short, L["animate"],
                                                       {"transformer": 2 * WAN_MORE_STEPS}, 33, [5, 5])
    masks = [np.where(f[..., 0] > 150, 255, 0).astype(np.uint8) for f in clip]
    row, _ = edit_drive("wan_animate_replace", engine, dict(short, mode="replace", pose_video=clip, face_video=clip,
                                                           background_video=clip[::-1], mask_video=masks),
                        L["animate"], {"transformer": WAN_MORE_STEPS}, WAN_MORE_FRAMES, 5)
    paths["wan_animate_replace"] = [row]
    del engine
    release()

    face_embeds = np.random.default_rng(199).normal(size=512).astype(np.float32)
    engine = wan_more_engine("lynx", home, manifests)
    lynx = dict(base, face_embeds=face_embeds)
    paths["wan_lynx"] = differ_pair("wan_lynx", engine, [dict(lynx, ip_scale=1.0), dict(lynx, ip_scale=0.0)],
                                    L["lynx"], cfg_fwd, WAN_MORE_FRAMES, 5, "ip_scale", extra=LYNX_RESAMPLER["depth"])
    check(engine.transformer.blocks[0].registers.shape[1] == 16, "Lynx's registers")
    del engine
    release()
    engine = wan_more_engine("lynx_lite", home, manifests)
    row, _ = edit_drive("wan_lynx_lite", engine, lynx, L["lynx"], cfg_fwd, WAN_MORE_FRAMES, 5,
                        LYNX_RESAMPLER["depth"])
    check(engine.transformer.blocks[0].registers is None and len(engine.transformer.blocks) == EDIT_LAYERS,
          "Lynx-lite's registers or depth")
    paths["wan_lynx_lite"] = [row]
    del engine
    release()
    return paths


def phase_wan_more(home: Path):
    """The 14B engines: the kernel at their new shapes, HoloCine's biased
    plain route timed, the 2-block full-width DiTs against f32, then
    ``wan_more_requests``."""
    rows, err = path_kernel_rows("wan_more", (c for c in wan_more_kernel_inputs()
                                              if not c[0].startswith(("wan5b", "lucy"))))
    holocine_plain_timing()
    wan_more_reference()
    return wan_more_requests(home), rows, err


# -- the other image families: Chroma, Ovis-Image, FIBO, HiDream-I1, HunyuanImage 2.1 -------

IMAGE_REST_MANIFESTS = {name: REPO / "manifests" / "image" / f for name, f in (
    ("chroma", "chroma-hd-text-to-image.yml"), ("ovis", "ovis-image-t2i.yml"), ("fibo", "fibo-ti2i.yml"),
    ("hidream", "hidream-i1-full.yml"), ("hunyuanimage", "hunyuanimage-2.1.yml"),
    ("hunyuanimage_distilled", "hunyuanimage-2.1-distilled.yml"))}
IMAGE_REST_STEPS = 1  # of 8-50: a cut of steps
# HiDream's 1 + 1 blocks in bf16 against f32: five bf16 SwiGLU experts a token (4 routed, 1 shared, each
# rounded before the f32 sum) put 1.27-1.31% there on an H100, where Flux-shaped blocks read
# 0.7-0.9%; the check reads the same module in bf16 on the CPU beside it
HIDREAM_BF16_REL_L2 = 1.5e-2
# Published configs the repository lacks, written where the manifests name them. Qwen3-1.7B, the text
# tower of Ovis2.5-2B (its 2048 features are the DiT's joint_attention_dim); SmolLM3-3B, FIBO's encoder,
# every hidden state stacked (FIBO's 57 blocks take the last 37, the first padded, as the engine pads);
# Llama-3.1-8B with HiDream's llama_layers (hidden states 1..32, the last repeated for blocks 33..48);
# CLIP-G/14's text tower; HiDream-I1-Full's and HunyuanImage 2.1's transformer configs (byT5-small's 1472
# glyph features) and its VAE's. Values the repository does not hold: FIBO's VAE is a 16x AutoencoderKL of the DiT's 64
# latent channels (the manifest's `base: auto`; the published FIBO decodes Wan 2.2 latents, ROADMAP Queue 3).
OVIS_QWEN3 = {"vocab_size": 151936, "hidden_size": 2048, "intermediate_size": 6144, "num_hidden_layers": 28,
              "num_attention_heads": 16, "num_key_value_heads": 8, "head_dim": 128, "rope_theta": 1000000.0}
SMOLLM3 = {"vocab_size": 128256, "hidden_size": 2048, "intermediate_size": 11008, "num_hidden_layers": 36,
           "num_attention_heads": 16, "num_key_value_heads": 4, "head_dim": 128, "rope_theta": 5000000.0,
           "rms_norm_eps": 1e-6, "stack_layers": list(range(37))}
FIBO_VAE = {"latent_channels": 64, "block_out_channels": [128, 256, 512, 512, 512]}
HIDREAM_LLAMA_LAYERS = list(range(32)) + [31] * 16
HIDREAM_TRANSFORMER = {"patch_size": 2, "in_channels": 16, "out_channels": 16, "num_layers": 16,
                       "num_single_layers": 32, "attention_head_dim": 128, "num_attention_heads": 20,
                       "text_emb_dim": 2048, "caption_channels": [4096, 4096], "num_routed_experts": 4,
                       "num_activated_experts": 2, "axes_dims_rope": [64, 32, 32],
                       "llama_layers": HIDREAM_LLAMA_LAYERS}
LLAMA31_8B = {"vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32,
              "num_attention_heads": 32, "num_key_value_heads": 8, "rope_theta": 500000.0,
              "stack_layers": [1 + i for i in HIDREAM_LLAMA_LAYERS]}
CLIP_G = {"vocab_size": 49408, "hidden_size": 1280, "intermediate_size": 5120, "num_hidden_layers": 32,
          "num_attention_heads": 20, "hidden_act": "gelu", "projection_dim": 1280}
HYI_TRANSFORMER = {"in_channels": 64, "out_channels": 64, "num_attention_heads": 28, "attention_head_dim": 128,
                   "num_layers": 20, "num_single_layers": 40, "num_refiner_layers": 2, "mlp_ratio": 4.0,
                   "patch_size": [1, 1], "text_embed_dim": 3584, "text_embed_2_dim": 1472, "rope_theta": 256.0,
                   "rope_axes_dim": [64, 64]}
# the published 32x VAE: six levels, five resamplers (the family's defaults list five levels: 16x)
HYI_VAE = {"latent_channels": 64, "block_out_channels": [128, 256, 512, 512, 1024, 1024], "layers_per_block": 2,
           "spatial_compression_ratio": 32, "scaling_factor": 0.75289}
# the requests' DiTs cut in depth since PR 21: Chroma 5 + 10 of 19 + 38 blocks, Ovis 2 + 7 of 6 + 27,
# HunyuanImage 2.1 5 + 10 of 20 + 40; FIBO and HiDream map text-encoder layers onto their blocks and keep
# their full depth
_HYI_CUT = dict(HYI_TRANSFORMER, num_layers=5, num_single_layers=10)
IMAGE_REST_CONFIGS = {
    "chroma": {"transformer": {"num_layers": 5, "num_single_layers": 10}},
    "ovis": {"text_encoder": OVIS_QWEN3, "transformer": {"num_layers": 2, "num_single_layers": 7}},
    "fibo": {"text_encoder": SMOLLM3, "vae": FIBO_VAE},
    "hidream": {"transformer": HIDREAM_TRANSFORMER, "text_encoder_2": CLIP_G, "text_encoder_4": LLAMA31_8B},
    "hunyuanimage": {"transformer": _HYI_CUT, "text_encoder_2": BYT5_SMALL, "vae": HYI_VAE},
    "hunyuanimage_distilled": {"transformer": dict(_HYI_CUT, guidance_embeds=True, use_meanflow=True),
                               "text_encoder_2": BYT5_SMALL, "vae": HYI_VAE}}
# flash launches a forward (one a block; HunyuanImage's two refiner blocks add two), and forwards a CFG step
IMAGE_REST_LAUNCHES = {"chroma": 5 + 10, "ovis": 2 + 7, "fibo": 19 + 38, "hidream": 16 + 32,
                       "hunyuanimage": 5 + 10 + 2, "hunyuanimage_distilled": 5 + 10 + 2}
IMAGE_REST_SIZE = {"hunyuanimage": 2048, "hunyuanimage_distilled": 2048}
# joint lengths at the manifests' defaults: 4096 image tokens (1024² at 8x packed 2x2, 16x, or 2048² at
# 32x) and each family's text: T5's 512; Ovis' 256 after the crop; FIBO's 2048; HiDream's T5 128 + two
# Llama layers of 128; HunyuanImage's byT5 128 + 1000
IMAGE_REST_TOKENS = {"chroma": 4096 + 512, "ovis": 4096 + 256, "fibo": 4096 + 2048, "hidream": 4096 + 3 * 128,
                     "hunyuanimage": 4096 + 128 + 1000}
IMAGE_REST_PROMPT = 'A lighthouse on a rocky coast at golden hour, a sign reading "OPEN" above the door'
FIBO_PROMPT = json.dumps({"short_description": "A lighthouse on a rocky coast at golden hour",
                          "style_medium": "photograph", "lighting": {"conditions": "golden hour"}})


def write_named_configs(root: Path, manifest: Path, configs: dict) -> None:
    """Each ``configs`` entry (component name or type → config) as the
    config.json its component's ``config_path`` names, under ``root``'s
    components."""
    import yaml

    for comp in yaml.safe_load(manifest.read_text())["spec"]["components"]:
        cfg = configs.get(comp.get("name") or comp["type"], configs.get(comp["type"]))
        if cfg is not None and comp.get("config_path"):
            path = root / "components" / comp["config_path"]
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(cfg))


def image_rest_kernel_inputs():
    """(case, q, k, v, bias) at the joint lengths of the new DiTs: Chroma's
    with the text key padding (the kernel route, ROADMAP Queue 3), Ovis's,
    FIBO's with its single blocks' mask and its dual blocks' 0/1 key bias,
    HiDream's at 20 heads, HunyuanImage's at 28 heads with the text bias and
    its refiner's 1000 rows."""
    import torch

    chroma = torch.zeros(1, IMAGE_REST_TOKENS["chroma"], device="cuda")
    chroma[:, 90:512] = -1e30  # [txt | img]: 90 of 512 text tokens kept
    fibo_s = IMAGE_REST_TOKENS["fibo"]
    fibo_mask = torch.zeros(1, fibo_s, device="cuda")
    fibo_mask[:, 120:2048] = -1e30
    fibo_dual = torch.ones(1, fibo_s, device="cuda")
    fibo_dual[:, 120:2048] = 0.0
    hyi_s = IMAGE_REST_TOKENS["hunyuanimage"]
    hyi = torch.zeros(1, hyi_s, device="cuda")
    hyi[:, 4096 + 6:4096 + 128] = -1e30  # [img | byT5 (6 kept) | mllm (60 kept)]
    hyi[:, 4096 + 128 + 60:] = -1e30
    refiner = torch.zeros(1, 1000, device="cuda")
    refiner[:, 60:] = -1e30
    cases = [(f"chroma_joint_s{IMAGE_REST_TOKENS['chroma']}_h24_bias", IMAGE_REST_TOKENS["chroma"], 24, chroma),
             (f"ovis_joint_s{IMAGE_REST_TOKENS['ovis']}_h24", IMAGE_REST_TOKENS["ovis"], 24, None),
             (f"fibo_single_s{fibo_s}_h24_bias", fibo_s, 24, fibo_mask),
             (f"fibo_dual_s{fibo_s}_h24_bias01", fibo_s, 24, fibo_dual),
             (f"hidream_joint_s{IMAGE_REST_TOKENS['hidream']}_h20", IMAGE_REST_TOKENS["hidream"], 20, None),
             (f"hunyuanimage_joint_s{hyi_s}_h28_bias", hyi_s, 28, hyi),
             ("hunyuanimage_refiner_s1000_h28_bias", 1000, 28, refiner)]
    for i, (name, s, h, bias) in enumerate(cases):
        yield (name, *qkv(1, s, s, h, 128, 200 + i), bias)


def image_rest_reference():
    """Each new DiT at full width with 1 + 1 blocks, on the card in bf16 (the
    kernel) against the same weights on the CPU in f32 (the plain version),
    within BF16_REL_L2, over a 16 x 16 latent token grid and 64 text rows of
    which 40 are real where the DiT takes a mask: Chroma (the approximator's
    17 rows), Ovis, FIBO (two text-encoder layers), HiDream (the MoE at its 4
    experts, top 2) and HunyuanImage 2.1 distilled (the refiner, byT5,
    guidance and meanflow); then HunyuanImage's 32x VAE decode of a seeded
    8 x 8 latent against float64, within 2e-2."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.models.transformers import chroma, fibo, hidream, hunyuanimage, ovis
    from apex_studio_tpu_torch.models.vaes import hunyuanimage_vae

    rng = np.random.default_rng(211)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    mask = (torch.arange(64) < 40)[None].to(torch.int32)
    one = dict(num_layers=1, num_single_layers=1)
    card_vs_cpu("chroma.base 24 heads of 128, 1 + 1 blocks, the approximator, text padding",
                lambda dt: chroma.ChromaTransformer2DModel(chroma.ChromaConfig(**one), dtype=dt),
                lambda m, x, c, t, k: m(x, c, t, attention_mask=k, grid_hw=(16, 16)),
                (tensor(1, 256, 64), tensor(1, 64, 4096), torch.tensor([0.7]), mask), BF16_REL_L2, 212,
                phase="image_rest")
    card_vs_cpu("ovis.base 24 heads of 128, 1 + 1 blocks", lambda dt: ovis.OvisImageTransformer2DModel(
        ovis.OvisConfig(**one), dtype=dt), lambda m, x, c, t: m(x, c, t, grid_hw=(16, 16)),
                (tensor(1, 256, 64), tensor(1, 64, 2048), torch.tensor([0.7])), BF16_REL_L2, 213, phase="image_rest")
    card_vs_cpu("fibo.base 24 heads of 128, 1 + 1 blocks, two text-encoder layers, text padding",
                lambda dt: fibo.BriaFiboTransformer2DModel(fibo.FiboConfig(**one), dtype=dt),
                lambda m, x, c, l1, l2, t, k: m(x, c, [l1, l2], t, text_mask=k, grid_hw=(16, 16)),
                (tensor(1, 256, 64), tensor(1, 64, 4096), tensor(1, 64, 2048), tensor(1, 64, 2048),
                 torch.tensor([700.0]), mask), BF16_REL_L2, 214, phase="image_rest")
    hidream_card_vs_cpu((tensor(1, 16, 32, 32), torch.tensor([700.0]), tensor(1, 64, 4096),
                         [tensor(1, 64, 4096), tensor(1, 64, 4096)], tensor(1, 2048)), 215)
    card_vs_cpu("hunyuanimage.base 28 heads of 128, 1 + 1 blocks, distilled, the refiner and byT5",
                lambda dt: hunyuanimage.HunyuanImageTransformer2DModel(hunyuanimage.HunyuanImageConfig.from_dict(
                    dict(HYI_TRANSFORMER, guidance_embeds=True, use_meanflow=True, **one)), dtype=dt),
                lambda m, x, t, txt, k, y, yk, g, r: m(x, t, txt, k, y, yk, guidance=g, t_r=r),
                (tensor(1, 64, 16, 16), torch.tensor([870.0]), tensor(1, 64, 3584), mask, tensor(1, 16, 1472),
                 (torch.arange(16) < 6)[None].to(torch.int32), torch.tensor([3250.0]), torch.tensor([500.0])),
                BF16_REL_L2, 216, phase="image_rest")
    vae = materialize_random_vae(lambda: hunyuanimage_vae.AutoencoderKLHunyuanImage(
        hunyuanimage_vae.HunyuanImageVAEConfig.from_dict(HYI_VAE)), seed=217)
    g = torch.Generator("cuda").manual_seed(218)
    z = torch.randn(1, vae.cfg.latent_channels, 8, 8, generator=g, device="cuda")
    vae_vs_float64("image_rest", "hunyuanimage.vae 32x", vae, z, (1, 3, 256, 256))
    del vae
    release()


def hidream_card_vs_cpu(inputs, seed: int):
    """The HiDream DiT at full width with 1 + 1 blocks (the MoE at its 4
    experts, top 2), card (bf16) against CPU (f32). The router reads bf16
    activations on the card and f32 ones on the CPU, and is discrete: a token
    whose second and third scores lie within bf16's rounding of each other
    picks another expert. So the CPU reference takes each token's routing
    weights from the card; the tokens whose f32 choice differs are counted
    (at most 1%), and the distance with the CPU's own f32 weights at the
    card's experts is reported beside. Held within HIDREAM_BF16_REL_L2: the
    same module in bf16 on the CPU (the plain route, the card's routing) is
    read against f32 beside it, the distance bf16 itself puts there."""
    import torch

    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.transformers import hidream

    def build(dt):
        return hidream.HiDreamImageTransformer2DModel(hidream.HiDreamConfig.from_dict(
            dict(HIDREAM_TRANSFORMER, llama_layers=[0, 1], num_layers=1, num_single_layers=1)), dtype=dt)

    cpu, card = bf16_card_and_f32_cpu(build, seed)
    picked, calls, mode = [], [], {}

    def moes(model):
        return [m for m in model.modules() if isinstance(m, hidream._MoESwiGLU)]

    for moe in moes(card):
        def card_routing(x, moe=moe):
            w = type(moe).routing(moe, x)
            picked.append(w.float().cpu())
            return w

        moe.routing = card_routing
    for moe in moes(cpu):
        def cpu_routing(x, moe=moe):
            own, card_w = type(moe).routing(moe, x), picked[len(calls) % len(picked)]
            calls.append(int(((own > 0) != (card_w > 0)).any(-1).sum()))
            if mode["weights"] == "card":
                return card_w
            return torch.softmax(x.float() @ moe.gate_weight.float().t(), dim=-1) * (card_w > 0)

        moe.routing = cpu_routing
    with torch.inference_mode():
        out = card(*(x.cuda() if isinstance(x, torch.Tensor) else [y.cuda() for y in x] for x in inputs)).float().cpu()
    del card
    release()

    def compare():
        cpu16 = materialize_random(lambda: build(torch.bfloat16), torch.device("cpu"), seed=0)
        cpu16.load_state_dict(cpu.state_dict())
        for n, moe in enumerate(moes(cpu16)):
            moe.routing = lambda x, n=n: picked[n].to(x.device)
        with torch.inference_mode():
            refs = {}
            for weights in ("card", "cpu_scores"):
                mode["weights"] = weights
                t0 = time.perf_counter()
                refs[weights] = cpu(*inputs)
                cpu_s = time.perf_counter() - t0
            bf16_on_cpu = cpu16(*inputs).float()
        tokens = sum(int(w.shape[-2]) for w in picked)
        rerouted = sum(calls[:len(picked)])
        ref = refs["card"]
        row = {"phase": "image_rest", "check": "card_bf16_vs_cpu_f32",
               "model": "hidream.base 20 heads of 128, 1 + 1 blocks, the MoE (4 experts, top 2), the card's routing",
               "parameters": sum(p.numel() for p in cpu.parameters()), "tokens_routed": tokens,
               "tokens_rerouted_in_f32": rerouted, "rel_l2": rel_l2(out, ref),
               "rel_l2_cpu_scores_at_the_card_experts": rel_l2(out, refs["cpu_scores"]),
               "rel_l2_cpu_bf16_vs_cpu_f32": rel_l2(bf16_on_cpu, ref),
               "max_abs_err": (out - ref).abs().max().item(), "max_abs_ref": ref.abs().max().item(),
               "finite": bool(torch.isfinite(out).all()), "tol_rel_l2": HIDREAM_BF16_REL_L2, "cpu_seconds": cpu_s}
        emit(row)
        check(row["finite"] and row["rel_l2"] <= HIDREAM_BF16_REL_L2 and rerouted <= tokens // 100,
              f"HiDream on the card is {row['rel_l2']} from the CPU (limit {HIDREAM_BF16_REL_L2}), "
              f"{rerouted} of {tokens} tokens routed otherwise in f32")

    in_background(compare)


def materialize_random_vae(build, seed: int, norms=None):
    """A VAE in f32 on the card with seeded random weights, its group norms
    (``norms``: the classes, by default AutoencoderKL's) at scale 1 and
    shift 0 (a random scale shrinks every activation)."""
    import torch

    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.vaes.autoencoder_kl import GroupNorm

    vae = materialize_random(build, torch.device("cuda"), seed=seed)
    with torch.no_grad():
        for m in vae.modules():
            if isinstance(m, norms or GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return vae


def image_rest_engine(name: str, home: Path, model_type: str = None):
    """``name``'s engine from its repository manifest in the phase's one home
    (its configs written there, the shared prompts' encodes read back from
    the disk cache), synthetic bf16 weights (the manifests' precisions; the
    memory fallback's gate read at the DiT's load), the byte-level tokenizer,
    its VAE loaded and its decode observed: the latents each decode gets
    (``engine.decoded``)."""
    import yaml

    manifest = IMAGE_REST_MANIFESTS[name]
    write_named_configs(home / "image_rest", manifest, IMAGE_REST_CONFIGS[name])
    model_type = model_type or yaml.safe_load(manifest.read_text())["spec"]["model_type"]
    engine = image_engine("image_rest", manifest, model_type[0] if isinstance(model_type, list) else model_type,
                          home, "bf16")
    engine.load_component_by_type("vae")
    decode, engine.decoded = engine.vae.decode, []

    def observed_decode(z):
        engine.decoded.append(z.detach().float().clone())
        return decode(z)

    engine.vae.decode = observed_decode
    return engine


_IMAGE_STEP = re.compile(r"(?:Denoising )?step (\d+)/(\d+)")


def image_rest_drive(label, engine, requests, launches_per_step, size):
    """Requests (run keyword dicts) through ``engine`` at ``size``², each with
    the kernel's launch count set to 0 before and read after: every progress
    message stamped (synchronised) with the peak GiB of the stage it ends,
    seconds per step, the latents handed to the decode checked finite, the
    frame checked. Returns (rows, frames, decoded latents)."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    rows, frames_out, latents = [], [], []
    for i, kw in enumerate(requests):
        stamps, peaks = [], {}

        def progress(p, message, *_a, **_k):
            torch.cuda.synchronize()
            stamps.append((message, time.perf_counter()))
            stage = "denoise" if _IMAGE_STEP.fullmatch(message) else message
            peaks[stage] = max(peaks.get(stage, 0.0), torch.cuda.max_memory_allocated() / 2**30)
            torch.cuda.reset_peak_memory_stats()

        engine.decoded.clear()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        frames = engine.run(height=size, width=size, num_inference_steps=IMAGE_REST_STEPS,
                            progress_callback=progress, **kw)
        torch.cuda.synchronize()
        total, launches = time.perf_counter() - t0, flash_attention.launches
        step_t = [t for m, t in stamps if _IMAGE_STEP.fullmatch(m)]
        before = max(t for m, t in stamps if t < step_t[0] and not _IMAGE_STEP.fullmatch(m))
        per_step = [b - a for a, b in zip([before] + step_t[:-1], step_t)]
        finite = [bool(torch.isfinite(z).all()) for z in engine.decoded]
        row = {
            "phase": label, "model_type": engine.model_type, "request": i + 1,
            "inputs": {k: (v if isinstance(v, (int, float, str)) else list(np.shape(v))) for k, v in kw.items()},
            "steps": IMAGE_REST_STEPS, "seconds_total": total, "seconds_per_step": per_step,
            "median_seconds_per_step_after_the_first": statistics.median(per_step[1:] or per_step),
            "stages": {m: t - t0 for m, t in dict(reversed(stamps)).items() if not _IMAGE_STEP.fullmatch(m)},
            "peak_gib_by_stage": peaks, "peak_gib": max(peaks.values()),
            "flash_launches": launches, "flash_launches_per_step": launches / IMAGE_REST_STEPS,
            "flash_launches_expected": launches_per_step * IMAGE_REST_STEPS,
            "frames": [list(f.shape) for f in frames], "latents": [list(z.shape) for z in engine.decoded],
            "latents_finite": finite,
        }
        emit(row)
        check(len(frames) == 1 and frames[0].shape == (size, size, 3) and frames[0].dtype == np.uint8,
              f"{label} request {i + 1}: bad frames {row['frames']}")
        check(finite == [True], f"{label} request {i + 1}: latents {finite}")
        check(launches == launches_per_step * IMAGE_REST_STEPS,
              f"{label} request {i + 1}: flash launched {launches} times, expected "
              f"{launches_per_step * IMAGE_REST_STEPS}")
        rows.append(row)
        frames_out.append(frames[0])
        latents.append(engine.decoded[0])
    return rows, frames_out, latents


def image_rest_family(name: str, home: Path, kw: dict, launches_per_step: int, model_type: str = None,
                      extra=()):
    """``kw`` with seeds 0, 0 and 1 through ``name``'s engine (latents and
    frames of the first two bit-identical, the third's frame different),
    then each ``extra`` request. Returns (rows, engine facts)."""
    import numpy as np
    import torch

    engine = image_rest_engine(name, home, model_type)
    size = IMAGE_REST_SIZE.get(name, SIZE)
    rows, frames, latents = image_rest_drive(name, engine, [dict(kw, seed=s) for s in (0, 0, 1)],
                                             launches_per_step, size)
    same = bool(torch.equal(latents[0], latents[1]) and np.array_equal(frames[0], frames[1]))
    differ = not np.array_equal(frames[0], frames[2])
    if extra:
        rows += image_rest_drive(name, engine, list(extra), launches_per_step, size)[0]
    tf = engine.transformer
    facts = {"phase": "image_rest", "family": name, "requests_1_2_identical": same, "requests_1_3_differ": differ,
             "dit_parameters": sum(p.numel() for p in tf.parameters()), "dit_dtype": str(tf.dtype),
             "dit_bits": dit_bits(tf), "dit_dim": tf.cfg.dim, "heads": tf.cfg.num_attention_heads,
             "memory_fallback_gate": engine.gate, "latents": list(latents[0].shape),
             "peak_gib": max(r["peak_gib"] for r in rows)}
    emit(facts)
    check(same, f"{name}: requests 1 and 2 (same inputs and seed) differ")
    check(differ, f"{name}: requests 1 and 3 (other seed) are identical")
    del engine, tf, frames, latents
    release()
    return rows, facts


def phase_image_rest(home: Path):
    """The other image families: the kernel at their shapes, the 1 + 1-block
    DiTs against f32 and the 32x VAE against float64, then each manifest at
    its default size (1024², HunyuanImage 2048²), full width (Chroma, Ovis
    and HunyuanImage cut in depth: ``IMAGE_REST_CONFIGS``), synthetic bf16
    weights, 1 step a request: Chroma with CFG, Ovis, FIBO
    on a JSON prompt, HiDream t2i and edit (a seeded image), HunyuanImage 2.1
    with CFG and APG, each thrice (seeds 0, 0, 1), and the distilled
    manifest once (guidance embedded, meanflow)."""
    import numpy as np

    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    kernel_rows, err = path_kernel_rows("image_rest", image_rest_kernel_inputs())
    lap("kernel_rows")
    image_rest_reference()
    lap("card_vs_cpu_and_vae_on_the_card")
    neg = "blurry, low quality, watermark"
    paths, facts = {}, {}
    for name, kw in (("chroma", dict(prompt=IMAGE_REST_PROMPT, negative_prompt=neg, guidance_scale=3.0)),
                     ("ovis", dict(prompt=IMAGE_REST_PROMPT, negative_prompt=neg, guidance_scale=5.0)),
                     ("fibo", dict(prompt=FIBO_PROMPT, guidance_scale=5.0))):
        paths[f"{name}_1024"], facts[name] = image_rest_family(name, home, kw, 2 * IMAGE_REST_LAUNCHES[name])
        lap(name)
    edit = dict(prompt="make the sky purple", negative_prompt=neg, image=cv2_smooth(np.random.default_rng(219),
                                                                                    (SIZE, SIZE)),
                guidance_scale=5.0, image_strength=0.75, seed=2)
    paths["hidream_1024"], facts["hidream"] = image_rest_family(
        "hidream", home, dict(prompt=IMAGE_REST_PROMPT, negative_prompt=neg, guidance_scale=5.0),
        2 * IMAGE_REST_LAUNCHES["hidream"], "t2i", extra=[edit])
    lap("hidream")
    paths["hunyuanimage_2048"], facts["hunyuanimage"] = image_rest_family(
        "hunyuanimage", home, dict(prompt=IMAGE_REST_PROMPT, negative_prompt=neg, guidance_scale=3.5),
        2 * IMAGE_REST_LAUNCHES["hunyuanimage"])
    lap("hunyuanimage")
    engine = image_rest_engine("hunyuanimage_distilled", home)
    paths["hunyuanimage_distilled_2048"], _, _ = image_rest_drive(
        "hunyuanimage_distilled", engine, [dict(prompt=IMAGE_REST_PROMPT, guidance_scale=1.0,
                                                distilled_guidance_scale=3.25, seed=0)],
        IMAGE_REST_LAUNCHES["hunyuanimage_distilled"], 2048)
    cfg = engine.transformer.cfg
    check(cfg.guidance_embeds and cfg.use_meanflow and engine.vae.cfg.spatial_scale == 32,
          "the distilled DiT's guidance / meanflow or the 32x VAE")
    del engine
    release()
    lap("hunyuanimage_distilled")
    emit({"phase": "image_rest", "seconds_by_step": seconds})
    widths = {"chroma": (3072, 24), "ovis": (3072, 24), "fibo": (3072, 24), "hidream": (2560, 20),
              "hunyuanimage": (3584, 28)}
    bad = [n for n, f in facts.items() if (f["dit_dim"], f["heads"]) != widths[n]]
    check(not bad, f"DiT widths other than published: {bad}")
    return paths, kernel_rows, err


# -- the video families on the ported VAEs and encoders: LongCat, Cosmos, Kandinsky 5 --------

LONGCAT_TYPES = ("t2v", "i2v", "vc", "continuation", "long_video", "interactive", "refine")
LONGCAT_MANIFESTS = {t: REPO / "manifests" / "video" / f"longcat-video-{t.replace('_', '-')}.yml"
                     for t in LONGCAT_TYPES}
COSMOS_MANIFEST = REPO / "manifests" / "video" / "cosmos-predict2-2b-video2world.yml"
KANDINSKY5_MANIFEST = REPO / "manifests" / "video" / "kandinsky5-t2v.yml"
VIDEO_REST_STEPS, VIDEO_REST_FRAMES = 1, 17  # of 35-50 steps: a cut of steps
LONGCAT_LAYERS = 4  # of the published 48: a cut of depth
# Cosmos 7 of its 28 layers and Kandinsky 5 8 of its 32 visual blocks in the requests (cuts of depth, PR 21)
COSMOS_LAYERS, KANDINSKY5_VISUAL_BLOCKS = 7, 8
# Published configs the repository lacks, written where the manifests name them: LongCat-Video's DiT
# (the LongCatConfig defaults, at the requests' depth) over UMT5-XXL; Cosmos-Predict2-2B-Video2World's DiT
# (16 heads of 128, 28 layers, 16 latent channels + the condition mask, no learnable position embedding)
# and its T5 at T5-11B's widths (d_model 1024: the published encoder's FFN is ReLU, the JAX module's
# gated GELU, ROADMAP Queue 3); Kandinsky 5.0 T2V Lite's DiT (1792 wide, 2 + 32 blocks, 28 heads of 64)
# and its i2v twin with the visual_cond input, which no manifest names. Qwen2.5-VL-7B, CLIP-L and the
# Wan 2.1 and HunyuanVideo VAEs are their families' defaults.
LONGCAT_TRANSFORMER = {"_class_name": "LongCatVideoTransformer3DModel", "in_channels": 16, "out_channels": 16,
                       "hidden_size": 4096, "depth": LONGCAT_LAYERS, "num_heads": 32, "caption_channels": 4096,
                       "mlp_ratio": 4, "adaln_tembed_dim": 512, "frequency_embedding_size": 256,
                       "patch_size": [1, 2, 2]}
COSMOS_TRANSFORMER = {"_class_name": "CosmosTransformer3DModel", "in_channels": 17, "out_channels": 16,
                      "num_attention_heads": 16, "attention_head_dim": 128, "num_layers": 28, "mlp_ratio": 4.0,
                      "text_embed_dim": 1024, "adaln_lora_dim": 256, "max_size": [128, 240, 240],
                      "patch_size": [1, 2, 2], "rope_scale": [1.0, 3.0, 3.0], "concat_padding_mask": True,
                      "extra_pos_embed_type": None}
COSMOS_T5 = {"model_type": "t5", "vocab_size": 32128, "d_model": 1024, "d_kv": 128, "d_ff": 65536, "num_layers": 24,
             "num_heads": 128, "relative_attention_num_buckets": 32, "feed_forward_proj": "relu"}
KANDINSKY5_TRANSFORMER = {"in_visual_dim": 16, "out_visual_dim": 16, "in_text_dim": 3584, "in_text_dim2": 768,
                          "time_dim": 512, "patch_size": [1, 2, 2], "model_dim": 1792, "ff_dim": 7168,
                          "num_text_blocks": 2, "num_visual_blocks": 32, "axes_dims": [16, 24, 24],
                          "visual_cond": False}
KANDINSKY5_I2V_CONFIG = "ai-forever/Kandinsky-5.0-I2V-Lite-5s/transformer/config.json"
# tokens at the requests' sizes: 480x832 (LongCat: 30 x 52 a latent frame), 720x1280 (refine: 45 x 80),
# 704x1280 (Cosmos: 44 x 80), 512x768 (Kandinsky: 32 x 48), 17 frames = 5 latent frames; LongCat's
# continuations keep 13 frames (4 latent frames) as context
VIDEO_REST_TOKENS = {"longcat": 5 * 1560, "longcat_frame": 1560, "longcat_ctx": 4 * 1560,
                     "longcat_refine": 4 * 3600, "cosmos": 5 * 3520, "kandinsky5": 5 * 1536}
LONGCAT_TEXT_KEPT, KANDINSKY5_TEXT = 120, 256
# flash launches a forward: LongCat one self and one cross a block (i2v two self: the conditioning frame
# alone, then the noise against every key; the cache's pass self only); Cosmos self and T5 cross a block;
# Kandinsky one a text block, self and cross a visual block
VIDEO_REST_LAUNCHES = {"longcat": 2 * LONGCAT_LAYERS, "longcat_i2v": 3 * LONGCAT_LAYERS,
                       "longcat_cache": LONGCAT_LAYERS, "cosmos": 2 * COSMOS_LAYERS,
                       "kandinsky5": 2 + 2 * KANDINSKY5_VISUAL_BLOCKS}
VIDEO_REST_NEG = "blurry, low quality, watermark"


def video_rest_kernel_inputs():
    """(case, q, k, v, bias) at the launches of the three families: LongCat
    at 32 heads (self over 7800 tokens, the i2v conditioning frame alone and
    its noise against every key, the KV-cache launch of the new frames
    against context + new keys, the UMT5 cross-attention with its mask,
    refine's 720p self-attention), Cosmos at 16 heads (self over 17,600 and
    the T5 cross, unmasked), Kandinsky 5 at 28 heads of 64 (self over 7680,
    its text blocks and the cross-attention over the Qwen sequence)."""
    import torch

    t = VIDEO_REST_TOKENS
    n, f, ctx, ref = t["longcat"], t["longcat_frame"], t["longcat_ctx"], t["longcat_refine"]
    mask = torch.zeros(1, WAN_TEXT_TOKENS, device="cuda")
    mask[:, LONGCAT_TEXT_KEPT:] = -1e30
    yield ("longcat_self_s%d_h32" % n, *qkv(1, n, n, 32, 128, 230), None)
    yield ("longcat_cond_s%d_h32" % f, *qkv(1, f, f, 32, 128, 231), None)
    yield ("longcat_noise_vs_all_sq%d_sk%d_h32" % (n - f, n), *qkv(1, n - f, n, 32, 128, 232), None)
    yield ("longcat_kv_cache_sq%d_sk%d_h32" % (n, ctx + n), *qkv(1, n, ctx + n, 32, 128, 233), None)
    yield ("longcat_cross_sq%d_sk%d_h32_bias" % (n, WAN_TEXT_TOKENS), *qkv(1, n, WAN_TEXT_TOKENS, 32, 128, 234), mask)
    yield ("longcat_refine_self_s%d_h32" % ref, *qkv(1, ref, ref, 32, 128, 235), None)
    c = t["cosmos"]
    yield ("cosmos_self_s%d_h16" % c, *qkv(1, c, c, 16, 128, 236), None)
    yield ("cosmos_t5_cross_sq%d_sk%d_h16" % (c, WAN_TEXT_TOKENS), *qkv(1, c, WAN_TEXT_TOKENS, 16, 128, 237), None)
    k5 = t["kandinsky5"]
    yield ("kandinsky5_self_s%d_h28_d64" % k5, *qkv(1, k5, k5, 28, 64, 238), None)
    yield ("kandinsky5_text_s%d_h28_d64" % KANDINSKY5_TEXT, *qkv(1, KANDINSKY5_TEXT, KANDINSKY5_TEXT, 28, 64, 239),
           None)
    yield ("kandinsky5_cross_sq%d_sk%d_h28_d64" % (k5, KANDINSKY5_TEXT), *qkv(1, k5, KANDINSKY5_TEXT, 28, 64, 240),
           None)


def video_rest_reference():
    """Each DiT at full width, on the card in bf16 (the kernel) against the
    same weights on the CPU in f32 (the plain version), within BF16_REL_L2,
    over 3 latent frames of 16 x 32 (128 tokens a frame) and 64 text rows:
    LongCat with 2 blocks, the first frame a conditioning frame at t = 0
    (the isolated launch and the noise-vs-all one) and 40 real text rows;
    Cosmos with 2 blocks, per-frame times and the condition mask; Kandinsky
    5 with 1 + 1 blocks and the visual_cond input."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.models.transformers import cosmos, kandinsky5, longcat

    rng = np.random.default_rng(241)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    mask = (torch.arange(64) < 40)[None].to(torch.int32)
    card_vs_cpu("longcat.base 32 heads of 128, 2 blocks, a conditioning frame, text padding",
                lambda dt: longcat.LongCatVideoTransformer3DModel(longcat.LongCatConfig.from_dict(
                    dict(LONGCAT_TRANSFORMER, depth=2)), dtype=dt),
                lambda m, x, t, c, k: m(x, t, c, k, num_cond_latents=1),
                (tensor(1, 16, 3, 16, 32), torch.tensor([[0.0, 700.0, 700.0]]), tensor(1, 64, 4096), mask),
                BF16_REL_L2, 242, phase="video_rest")
    cond = torch.zeros(1, 1, 3, 16, 32)
    cond[:, :, :1] = 1.0
    card_vs_cpu("cosmos.base 16 heads of 128, 2 blocks, per-frame times, the condition mask",
                lambda dt: cosmos.CosmosTransformer3DModel(cosmos.CosmosConfig.from_dict(
                    dict(COSMOS_TRANSFORMER, num_layers=2)), dtype=dt),
                lambda m, x, t, c, k: m(x, t, c, condition_mask=k),
                (tensor(1, 16, 3, 16, 32), torch.tensor([[1e-4 / 1.0001, 0.5, 0.5]]), tensor(1, 64, 1024), cond),
                BF16_REL_L2, 243, phase="video_rest")
    card_vs_cpu("kandinsky5.base 28 heads of 64, 1 + 1 blocks, visual_cond",
                lambda dt: kandinsky5.Kandinsky5Transformer3DModel(kandinsky5.Kandinsky5Config.from_dict(
                    dict(KANDINSKY5_TRANSFORMER, num_text_blocks=1, num_visual_blocks=1, visual_cond=True)),
                    dtype=dt),
                lambda m, x, t, c, p: m(x, t, c, p),
                (tensor(1, 33, 3, 16, 32), torch.tensor([730.0]), tensor(1, 64, 3584), tensor(1, 768)),
                BF16_REL_L2, 244, phase="video_rest")


_VIDEO_STEP = re.compile(r"(?:Denoising )?step (\d+)/(\d+)")


def video_rest_engine(manifest: Path, model_type: str, home: Path, configs: dict, label: str, share=None):
    """``model_type``'s engine from ``manifest`` in its family's one home
    (``label``: the configs written there, the shared prompts' encodes read
    back from the disk cache), synthetic bf16 weights (the manifests'
    precisions), the byte-level tokenizer; with ``share``, that engine's
    components (the same files in every manifest of the family) instead of
    building them again. Each decode's latents are kept (``engine.decoded``)."""
    write_named_configs(home / label, manifest, configs)
    engine = image_engine(label, manifest, model_type, home, "bf16")
    if share is not None:
        for name in ("text_encoder", "text_encoder_2", "transformer", "vae", "scheduler"):
            if getattr(share, name, None) is not None:
                setattr(engine, name, getattr(share, name))
        engine.gate = share.gate
    engine.decoded = []
    for attr in ("decode_video", "decode_latents", "decode_frames"):
        decode = getattr(engine, attr, None)
        if decode is not None:
            def observed(z, *args, decode=decode, **kwargs):
                engine.decoded.append(z.detach().float().clone())
                return decode(z, *args, **kwargs)

            setattr(engine, attr, observed)
    return engine


def video_rest_drive(label, engine, kw, launches, frames_expected=None, size=None, latents_expected=(),
                     phase="video_rest", step=_VIDEO_STEP):
    """One request through ``engine``, the kernel's launch count set to 0
    before and read after (``launches`` expected), every progress message
    stamped (synchronised), seconds per step (each from the message before
    it; ``step`` matches a step's message), peak GiB; the frames' count and
    size (or, with ``return_latents``, the latents' shape) and every decoded
    latent checked finite. Returns (row, output)."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    os.environ["APEX_HOME_DIR"] = str(Path(engine.components_root).parent)
    stamps = []

    def progress(p, message, *_a, **_k):
        torch.cuda.synchronize()
        stamps.append((message, time.perf_counter()))

    engine.decoded.clear()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    out = engine.run(progress_callback=progress, **kw)
    torch.cuda.synchronize()
    total, n_launch = time.perf_counter() - t0, flash_attention.launches
    times = [t0] + [t for _, t in stamps]
    per_step = [times[i + 1] - times[i] for i, (m, _) in enumerate(stamps) if step.fullmatch(m)]
    latents = [out] if isinstance(out, torch.Tensor) else engine.decoded
    row = {"phase": phase, "path": label, "model_type": engine.model_type,
           "request": {k: (v if isinstance(v, (int, float, str)) else list(np.shape(v))) for k, v in kw.items()},
           "seconds_total": total, "seconds_per_step": per_step,
           "median_seconds_per_step_after_the_first": statistics.median(per_step[1:] or per_step),
           "stages": {m: t - t0 for m, t in dict(reversed(stamps)).items() if not step.fullmatch(m)},
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "flash_launches": n_launch,
           "flash_launches_expected": launches, "latents": [list(z.shape) for z in latents],
           "latents_finite": all(bool(torch.isfinite(z).all()) for z in latents)}
    if not isinstance(out, torch.Tensor):
        row["frames"], row["frame_shape"] = len(out), list(out[0].shape)
    emit(row)
    check(row["latents_finite"], f"{label}: latents not finite")
    check(n_launch == launches, f"{label}: flash launched {n_launch} times, expected {launches}")
    if latents_expected:
        check(row["latents"] == [list(s) for s in latents_expected],
              f"{label}: latents {row['latents']}, expected {latents_expected}")
    if frames_expected is not None:
        check(len(out) == frames_expected and all(f.shape == (*size, 3) and f.dtype == np.uint8 for f in out),
              f"{label}: {len(out)} frames of {out[0].shape}, expected {frames_expected} of {size}")
    return row, out


def seed_pair(label, engine, kw, launches, lat, frames_expected, size, phase="video_rest", step=_VIDEO_STEP,
              latent_launches=None):
    """``kw`` with seeds 0, 0 and 1, the last two returning their latents
    (``latent_launches`` where a decode launches the kernel too): the first
    two's latents bit-identical, the third's different. Returns (rows, the
    first request's frames, its latents, the third's)."""
    import torch

    row1, frames = video_rest_drive(label, engine, dict(kw, seed=0), launches, frames_expected, size, [lat],
                                    phase=phase, step=step)
    first = engine.decoded[0]
    launches = launches if latent_launches is None else latent_launches
    row2, again = video_rest_drive(label, engine, dict(kw, seed=0, return_latents=True), launches,
                                   latents_expected=[lat], phase=phase, step=step)
    row3, other = video_rest_drive(label, engine, dict(kw, seed=1, return_latents=True), launches,
                                   latents_expected=[lat], phase=phase, step=step)
    same, differ = bool(torch.equal(first, again)), not torch.equal(first, other)
    emit({"phase": phase, "path": label, "seeds_0_0_identical": same, "seeds_0_1_differ": differ})
    check(same, f"{label}: two requests with one seed differ")
    check(differ, f"{label}: requests with seeds 0 and 1 are identical")
    return [row1, row2, row3], frames, first, other


def longcat_requests(home: Path):
    """The seven LongCat types from their manifests, the DiT at LONGCAT_LAYERS
    of its 48 blocks (4096 wide, 32 heads), UMT5-XXL, the Wan 2.1 VAE, bf16,
    1 step, CFG-zero* at 4.0 with a negative prompt: t2v (seeds 0, 0, 1),
    i2v from a seeded image, vc on a 17-frame clip with the KV cache (13
    context frames), continuation of a 30 fps clip, long_video with one
    continuation segment, interactive with two sentences, all 480x832 over
    17 frames; refine at 720x1280 on the t2v request's first 5 frames (2x in
    time: 10 frames)."""
    import numpy as np
    import torch

    configs = {"transformer": LONGCAT_TRANSFORMER, "text_encoder": UMT5_XXL}
    lat = (1, 16, 5, 60, 104)
    kw = dict(prompt=WAN_PROMPT, negative_prompt=VIDEO_REST_NEG, height=480, width=832, num_frames=VIDEO_REST_FRAMES,
              num_inference_steps=VIDEO_REST_STEPS, guidance_scale=4.0)
    forwards = 2 * VIDEO_REST_STEPS  # CFG
    lc = VIDEO_REST_LAUNCHES
    t2v = video_rest_engine(LONGCAT_MANIFESTS["t2v"], "t2v", home, configs, "longcat")
    paths, rows = {}, {}
    rows["t2v"], frames, _, _ = seed_pair("longcat_t2v", t2v, kw, forwards * lc["longcat"], lat, VIDEO_REST_FRAMES,
                                          (480, 832))
    paths["longcat_t2v_480x832"] = rows["t2v"]
    engines = {t: video_rest_engine(LONGCAT_MANIFESTS[t], t, home, configs, "longcat", share=t2v)
               for t in LONGCAT_TYPES[1:]}
    image = cv2_smooth(np.random.default_rng(245), (480, 832))
    clip, _ = disk_clip(VIDEO_REST_FRAMES, seed=246)
    cached = lc["longcat_cache"] + forwards * lc["longcat"]  # the context's pass, then the new frames' steps
    continued = (1, 16, 4 + 5, 60, 104)  # 13 context frames and 17 new ones
    requests = [
        ("i2v", dict(kw, image=image, seed=0), forwards * lc["longcat_i2v"], VIDEO_REST_FRAMES, [lat]),
        ("vc", dict(kw, video=clip, use_kv_cache=True, seed=0), cached, 33, [continued]),
        ("continuation", dict(kw, video=disk_clip(26, seed=247)[0], source_fps=30, seed=0), cached, 33,
         [continued]),
        ("long_video", dict(kw, num_segments=1, seed=0), forwards * lc["longcat"] + cached, VIDEO_REST_FRAMES + 20,
         [lat, continued]),
        ("interactive", dict(kw, prompt="A lighthouse on a rocky coast. Waves crash against the rocks at dusk.",
                             seed=0), forwards * lc["longcat"] + cached, VIDEO_REST_FRAMES + 20, [lat, continued]),
        ("refine", dict(prompt=WAN_PROMPT, video=frames[:5], height=720, width=1280,
                        num_inference_steps=VIDEO_REST_STEPS, seed=0), VIDEO_REST_STEPS * lc["longcat"],
         10, [(1, 16, 4, 90, 160)]),
    ]
    i2v, i2v.encoded = engines["i2v"], []
    encode = i2v._encode

    def observed_encode(px):
        i2v.encoded.append(encode(px))
        return i2v.encoded[-1]

    i2v._encode = observed_encode
    for t, req, launches, n_frames, lats in requests:
        size = (req["height"], req["width"])
        row, out = video_rest_drive(f"longcat_{t}", engines[t], req, launches, n_frames, size, lats)
        paths[f"longcat_{t}_{size[0]}x{size[1]}"] = [row]
        rows[t] = [row]
        if t == "i2v":
            pinned = bool(torch.equal(i2v.decoded[0][:, :, :1], i2v.encoded[0]))
            emit({"phase": "video_rest", "path": "longcat_i2v", "image_latent_pinned": pinned})
            check(pinned, "LongCat i2v: the first latent frame is not the image's latent")
    tf = t2v.transformer
    facts = {"phase": "video_rest", "family": "longcat", "dit_dim": tf.cfg.hidden_size, "dit_blocks": len(tf.blocks),
             "heads": tf.cfg.num_heads, "dit_parameters": sum(p.numel() for p in tf.parameters()),
             "dit_dtype": str(tf.dtype), "dit_bits": dit_bits(tf), "memory_fallback_gate": t2v.gate,
             "peak_gib": max(r["peak_gib"] for rs in rows.values() for r in rs)}
    emit(facts)
    check(tf.cfg.hidden_size == 4096 and tf.cfg.num_heads == 32 and len(tf.blocks) == LONGCAT_LAYERS
          and not dit_bits(tf), f"the LongCat DiT's widths: {facts}")
    del t2v, i2v, engines, tf, frames
    release()
    return paths


def cosmos_requests(home: Path):
    """Cosmos Predict2 2B video2world from its manifest at the published
    widths, COSMOS_LAYERS of its 28 layers, bf16, its T5 at T5-11B's widths, the Wan
    2.1 VAE: i2v from a seeded image (seeds 0, 0, 1) and v2v continuing the
    first 9 frames of a clip, both 704x1280 over 17 frames, 1 step, CFG 7
    against a negative prompt."""
    import numpy as np
    import torch

    configs = {"transformer": dict(COSMOS_TRANSFORMER, num_layers=COSMOS_LAYERS), "text_encoder": COSMOS_T5}
    lat = (1, 16, 5, 88, 160)
    kw = dict(prompt=WAN_PROMPT, negative_prompt=VIDEO_REST_NEG, height=704, width=1280,
              num_frames=VIDEO_REST_FRAMES, num_inference_steps=VIDEO_REST_STEPS, guidance_scale=7.0)
    launches = 2 * VIDEO_REST_STEPS * VIDEO_REST_LAUNCHES["cosmos"]
    i2v = video_rest_engine(COSMOS_MANIFEST, "i2v", home, configs, "cosmos")
    image = cv2_smooth(np.random.default_rng(248), (704, 1280))
    rows, _, first, other = seed_pair("cosmos_i2v", i2v, dict(kw, image=image), launches, lat, VIDEO_REST_FRAMES,
                                      (704, 1280))
    paths = {"cosmos_i2v_704x1280": rows}
    pinned = bool(torch.equal(first[:, :, :1], other[:, :, :1]))
    v2v = video_rest_engine(COSMOS_MANIFEST, "v2v", home, configs, "cosmos", share=i2v)
    clip, _ = disk_clip(VIDEO_REST_FRAMES, 704, 1280, seed=249)
    row, _ = video_rest_drive("cosmos_v2v", v2v, dict(kw, video=clip, conditioning_frames=9, seed=0), launches,
                              VIDEO_REST_FRAMES, (704, 1280), [lat])
    paths["cosmos_v2v_704x1280"] = [row]
    tf = i2v.transformer
    facts = {"phase": "video_rest", "family": "cosmos", "dit_dim": tf.cfg.dim, "dit_blocks": len(tf.transformer_blocks),
             "heads": tf.cfg.num_attention_heads, "in_channels": tf.cfg.in_channels,
             "dit_parameters": sum(p.numel() for p in tf.parameters()), "dit_dtype": str(tf.dtype),
             "t5_d_model": i2v.text_encoder._ensure_model().cfg.d_model, "memory_fallback_gate": i2v.gate,
             "conditioning_frame_pinned": pinned, "peak_gib": max(r["peak_gib"] for r in rows + [row])}
    emit(facts)
    check(pinned, "Cosmos i2v: the conditioning latent frame moves with the seed")
    check(tf.cfg.dim == 2048 and tf.cfg.num_attention_heads == 16 and len(tf.transformer_blocks) == COSMOS_LAYERS
          and not dit_bits(tf), f"the Cosmos DiT's widths: {facts}")
    del i2v, v2v, tf, first, other
    release()
    return paths


def kandinsky5_requests(home: Path):
    """Kandinsky 5.0 T2V Lite from its manifest at full width (1792 wide, 28
    heads of 64; 2 + KANDINSKY5_VISUAL_BLOCKS of the 2 + 32 blocks), bf16, Qwen2.5-VL-7B, CLIP-L
    and the HunyuanVideo VAE: t2v (seeds 0, 0, 1) and i2v from a seeded image
    on the visual_cond twin the script writes, 512x768 over 17 frames, 2
    steps, CFG 5 against a negative prompt."""
    import numpy as np
    import yaml

    lat = (1, 16, 5, 64, 96)
    kw = dict(prompt=WAN_PROMPT, negative_prompt=VIDEO_REST_NEG, height=512, width=768,
              num_frames=VIDEO_REST_FRAMES, num_inference_steps=VIDEO_REST_STEPS, guidance_scale=5.0)
    launches = 2 * VIDEO_REST_STEPS * VIDEO_REST_LAUNCHES["kandinsky5"]
    k5 = dict(KANDINSKY5_TRANSFORMER, num_visual_blocks=KANDINSKY5_VISUAL_BLOCKS)
    t2v = video_rest_engine(KANDINSKY5_MANIFEST, "t2v", home, {"transformer": k5}, "kandinsky5")
    rows = seed_pair("kandinsky5_t2v", t2v, kw, launches, lat, VIDEO_REST_FRAMES, (512, 768))[0]
    paths = {"kandinsky5_t2v_512x768": rows}
    peaks = [r["peak_gib"] for r in rows]
    doc = yaml.safe_load(KANDINSKY5_MANIFEST.read_text())
    doc["metadata"]["id"] += "-i2v-smoke"
    next(c for c in doc["spec"]["components"] if c["type"] == "transformer")["config_path"] = KANDINSKY5_I2V_CONFIG
    manifest = home / "kandinsky5-i2v.yml"
    manifest.write_text(yaml.safe_dump(doc))
    i2v = video_rest_engine(manifest, "i2v", home, {"transformer": dict(k5, visual_cond=True)},
                            "kandinsky5", share=t2v)
    i2v.transformer = None  # the visual_cond twin is another DiT
    del t2v
    release()
    image = cv2_smooth(np.random.default_rng(250), (512, 768))
    row, _ = video_rest_drive("kandinsky5_i2v", i2v, dict(kw, image=image, seed=0), launches, VIDEO_REST_FRAMES,
                              (512, 768), [lat])
    paths["kandinsky5_i2v_512x768"] = [row]
    tf = i2v.transformer
    facts = {"phase": "video_rest", "family": "kandinsky5", "dit_dim": tf.cfg.model_dim,
             "heads": tf.cfg.model_dim // tf.cfg.head_dim, "head_dim": tf.cfg.head_dim,
             "blocks": [len(tf.text_transformer_blocks), len(tf.visual_transformer_blocks)],
             "visual_in_channels": tf.visual_in_channels, "dit_parameters": sum(p.numel() for p in tf.parameters()),
             "dit_dtype": str(tf.dtype), "memory_fallback_gate": i2v.gate, "peak_gib": max(peaks + [row["peak_gib"]])}
    emit(facts)
    check(tf.cfg.model_dim == 1792 and tf.cfg.head_dim == 64
          and len(tf.visual_transformer_blocks) == KANDINSKY5_VISUAL_BLOCKS
          and tf.visual_in_channels == 33 and not dit_bits(tf), f"the Kandinsky 5 DiT's widths: {facts}")
    del i2v, tf
    release()
    return paths


def phase_video_rest(home: Path):
    """The video families on the ported VAEs and encoders: the kernel at
    their shapes, the DiTs at full width against f32, then LongCat's seven
    types, Cosmos' i2v and v2v and Kandinsky 5's t2v and i2v from their
    manifests (``longcat_requests``, ``cosmos_requests``,
    ``kandinsky5_requests``), each family in one home."""
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    kernel_rows, err = path_kernel_rows("video_rest", video_rest_kernel_inputs())
    lap("kernel_rows")
    video_rest_reference()
    lap("card_vs_cpu")
    paths = {}
    for name, requests in (("longcat", longcat_requests), ("cosmos", cosmos_requests),
                           ("kandinsky5", kandinsky5_requests)):
        paths.update(requests(home))
        lap(name)
    emit({"phase": "video_rest", "seconds_by_step": seconds})
    return paths, kernel_rows, err


# -- HunyuanImage 3.0 and CogVideoX 5B ----------------------------------------------------

HY3_MANIFEST = REPO / "manifests" / "image" / "hunyuanimage-3.yml"
COG_MANIFESTS = {t: REPO / "manifests" / "video" / f"cogvideox-5b-{n}.yml"
                 for t, n in (("t2v", "text-to-video"), ("i2v", "image-to-video"), ("v2v", "video-to-video"))}
HY3_LAYERS = 2  # of the published 32: the requests' cut of depth (one forward runs all 32)
HY3_STEPS, COG_STEPS, COG_FRAMES = 2, 2, 17
HY3_TEXT = 128  # the engine's max_sequence_length: the prompt's ids, padded
HY3_IMAGE_TOKENS = 64 * 64  # 1024² at 16x, patch size 1
# Published configs the repository lacks, written where the manifests name them. tencent/HunyuanImage-3.0
# config.json: hidden 4096, 32 layers, 32 query heads of 128 over 8 KV heads, QK norm, 64 experts of 3072
# and one shared expert, top 8, every layer MoE, the UNet patch embed (patch 1, hidden 1024); its VAE at the
# HunyuanImage3VAEConfig defaults (32 latent channels, 16x). THUDM/CogVideoX-5b transformer/config.json
# (48 heads of 64, 42 layers, text 4096, time 512), -5b-I2V's (32 input channels; its
# use_learned_positional_embeddings, which neither package's config takes: ROADMAP Queue 3), the 5B VAE's
# (scaling_factor 0.7) and T5 v1.1 XXL's; control and inp, which no manifest names, run on twins of the
# t2v manifest whose DiT configs take the channels their engines build (16 + 16, 16 + 1 + 16).
HY3_TRANSFORMER = {"architectures": ["HunyuanImage3ForCausalMM"], "vocab_size": 133120, "hidden_size": 4096,
                   "intermediate_size": 3072, "moe_intermediate_size": 3072, "num_hidden_layers": 32,
                   "num_attention_heads": 32, "num_key_value_heads": 8, "attention_head_dim": 128,
                   "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "use_qk_norm": True, "num_experts": 64,
                   "use_mixed_mlp_moe": True, "num_shared_expert": 1, "moe_topk": 8, "moe_layer_num_skipped": 0,
                   "norm_topk_prob": True, "patch_size": 1, "patch_embed_hidden_dim": 1024, "img_proj_type": "unet",
                   "vae": {"latent_channels": 32}}
HY3_VAE = {"_class_name": "AutoencoderKLConv3D", "in_channels": 3, "out_channels": 3, "latent_channels": 32,
           "block_out_channels": [128, 256, 512, 1024, 1024], "layers_per_block": 2, "ffactor_spatial": 16,
           "ffactor_temporal": 4}
COG_TRANSFORMER = {"_class_name": "CogVideoXTransformer3DModel", "activation_fn": "gelu-approximate",
                   "attention_bias": True, "attention_head_dim": 64, "flip_sin_to_cos": True, "freq_shift": 0,
                   "in_channels": 16, "max_text_seq_length": 226, "norm_elementwise_affine": True, "norm_eps": 1e-5,
                   "num_attention_heads": 48, "num_layers": 42, "out_channels": 16, "patch_size": 2,
                   "sample_frames": 49, "sample_height": 60, "sample_width": 90,
                   "spatial_interpolation_scale": 1.875, "temporal_compression_ratio": 4,
                   "temporal_interpolation_scale": 1.0, "text_embed_dim": 4096, "time_embed_dim": 512,
                   "timestep_activation_fn": "silu", "use_rotary_positional_embeddings": True}
COG_I2V_TRANSFORMER = dict(COG_TRANSFORMER, in_channels=32, use_learned_positional_embeddings=True)
COG_VAE = {"_class_name": "AutoencoderKLCogVideoX", "act_fn": "silu", "block_out_channels": [128, 256, 256, 512],
           "in_channels": 3, "latent_channels": 16, "latents_mean": None, "latents_std": None,
           "layers_per_block": 3, "norm_eps": 1e-6, "norm_num_groups": 32, "out_channels": 3,
           "sample_height": 480, "sample_width": 720, "scaling_factor": 0.7, "shift_factor": None,
           "temporal_compression_ratio": 4, "use_post_quant_conv": False, "use_quant_conv": False}
T5_XXL = {"model_type": "t5", "vocab_size": 32128, "d_model": 4096, "d_kv": 64, "d_ff": 10240, "num_layers": 24,
          "num_heads": 64, "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128,
          "layer_norm_epsilon": 1e-6, "feed_forward_proj": "gated-gelu"}
COG_TWINS = {"control": 32, "inp": 33}
# [text 226 | video]: 17 frames at 480x720 (5 latent frames of 30 x 45 tokens); the manifests' 49 (13)
COG_TOKENS = {"17": 226 + 5 * 1350, "49": 226 + 13 * 1350}
COG_LAYERS = 6  # of the published 42: the requests' cut of depth (PR 21); one joint launch a block and forward
HY3_CFG = 7.5


def hy3_kernel_inputs():
    """(case, q, k, v, bias): the image span's 4096 queries against all 4225
    keys (128 text ids, the timestep token, the image) at 32 heads of 128."""
    s = HY3_TEXT + 1 + HY3_IMAGE_TOKENS
    yield ("hy3_image_vs_all_sq%d_sk%d_h32" % (HY3_IMAGE_TOKENS, s), *qkv(1, HY3_IMAGE_TOKENS, s, 32, 128, 260), None)


def cog_kernel_inputs():
    """(case, q, k, v, bias): the joint launch at 48 heads of 64 over the smoke
    run's 17 frames and the manifests' 49 (unmasked, as in JAX)."""
    for frames, seed in (("17", 261), ("49", 262)):
        s = COG_TOKENS[frames]
        yield ("cogvideox_joint_s%d_h48_d64" % s, *qkv(1, s, s, 48, 64, seed), None)


def causal_kernel_row(label, case, q, k, v) -> dict:
    """A causal launch (Sq == Sk) against its plain version and timed beside
    ``scaled_dot_product_attention(is_causal=True)``; the bound counts the
    kept (query, key) pairs, S·(S + 1)/2 a head, and q, k, v and o once."""
    import torch
    import torch.nn.functional as F

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention, flash_attention_reference

    b, s, h, d = q.shape
    out = flash_attention(q, k, v, is_causal=True)
    agree = agreement(out, flash_attention_reference(q, k, v, is_causal=True))
    finite = bool(torch.isfinite(out.float()).all())
    emit({"phase": "kernels", "path": label, "cases": [{"case": f"{case}_all_rows", "shape": list(q.shape), "sk": s,
                                                        "causal": True, **agree, "finite": finite}]})
    check(finite and agree["within"], f"flash kernel disagrees with its plain version at {label}'s {case}")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pairs = b * s * (s + 1) / 2
    flops, nbytes = 4.0 * h * d * pairs, 4 * b * s * h * d * q.element_size()
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    ms = time_ms(lambda: flash_attention(q, k, v, is_causal=True))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    row = {"phase": "timing", "path": label, "kernel": "flash_attention", "case": case, "shape": list(q.shape),
           "sk": s, "bias": False, "causal": True, "ms": ms,
           "queued_ms": queued_ms(lambda: flash_attention(q, k, v, is_causal=True)),
           "plain_ms": time_ms(lambda: flash_attention_reference(q, k, v, is_causal=True)), "plain_rows": s,
           "library_ms": library_ms,
           "library_queued_ms": queued_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)),
           "library_call": "torch.nn.functional.scaled_dot_product_attention(is_causal=True)",
           "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes, "keys_kept": pairs / s, "bound_ms_as_launched": max(t_ops, t_bytes),
           "bound_ms_as_launched_padded": max(t_ops, t_bytes), "vs_library": ms / library_ms}
    emit(row)
    return row, agree["max_abs_err"]


def dequantized(u, s):
    """A packed int4 ``Linear``'s weight [out, in] in f32 from its packed bytes
    ``u`` and scales ``s``, as ``_w4`` unpacks it."""
    import torch

    s = s.float()
    half = u.shape[0]
    lo = ((u & 0xF).to(torch.int8) - 8).float() * s[:half, None]
    hi = ((u >> 4).to(torch.int8) - 8).float() * s[half:, None]
    return torch.cat([lo, hi], dim=0)


def hy3_card_vs_cpu(seed: int):
    """The backbone at full width with 1 + 1 layers (one dense, one MoE at 64
    experts, top 8, and the shared expert), on the card with int4 residency
    (bf16 compute, the kernel) against the same dequantised weights on the
    CPU in f32 (the plain version), over a 16 x 16 latent and 16 ids. The
    router is discrete and reads bf16 on the card: the CPU takes each token's
    routing weights from the card, and the tokens whose f32 choice differs
    are counted beside. Within BF16_REL_L2."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine.base import SYNTHETIC_STD
    from apex_studio_tpu_torch.models.layers import Linear
    from apex_studio_tpu_torch.models.transformers import hunyuanimage3 as hy3
    from apex_studio_tpu_torch.quantize.residency import count_resident, materialize_random_int4

    cfg = hy3.HunyuanImage3Config.from_dict(dict(HY3_TRANSFORMER, num_hidden_layers=2, moe_layer_num_skipped=1))
    with torch.device("meta"):
        card = hy3.HunyuanImage3ForCausalMM(cfg, dtype=torch.bfloat16)
        cpu = hy3.HunyuanImage3ForCausalMM(cfg, dtype=torch.float32)
    materialize_random_int4(card, device="cuda", seed=seed, scale=SYNTHETIC_STD)
    card.eval().requires_grad_(False)
    # each CPU parameter's source copied off the card as stored (int4 packed with its scales); the
    # CPU model is built and dequantised beside the card (``compare``)
    card_params, card_mods, sources = dict(card.named_parameters()), dict(card.named_modules()), {}
    for name, _ in cpu.named_parameters():
        owner = card_mods[name.rpartition(".")[0]]
        quantized = isinstance(owner, Linear) and owner.weight_scale is not None and name.endswith(".weight")
        sources[name] = (owner.weight.cpu(), owner.weight_scale.cpu()) if quantized else card_params[name].cpu()
    resident = count_resident(card)
    picked, rerouted = [], []
    for gate in (m for m in card.modules() if isinstance(m, hy3._HYGate)):
        def card_gate(x, gate=gate):
            w = type(gate).forward(gate, x)
            picked.append(w.float().cpu())
            return w

        gate.forward = card_gate
    for n, gate in enumerate(m for m in cpu.modules() if isinstance(m, hy3._HYGate)):
        def cpu_gate(x, gate=gate, n=n):
            own, card_w = type(gate).forward(gate, x), picked[n]
            rerouted.append(int(((own > 0) != (card_w > 0)).any(-1).sum()))
            return card_w

        gate.forward = cpu_gate
    rng = np.random.default_rng(seed + 1)
    inputs = (torch.from_numpy(rng.normal(size=(1, 32, 16, 16)).astype(np.float32)), torch.tensor([700.0]),
              torch.from_numpy(rng.integers(0, 256, size=(1, 16))))
    with torch.inference_mode():
        out = card(*(x.cuda() for x in inputs)).float().cpu()
    del card
    release()

    def compare():
        cpu.to_empty(device="cpu").eval().requires_grad_(False)
        with torch.no_grad():
            for name, prm in cpu.named_parameters():
                src = sources.pop(name)
                prm.copy_(dequantized(*src) if isinstance(src, tuple) else src.float())
        with torch.inference_mode():
            t0 = time.perf_counter()
            ref = cpu(*inputs)
            cpu_s = time.perf_counter() - t0
        row = {"phase": "hunyuanimage3", "check": "card_int4_bf16_vs_cpu_f32",
               "model": "hunyuanimage3.base 32 heads of 128 over 8 KV heads, 1 + 1 layers (64 experts, top 8, the "
                        "shared expert), int4 on the card, the same dequantised weights in f32 on the CPU, "
                        "the card's routing", "parameters": sum(p.numel() for p in cpu.parameters()),
               "int4_resident_on_card": resident, "tokens_routed": int(picked[0].shape[-2]),
               "tokens_rerouted_in_f32": sum(rerouted), "rel_l2": rel_l2(out, ref),
               "max_abs_err": (out - ref).abs().max().item(), "max_abs_ref": ref.abs().max().item(),
               "finite": bool(torch.isfinite(out).all()), "tol_rel_l2": BF16_REL_L2, "cpu_seconds": cpu_s}
        emit(row)
        check(row["finite"] and row["rel_l2"] <= BF16_REL_L2,
              f"the HunyuanImage 3 backbone on the card is {row['rel_l2']} from the CPU (limit {BF16_REL_L2})")

    in_background(compare)


def vae_vs_float64(phase, label, vae, z, pixels):
    """``vae_decode_vs_float64`` emitted and held: ``pixels`` the decode's
    shape, within 2e-2 of float64."""
    row = {"phase": phase, "check": "vae_decode_vs_float64", "vae": label, **vae_decode_vs_float64(vae, z),
           "tol": 2e-2}
    emit(row)
    check(row["pixels"] == list(pixels), f"{label} decoded {row['pixels']}")
    check(row["rel_l2_vs_float64"] <= 2e-2, f"{label}'s decode is {row['rel_l2_vs_float64']} from float64")


def hy3_full_depth(engine) -> dict:
    """The engine's backbone at all 32 layers, int4: the resident count; a
    first forward at 1024² (4096 image tokens + 129), then the same forward
    warm, timed with its launches and each ``_w4`` call between CUDA events
    (the ``_w4`` share: their device seconds over that forward's seconds,
    the events in place); the peak GiB."""
    import torch

    from apex_studio_tpu_torch.models.layers import Linear
    from apex_studio_tpu_torch.ops.attention.flash import flash_attention
    from apex_studio_tpu_torch.quantize.residency import count_resident

    tf = engine.transformer
    g = torch.Generator("cuda").manual_seed(265)
    x = torch.randn(1, tf.cfg.img_in_channels, 64, 64, generator=g, device="cuda").to(tf.dtype)
    t = torch.tensor([500.0], device="cuda")
    ids = torch.from_numpy(engine.text_encoder.tokenize([WAN_PROMPT], HY3_TEXT)[0]).long().cuda()
    backbone = [m for name, m in tf.layers.named_modules() if isinstance(m, Linear) and not name.endswith("wg")]
    events, w4 = [], Linear._w4

    def timed_w4(self, inp):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = w4(self, inp)
        end.record()
        events.append((start, end))
        return y

    with torch.inference_mode():
        t0 = time.perf_counter()
        tf(x, t, ids)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        flash_attention.launches = 0
        Linear._w4 = timed_w4
        try:  # warm, each _w4 call between CUDA events
            t0 = time.perf_counter()
            tf(x, t, ids)
            torch.cuda.synchronize()
            forward_s, launches = time.perf_counter() - t0, flash_attention.launches
        finally:
            Linear._w4 = w4
    w4_s = sum(s.elapsed_time(e) for s, e in events) / 1e3
    row = {"phase": "hunyuanimage3", "check": "full_depth_forward", "layers": len(tf.layers),
           "parameters": sum(p.numel() * (2 if n == "weight" and getattr(m, "weight_scale", None) is not None
                                           and m.weight_bits == 4 else 1)
                             for m in tf.modules() for n, p in m.named_parameters(recurse=False)),
           "int4_resident": count_resident(tf), "backbone_linears": len(backbone),
           "backbone_linears_int4": sum(m.weight_scale is not None and m.weight_bits == 4 for m in backbone),
           "reckoned_gib": engine.reckoned_bytes["transformer"] / 2**30,
           "resident_gib": torch.cuda.memory_allocated() / 2**30, "tokens": x.shape[-1] * x.shape[-2] + HY3_TEXT + 1,
           "forward_seconds": forward_s, "flash_launches": launches, "flash_launches_expected": 2 * len(tf.layers),
           "forward_with_w4_events": True, "w4_calls": len(events), "w4_seconds": w4_s,
           "first_forward_seconds": first_s, "w4_share": w4_s / forward_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    check(len(tf.layers) == 32 and row["backbone_linears_int4"] == row["backbone_linears"] == 32 * (2 + 2 * 65),
          f"the HunyuanImage 3 backbone is not the published one held int4: {row}")
    check(launches == 2 * len(tf.layers), f"the full-depth forward launched the kernel {launches} times")
    return row


def hunyuanimage3_requests(home: Path):
    """HunyuanImage 3.0 from its manifest: the backbone built int4 on the card
    (synthetic ``int4``: every Linear of 2²⁰ elements or more packed int4),
    the DC-AE VAE in f32, the byte-level tokenizer; the fit check's reckoning
    at bf16 and int8 (the base engine's, at the transformer's load: both
    raise before anything is built) and int4; one forward at all 32 layers
    (``hy3_full_depth``); then the backbone cut to its first HY3_LAYERS
    layers and t2i at 1024² with CFG 7.5, 2 steps, seeds 0, 0 and 1."""
    import torch

    from apex_studio_tpu_torch.engine import hunyuanimage3 as hy3_engine

    configs = {"transformer": HY3_TRANSFORMER, "vae": HY3_VAE}
    write_named_configs(home / "hunyuanimage3", HY3_MANIFEST, configs)
    reckoned = {}
    for weights in ("bf16", "int8"):
        engine = image_engine("hunyuanimage3", HY3_MANIFEST, "t2i", home, weights)
        allocated = torch.cuda.memory_allocated()
        try:
            engine.load_component_by_type("transformer")
            raised = None
        except MemoryError as e:
            raised = str(e)
        reckoned[weights] = {"gib": engine.reckoned_bytes["transformer"] / 2**30, "raised": raised,
                             "allocated_gib_added": (torch.cuda.memory_allocated() - allocated) / 2**30}
        check(raised is not None and engine.transformer is None and reckoned[weights]["allocated_gib_added"] < 1,
              f"a {weights} HunyuanImage 3 backbone passed the fit check or was built: {reckoned[weights]}")
        del engine
    engine = video_rest_engine(HY3_MANIFEST, "t2i", home, configs, "hunyuanimage3")
    os.environ["APEX_SYNTHETIC_WEIGHTS"] = "int4"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.load_components()
    load_s = time.perf_counter() - t0
    reckoned["int4"] = {"gib": engine.reckoned_bytes["transformer"] / 2**30, "raised": None}
    emit({"phase": "hunyuanimage3", "fit_check": reckoned, "load_seconds": load_s,
          "headroom_gib": hy3_engine.HEADROOM_BYTES / 2**30})
    full = hy3_full_depth(engine)
    engine.transformer.layers = engine.transformer.layers[:HY3_LAYERS]
    release()
    lat = (1, 32, 64, 64)
    kw = dict(prompt=WAN_PROMPT, negative_prompt=VIDEO_REST_NEG, height=1024, width=1024,
              num_inference_steps=HY3_STEPS, guidance_scale=HY3_CFG)
    rows = seed_pair("hunyuanimage3_t2i", engine, kw, 2 * HY3_STEPS * 2 * HY3_LAYERS, lat, 1, (1024, 1024),
                     phase="hunyuanimage3")[0]
    emit({"phase": "hunyuanimage3", "requests_layers": HY3_LAYERS, "full_depth_peak_gib": full["peak_gib"],
          "peak_gib": max(r["peak_gib"] for r in rows)})
    del engine
    release()
    return {"hunyuanimage3_t2i_1024": rows}, full


def phase_hunyuanimage3(home: Path):
    """HunyuanImage 3.0: the kernel at the image span's launch against every
    key and at the causal prefix; the 1 + 1-layer backbone int4 against f32;
    the VAE against float64; the full-depth int4 backbone's forward and the
    requests (``hunyuanimage3_requests``)."""
    import torch

    from apex_studio_tpu_torch.models.vaes import hunyuanimage3_vae
    from apex_studio_tpu_torch.models.vaes.hunyuanvideo_vae import GroupNormCh

    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    rows, err = path_kernel_rows("hunyuanimage3", hy3_kernel_inputs())
    s = HY3_TEXT + 1
    causal, causal_err = causal_kernel_row("hunyuanimage3", "hy3_causal_prefix_s%d_h32" % s, *qkv(1, s, s, 32, 128,
                                                                                                  263))
    rows.append(causal)
    lap("kernel_rows")
    hy3_card_vs_cpu(266)
    vae = materialize_random_vae(lambda: hunyuanimage3_vae.AutoencoderKLConv3D(
        hunyuanimage3_vae.HunyuanImage3VAEConfig.from_dict(HY3_VAE)), seed=267, norms=GroupNormCh)
    z = torch.randn(1, 32, 4, 4, generator=torch.Generator("cuda").manual_seed(268), device="cuda")
    vae_vs_float64("hunyuanimage3", "hunyuanimage3 DC-AE 16x", vae, z, (1, 3, 64, 64))
    del vae
    release()
    lap("card_vs_cpu")
    paths, _ = hunyuanimage3_requests(home)
    lap("requests")
    emit({"phase": "hunyuanimage3", "seconds_by_step": seconds})
    return paths, rows, max(err, causal_err)


def cog_twin(home: Path, model_type: str) -> Path:
    """The t2v manifest with ``model_type`` and its DiT config at a path of its
    own (the twin's config is written there)."""
    import yaml

    doc = yaml.safe_load(COG_MANIFESTS["t2v"].read_text())
    doc["metadata"]["id"] += f"-{model_type}-smoke"
    doc["spec"]["model_type"] = model_type
    tf = next(c for c in doc["spec"]["components"] if c["type"] == "transformer")
    tf["config_path"] = f"THUDM/CogVideoX-5b-{model_type}-twin/transformer/config.json"
    path = home / f"cogvideox-5b-{model_type}.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


def cogvideox_requests(home: Path):
    """CogVideoX 5B from its three manifests and the control and inp twins at
    full width (48 heads of 64) and COG_LAYERS of the 42 layers in bf16, T5-XXL bf16,
    the VAE in f32; 480x720 over 17 frames, 2 steps, CFG 6 with dynamic CFG
    against a negative prompt: t2v (seeds 0, 0, 1), v2v on a seeded 17-frame
    clip at strength 0.8, i2v from a seeded image (its first latent frame the
    condition), control on a clip, inp on a clip and a moving disk mask."""
    import numpy as np
    import torch

    lat = (1, 16, 5, 60, 90)
    size = (480, 720)
    kw = dict(prompt=WAN_PROMPT, negative_prompt=VIDEO_REST_NEG, height=480, width=720, num_frames=COG_FRAMES,
              num_inference_steps=COG_STEPS, guidance_scale=6.0, use_dynamic_cfg=True)
    launches = 2 * COG_STEPS * COG_LAYERS
    t2v_configs = {"transformer": dict(COG_TRANSFORMER, num_layers=COG_LAYERS), "vae": COG_VAE, "text_encoder": T5_XXL}
    t2v = video_rest_engine(COG_MANIFESTS["t2v"], "t2v", home, t2v_configs, "cogvideox")
    rows = {}
    rows["t2v"] = seed_pair("cogvideox_t2v", t2v, kw, launches, lat, COG_FRAMES, size, phase="cogvideox")[0]
    clip, _ = disk_clip(COG_FRAMES, 480, 720, seed=269)
    rows["v2v"] = [video_rest_drive("cogvideox_v2v", video_rest_engine(
        COG_MANIFESTS["v2v"], "v2v", home, t2v_configs, "cogvideox", share=t2v), dict(kw, video=clip, strength=0.8,
                                                                                      seed=0),
        launches, COG_FRAMES, size, [lat], phase="cogvideox")[0]]
    tf = t2v.transformer
    facts = {"phase": "cogvideox", "dit_dim": tf.cfg.dim, "dit_blocks": len(tf.transformer_blocks),
             "heads": tf.cfg.num_attention_heads, "head_dim": tf.cfg.attention_head_dim,
             "dit_parameters": sum(p.numel() for p in tf.parameters()), "dit_dtype": str(tf.dtype),
             "t5_d_model": t2v.text_encoder._ensure_model().cfg.d_model, "vae_dtype": str(
                 next(t2v.vae.parameters()).dtype), "memory_fallback_gate": t2v.gate}
    check(tf.cfg.dim == 3072 and tf.cfg.attention_head_dim == 64 and len(tf.transformer_blocks) == COG_LAYERS
          and not dit_bits(tf), f"the CogVideoX DiT's widths: {facts}")
    t2v.transformer = tf = None
    release()
    i2v = video_rest_engine(COG_MANIFESTS["i2v"], "i2v", home,
                            {"transformer": dict(COG_I2V_TRANSFORMER, num_layers=COG_LAYERS), "vae": COG_VAE,
                             "text_encoder": T5_XXL}, "cogvideox", share=t2v)
    i2v.transformer = None  # the 32-channel DiT
    i2v.encoded = []
    encode = i2v.encode_video_latents

    def observed_encode(px):
        i2v.encoded.append(encode(px))
        return i2v.encoded[-1]

    i2v.encode_video_latents = observed_encode
    image = cv2_smooth(np.random.default_rng(270), size)
    rows["i2v"] = [video_rest_drive("cogvideox_i2v", i2v, dict(kw, image=image, seed=0), launches, COG_FRAMES, size,
                                    [lat], phase="cogvideox")[0]]
    cond_pinned = bool(i2v.encoded and tuple(i2v.encoded[0].shape) == (1, 16, 1, 60, 90))
    i2v.transformer = None
    release()
    masks = [np.where(f[..., 0] == 220, 255, 0).astype(np.uint8) for f in clip]
    for model_type, extra in (("control", dict(control_video=clip)), ("inp", dict(video=clip, mask_video=masks))):
        twin = dict(COG_TRANSFORMER, in_channels=COG_TWINS[model_type], num_layers=COG_LAYERS)
        engine = video_rest_engine(cog_twin(home, model_type), model_type, home,
                                   {"transformer": twin, "vae": COG_VAE, "text_encoder": T5_XXL}, "cogvideox",
                                   share=t2v)
        engine.transformer = None
        rows[model_type] = [video_rest_drive(f"cogvideox_{model_type}", engine, dict(kw, seed=0, **extra), launches,
                                             COG_FRAMES, size, [lat], phase="cogvideox")[0]]
        check(engine.transformer.cfg.in_channels == COG_TWINS[model_type],
              f"CogVideoX {model_type}: DiT in_channels {engine.transformer.cfg.in_channels}")
        engine.transformer = None
        release()
    facts.update(i2v_condition_encoded=cond_pinned, peak_gib=max(r["peak_gib"] for rs in rows.values() for r in rs))
    emit(facts)
    check(cond_pinned, "CogVideoX i2v: the first frame was not encoded to one latent frame")
    del t2v, i2v
    release()
    return {f"cogvideox_{t}_480x720": rs for t, rs in rows.items()}


def cog_reference():
    """The CogVideoX DiT at full width with 2 blocks, card (bf16, the kernel)
    against CPU (f32, the plain version) within BF16_REL_L2 over 3 latent
    frames of 16 x 24 and 64 text rows; the 5B VAE decode of a seeded 3 x 8
    x 12 latent against float64."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.models.transformers import cogvideox
    from apex_studio_tpu_torch.models.vaes import cogvideox_vae
    from apex_studio_tpu_torch.models.vaes.hunyuanvideo_vae import GroupNormCh

    rng = np.random.default_rng(271)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    card_vs_cpu("cogvideo.base 48 heads of 64, 2 blocks",
                lambda dt: cogvideox.CogVideoXTransformer3DModel(cogvideox.CogVideoXConfig.from_dict(
                    dict(COG_TRANSFORMER, num_layers=2)), dtype=dt),
                lambda m, x, t, c: m(x, t, c), (tensor(1, 16, 3, 16, 24), torch.tensor([731.0]), tensor(1, 64, 4096)),
                BF16_REL_L2, 272, phase="cogvideox")
    vae = materialize_random_vae(lambda: cogvideox_vae.AutoencoderKLCogVideoX(
        cogvideox_vae.CogVideoXVAEConfig.from_dict(COG_VAE)), seed=273, norms=GroupNormCh)
    z = torch.randn(1, 16, 3, 8, 12, generator=torch.Generator("cuda").manual_seed(274), device="cuda")
    vae_vs_float64("cogvideox", "cogvideo.base VAE (5B)", vae, z, (1, 3, 9, 64, 96))
    del vae
    release()


def phase_cogvideox(home: Path):
    """CogVideoX 5B: the kernel at the joint launch (17 and 49 frames, 48 heads
    of 64), the DiT against f32 and the VAE against float64
    (``cog_reference``), then the five types (``cogvideox_requests``)."""
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    rows, err = path_kernel_rows("cogvideox", cog_kernel_inputs())
    lap("kernel_rows")
    cog_reference()
    lap("card_vs_cpu")
    paths = cogvideox_requests(home)
    lap("requests")
    emit({"phase": "cogvideox", "seconds_by_step": seconds})
    return paths, rows, err


# -- Mochi-1 and LTX-Video (the rectified-flow families) ------------------------------------

MOCHI_MANIFEST = REPO / "manifests" / "video" / "mochi-1-text-to-video.yml"
LTX_MANIFEST = REPO / "manifests" / "video" / "ltx-video-x2v.yml"
MOCHI_LAYERS = 4  # of the published 48: the requests' cut of depth (one forward runs all 48)
MOCHI_STEPS, LTX_STEPS = 2, 2
# 480x848 over 85 frames: 15 latent frames of 30 x 53 tokens beside the 256 text rows, one joint launch a block
MOCHI_TOKENS = 15 * 30 * 53 + 256
# 480x832 over 5 s at 30 fps (145 frames): 19 latent frames of 15 x 26 tokens, 128 text rows
LTX_TOKENS, LTX_TEXT = 19 * 15 * 26, 128
LTX_STG_BLOCK = 19
# The 1 + 1-block AsymmDiT in bf16 is 1.1% from f32 on the CPU and JAX's own bf16 forward of the same weights
# 1.3% (``python -m tests.torch_bf16_width mochi``): its card-vs-CPU check is held at HiDream's 1.5%, not 1%.
MOCHI_BF16_REL_L2 = 1.5e-2
# Published widths the repository lacks, written where the manifests name them. genmo/mochi-1-preview:
# the AsymmDiT at 48 layers of 24 heads of 128, T5 4096 -> a 1536-wide text stream, time 256, patch 2,
# 12 latent channels; its VAE's decoder (128, 256, 512, 768), encoder (64, 128, 256, 384), layers
# (3, 3, 4, 6, 3), time expansions (1, 2, 3), space (2, 2, 2), per-channel latent statistics (seeded here,
# not the published values). Lightricks/LTX-Video: the DiT at 28 layers of 32 heads of 64, T5 4096, 128
# latent channels; the causal VAE at the LTXVAEConfig defaults (patch 4, three res-compress stages, the
# decoder's timestep tables and noise injection). Both on T5 v1.1 XXL (T5_XXL).
MOCHI_TRANSFORMER = {"_class_name": "MochiTransformer3DModel", "activation_fn": "swiglu", "attention_head_dim": 128,
                     "in_channels": 12, "max_sequence_length": 256, "num_attention_heads": 24, "num_layers": 48,
                     "out_channels": 12, "patch_size": 2, "pooled_projection_dim": 1536, "qk_norm": "rms_norm",
                     "text_embed_dim": 4096, "time_embed_dim": 256}
MOCHI_VAE = {"_class_name": "AutoencoderKLMochi", "act_fn": "silu",
             "add_attention_block": [False, True, True, True, True],
             "block_out_channels": [128, 256, 512, 768], "encoder_block_out_channels": [64, 128, 256, 384],
             "in_channels": 15, "latent_channels": 12, "layers_per_block": [3, 3, 4, 6, 3], "out_channels": 3,
             "scaling_factor": 1.0, "spatial_expansions": [2, 2, 2], "temporal_expansions": [1, 2, 3]}
LTX_TRANSFORMER = {"_class_name": "Transformer3DModel", "activation_fn": "gelu-approximate", "attention_bias": True,
                   "attention_head_dim": 64, "caption_channels": 4096, "cross_attention_dim": 2048,
                   "in_channels": 128, "norm_eps": 1e-6, "num_attention_heads": 32, "num_layers": 28,
                   "out_channels": 128, "positional_embedding_max_pos": [20, 2048, 2048],
                   "positional_embedding_theta": 10000.0, "qk_norm": "rms_norm", "timestep_scale_multiplier": 1000.0}
LTX_VAE = {"_class_name": "CausalVideoAutoencoder", "dims": 3, "in_channels": 3, "out_channels": 3,
           "latent_channels": 128, "base_channels": 128, "patch_size": 4, "norm_layer": "pixel_norm",
           "latent_log_var": "uniform", "causal_decoder": False, "timestep_conditioning": True,
           "spatial_padding_mode": "zeros",
           "encoder_blocks": [["res_x", {"num_layers": 4}], ["compress_all_res", {"multiplier": 2}],
                              ["res_x", {"num_layers": 6}], ["compress_all_res", {"multiplier": 2}],
                              ["res_x", {"num_layers": 6}], ["compress_all_res", {"multiplier": 2}],
                              ["res_x", {"num_layers": 2}], ["res_x", {"num_layers": 2}]],
           "decoder_blocks": [["res_x", {"num_layers": 5, "inject_noise": True}],
                              ["compress_all", {"residual": True, "multiplier": 2}],
                              ["res_x", {"num_layers": 6, "inject_noise": True}],
                              ["compress_all", {"residual": True, "multiplier": 2}],
                              ["res_x", {"num_layers": 7, "inject_noise": True}],
                              ["compress_all", {"residual": True, "multiplier": 2}],
                              ["res_x", {"num_layers": 8, "inject_noise": False}]]}


def mochi_vae_config() -> dict:
    """MOCHI_VAE with seeded per-channel latent statistics."""
    import numpy as np

    rng = np.random.default_rng(280)
    return dict(MOCHI_VAE, latents_mean=(0.05 * rng.normal(size=12)).tolist(),
                latents_std=(0.9 + 0.1 * rng.random(12)).tolist())


def mochi_kernel_inputs():
    """(case, q, k, v, bias): the joint launch over [video | text] (unmasked,
    as in JAX) at 24 heads of 128."""
    yield ("mochi_joint_s%d_h24" % MOCHI_TOKENS, *qkv(1, MOCHI_TOKENS, MOCHI_TOKENS, 24, 128, 281), None)


def wide_query_row(label, case, q, k, v, bias) -> dict:
    """A one-query launch past the kernel's head dims
    (``one_query_wide_head_attention``: its f32 scores as the key bias) against
    its plain version, timed beside ``scaled_dot_product_attention`` with the
    bias as its mask; the bound counts q, k, v, the bias and the output once
    and 4·Sk·D·H operations."""
    import torch
    import torch.nn.functional as F

    from apex_studio_tpu_torch.ops.attention import one_query_wide_head_attention
    from apex_studio_tpu_torch.ops.attention.flash import flash_attention, flash_attention_reference

    b, sq, h, d = q.shape
    sk = k.shape[1]
    before = flash_attention.launches
    out = one_query_wide_head_attention(q, k, v, bias=bias)
    launched = flash_attention.launches - before
    agree = agreement(out, flash_attention_reference(q, k, v, bias=bias))
    finite = bool(torch.isfinite(out.float()).all())
    emit({"phase": "kernels", "path": label, "cases": [{"case": f"{case}_all_rows", "shape": list(q.shape), "sk": sk,
                                                        "bias": True, **agree, "finite": finite,
                                                        "launches": launched}]})
    check(finite and agree["within"] and launched == 1,
          f"the wide-head query disagrees with its plain version at {label}'s {case} ({launched} launches)")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = library_mask(bias)
    flops = 4.0 * b * h * sq * sk * d
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size() + bias.numel() * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    ms = time_ms(lambda: one_query_wide_head_attention(q, k, v, bias=bias))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    row = {"phase": "timing", "path": label, "kernel": "flash_attention", "case": case, "shape": list(q.shape),
           "sk": sk, "bias": True, "ms": ms,
           "queued_ms": queued_ms(lambda: one_query_wide_head_attention(q, k, v, bias=bias)),
           "plain_ms": time_ms(lambda: flash_attention_reference(q, k, v, bias=bias)), "plain_rows": sq,
           "library_ms": library_ms,
           "library_queued_ms": queued_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)),
           "library_call": "torch.nn.functional.scaled_dot_product_attention",
           "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes, "keys_kept": sk, "bound_ms_as_launched": max(t_ops, t_bytes),
           "bound_ms_as_launched_padded": max(t_ops, t_bytes), "vs_library": ms / library_ms}
    emit(row)
    return row, agree["max_abs_err"]


def mochi_pooler_row():
    """The pooler's one query over [mean | 256 text rows] at 8 heads of 512,
    the keys past a 24-token prompt at -1e9 (``wide_query_row``)."""
    import torch

    bias = torch.zeros(1, 257, device="cuda")
    bias[:, 1 + 24:] = -1e9
    return wide_query_row("mochi", "mochi_pooler_sq1_sk257_h8_d512", *qkv(1, 1, 257, 8, 512, 282), bias)


def ltx_kernel_inputs():
    """(case, q, k, v, bias): the self-attention over the video tokens and the
    cross-attention against the 128 text rows (a 24-token prompt, the padded
    keys at -10000) at 32 heads of 64."""
    import torch

    yield ("ltx_self_s%d_h32_d64" % LTX_TOKENS, *qkv(1, LTX_TOKENS, LTX_TOKENS, 32, 64, 283), None)
    bias = torch.zeros(1, LTX_TEXT, device="cuda")
    bias[:, 24:] = -10000.0
    yield ("ltx_cross_sq%d_sk%d_h32_d64" % (LTX_TOKENS, LTX_TEXT), *qkv(1, LTX_TOKENS, LTX_TEXT, 32, 64, 284), bias)


def mochi_full_depth(engine) -> dict:
    """The engine's DiT at all 48 blocks over the manifest's 85 frames at
    480x848 (24,106 tokens, the prompt's T5 features and mask): one forward
    timed with its launches (48 joint + the pooler's; the kernel built and
    its shapes timed before), and the peak GiB."""
    import torch

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    tf = engine.transformer
    g = torch.Generator("cuda").manual_seed(285)
    x = torch.randn(1, 12, 15, 60, 106, generator=g, device="cuda").to(tf.dtype)
    t = torch.tensor([500.0], device="cuda")
    context, mask = engine.encode_prompt(WAN_PROMPT)
    with torch.inference_mode():
        flash_attention.launches = 0
        t0 = time.perf_counter()
        out = tf(x, t, context, encoder_attention_mask=mask)
        torch.cuda.synchronize()
        forward_s, launches = time.perf_counter() - t0, flash_attention.launches
    row = {"phase": "mochi", "check": "full_depth_forward", "blocks": len(tf.blocks), "dim": tf.cfg.dim,
           "heads": tf.cfg.num_attention_heads, "head_dim": tf.cfg.attention_head_dim,
           "parameters": sum(p.numel() for p in tf.parameters()), "dtype": str(tf.dtype),
           "tokens": MOCHI_TOKENS, "text_rows_kept": int(mask.sum().item()), "forward_seconds": forward_s,
           "flash_launches": launches, "flash_launches_expected": len(tf.blocks) + 1,
           "out_shape": list(out.shape), "finite": bool(torch.isfinite(out.float()).all()),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    check(len(tf.blocks) == 48 and tf.cfg.dim == 3072 and row["finite"] and row["out_shape"] == [1, 12, 15, 60, 106],
          f"the Mochi DiT's full-depth forward: {row}")
    check(launches == 49, f"the full-depth Mochi forward launched the kernel {launches} times")
    return row


def mochi_reference():
    """The AsymmDiT at full width with 1 + 1 blocks (a regular and the last),
    card (bf16, the kernel) against CPU (f32, the plain version) over 3
    latent frames of 16 x 24 and 256 text rows (40 kept) within
    MOCHI_BF16_REL_L2; the VAE's decode of a seeded 2 x 8 x 12 latent
    against float64."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.models.transformers import mochi
    from apex_studio_tpu_torch.models.vaes import mochi_vae

    rng = np.random.default_rng(286)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    mask = torch.zeros(1, 256)
    mask[:, :40] = 1.0
    card_vs_cpu("mochi.base 24 heads of 128, 1 + 1 blocks",
                lambda dt: mochi.MochiTransformer3DModel(mochi.MochiConfig.from_dict(
                    dict(MOCHI_TRANSFORMER, num_layers=2)), dtype=dt),
                lambda m, x, t, c, msk: m(x, t, c, encoder_attention_mask=msk),
                (tensor(1, 12, 3, 16, 24), torch.tensor([731.0]), tensor(1, 256, 4096), mask),
                MOCHI_BF16_REL_L2, 287, phase="mochi")
    vae = materialize_random_vae(lambda: mochi_vae.AutoencoderKLMochi(mochi_vae.MochiVAEConfig.from_dict(
        mochi_vae_config())), seed=288, norms=mochi_vae.MochiGroupNorm)
    z = torch.randn(1, 12, 2, 8, 12, generator=torch.Generator("cuda").manual_seed(289), device="cuda")
    vae_vs_float64("mochi", "mochi.base VAE", vae, z, (1, 3, 7, 64, 96))
    del vae
    release()


def mochi_requests(home: Path):
    """Mochi-1 from its manifest at full width in bf16 (T5-XXL bf16, the VAE
    f32): one forward at all 48 blocks (``mochi_full_depth``), then the DiT
    cut to its first MOCHI_LAYERS - 1 blocks and its last, and t2v at the
    manifest's 480x848 over 85 frames, 2 steps, CFG 4.5 against a negative
    prompt, seeds 0, 0 and 1 (the first decoded)."""
    import torch
    from torch import nn

    configs = {"transformer": MOCHI_TRANSFORMER, "vae": mochi_vae_config(), "text_encoder": T5_XXL}
    engine = video_rest_engine(MOCHI_MANIFEST, "t2v", home, configs, "mochi")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.load_components()
    emit({"phase": "mochi", "load_seconds": time.perf_counter() - t0})
    full = mochi_full_depth(engine)
    tf = engine.transformer
    tf.blocks = nn.ModuleList(list(tf.blocks[:MOCHI_LAYERS - 1]) + [tf.blocks[-1]])
    release()
    kw = dict(prompt=WAN_PROMPT, negative_prompt=VIDEO_REST_NEG, height=480, width=848, num_frames=85,
              num_inference_steps=MOCHI_STEPS, guidance_scale=4.5)
    rows = seed_pair("mochi_t2v", engine, kw, 2 * MOCHI_STEPS * (MOCHI_LAYERS + 1), (1, 12, 15, 60, 106), 85,
                     (480, 848), phase="mochi")[0]
    emit({"phase": "mochi", "requests_blocks": len(tf.blocks), "full_depth_peak_gib": full["peak_gib"],
          "peak_gib": max(r["peak_gib"] for r in rows), "vae_dtype": str(next(engine.vae.parameters()).dtype),
          "t5_d_model": engine.text_encoder._ensure_model().cfg.d_model})
    del engine, tf
    release()
    return {"mochi_t2v_480x848x85": rows}, full


def phase_mochi(home: Path):
    """Mochi-1: the kernel at the joint launch and the pooler's, the 1 + 1-block
    DiT against f32 and the VAE against float64 (``mochi_reference``), the
    full-depth forward and the t2v requests (``mochi_requests``)."""
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    rows, err = path_kernel_rows("mochi", mochi_kernel_inputs())
    pooler, pooler_err = mochi_pooler_row()
    rows, err = rows + [pooler], max(err, pooler_err)
    release()
    lap("kernel_rows")
    mochi_reference()
    lap("card_vs_cpu")
    paths, _ = mochi_requests(home)
    lap("requests")
    emit({"phase": "mochi", "seconds_by_step": seconds})
    return paths, rows, err


def ltx_reference():
    """The LTX DiT at full width with 2 blocks, card (bf16, the kernel) against
    CPU (f32, the plain version) over 3 latent frames of 8 x 12 tokens with
    per-token timesteps (the first frame's held at 0) and 128 text rows (24
    kept), and again with block 1 skipped as STG skips it (one rel L2 over
    both); the VAE's decode of a seeded 2 x 4 x 6 latent against float64."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine.ltx import latent_coords
    from apex_studio_tpu_torch.models.transformers import ltx
    from apex_studio_tpu_torch.models.vaes import ltx_vae

    rng = np.random.default_rng(290)
    s = 3 * 8 * 12
    tokens = torch.from_numpy(rng.normal(size=(1, s, 128)).astype(np.float32))
    ctx = torch.from_numpy(rng.normal(size=(1, LTX_TEXT, 4096)).astype(np.float32))
    mask = torch.zeros(1, LTX_TEXT)
    mask[:, :24] = 1.0
    t = torch.full((1, s), 0.7)
    t[:, :96] = 0.0
    coords = torch.from_numpy((latent_coords(3, 8, 12) * np.array([[8 / 30], [32], [32]]))[None].astype(np.float32))
    card_vs_cpu("ltx.base 32 heads of 64, 2 blocks, without and with block 1 skipped",
                lambda dt: ltx.LTXVideoTransformer3D(ltx.LTXVideoConfig.from_dict(
                    dict(LTX_TRANSFORMER, num_layers=2)), dtype=dt),
                lambda m, x, c, tt, msk, xyz: torch.stack([m(x, c, tt, encoder_attention_mask=msk, video_coords=xyz,
                                                             skip_blocks=skips) for skips in ((), (1,))]),
                (tokens, ctx, t, mask, coords), BF16_REL_L2, 291, phase="ltx")
    vae = materialize_random_vae(lambda: ltx_vae.AutoencoderKLLTX(ltx_vae.LTXVAEConfig.from_dict(LTX_VAE)), seed=292)
    z = torch.randn(1, 128, 2, 4, 6, generator=torch.Generator("cuda").manual_seed(293), device="cuda")
    vae_vs_float64("ltx", "ltx_vae.base", vae, z, (1, 3, 9, 128, 192))
    del vae
    release()


def ltx_requests(home: Path):
    """LTX-Video x2v from its manifest at full width and depth (28 layers) in
    bf16 (T5-XXL bf16, the VAE f32): 480x832 over 5 s at 30 fps (145
    frames), 2 steps, CFG 3 with STG (scale 1, block 19, rescaling 0.7), the
    manifest's decode timestep and noise: t2v (seeds 0, 0, 1), i2v from a
    seeded image (decoded), and an extension of a 17-frame clip as a
    ``conditions`` item at strength 0.8 (its latents)."""
    import numpy as np

    configs = {"transformer": LTX_TRANSFORMER, "vae": LTX_VAE, "text_encoder": T5_XXL}
    engine = video_rest_engine(LTX_MANIFEST, "x2v", home, configs, "ltx")
    engine.encoded = []
    kw = dict(prompt=WAN_PROMPT, negative_prompt=VIDEO_REST_NEG, height=480, width=832, duration=5.0, fps=30,
              num_inference_steps=LTX_STEPS, guidance_scale=3.0, stg_scale=1.0, skip_block_list=[LTX_STG_BLOCK],
              rescaling_scale=0.7, image_cond_noise_scale=0.15, decode_timestep=0.05, decode_noise_scale=0.025)
    # a step: the CFG forward over [neg | pos] (self + cross a block), the STG forward (block 19's self skipped)
    launches = LTX_STEPS * ((28 + 28) + (27 + 28))
    lat, size = (1, 128, 19, 15, 26), (480, 832)
    rows = {"t2v": seed_pair("ltx_t2v", engine, kw, launches, lat, 145, size, phase="ltx")[0]}
    vae = engine.vae
    encode = vae.encode

    def observed_encode(x):
        engine.encoded.append(tuple(x.shape))
        return encode(x)

    vae.encode = observed_encode
    image = cv2_smooth(np.random.default_rng(294), size)
    rows["i2v"] = [video_rest_drive("ltx_i2v", engine, dict(kw, image=image, seed=0), launches, 145, size, [lat],
                                    phase="ltx")[0]]
    clip, _ = disk_clip(17, 480, 832, seed=295)
    rows["extension"] = [video_rest_drive("ltx_extension", engine, dict(
        kw, conditions=[{"video": np.stack(clip), "frame_number": 0, "strength": 0.8}], seed=0, return_latents=True),
        launches, latents_expected=[lat], phase="ltx")[0]]
    vae.encode = encode
    tf = engine.transformer
    facts = {"phase": "ltx", "dit_dim": tf.cfg.inner_dim, "dit_blocks": len(tf.blocks),
             "heads": tf.cfg.num_attention_heads, "head_dim": tf.cfg.attention_head_dim,
             "dit_parameters": sum(p.numel() for p in tf.parameters()), "dit_dtype": str(tf.dtype),
             "vae_dtype": str(next(vae.parameters()).dtype), "conditions_encoded": engine.encoded,
             "peak_gib": max(r["peak_gib"] for rs in rows.values() for r in rs)}
    emit(facts)
    check(tf.cfg.inner_dim == 2048 and len(tf.blocks) == 28 and not dit_bits(tf), f"the LTX DiT's widths: {facts}")
    check(engine.encoded == [(1, 3, 1, 480, 832), (1, 3, 17, 480, 832)],
          f"LTX: the conditioning media encoded were {engine.encoded}")
    del engine, tf, vae
    release()
    return {f"ltx_{t}_480x832x145": rs for t, rs in rows.items()}


def phase_ltx(home: Path):
    """LTX-Video: the kernel at the self- and cross-attention launches, the
    2-block DiT against f32 and the VAE against float64 (``ltx_reference``),
    then the x2v requests (``ltx_requests``)."""
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    rows, err = path_kernel_rows("ltx", ltx_kernel_inputs())
    lap("kernel_rows")
    ltx_reference()
    lap("card_vs_cpu")
    paths = ltx_requests(home)
    lap("requests")
    emit({"phase": "ltx", "seconds_by_step": seconds})
    return paths, rows, err


# -- LTX-2 -------------------------------------------------------------------------------

LTX2_MANIFEST = REPO / "manifests" / "video" / "ltx2-19b-ti2v.yml"
LTX2_LAYERS = 4  # of the published 48: the requests' cut of depth (one forward runs all 48)
LTX2_STEPS = 2
LTX2_STG_BLOCK = 1
# the manifest's default request: 512x768 over 5 s at 25 fps (121 frames): 16 latent frames of 16 x 24
# tokens, 121 audio tokens, the prompt at 1024 tokens; the other requests at 17 frames (3 x 16 x 24)
LTX2_TOKENS, LTX2_AUDIO, LTX2_TEXT = 16 * 16 * 24, 121, 1024
LTX2_SHORT_TOKENS, LTX2_SHORT_AUDIO = 3 * 16 * 24, 17
# Published widths the repository lacks, written where the manifest names them. Lightricks/LTX-2: Gemma-3
# 12B's text tower (48 layers of 3840, 16 query / 8 key-value heads of 256, a 1024-token window on five
# layers of six, linear RoPE scaling 8 on the global ones); the text connectors (the 49 hidden states'
# 188,160 features to 3840, two 2-layer stacks of 30 heads of 128 with 128 registers); the video VAE
# (patch 4, 128 latent channels, encoder 256 -> 2048 over four samplers, decoder 1024 -> 128 over three),
# with seeded per-channel statistics; the audio VAE (base 128, ch_mult 1, 2, 4, 8 latent channels over 64
# mel bins) and the vocoder (1024 hidden, 6 x 5 x 2 x 2 x 2 to 24 kHz), at the modules' defaults.
GEMMA3_12B = {"architectures": ["Gemma3ForConditionalGeneration"], "model_type": "gemma3", "text_config": {
    "model_type": "gemma3_text", "vocab_size": 262208, "hidden_size": 3840, "intermediate_size": 15360,
    "num_hidden_layers": 48, "num_attention_heads": 16, "num_key_value_heads": 8, "head_dim": 256,
    "query_pre_attn_scalar": 256, "sliding_window": 1024, "sliding_window_pattern": 6, "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0, "rope_local_base_freq": 10000.0, "rope_scaling": {"factor": 8.0, "rope_type": "linear"}}}
LTX2_CONNECTORS = {"caption_channels": 3840, "text_proj_in_factor": 49, "video_connector_num_attention_heads": 30,
                   "video_connector_attention_head_dim": 128, "video_connector_num_layers": 2,
                   "video_connector_num_learnable_registers": 128, "audio_connector_num_attention_heads": 30,
                   "audio_connector_attention_head_dim": 128, "audio_connector_num_layers": 2,
                   "audio_connector_num_learnable_registers": 128, "connector_rope_base_seq_len": 4096}
LTX2_AUDIO_VAE = {"base_channels": 128, "ch_mult": [1, 2, 4], "num_res_blocks": 2, "latent_channels": 8,
                  "mel_bins": 64, "sample_rate": 16000, "mel_hop_length": 160}
LTX2_VOCODER = {"in_channels": 128, "hidden_channels": 1024, "out_channels": 2,
                "upsample_kernel_sizes": [16, 15, 8, 4, 4], "upsample_factors": [6, 5, 2, 2, 2],
                "resnet_kernel_sizes": [3, 7, 11], "resnet_dilations": [[1, 3, 5]] * 3,
                "output_sampling_rate": 24000}
# the published latent upsampler (spatial 2x, rational resampler) at its defaults
LTX2_UPSAMPLER = {"in_channels": 128, "mid_channels": 512, "num_blocks_per_stage": 4, "dims": 3,
                  "spatial_upsample": True, "rational_resampler": True, "spatial_scale": 2.0}


def ltx2_vae_config() -> dict:
    """The LTX-2 video VAE at its published widths with seeded per-channel statistics."""
    import dataclasses

    import numpy as np

    from apex_studio_tpu_torch.models.vaes.ltx2_vae import LTX2VAEConfig

    rng = np.random.default_rng(300)
    return dict(dataclasses.asdict(LTX2VAEConfig()), latents_mean=(0.05 * rng.normal(size=128)).tolist(),
                latents_std=(0.9 + 0.1 * rng.random(128)).tolist())


def ltx2_kernel_inputs():
    """(case, q, k, v, bias) at the launches of the manifest's default request
    with CFG (B = 2): the video self-attention (32 heads of 128), the video and
    audio text cross-attention over the 1024 connector rows (the unconditional
    row of a request without a negative prompt fully masked, the conditional
    row kept whole: the registers fill its padding), the AV cross launches at
    the audio geometry (32 heads of 64) both ways, the audio self-attention,
    and one connector stack's self-attention (30 heads of 128, unmasked)."""
    import torch

    bias = torch.zeros(2, LTX2_TEXT, device="cuda")
    bias[0] = -1e30
    t, a, x = LTX2_TOKENS, LTX2_AUDIO, LTX2_TEXT
    yield (f"ltx2_video_self_s{t}_h32_d128", *qkv(2, t, t, 32, 128, 301), None)
    yield (f"ltx2_video_text_sq{t}_sk{x}_h32_d128", *qkv(2, t, x, 32, 128, 302), bias)
    yield (f"ltx2_a2v_sq{t}_sk{a}_h32_d64", *qkv(2, t, a, 32, 64, 303), None)
    yield (f"ltx2_v2a_sq{a}_sk{t}_h32_d64", *qkv(2, a, t, 32, 64, 304), None)
    yield (f"ltx2_audio_self_s{a}_h32_d64", *qkv(2, a, a, 32, 64, 305), None)
    yield (f"ltx2_audio_text_sq{a}_sk{x}_h32_d64", *qkv(2, a, x, 32, 64, 306), bias)
    yield (f"ltx2_connector_s{x}_h30_d128", *qkv(1, x, x, 30, 128, 307), None)


def ltx2_masked_rows():
    """The kernel's fully masked batch rows (the unconditional text cross
    rows of a request without a negative prompt) against the plain version
    of what they compute: every query row the mean of V over the keys."""
    import torch

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    cases = []
    for name, sq, h, d, seed in (("video_text", LTX2_TOKENS, 32, 128, 308), ("audio_text", LTX2_AUDIO, 32, 64, 309)):
        q, k, v = qkv(2, sq, LTX2_TEXT, h, d, seed)
        bias = torch.zeros(2, LTX2_TEXT, device="cuda")
        bias[0] = -1e30
        out = flash_attention(q, k, v, bias=bias)
        mean = v[:1].float().mean(1, keepdim=True).to(v.dtype).expand(1, sq, h, d)
        cases.append({"case": f"ltx2_{name}_fully_masked_row_vs_mean_of_v", **agreement(out[:1], mean)})
    emit({"phase": "ltx2", "check": "fully_masked_rows", "cases": cases})
    check(all(c["within"] for c in cases), f"LTX-2: fully masked rows: {cases}")
    release()


def ltx2_reference():
    """The LTX-2 DiT at full width with 2 blocks, card (bf16, the kernel)
    against CPU (f32, the plain version): 3 latent frames of 8 x 12 tokens with
    per-token timesteps (the first frame's held at 0), 13 audio tokens and 128
    text rows (batch 0 fully masked, batch 1 keeping 40), the video and audio
    outputs within BF16_REL_L2; the video VAE's decode of a seeded 2 x 4 x 6
    latent against float64; the latent upsampler in f32 on the card against
    the CPU within F32_REL_L2 (``ltx2_upsampler_check``)."""
    import numpy as np
    import torch
    import yaml

    from apex_studio_tpu_torch.models.transformers import ltx2
    from apex_studio_tpu_torch.models.vaes import ltx2_vae

    cfg = next(c for c in yaml.safe_load(LTX2_MANIFEST.read_text())["spec"]["components"]
               if c["type"] == "transformer")["config"]
    rng = np.random.default_rng(310)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    s = 3 * 8 * 12
    t = torch.full((2, s), 0.7)
    t[:, :96] = 0.0
    mask = torch.zeros(2, 128)
    mask[1, :40] = 1.0
    card_vs_cpu("ltx2.base 32 heads of 128 (audio 32 of 64), 2 blocks",
                lambda dt: ltx2.LTX2VideoTransformer3D(ltx2.LTX2Config.from_dict(dict(cfg, num_layers=2)), dtype=dt),
                lambda m, x, xa, tt, c, ca, msk: torch.cat([o.flatten() for o in m(
                    x, xa, tt, c, video_shape=(3, 8, 12), fps=25.0, ctx_audio=ca, ctx_mask=msk)]),
                (tensor(2, s, 128), tensor(2, 13, 128), t, tensor(2, 128, 3840), tensor(2, 128, 3840), mask),
                BF16_REL_L2, 311, phase="ltx2")
    vae = materialize_random_vae(lambda: ltx2_vae.AutoencoderKLLTX2(ltx2_vae.LTX2VAEConfig.from_dict(
        ltx2_vae_config())), seed=312)
    z = torch.randn(1, 128, 2, 4, 6, generator=torch.Generator("cuda").manual_seed(313), device="cuda")
    vae_vs_float64("ltx2", "ltx2.base VAE", vae, z, (1, 3, 9, 128, 192))
    del vae
    release()


def ltx2_upsampler_check(engine, lats):
    """The published latent upsampler (2x spatial, the rational resampler)
    with seeded weights in f32 on the card over ``lats`` (a request's latents,
    the VAE's statistics around it) against the same module on the CPU."""
    import torch

    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models import ltx2_upsampler

    build = lambda: ltx2_upsampler.LTXLatentUpsampler(  # noqa: E731
        ltx2_upsampler.LTX2UpsamplerConfig.from_dict(LTX2_UPSAMPLER), dtype=torch.float32)
    card = materialize_random(build, torch.device("cuda"), seed=314, std=0.02)
    with torch.no_grad():  # the group norms at scale 1, shift 0 (a random scale shrinks every activation)
        for m in card.modules():
            if isinstance(m, ltx2_upsampler._GroupNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
    cpu = materialize_random(build, torch.device("cpu"), seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ltx2_upsampler.upsample_latents(lats, engine.vae, card)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    out, lats_cpu, vae = out.float().cpu(), lats.float().cpu(), engine.vae
    del card
    release()

    def compare():
        with torch.inference_mode():  # the VAE's statistics built on the CPU
            ref = ltx2_upsampler.upsample_latents(lats_cpu, vae, cpu)
        row = {"phase": "ltx2", "check": "upsampler_card_f32_vs_cpu_f32", "latent": list(lats_cpu.shape),
               "upsampled": list(out.shape), "card_seconds": card_s, "rel_l2": rel_l2(out, ref),
               "tol_rel_l2": F32_REL_L2, "finite": bool(torch.isfinite(out).all())}
        emit(row)
        check(row["finite"] and row["rel_l2"] <= F32_REL_L2 and list(out.shape) == [
            *lats_cpu.shape[:3], 2 * lats_cpu.shape[3], 2 * lats_cpu.shape[4]],
            f"LTX-2 upsampler on the card against the CPU: {row}")

    in_background(compare)


_LTX2_STEP = re.compile(r"denoise step (\d+)/(\d+)")


def ltx2_drive(label, engine, kw, launches, frames_expected=None, latents_expected=None):
    """One request through ``engine`` with the kernel's count set to 0 before
    and read after (``launches`` expected), seconds per step, peak GiB; the
    frames (count, 512x768 size), the waveform (stereo, the vocoder's rate,
    its length) or the latents (shape) checked finite. Returns (row, output)."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    os.environ["APEX_HOME_DIR"] = str(Path(engine.components_root).parent)
    stamps = []

    def progress(p, message, *_a, **_k):
        torch.cuda.synchronize()
        stamps.append((message, time.perf_counter()))

    engine.decoded.clear()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    out = engine.run(progress_callback=progress, **kw)
    torch.cuda.synchronize()
    total, n_launch = time.perf_counter() - t0, flash_attention.launches
    times = [t0] + [t for _, t in stamps]
    per_step = [times[i + 1] - times[i] for i, (m, _) in enumerate(stamps) if _LTX2_STEP.fullmatch(m)]
    row = {"phase": "ltx2", "path": label, "model_type": engine.model_type,
           "request": {k: (v if isinstance(v, (int, float, str)) else list(np.shape(v))) for k, v in kw.items()},
           "seconds_total": total, "seconds_per_step": per_step,
           "stages": {m: t - t0 for m, t in dict(reversed(stamps)).items() if not _LTX2_STEP.fullmatch(m)},
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "flash_launches": n_launch,
           "flash_launches_expected": launches}
    outs = out if isinstance(out, tuple) else (out,)
    latents = [o for o in outs if isinstance(o, torch.Tensor)] + engine.decoded
    row["latents"] = [list(z.shape) for z in latents]
    row["latents_finite"] = all(bool(torch.isfinite(z).all()) for z in latents)
    if frames_expected is not None:
        frames, wave, rate = out
        row.update(frames=len(frames), frame_shape=list(frames[0].shape), waveform=list(wave.shape),
                   sample_rate=rate, waveform_finite=bool(np.isfinite(wave).all()))
    emit(row)
    check(row["latents_finite"], f"{label}: latents not finite")
    check(n_launch == launches, f"{label}: flash launched {n_launch} times, expected {launches}")
    if latents_expected is not None:
        check(row["latents"] == [list(s) for s in latents_expected],
              f"{label}: latents {row['latents']}, expected {latents_expected}")
    if frames_expected is not None:
        frames_s = frames_expected / float(kw["fps"])
        check(len(frames) == frames_expected and all(f.shape == (512, 768, 3) and f.dtype == np.uint8
                                                     for f in frames), f"{label}: frames {row}")
        # 100 mel frames a second, 4 a latent frame; the vocoder's 240 samples a mel frame
        check(rate == 24000 and wave.shape[0] == 2 and row["waveform_finite"]
              and abs(wave.shape[1] / rate - frames_s) <= 0.2, f"{label}: waveform {row}")
    return row, out


def ltx2_full_depth(engine) -> dict:
    """The DiT at all 48 blocks over the default request's 6144 video and 121
    audio tokens with CFG (B = 2: a zero context with an all-zero mask beside
    the prompt's connector rows), per-token timesteps: one forward timed with
    its launches (6 a block) and the peak GiB."""
    import torch

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    tf = engine.transformer
    ctx, ctx_a, mask = engine._encode_prompt(WAN_PROMPT)
    ctx_b = torch.cat([torch.zeros_like(ctx), ctx]).to(tf.dtype)
    ctxa_b = torch.cat([torch.zeros_like(ctx_a), ctx_a]).to(tf.dtype)
    mask_b = torch.cat([torch.zeros_like(mask), mask])
    g = torch.Generator("cuda").manual_seed(315)
    x = torch.randn(2, LTX2_TOKENS, 128, generator=g, device="cuda").to(tf.dtype)
    xa = torch.randn(2, LTX2_AUDIO, 128, generator=g, device="cuda").to(tf.dtype)
    t = torch.full((2, LTX2_TOKENS), 0.9, device="cuda")
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, a = tf(x, xa, t, ctx_b, video_shape=(16, 16, 24), fps=25.0, t_audio=t[:, 0], ctx_audio=ctxa_b,
                  ctx_mask=mask_b)
        torch.cuda.synchronize()
        first_s, launches = time.perf_counter() - t0, flash_attention.launches
        t0 = time.perf_counter()  # again, the RoPE tables of the grid now cached
        tf(x, xa, t, ctx_b, video_shape=(16, 16, 24), fps=25.0, t_audio=t[:, 0], ctx_audio=ctxa_b, ctx_mask=mask_b)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
    row = {"phase": "ltx2", "check": "full_depth_forward", "blocks": len(tf.blocks), "dim": tf.cfg.inner_dim,
           "audio_dim": tf.cfg.audio_inner_dim, "parameters": sum(p.numel() for p in tf.parameters()),
           "dtype": str(tf.dtype), "video_tokens": LTX2_TOKENS, "audio_tokens": LTX2_AUDIO, "text_rows": LTX2_TEXT,
           "first_forward_seconds": first_s, "forward_seconds": forward_s, "flash_launches": launches,
           "flash_launches_expected": 6 * 48, "out_shapes": [list(v.shape), list(a.shape)],
           "finite": bool(torch.isfinite(v).all() and torch.isfinite(a).all()),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "resident_gib": torch.cuda.memory_allocated() / 2**30}
    emit(row)
    check(len(tf.blocks) == 48 and tf.cfg.inner_dim == 4096 and row["finite"]
          and row["out_shapes"] == [[2, LTX2_TOKENS, 128], [2, LTX2_AUDIO, 128]], f"the LTX-2 full-depth forward: {row}")
    check(launches == 6 * 48, f"the full-depth LTX-2 forward launched the kernel {launches} times")
    return row


def ltx2_requests(home: Path):
    """LTX-2 from its manifest at full width in bf16 (Gemma-3 12B and the
    connectors bf16, the video VAE bf16, the audio VAE and vocoder f32): the
    full-depth forward (``ltx2_full_depth``), then the DiT cut to its first
    LTX2_LAYERS blocks and the four types, LTX2_STEPS steps, CFG 4: t2v at the
    manifest's 512x768 over 121 frames with no negative prompt (seeds 0, 0, 1;
    the first decoded to frames and a waveform); then 17-frame requests: i2v
    from a seeded image (its first latent frame pinned across seeds),
    multimodal guidance (STG on block LTX2_STG_BLOCK, the isolated-modality
    pass at 1.5, the std rescale 0.5, a negative prompt), IC-LoRA (two
    keyframe images and a 17-frame conditioning video) and keyframe
    interpolation (two keyframes, decoded); the upsampler on the i2v latents."""
    import numpy as np
    import torch
    from torch import nn

    configs = {"video_vae": ltx2_vae_config(), "connectors": LTX2_CONNECTORS, "audio_vae": LTX2_AUDIO_VAE,
               "vocoder": LTX2_VOCODER, "text_encoder": GEMMA3_12B}
    base = video_rest_engine(LTX2_MANIFEST, "ti2v", home, configs, "ltx2")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # The 35 GiB bf16 DiT fits beside Gemma-3 and the rest (about 62 GiB), but the memory fallback's gate reads
    # the free memory after the DiT is resident (as the JAX gate does) and would make it int8 (ROADMAP Queue 3):
    # a user who wants the manifests' bf16 turns the fallback off, and so does this phase. The gate's reading is
    # kept (``memory_fallback_gate``).
    saved = os.environ.get("APEX_MEMORY_FALLBACK")
    os.environ["APEX_MEMORY_FALLBACK"] = "off"
    try:
        base.load_missing("text_encoder", "vae", "transformer", "scheduler")
    finally:
        if saved is None:
            del os.environ["APEX_MEMORY_FALLBACK"]
        else:
            os.environ["APEX_MEMORY_FALLBACK"] = saved
    base._get_connectors()
    base.text_encoder._ensure_model()
    load = {"phase": "ltx2", "load_seconds": time.perf_counter() - t0, "reckoned_gib": {
        k: v / 2**30 for k, v in base.reckoned_bytes.items()}, "resident_gib": torch.cuda.memory_allocated() / 2**30,
        "memory_fallback_gate": base.gate}
    emit(load)
    full = ltx2_full_depth(base)
    tf = base.transformer
    tf.blocks = nn.ModuleList(list(tf.blocks[:LTX2_LAYERS]))
    release()
    engines = {"ti2v": base}
    for model_type in ("multimodal_guidance", "ic_lora", "keyframe_interpolation"):
        engines[model_type] = video_rest_engine(LTX2_MANIFEST, model_type, home, configs, "ltx2", share=base)
        engines[model_type].helpers = base.helpers
    forward, layers, steps = 6 * LTX2_LAYERS, LTX2_LAYERS, LTX2_STEPS
    encode = 4  # the two connector stacks of two layers, at each prompt's encode
    kw = dict(prompt=WAN_PROMPT, height=512, width=768, duration=5.0, fps=25, num_inference_steps=steps,
              guidance_scale=4.0)
    short = dict(kw, duration=None, num_frames=17, return_latents=True)
    lat, lat_short = (1, 128, 16, 16, 24), (1, 128, 3, 16, 24)
    rows = {}
    row1, _ = ltx2_drive("ltx2_t2v", base, dict(kw, seed=0), encode + steps * forward, frames_expected=121,
                         latents_expected=[lat])
    first = base.decoded[0]
    row2, again = ltx2_drive("ltx2_t2v", base, dict(kw, seed=0, return_latents=True), encode + steps * forward,
                             latents_expected=[lat])
    row3, other = ltx2_drive("ltx2_t2v", base, dict(kw, seed=1, return_latents=True), encode + steps * forward,
                             latents_expected=[lat])
    same, differ = bool(torch.equal(first, again)), not torch.equal(first, other)
    emit({"phase": "ltx2", "path": "ltx2_t2v", "seeds_0_0_identical": same, "seeds_0_1_differ": differ})
    check(same and differ, f"LTX-2 t2v: seeds 0, 0 identical {same}, seeds 0, 1 differ {differ}")
    rows["t2v"] = [row1, row2, row3]
    del first, again, other

    image = cv2_smooth(np.random.default_rng(316), (512, 768))
    i2v = []
    for seed in (0, 1):
        row, out = ltx2_drive("ltx2_i2v", base, dict(short, image=image, seed=seed), encode + steps * forward,
                              latents_expected=[lat_short])
        i2v.append((row, out))
    pinned = bool(torch.equal(i2v[0][1][:, :, 0], i2v[1][1][:, :, 0]))
    emit({"phase": "ltx2", "path": "ltx2_i2v", "first_latent_frame_pinned_across_seeds": pinned})
    check(pinned, "LTX-2 i2v: the first latent frame differs across seeds")
    rows["i2v"] = [r for r, _ in i2v]
    ltx2_upsampler_check(base, i2v[0][1])

    mm = dict(short, negative_prompt=VIDEO_REST_NEG, seed=0, stg_blocks=[LTX2_STG_BLOCK], modality_scale=1.5,
              guidance_rescale=0.5)
    # a step: the CFG forward, the STG pass (block 1's two self launches skipped), the pass without AV cross
    rows["multimodal_guidance"] = [ltx2_drive(
        "ltx2_multimodal_guidance", engines["multimodal_guidance"], mm,
        2 * encode + steps * (forward + (forward - 2) + 4 * layers), latents_expected=[lat_short])[0]]
    keys = [cv2_smooth(np.random.default_rng(s), (512, 768)) for s in (317, 318)]
    clip, _ = disk_clip(17, 512, 768, seed=319)
    rows["ic_lora"] = [ltx2_drive("ltx2_ic_lora", engines["ic_lora"], dict(
        short, seed=0, image=keys, image_pixel_frame_indices=[0, 16], image_strengths=[1.0, 0.8],
        conditioning_video=clip, conditioning_video_strength=0.9), encode + steps * forward,
        latents_expected=[lat_short])[0]]
    rows["keyframe_interpolation"] = [ltx2_drive("ltx2_keyframe_interpolation", engines["keyframe_interpolation"],
                                                 dict(short, seed=0, image=keys, image_pixel_frame_indices=[0, 16],
                                                      return_latents=False),
                                                 encode + steps * forward, latents_expected=[lat_short])[0]]
    te = base.text_encoder._ensure_model()
    facts = {"phase": "ltx2", "dit_dim": tf.cfg.inner_dim, "dit_requests_blocks": len(tf.blocks),
             "dit_dtype": str(tf.dtype), "gemma3_layers": te.cfg.num_hidden_layers, "gemma3_hidden": te.cfg.hidden_size,
             "connectors_parameters": sum(p.numel() for p in base.helpers["connectors"].parameters()),
             "vae_dtype": str(next(base.vae.parameters()).dtype),
             "audio_vae_dtype": str(next(base.helpers["audio_vae"].parameters()).dtype),
             "text_encoder_released": base.text_encoder.model is None, "memory_fallback_gate": base.gate,
             "full_depth_peak_gib": full["peak_gib"], "peak_gib": max(r["peak_gib"] for rs in rows.values() for r in rs)}
    emit(facts)
    check(tf.cfg.inner_dim == 4096 and te.cfg.hidden_size == 3840 and te.cfg.num_hidden_layers == 48
          and not dit_bits(tf), f"the LTX-2 widths: {facts}")
    del engines, base, tf, te
    release()
    return {f"ltx2_{t}": rs for t, rs in rows.items()}


def phase_ltx2(home: Path):
    """LTX-2: the kernel at its seven launch shapes and the fully masked rows,
    the 2-block DiT against f32 and the VAE against float64
    (``ltx2_reference``), then the full-depth forward and the requests of the
    four types (``ltx2_requests``)."""
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    rows, err = path_kernel_rows("ltx2", ltx2_kernel_inputs())
    ltx2_masked_rows()
    lap("kernel_rows")
    ltx2_reference()
    lap("card_vs_cpu")
    paths = ltx2_requests(home)
    lap("requests")
    emit({"phase": "ltx2", "seconds_by_step": seconds})
    return paths, rows, err


# -- MAGI-1 and FlashVSR 1.1 ---------------------------------------------------------------


MAGI_MANIFEST = REPO / "manifests" / "video" / "magi-1-t2v.yml"
FLASHVSR_MANIFESTS = {kind: REPO / "manifests" / "upscalers" / f"flashvsr-1.1-{kind}.yml" for kind in ("full", "tiny")}
# MAGI-1 4.5B as the manifest writes it (34 layers, 24 heads of 128 over 8 KV groups, FFN 12288, half-channel
# VAE latents); at 480x832 a chunk of 6 latent frames is 6 x 30 x 52 = 9360 tokens, the default window of 4
# chunks 37,440
MAGI_TRANSFORMER = {"num_layers": 34, "num_attention_heads": 24, "attention_head_dim": 128, "ffn_dim": 12288,
                    "num_query_groups": 8, "in_channels": 32, "out_channels": 32, "patch_size": 2, "t_patch_size": 1,
                    "caption_channels": 4096, "caption_max_length": 800, "cond_hidden_ratio": 0.25,
                    "xattn_cond_hidden_ratio": 1.0, "half_channel_vae": True}
MAGI_CHUNK, MAGI_WINDOW, MAGI_CAPTION, MAGI_CAPTION_KEPT = 6 * 30 * 52, 4, 800, 120
# the ViT VAE's decode of the default 96 frames: 24 latent frames of 60 x 104 and the cls token, 12 heads of 64
MAGI_VAE_TOKENS = 24 * 60 * 104 + 1
MAGI_LAYERS = 4  # of the published 34: the requests' cut of depth (one forward runs all 34)
MAGI_VAE_DEPTH = 12
# the requests: 3 chunks (72 frames) with a window of 2, one step a stage: 4 stages of text, previous-chunk and
# unconditional forwards over 1 + 1 + 1, 2 + 2 + 1, 3 + 3 + 1 and 3 + 3 + 1 chunks; a forward launches one
# self-attention a chunk (one with a single chunk) and one cross-attention a layer: 34 launches a layer; v2v
# from a one-chunk clip, 3 stages: 28 a layer
MAGI_REQUEST = dict(height=480, width=832, num_frames=72, num_inference_steps=2, chunk_width=6, window_size=2,
                    cfg_number=3)
MAGI_STEP = re.compile(r"magi stage (\d+) step (\d+)/(\d+)")
# Wan 2.1 1.3B's widths at full depth (the manifests' inline config), the LQ projector; 41 frames of 160 x 320
# upscaled x4 to 640 x 1280: 10 latent frames of 40 x 80 tokens in three streaming chunks (6, 2, 2 frames)
FLASHVSR_FRAMES, FLASHVSR_SIZE, FLASHVSR_OUT = 41, (160, 320), (640, 1280)
FLASHVSR_FRAME_TOKENS = 40 * 80
FLASHVSR_STEP = re.compile(r"FlashVSR chunk (\d+)/(\d+)")
FLASHVSR_CONFIG = {"patch_size": [1, 2, 2], "in_dim": 16, "dim": 1536, "ffn_dim": 8960, "freq_dim": 256,
                   "text_dim": 4096, "out_dim": 16, "num_heads": 12, "num_layers": 30, "eps": 1e-6,
                   "lq4x_proj_in_dim": 3, "lq4x_proj_out_dim": 1536, "lq4x_proj_layer_num": 1}


def magi_kernel_inputs():
    """(case, q, k, v, bias): the block-causal self-attention's chunk launches
    at the default window (chunk i's 9360 queries against 9360·(i + 1) keys,
    24 heads of 128), the cross-attention over the window's 4 chunks as batch
    rows against the 800 caption rows (a 120-token prompt kept), the VAE's
    149,761-token launch at 12 heads of 64 (bf16, as the manifest resolves
    the VAE)."""
    import torch

    for i in range(MAGI_WINDOW):
        yield (f"magi_self_chunk{i}_sq{MAGI_CHUNK}_sk{MAGI_CHUNK * (i + 1)}_h24",
               *qkv(1, MAGI_CHUNK, MAGI_CHUNK * (i + 1), 24, 128, 330 + i), None)
    bias = torch.zeros(MAGI_WINDOW, MAGI_CAPTION, device="cuda")
    bias[:, MAGI_CAPTION_KEPT:] = -1e30
    yield (f"magi_cross_b{MAGI_WINDOW}_sq{MAGI_CHUNK}_sk{MAGI_CAPTION}_h24",
           *qkv(MAGI_WINDOW, MAGI_CHUNK, MAGI_CAPTION, 24, 128, 334), bias)
    yield (f"magi_vae_s{MAGI_VAE_TOKENS}_h12_d64", *qkv(1, MAGI_VAE_TOKENS, MAGI_VAE_TOKENS, 12, 64, 335), None)


def magi_block_causal_rows():
    """``block_causal_attention`` over the default window (4 chunks of 9360
    rows, 24 heads of 128): 4 launches, and rows at each chunk's first and
    last tile and across each chunk edge against the plain attention under
    the explicit block-causal [S, S] mask over every key."""
    import torch

    from apex_studio_tpu_torch.models.transformers.magi import block_causal_attention
    from apex_studio_tpu_torch.ops.attention import naive_attention
    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    s = MAGI_CHUNK * MAGI_WINDOW
    q, k, v = qkv(1, s, s, 24, 128, 336)
    before = flash_attention.launches
    out = block_causal_attention(q, k, v, MAGI_WINDOW)
    torch.cuda.synchronize()
    launched = flash_attention.launches - before
    chunk_of = torch.arange(s, device="cuda") // MAGI_CHUNK
    cases = []
    for i in range(MAGI_WINDOW):
        a, b = i * MAGI_CHUNK, (i + 1) * MAGI_CHUNK
        for part, rows in (("first_tile", slice(a, a + 128)), ("last_tile", slice(b - 128, b)),
                           ("chunk_edge", slice(max(a - 64, 0), a + 64))):
            bias = torch.where(chunk_of[rows, None] >= chunk_of[None, :], 0.0, -1e30)[None, None]
            agree = agreement(out[:, rows], naive_attention(q[:, rows], k, v, bias=bias))
            finite = bool(torch.isfinite(out[:, rows].float()).all())
            cases.append({"case": f"magi_block_causal_s{s}_chunk{i}_{part}", "shape": list(q.shape), "sk": s,
                          "rows": [rows.start, rows.stop], "bias": "explicit [S, S] block-causal mask", **agree,
                          "finite": finite, "ok": finite and agree["within"]})
    emit({"phase": "kernels", "path": "magi", "block_causal_launches": launched, "cases": cases})
    check(launched == MAGI_WINDOW, f"the block-causal attention launched the kernel {launched} times")
    bad = [c["case"] for c in cases if not c["ok"]]
    check(not bad, f"the block-causal launches disagree with the explicit mask: {bad}")
    del q, k, v, out
    release()
    return max(c["max_abs_err"] for c in cases)


def magi_reference():
    """The DiT at full width with 2 blocks, block-causal over 3 chunks of 2
    latent frames of 8 x 8 tokens (the first a clean context chunk) against
    64 caption rows (40 kept), card (bf16, the kernel) against CPU (f32, the
    plain version) within BF16_REL_L2; the ViT VAE's decode of a 2 x 8 x 8
    latent likewise within 2e-2."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.models.transformers import magi
    from apex_studio_tpu_torch.models.vaes import magi_vae

    rng = np.random.default_rng(337)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    mask = torch.zeros(1, 3, 64, dtype=torch.bool)
    mask[..., :40] = True
    card_vs_cpu("magi.base 24 heads of 128 over 8 groups, 2 blocks",
                lambda dt: magi.MagiTransformer3DModel(magi.MagiConfig.from_dict(
                    dict(MAGI_TRANSFORMER, num_layers=2)), dtype=dt),
                lambda m, x, t, y, msk: m(x, t, y, msk),
                (tensor(1, 16, 6, 16, 16), torch.tensor([[0.9999, 0.5, 0.2]]), tensor(1, 3, 64, 4096), mask),
                BF16_REL_L2, 338, phase="magi")
    card_vs_cpu("magi.base ViT VAE decode", lambda dt: magi_vae.AutoencoderKLMagi(magi_vae.MagiVAEConfig(),
                                                                                 dtype=dt),
                lambda m, z: m.decode(z), (tensor(1, 16, 2, 8, 8),), 2e-2, 339, phase="magi")


def magi_full_depth(engine) -> dict:
    """The DiT at all 34 layers over the default window at 480x832 (4 chunks
    of 9360 tokens, 37,440 in all, block-causal, the prompt's T5 rows a chunk):
    two forwards, the first with its launches counted (4 self + 1 cross a
    layer: 170); seconds, peak GiB, and the attention's share of the second
    from the kernel rows' queued times."""
    import torch

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    tf = engine.transformer
    g = torch.Generator("cuda").manual_seed(340)
    x = torch.randn(1, 16, 6 * MAGI_WINDOW, 60, 104, generator=g, device="cuda")
    t = torch.tensor([[0.9999, 0.62, 0.31, 0.05]], device="cuda")
    ctx, mask = engine.encode_prompt(WAN_PROMPT)
    y = ctx[:, None].expand(1, MAGI_WINDOW, *ctx.shape[1:])
    m = mask[:, None].expand(1, MAGI_WINDOW, mask.shape[-1])
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tf(x, t, y, m)
        torch.cuda.synchronize()
        first_s, launches = time.perf_counter() - t0, flash_attention.launches
        t0 = time.perf_counter()
        tf(x, t, y, m)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
    row = {"phase": "magi", "check": "full_depth_forward", "blocks": len(tf.blocks), "dim": tf.cfg.dim,
           "heads": tf.cfg.num_attention_heads, "query_groups": tf.cfg.num_query_groups,
           "parameters": sum(p.numel() for p in tf.parameters()), "dtype": str(tf.dtype),
           "tokens": MAGI_CHUNK * MAGI_WINDOW, "chunks": MAGI_WINDOW, "caption_rows_kept": int(mask.sum().item()),
           "first_forward_seconds": first_s, "forward_seconds": forward_s, "flash_launches": launches,
           "flash_launches_expected": 34 * (MAGI_WINDOW + 1), "out_shape": list(out.shape),
           "finite": bool(torch.isfinite(out).all()), "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    check(len(tf.blocks) == 34 and tf.cfg.dim == 3072 and row["finite"]
          and row["out_shape"] == [1, 16, 6 * MAGI_WINDOW, 60, 104], f"the MAGI-1 full-depth forward: {row}")
    check(launches == 34 * (MAGI_WINDOW + 1), f"the full-depth MAGI-1 forward launched the kernel {launches} times")
    return row


def magi_decode_96(engine) -> dict:
    """The VAE's decode of seeded latents for the manifest's default 96 frames
    at 480x832 (24 latent frames: one 149,761-token launch a block), timed,
    its launches and peak GiB."""
    import torch

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    z = torch.randn(1, 16, 24, 60, 104, generator=torch.Generator("cuda").manual_seed(341), device="cuda")
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        video = engine.vae.decode(z)
        torch.cuda.synchronize()
        seconds, launches = time.perf_counter() - t0, flash_attention.launches
    row = {"phase": "magi", "check": "vae_decode_96_frames", "latent": list(z.shape), "pixels": list(video.shape),
           "tokens": MAGI_VAE_TOKENS, "vae_dtype": str(next(engine.vae.decoder.core.blocks.parameters()).dtype),
           "seconds": seconds, "flash_launches": launches, "flash_launches_expected": MAGI_VAE_DEPTH,
           "finite": bool(torch.isfinite(video).all()), "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(row)
    check(row["pixels"] == [1, 3, 96, 480, 832] and row["finite"] and launches == MAGI_VAE_DEPTH,
          f"the MAGI-1 96-frame decode: {row}")
    del video
    release()
    return row


def magi_requests(home: Path):
    """MAGI-1 from its manifest at full width in bf16 (T5-XXL, whose config the
    phase writes; the ViT VAE as the manifest resolves it): the full-depth
    forward (``magi_full_depth``), the 96-frame decode (``magi_decode_96``),
    then the DiT cut to its first MAGI_LAYERS layers and t2v (seeds 0, 0, 1;
    the first decoded), i2v from a seeded image and v2v continuing a seeded
    24-frame clip (one whole chunk), each at MAGI_REQUEST."""
    import numpy as np
    import torch
    from torch import nn

    configs = {"text_encoder": T5_XXL}
    base = video_rest_engine(MAGI_MANIFEST, "t2v", home, configs, "magi")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base.load_components()
    emit({"phase": "magi", "load_seconds": time.perf_counter() - t0,
          "reckoned_gib": {k: v / 2**30 for k, v in base.reckoned_bytes.items()},
          "resident_gib": torch.cuda.memory_allocated() / 2**30, "memory_fallback_gate": base.gate})
    full = magi_full_depth(base)
    decode = magi_decode_96(base)
    tf = base.transformer
    tf.blocks = nn.ModuleList(list(tf.blocks[:MAGI_LAYERS]))
    release()
    engines = {"t2v": base, **{mt: video_rest_engine(MAGI_MANIFEST, mt, home, configs, "magi", share=base)
                               for mt in ("i2v", "v2v")}}
    kw = dict(MAGI_REQUEST, prompt=WAN_PROMPT, negative_prompt=VIDEO_REST_NEG)
    lat, frames, size, vae = (1, 16, 18, 60, 104), 72, (480, 832), MAGI_VAE_DEPTH
    rows = {"t2v": seed_pair("magi_t2v", base, kw, 34 * MAGI_LAYERS + vae, lat, frames, size, phase="magi",
                             step=MAGI_STEP, latent_launches=34 * MAGI_LAYERS)[0]}
    image = cv2_smooth(np.random.default_rng(342), (512, 896))
    row, out = video_rest_drive("magi_i2v", engines["i2v"], dict(kw, image=image, seed=0, return_latents=True),
                                34 * MAGI_LAYERS + vae, latents_expected=[lat], phase="magi", step=MAGI_STEP)
    rows["i2v"] = [row]
    clip, _ = disk_clip(24, 480, 832, seed=343)
    row, frames_out = video_rest_drive("magi_v2v", engines["v2v"], dict(kw, video=clip, seed=0),
                                       28 * MAGI_LAYERS + 2 * vae, frames, size, [lat], phase="magi",
                                       step=MAGI_STEP)
    rows["v2v"] = [row]
    facts = {"phase": "magi", "dit_dim": tf.cfg.dim, "dit_requests_layers": len(tf.blocks), "dit_dtype": str(tf.dtype),
             "t5_d_model": base.text_encoder._ensure_model().cfg.d_model,
             "vae_dtype": str(next(base.vae.decoder.core.blocks.parameters()).dtype),
             "i2v_first_latent_frame_finite": bool(torch.isfinite(out[:, :, 0]).all()),
             "full_depth_peak_gib": full["peak_gib"], "decode_96_peak_gib": decode["peak_gib"],
             "peak_gib": max(r["peak_gib"] for rs in rows.values() for r in rs)}
    emit(facts)
    check(tf.cfg.dim == 3072 and facts["t5_d_model"] == 4096 and not dit_bits(tf), f"the MAGI-1 widths: {facts}")
    del engines, base, tf, out, frames_out
    release()
    return {f"magi_{t}": rs for t, rs in rows.items()}, full


def phase_magi(home: Path):
    """MAGI-1: the kernel at the chunk launches, the cross launch and the VAE's
    149,761-token launch (``magi_kernel_inputs``), the block-causal launches
    against the explicit mask (``magi_block_causal_rows``), the 2-block DiT
    and the VAE against f32 (``magi_reference``), then the full-depth forward,
    the 96-frame decode and the t2v, i2v and v2v requests (``magi_requests``);
    the attention's share of the full-depth forward from the kernel rows."""
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    rows, err = path_kernel_rows("magi", magi_kernel_inputs())
    err = max(err, magi_block_causal_rows())
    lap("kernel_rows")
    magi_reference()
    lap("card_vs_cpu")
    paths, full = magi_requests(home)
    lap("requests")
    attention_ms = 34 * sum(r["queued_ms"] for r in rows if not r["case"].startswith("magi_vae"))
    emit({"phase": "magi", "seconds_by_step": seconds, "full_depth_attention_ms_from_rows": attention_ms,
          "full_depth_attention_share": attention_ms / 1e3 / full["forward_seconds"]})
    return paths, rows, err


def flashvsr_kernel_inputs():
    """(case, q, k, v, bias): FlashVSR at 640x1280 (40 x 80 tokens a latent
    frame, 12 heads of 128): the first chunk's self-attention (6 frames
    alone), a later chunk's (2 frames against the 6-frame cache and
    themselves), and the cross-attention of each against the 512 context
    rows, unmasked as in JAX."""
    first, later = 6 * FLASHVSR_FRAME_TOKENS, 2 * FLASHVSR_FRAME_TOKENS
    yield (f"flashvsr_self_first_s{first}_h12", *qkv(1, first, first, 12, 128, 350), None)
    yield (f"flashvsr_self_cached_sq{later}_sk{first + later}_h12", *qkv(1, later, first + later, 12, 128, 351), None)
    yield (f"flashvsr_cross_sq{first}_sk512_h12", *qkv(1, first, 512, 12, 128, 352), None)
    yield (f"flashvsr_cross_sq{later}_sk512_h12", *qkv(1, later, 512, 12, 128, 353), None)


def flashvsr_reference():
    """The DiT at full width with 2 blocks over two streaming chunks (6 latent
    frames, then 2 against the cache; 4 x 4 tokens a frame) with the LQ
    projector's features, card (bf16) against CPU (f32) within BF16_REL_L2;
    the TCDecoder (``tiny_wan`` at the tiny manifest's widths) decoding 3
    latent frames of 8 x 8 with its 9-frame LQ condition likewise within 2e-2."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.models.transformers import flashvsr
    from apex_studio_tpu_torch.models.vaes import tae_vae

    rng = np.random.default_rng(354)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def two_chunks(m, noise, video, context):
        t, t_mod = m.time_embed(1000.0)
        ctx_kv, lq = m.context_kv(context), m.LQ_proj_in(video)
        caches, preds = None, []
        for a, b in ((0, 6), (6, 8)):
            cos, sin = m.rope_for_chunk(b - a, 4, 4, a)
            pred, caches = m(noise[:, :, a:b], t, t_mod, cos, sin, ctx_kv,
                             lq_tokens=[x[:, a * 16:b * 16] for x in lq], caches=caches)
            preds.append(pred)
        return torch.cat(preds, dim=2)

    card_vs_cpu("wan.flashvsr 12 heads of 128, 2 blocks, two chunks",
                lambda dt: flashvsr.FlashVSRTransformer3DModel(flashvsr.FlashVSRConfig.from_dict(
                    dict(FLASHVSR_CONFIG, num_layers=2)), dtype=dt), two_chunks,
                (tensor(1, 16, 8, 8, 8), torch.rand(1, 3, 33, 64, 64, generator=torch.Generator().manual_seed(355))
                 * 2 - 1, tensor(1, 512, 4096) * 0.1), BF16_REL_L2, 356, phase="flashvsr")
    import yaml

    tiny = next(c for c in yaml.safe_load(FLASHVSR_MANIFESTS["tiny"].read_text())["spec"]["components"]
                if c["type"] == "vae")["config"]
    card_vs_cpu("tiny_wan TCDecoder decode with its LQ condition",
                lambda dt: tae_vae.TinyWanVAE(tae_vae.TAEConfig.from_dict(tiny), dtype=dt),
                lambda m, z, cond: m.decode(z, cond=cond),
                (tensor(1, 16, 3, 8, 8), torch.rand(1, 3, 9, 64, 64, generator=torch.Generator().manual_seed(357))
                 * 2 - 1), 2e-2, 358, phase="flashvsr")


def flashvsr_requests(home: Path):
    """Both FlashVSR 1.1 manifests at Wan 2.1 1.3B's widths and full depth
    (30 layers, the LQ projector), bf16 as they resolve: 41 seeded frames of
    160x320, x4 to 640x1280 (10 latent frames, three streaming chunks, the
    cache used and trimmed), 2 launches a block and chunk; the full manifest
    through the Wan 2.1 VAE with seeds 0, 0, 1 (the first decoded), the tiny
    one through the TCDecoder with the LQ condition. Seconds a chunk, peak GiB."""
    import torch

    full = video_rest_engine(FLASHVSR_MANIFESTS["full"], "upscale", home, {}, "flashvsr")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full.load_missing("transformer", "vae")
    emit({"phase": "flashvsr", "load_seconds": time.perf_counter() - t0,
          "reckoned_gib": {k: v / 2**30 for k, v in full.reckoned_bytes.items()},
          "resident_gib": torch.cuda.memory_allocated() / 2**30})
    tiny = video_rest_engine(FLASHVSR_MANIFESTS["tiny"], "upscale", home, {}, "flashvsr")
    tiny.transformer = full.transformer
    tiny.load_missing("vae")
    clip, _ = disk_clip(FLASHVSR_FRAMES, *FLASHVSR_SIZE, seed=359)
    launches = 3 * 2 * 30
    frames = 4 * 10 - 3
    rows, first, _, _ = seed_pair("flashvsr_full", full, dict(video=clip), launches, (1, 16, 10, 80, 160), frames,
                                  FLASHVSR_OUT, phase="flashvsr", step=FLASHVSR_STEP)
    row, out = video_rest_drive("flashvsr_tiny", tiny, dict(video=clip, seed=0), launches, frames, FLASHVSR_OUT,
                                phase="flashvsr", step=FLASHVSR_STEP)
    tf = full.transformer
    facts = {"phase": "flashvsr", "dit_dim": tf.cfg.dim, "dit_layers": len(tf.blocks), "dit_dtype": str(tf.dtype),
             "parameters": sum(p.numel() for p in tf.parameters()),
             "lq_proj_parameters": sum(p.numel() for p in tf.LQ_proj_in.parameters()),
             "full_vae": type(full.vae).__name__, "tiny_vae": type(tiny.vae).__name__,
             "tiny_vae_decoder_layers": len(tiny.vae.decoder),
             "seconds_a_chunk": {r["path"]: r["seconds_per_step"] for r in rows + [row]},
             "peak_gib": max(r["peak_gib"] for r in rows + [row])}
    emit(facts)
    check(tf.cfg.dim == 1536 and len(tf.blocks) == 30 and facts["tiny_vae"] == "TinyWanVAE",
          f"the FlashVSR widths: {facts}")
    del full, tiny, tf, first, out
    release()
    return {"flashvsr_full": rows, "flashvsr_tiny": [row]}


def phase_flashvsr(home: Path):
    """FlashVSR 1.1: the kernel at the first and cached chunks' launches and
    their cross launches (``flashvsr_kernel_inputs``), the 2-block DiT and
    the TCDecoder against f32 (``flashvsr_reference``), then both manifests'
    requests (``flashvsr_requests``)."""
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    rows, err = path_kernel_rows("flashvsr", flashvsr_kernel_inputs())
    lap("kernel_rows")
    flashvsr_reference()
    lap("card_vs_cpu")
    paths = flashvsr_requests(home)
    lap("requests")
    emit({"phase": "flashvsr", "seconds_by_step": seconds})
    return paths, rows, err



# -- SAM2 point masks and tracking; the preprocessors ------------------------------------


def sam2_kernel_inputs():
    """(case, q, k, v, None) at the shapes SAM2's Hiera-B+ at 1024² and its
    mask decoder give the kernel (bf16 here; the f32 model's route rounds to
    these tiles): a 256 x 256 token grid at patch stride 4, head dim 56 in
    every block. Stage 1's windows of 8 (1024 windows of 64 tokens, 2 heads);
    the q-pool blocks, global in the JAX module (16,384 pooled queries against
    65,536 keys at 4 heads, 4096 against 16,384 at 8, 1024 against 4096 at
    16); stage 2's windows of 4 (1024 x 16 tokens); stage 3's windows of 14 on
    64 x 64 padded to 70 (25 x 196) and its global blocks (4096 at 8 heads);
    stage 4's windows of 7 on 32 x 32 padded to 35 (25 x 49). The decoder's
    10 tokens (obj, iou, 4 mask tokens, a bucket of 4 prompt points): their
    self-attention (8 heads of 32) and the token↔image attentions over the
    64 x 64 embedding (8 heads of 16). Then the global-block shape at the
    other published trunks' head dims: Hiera-L's 72 (8 heads) and Hiera-T/S's
    96 (4 heads)."""
    d = SAM2_BASE_PLUS["embed_dim"] // SAM2_BASE_PLUS["num_heads"]
    yield (f"sam2_s1_window8_b1024_s64_h2_d{d}", *qkv(1024, 64, 64, 2, d, 130), None)
    yield (f"sam2_qpool2_sq16384_sk65536_h4_d{d}", *qkv(1, 16384, 65536, 4, d, 131), None)
    yield (f"sam2_s2_window4_b1024_s16_h4_d{d}", *qkv(1024, 16, 16, 4, d, 132), None)
    yield (f"sam2_qpool3_sq4096_sk16384_h8_d{d}", *qkv(1, 4096, 16384, 8, d, 133), None)
    yield (f"sam2_s3_window14_b25_s196_h8_d{d}", *qkv(25, 196, 196, 8, d, 134), None)
    yield (f"sam2_s3_global_s4096_h8_d{d}", *qkv(1, 4096, 4096, 8, d, 135), None)
    yield (f"sam2_qpool4_sq1024_sk4096_h16_d{d}", *qkv(1, 1024, 4096, 16, d, 136), None)
    yield (f"sam2_s4_window7_b25_s49_h16_d{d}", *qkv(25, 49, 49, 16, d, 137), None)
    yield ("sam2_decoder_self_s10_h8_d32", *qkv(1, 10, 10, 8, 32, 138), None)
    yield ("sam2_decoder_token_to_image_sq10_sk4096_h8_d16", *qkv(1, 10, 4096, 8, 16, 139), None)
    yield ("sam2_decoder_image_to_token_sq4096_sk10_h8_d16", *qkv(1, 4096, 10, 8, 16, 140), None)
    yield ("hiera_l_global_s4096_h8_d72", *qkv(1, 4096, 4096, 8, 72, 141), None)
    yield ("hiera_s_global_s4096_h4_d96", *qkv(1, 4096, 4096, 4, 96, 142), None)


def seeded_like_tests(module, seed: int):
    """Fill ``module`` (on the CPU) with the CPU tests' recipe
    (``tests/torch_port_helpers.py jax_build``): weights of rank 2 or more
    normal(0, 1/√fan_in), biases normal(0, 0.05), other 1-D parameters
    1 + normal(0, 0.05), the rest normal(0, 0.02)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rpartition(".")[2]
            x = torch.randn(p.shape, generator=g)
            if leaf == "weight" and p.ndim >= 2:
                x = x / math.sqrt(max(1, p[0].numel()))
            elif leaf == "bias":
                x = 0.05 * x
            elif p.ndim == 1:
                x = 1.0 + 0.05 * x
            else:
                x = 0.02 * x
            p.copy_(x)
    return module.eval().requires_grad_(False)


def write_sam2_checkpoint(root: Path) -> Path:
    """The seeded Hiera-B+ SAM2 image model (the port module's initialisers,
    torch's global generator at seed 0) as ``sam2.1_hiera_base_plus.pt`` in
    the published key layout, under ``{"model": ...}`` as the published file
    keeps it, with its ``config.json`` beside it; returns the path."""
    import torch

    from apex_studio_tpu_torch.loaders.export import published_state_dict
    from apex_studio_tpu_torch.mask.sam2 import SAM2Config, SAM2ImageModel

    torch.manual_seed(0)
    model = SAM2ImageModel(SAM2Config.from_dict(SAM2_BASE_PLUS))
    path = root / "sam2" / "sam2.1_hiera_base_plus.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": published_state_dict("sam2", model.state_dict())}, path)
    (path.parent / "config.json").write_text(json.dumps(SAM2_BASE_PLUS))
    return path


def disk_clip(n: int, h: int = 480, w: int = 832, seed: int = 50):
    """``n`` seeded frames of a bright disk moving 6 px a frame over smooth
    noise, and the disk's first centre."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    frames = []
    for i in range(n):
        f = (cv2_smooth(rng, (h, w)) // 3).astype(np.uint8)
        f[(yy - h // 2) ** 2 + (xx - w // 3 - 6 * i) ** 2 <= (h // 6) ** 2] = [220, 90, 80]
        frames.append(f)
    return frames, (w // 3, h // 2)


def wait_job(base: str, job_id: str, limit_s: float = 300.0) -> dict:
    """Poll ``/jobs/status/{job_id}`` until the job leaves queued / running."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < limit_s:
        st = http(base, "GET", f"/jobs/status/{job_id}")[1]
        if st.get("status") not in ("queued", "running", "pending"):
            return st
        time.sleep(0.05)
    raise CheckFailed(f"job {job_id} did not finish in {limit_s} s")


def phase_sam2(home: Path):
    """SAM2 at Hiera-B+ widths (``SAM2_BASE_PLUS``) on the card: the kernel
    at the path's shapes; a seeded checkpoint written in the published
    ``sam2.1_hiera_base_plus.pt`` layout with its ``config.json`` and named by
    ``APEX_SAM2_PATH``; the predictor's mask logits with the kernel against
    the plain attention on the card within ``SAM2_LOGITS_REL_L2``; two
    identical ``/mask/create`` requests through the port's server (points on
    a 480x832 frame: contours equal to each other and to ``mask_from_points``,
    ``/system/memory``'s ``mask_backend`` reading ``sam2``), ``SAM2_LAUNCHES``
    a request; then ``sam2_track_video`` on a ``SAM2VideoModel`` of the same
    widths (seeded) over ``SAM2_TRACK_FRAMES`` frames, forward, the memory
    bank rolling past its 7 slots, ``SAM2_LAUNCHES`` a frame. Returns the path
    rows, the kernel rows and the largest max|Δ|."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.mask import mask_from_points, mask_to_contours
    from apex_studio_tpu_torch.mask import predictor as sam2_predictor
    from apex_studio_tpu_torch.mask.sam2 import SAM2Config, SAM2VideoModel
    from apex_studio_tpu_torch.ops.attention.flash import flash_attention
    from apex_studio_tpu_torch.server.app import create_app
    from PIL import Image

    kernel_rows, kernel_err = path_kernel_rows("sam2", sam2_kernel_inputs())
    sh = home / "sam2"
    ckpt = write_sam2_checkpoint(sh / "models")
    saved = {k: os.environ.get(k) for k in ("APEX_HOME_DIR", "APEX_SAM2_PATH")}
    os.environ.update({"APEX_HOME_DIR": str(sh), "APEX_SAM2_PATH": str(ckpt)})
    sam2_predictor.reset_sam2_predictor()
    frames, (cx, cy) = disk_clip(SAM2_TRACK_FRAMES)
    points, labels = [{"x": cx, "y": cy}, {"x": 40, "y": 40}], [1, 0]
    rows, track_rows = [], []
    try:
        release()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pred = sam2_predictor.get_sam2_predictor()
        load_s = time.perf_counter() - t0
        model = pred.model
        check(model.cfg.embed_dim == 112 and len(model.trunk.blocks) == 24 and pred.device.type == "cuda",
              "the SAM2 predictor's widths or device")
        img = pred._image(frames[0])
        pts, lab = pred._prompt([[cx / 832, cy / 480], [40 / 832, 40 / 480], [0, 0], [0, 0]], [1, 0, -1, -1])
        with torch.no_grad():
            flash_attention.launches = 0
            masks, iou, _ = model.predict(img, pts, lab)
            launches = flash_attention.launches
            again = model.predict(img, pts, lab)[0]
            with plain_attention():
                plain, plain_iou, _ = model.predict(img, pts, lab)
        torch.cuda.synchronize()
        rel = rel_l2(masks, plain)
        signs = float(((masks > 0) == (plain > 0)).float().mean())
        emit({"phase": "sam2", "check": "mask_logits_kernel_vs_plain_attention", "rel_l2": rel,
              "tol": SAM2_LOGITS_REL_L2, "sign_agreement": signs, "launches": launches,
              "logits_shape": list(masks.shape), "bit_identical_repeat": bool(torch.equal(masks, again)),
              "seconds_load": load_s, "iou": iou[0].tolist(), "iou_plain": plain_iou[0].tolist()})
        check(bool(torch.isfinite(masks).all()) and list(masks.shape) == [1, 4, 256, 256],
              f"SAM2 logits {list(masks.shape)}")
        check(rel <= SAM2_LOGITS_REL_L2, f"SAM2 logits with the kernel {rel:.4f} from the plain attention")
        check(launches == SAM2_LAUNCHES, f"SAM2 predict launched flash {launches} times, expected {SAM2_LAUNCHES}")
        check(bool(torch.equal(masks, again)), "two identical SAM2 predictions differ")
        del masks, again, plain

        # served: two identical /mask/create requests
        image = sh / "mask_input.png"
        Image.fromarray(frames[0]).save(image)
        base, stop = start_server(create_app())
        try:
            served = []
            for i in range(2):
                flash_attention.launches = 0
                t0 = time.perf_counter()
                code, out = http(base, "POST", "/mask/create", {"input_path": str(image), "points": points,
                                                                "point_labels": labels})
                seconds = time.perf_counter() - t0
                launches = flash_attention.launches
                row = {"phase": "sam2", "request": f"mask_create_{i + 1}", "status": code,
                       "contours": len(out.get("contours", [])) if isinstance(out, dict) else None,
                       "seconds_post_to_response": seconds, "flash_launches": launches,
                       "flash_launches_expected": SAM2_LAUNCHES, "seconds_per_step": [seconds]}
                emit(row)
                check(code == 200 and out["status"] == "success", f"/mask/create answered {code}: {out}")
                check(launches == SAM2_LAUNCHES, f"/mask/create launched flash {launches} times")
                served.append(out["contours"])
                rows.append(row)
            backend = http(base, "GET", "/system/memory")[1]["mask_backend"]
        finally:
            stop()
        direct = mask_to_contours(mask_from_points(frames[0], points, labels))
        emit({"phase": "sam2", "check": "served_masks", "mask_backend": backend,
              "contours_equal": served[0] == served[1] == direct, "contour_points": [len(c) for c in direct]})
        check(backend["backend"] == "sam2" and backend["checkpoint"] == str(ckpt),
              f"/system/memory mask_backend {backend}")
        check(served[0] == served[1] == direct, "the served SAM2 masks differ from each other or the predictor's")
        peak_create = torch.cuda.max_memory_allocated() / 2 ** 30

        # tracking on the video model at the same widths
        del pred, model
        sam2_predictor.reset_sam2_predictor()
        release()
        torch.cuda.reset_peak_memory_stats()
        torch.manual_seed(1)
        video = SAM2VideoModel(SAM2Config.from_dict(SAM2_BASE_PLUS)).cuda().eval().requires_grad_(False)
        tracker = sam2_predictor.SAM2Predictor(video, img_size=SAM2_BASE_PLUS["img_size"])
        steps, track_step = [], video.track_step

        def timed_step(*a, **kw):  # a frame's seconds and launches, synchronised
            t, n = time.perf_counter(), flash_attention.launches
            out = track_step(*a, **kw)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t, flash_attention.launches - n))
            return out

        video.track_step = timed_step
        flash_attention.launches = 0
        t0 = time.perf_counter()
        masks = sam2_predictor.sam2_track_video(tracker, frames, points, labels, start_frame=0,
                                                direction="forward")
        total_s = time.perf_counter() - t0
        launches = flash_attention.launches
        per_launch = [n for _, n in steps]
        track_row = {"phase": "sam2", "request": "track_video", "frames": len(frames), "seconds": total_s,
                     "seconds_per_step": [t for t, _ in steps], "flash_launches": launches,
                     "flash_launches_expected": SAM2_LAUNCHES * len(frames), "launches_per_frame": per_launch,
                     "mask_pixels": [int(masks[i].sum()) for i in sorted(masks)],
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        emit(track_row)
        check(sorted(masks) == list(range(len(frames))) and all(m.shape == (480, 832) for m in masks.values()),
              "sam2_track_video's masks")
        check(launches == SAM2_LAUNCHES * len(frames) and per_launch == [SAM2_LAUNCHES] * len(frames),
              f"tracking launched flash {launches} times ({per_launch} a frame)")
        track_rows.append(track_row)
        emit({"phase": "sam2", "peak_gib_mask_create": peak_create, "peak_gib_track": track_row["peak_gib"],
              "checkpoint_mib": ckpt.stat().st_size / 2 ** 20})
        del video, tracker
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        sam2_predictor.reset_sam2_predictor()
        release()
    return {"sam2": rows + track_rows}, kernel_rows, kernel_err


def write_preprocessor_checkpoints(models: Path) -> dict:
    """Seeded ``depth_anything_v2_vitl.pth`` and ``body_pose_model.pth`` at
    their published widths and key names (``seeded_like_tests``; OpenPose's
    final heatmap bias at -1) under ``models``; returns their sizes in MiB."""
    import torch

    from apex_studio_tpu_torch.loaders.export import published_state_dict
    from apex_studio_tpu_torch.preprocess.depth_anything import DAv2Config, DepthAnythingV2
    from apex_studio_tpu_torch.preprocess.openpose import OpenPoseBody, OpenPoseConfig

    models.mkdir(parents=True, exist_ok=True)
    sizes = {}
    for name, family, build, seed in (
            ("depth_anything_v2_vitl.pth", "depth_anything_v2",
             lambda: DepthAnythingV2(DAv2Config.from_name("vitl")), 60),
            ("body_pose_model.pth", "openpose", lambda: OpenPoseBody(OpenPoseConfig()), 61)):
        module = seeded_like_tests(build(), seed)
        if family == "openpose":
            # The last stage's heatmaps background, as trained ones are almost
            # everywhere: random ones hold thousands of peaks a part, whose
            # greedy assembly on the host is quadratic in them.
            module.refine_l2[-1].convs[-1].bias.fill_(-1.0)
        torch.save(published_state_dict(family, module.state_dict()), models / name)
        sizes[name] = (models / name).stat().st_size / 2 ** 20
        del module
    return sizes


def preprocess_card_vs_cpu() -> dict:
    """Depth Anything V2 ``vits`` on a 518² input and OpenPose at its published
    widths on a 184² input, seeded (``seeded_like_tests``), f32 on the card
    (products in full f32, as the preprocessors set them) against the same
    module on the CPU, within ``F32_REL_L2`` (summation order)."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine.base import configure_float32_matmul
    from apex_studio_tpu_torch.preprocess.depth_anything import DAv2Config, DepthAnythingV2
    from apex_studio_tpu_torch.preprocess.openpose import OpenPoseBody, OpenPoseConfig

    configure_float32_matmul()
    rng = np.random.default_rng(62)
    out = {}
    for name, build, shape in (("depth_anything_v2_vits", lambda: DepthAnythingV2(DAv2Config.from_name("vits")),
                                (1, 518, 518, 3)),
                               ("openpose", lambda: OpenPoseBody(OpenPoseConfig()), (1, 184, 184, 3))):
        cpu = seeded_like_tests(build(), 63)
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        with torch.no_grad():
            ref = cpu(x)
            card = [t.cpu() for t in (lambda o: o if isinstance(o, tuple) else (o,))(cpu.cuda()(x.cuda()))]
        ref = ref if isinstance(ref, tuple) else (ref,)
        out[name] = [rel_l2(c, r) for c, r in zip(card, ref)]
        del cpu
    emit({"phase": "preprocess", "check": "f32_card_vs_cpu", "rel_l2": out, "tol": F32_REL_L2})
    check(all(e <= F32_REL_L2 for errs in out.values() for e in errs),
          f"the preprocessors' f32 forward on the card is too far from the CPU's: {out}")
    return out


def phase_preprocess(home: Path):
    """The preprocessors on the card: ``/preprocessor/list`` through the
    port's server answers every registered name; ``/preprocessor/run`` runs
    canny on an 8-frame 480x832 clip and ``depth_anything_v2`` (``vitl``,
    518) on a 720x1280 image on the server's device; ``run_preprocessor``
    runs ``depth_anything_v2`` at ``vitl`` and 518 and ``openpose`` at 368
    on the card, each twice (bit-identical); seeded checkpoints at the
    published widths and names under the preprocessor models dir; Depth
    Anything ``vits`` and OpenPose f32 on the card against the CPU. No flash
    launch: Depth Anything's attention is the plain version, as in JAX."""
    import numpy as np
    import torch
    from PIL import Image

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention
    from apex_studio_tpu_torch.preprocess import preprocessor_registry, run_preprocessor
    from apex_studio_tpu_torch.server.app import create_app
    from apex_studio_tpu_torch.utils.media import save_video

    ph = home / "preprocess"
    saved = {k: os.environ.get(k) for k in ("APEX_HOME_DIR", "APEX_PREPROCESSOR_MODELS_PATH")}
    os.environ.update({"APEX_HOME_DIR": str(ph), "APEX_PREPROCESSOR_MODELS_PATH": str(ph / "models")})
    rows = []
    try:
        sizes = prewritten("preprocess", home)
        clip, _ = disk_clip(8, seed=64)
        clip_path = save_video(clip, ph / "clip.mp4", fps=16)
        image = cv2_smooth(np.random.default_rng(65), (720, 1280))
        image_path = ph / "image.png"
        Image.fromarray(image).save(image_path)
        flash_attention.launches = 0
        base, stop = start_server(create_app())
        try:
            listed = [e["name"] for e in http(base, "GET", "/preprocessor/list")[1]]
            served = {}
            for name, path, params in (("canny", clip_path, {}),
                                       ("depth_anything_v2", image_path,
                                        {"encoder": "vitl", "detect_resolution": 518})):
                t0 = time.perf_counter()
                code, out = http(base, "POST", "/preprocessor/run", {"preprocessor_name": name,
                                                                     "input_path": str(path), "params": params})
                check(code == 200, f"/preprocessor/run {name} answered {code}: {out}")
                st = wait_job(base, out["job_id"])
                served[name] = {"status": st["status"], "seconds_post_to_complete": time.perf_counter() - t0,
                                "result": Path(st.get("result_path") or "").name, "error": st.get("error")}
        finally:
            stop()
        emit({"phase": "preprocess", "listed": listed, "served": served, "checkpoints_mib": sizes})
        check(set(preprocessor_registry.names()) <= set(listed) and "openpose" in listed,
              f"/preprocessor/list lists {listed}")
        check(all(v["status"] == "complete" for v in served.values()), f"/preprocessor/run jobs: {served}")

        for name, params in (("depth_anything_v2", {"encoder": "vitl", "detect_resolution": 518}),
                             ("openpose", {"detect_resolution": 368})):
            outs, secs = [], []
            release()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(2):
                t0 = time.perf_counter()
                outs.append(run_preprocessor(name, image, dict(params))[0])
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            row = {"phase": "preprocess", "preprocessor": name, "params": params, "seconds": secs,
                   "shape": list(outs[0].shape), "identical": bool(np.array_equal(*outs)),
                   "nonzero_share": float((outs[0] > 0).mean()),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            emit(row)
            check(row["shape"] == [720, 1280, 3] and outs[0].dtype == np.uint8, f"{name} output {row['shape']}")
            check(row["identical"], f"two identical {name} runs differ")
            rows.append(row)
        rows.append({"card_vs_cpu": preprocess_card_vs_cpu()})
        check(flash_attention.launches == 0, f"the preprocess path launched flash {flash_attention.launches} times")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        release()
    return rows


# The line, edge, normal and LeReS depth preprocessors: (manifest name, the
# net it runs, its params on the 720x1280 image; the manifests' defaults)
PREPROCESS_NETS = (
    ("hed", "hed", {}), ("scribble_hed", "hed", {}), ("pidi", "pidinet", {}), ("pidinet", "pidinet", {}),
    ("teed", "teed", {}), ("lineart_realistic", "lineart", {}), ("lineart_anime", "lineart_anime", {}),
    ("scribble_anime", "scribble_anime", {}), ("manga_line", "manga_line", {}), ("mlsd", "mlsd", {}),
    ("normalbae", "normalbae", {}), ("dsine", "dsine", {}), ("leres", "leres", {}),
)


def preprocess_net_builds() -> dict:
    """net → (the port module's constructor, the published family, the file(s) it is
    written to, the container it is kept under, the card-vs-CPU input's shape
    and range)."""
    from apex_studio_tpu_torch.preprocess import (dsine, efficientnet, hed, leres, lineart_anime, lineart_model,
                                                  manga_line, mlsd, normalbae, pidinet, teed)

    return {
        "hed": (hed.ControlNetHED, "hed", ("ControlNetHED.pth",), None, (1, 128, 192, 3), 255.0),
        "pidinet": (pidinet.PiDiNet, None, ("table5_pidinet.pth",), None, (1, 128, 192, 3), 1.0),
        "teed": (teed.TED, "teed", ("7_model.pth",), None, (1, 128, 192, 3), 255.0),
        "lineart": (lineart_model.LineartGenerator, "lineart", ("sk_model.pth", "sk_model2.pth"), None,
                    (1, 128, 192, 3), 1.0),
        "scribble_anime": (lineart_model.LineartGenerator, "lineart",
                           ("scribble/anime_style/netG_A_latest.pth",), None, None, None),
        "lineart_anime": (lineart_anime.LineartAnimeGenerator, "lineart_anime", ("netG.pth",), None,
                          (1, 256, 256, 3), 1.0),
        "manga_line": (manga_line.MangaLineModel, "manga_line", ("erika.pth",), None, (1, 128, 128, 1), 255.0),
        "mlsd": (mlsd.MLSDModel, "mlsd", ("mlsd_large_512_fp32.pth",), None, (1, 128, 128, 4), 1.0),
        "efficientnet": (efficientnet.EfficientNetFeatures, "efficientnet", (), None, (1, 128, 192, 3), 1.0),
        "normalbae": (normalbae.NNET, "normalbae", ("scannet.pt",), "model", (1, 128, 192, 3), 1.0),
        "dsine": (dsine.DSINE, "dsine", ("dsine.pt",), "model", (1, 128, 192, 3), 1.0),
        "leres": (leres.LeReSModel, "leres", ("res101.pth",), "depth_model", (1, 128, 192, 3), 1.0),
    }


def seeded_detector(build, seed: int):
    """``build()`` on the CPU filled by ``seeded_like_tests`` (built on
    ``meta`` first: its own initialisers would draw every weight twice), then
    each inference BatchNorm's running mean redrawn as normal(0, 0.05), as the
    CPU tests draw them (``tests/torch_port_helpers.py jax_build_bn``): a mean
    near 1 shifts each BN's input down by one and M-LSD's stack of BN → ReLU6
    collapses to a constant map."""
    import torch

    with torch.device("meta"):
        module = build()
    module = seeded_like_tests(module.to_empty(device="cpu"), seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.rpartition(".")[2] in ("mean", "bn_mean", "running_mean"):
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return module


def write_preprocess_net_checkpoints(models: Path) -> dict:
    """Seeded checkpoints of the 11 nets at their published widths, key
    names and file names under ``models``: ``loaders/export.py``'s names in
    the published containers (``scannet.pt`` and ``dsine.pt`` under
    ``model``, ``res101.pth`` under ``depth_model``); PiDiNet's raw
    pixel-difference weights under ``table5_pidinet.pth``'s names
    (``module.`` prefixed), which its converter folds. Returns the sizes in
    MiB."""
    import torch

    from apex_studio_tpu_torch.loaders.export import published_state_dict
    from apex_studio_tpu_torch.preprocess.pidinet import published_shapes

    sizes = {}
    for seed, (net, (build, family, files, container, _, _)) in enumerate(preprocess_net_builds().items(), 70):
        if not files:
            continue
        if family is None:  # PiDiNet: raw weights, normal(0, 1/√fan_in)
            g = torch.Generator().manual_seed(seed)
            sd = {f"module.{k}": torch.randn(shape, generator=g) / math.sqrt(max(1, math.prod(shape[1:])))
                  for k, shape in published_shapes().items()}
        else:
            sd = published_state_dict(family, seeded_detector(build, seed).state_dict())
        for name in files:
            path = models / name
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save({container: sd} if container else sd, path)
            sizes[name] = path.stat().st_size / 2 ** 20
        del sd
    return sizes


def preprocess_nets_card_vs_cpu() -> dict:
    """The 11 nets (the EfficientNet-B5 trunk on its own, DSINE with its 5
    refinements) at their published widths, seeded (``seeded_detector``),
    f32 on the card (products in full f32, as the preprocessors set them)
    against the same module on the CPU at a small input, within
    ``F32_REL_L2`` on every output."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine.base import configure_float32_matmul
    from apex_studio_tpu_torch.preprocess.dsine import get_intrins_from_fov

    configure_float32_matmul()
    rng = np.random.default_rng(80)
    out = {}
    for seed, (net, (build, _, _, _, shape, scale)) in enumerate(preprocess_net_builds().items(), 81):
        if shape is None:  # the anime scribble is the lineart generator with other weights
            continue
        cpu = seeded_detector(build, seed)
        x = torch.from_numpy((rng.random(shape) * scale).astype(np.float32))
        args = (x,)
        if net == "dsine":
            k = get_intrins_from_fov(60.0, shape[1], shape[2])
            k[:2, 2] += 0.5
            args = (x, torch.from_numpy(k)[None])
        with torch.no_grad():
            ref = cpu(*args)
            card = cpu.cuda()(*(a.cuda() for a in args))
        ref, card = ((t,) if isinstance(t, torch.Tensor) else tuple(t) for t in (ref, card))
        out[net] = max(rel_l2(c.cpu(), r) for c, r in zip(card, ref))
        del cpu, card
    release()
    emit({"phase": "preprocess_nets", "check": "f32_card_vs_cpu", "max_rel_l2": out, "tol": F32_REL_L2})
    check(len(out) == 11 and all(e <= F32_REL_L2 for e in out.values()),
          f"the preprocessors' f32 forwards on the card are too far from the CPU's: {out}")
    return out


def phase_preprocess_nets(home: Path):
    """The line, edge, normal and LeReS depth preprocessors on the card, on
    seeded checkpoints at their published widths and file names under the
    preprocessor models dir: each of the 13 manifest names twice through
    ``run_preprocessor`` on a 720x1280 image (bit-identical, the JAX
    preprocessor's output shape and dtype: the frame's, uint8), with its
    seconds and peak memory; ``hed`` on an 8-frame 480x832 clip and ``dsine``
    on the image through ``/preprocessor/run``; the 11 nets' f32 forwards on
    the card against the CPU. None of them attends: no flash launch."""
    import numpy as np
    import torch
    from PIL import Image

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention
    from apex_studio_tpu_torch.preprocess import preprocessor_registry, run_preprocessor
    from apex_studio_tpu_torch.server.app import create_app
    from apex_studio_tpu_torch.utils.media import save_video

    ph = home / "preprocess_nets"
    saved = {k: os.environ.get(k) for k in ("APEX_HOME_DIR", "APEX_PREPROCESSOR_MODELS_PATH")}
    os.environ.update({"APEX_HOME_DIR": str(ph), "APEX_PREPROCESSOR_MODELS_PATH": str(ph / "models")})
    rows = []
    try:
        t0 = time.perf_counter()
        sizes = prewritten("preprocess_nets", home)
        write_s = time.perf_counter() - t0
        image = cv2_smooth(np.random.default_rng(66), (720, 1280))
        flash_attention.launches = 0
        for name, net, params in PREPROCESS_NETS:
            outs, secs = [], []
            release()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(2):
                t0 = time.perf_counter()
                outs.append(run_preprocessor(name, image, dict(params))[0])
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            row = {"phase": "preprocess_nets", "preprocessor": name, "net": net, "params": params,
                   "seconds": secs, "shape": list(outs[0].shape), "dtype": str(outs[0].dtype),
                   "identical": bool(np.array_equal(*outs)), "distinct_values": int(len(np.unique(outs[0]))),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            emit(row)
            check(row["shape"] == [720, 1280, 3] and outs[0].dtype == np.uint8, f"{name} output {row['shape']}")
            check(row["identical"], f"two identical {name} runs differ")
            rows.append(row)
        release()

        clip, _ = disk_clip(8, seed=67)
        clip_path = save_video(clip, ph / "clip.mp4", fps=16)
        image_path = ph / "image.png"
        Image.fromarray(image).save(image_path)
        base, stop = start_server(create_app())
        try:
            listed = [e["name"] for e in http(base, "GET", "/preprocessor/list")[1]]
            served = {}
            for name, path in (("hed", clip_path), ("dsine", image_path)):
                t0 = time.perf_counter()
                code, out = http(base, "POST", "/preprocessor/run", {"preprocessor_name": name,
                                                                     "input_path": str(path), "params": {}})
                check(code == 200, f"/preprocessor/run {name} answered {code}: {out}")
                st = wait_job(base, out["job_id"])
                served[name] = {"status": st["status"], "seconds_post_to_complete": time.perf_counter() - t0,
                                "result": Path(st.get("result_path") or "").name, "error": st.get("error")}
        finally:
            stop()
        emit({"phase": "preprocess_nets", "listed": listed, "served": served, "checkpoints_mib": sizes,
              "checkpoint_write_seconds": write_s})
        check({name for name, _, _ in PREPROCESS_NETS} <= set(listed)
              and set(preprocessor_registry.names()) <= set(listed), f"/preprocessor/list lists {listed}")
        check(all(v["status"] == "complete" for v in served.values()), f"/preprocessor/run jobs: {served}")
        rows.append({"card_vs_cpu": preprocess_nets_card_vs_cpu()})
        check(flash_attention.launches == 0,
              f"the preprocess_nets path launched flash {flash_attention.launches} times")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        release()
    return rows


# -- the rest of the preprocessors and the Cosmos guardrail --------------------------------

# the seeded files of the preprocess_rest phase, each under its published name
# (in the models dir) and container: (net, file, container)
PREPROCESS_REST_FILES = (
    ("u2net", "u2net.pth", None), ("u2netp", "u2netp.pth", None),
    ("anime_face", "Annotators/UNet.pth", None), ("isnet", "isnetis.ckpt", "lightning"),
    ("gmflow-scale1", "gmflow-scale1-mixdata.pth", "model"), ("gmflow-scale2", "gmflow-scale2-mixdata.pth", "model"),
    ("metric3d", "metric_depth_vit_small_800k.pth", "model_state_dict"),
)
# (manifest name, params) twice each on the 720x1280 image; the JAX output's
# channels (rembg's RGBA)
PREPROCESS_REST_IMAGE = (("rembg", {}, 4), ("anime_face_segment", {}, 3), ("metric3d", {}, 3),
                         ("metric3d_normal", {"output_type": "normal"}, 3), ("densepose", {}, 3))
# (manifest name, variant, runs) on the 8-frame 480x832 clip
PREPROCESS_REST_CLIP = (("optical_flow", "gmflow-scale1", 2), ("unimatch", "gmflow-scale2", 2),
                        ("ptlflow", "gmflow-scale1", 1))
# SigLIP so400m's pooled output in bf16 against f32 of the same synthetic
# weights (27 layers and the MAP head in bf16)
SIGLIP_POOLED_REL_L2 = 2e-2
GUARDRAIL_FRAMES, GUARDRAIL_SAMPLE_EVERY = 33, 8

DENSEPOSE_STAND_IN = '''"""A stand-in for the DensePose R50-FPN TorchScript export with its output
contract (boxes, coarse and fine segmentation, u, v) and its detection ops:
1000 proposals through torchvision::nms at 0.7, roi_align 7x7 over the kept
ones on a stride-4 map, a second nms at 0.5 of the scored boxes keeping 16,
roi_align 28x28 over those. Boxes come from a hash of their index, so two
calls are equal."""

import torch


class DensePoseStandIn(torch.nn.Module):
    def forward(self, img: torch.Tensor):
        dev = img.device
        h = img.shape[1]
        w = img.shape[2]
        x = img.unsqueeze(0).to(torch.float32) / 255.0
        feat = torch.nn.functional.avg_pool2d(x, 4)
        feat = torch.cat([feat, feat * feat, 1.0 - feat], dim=1).repeat(1, 10, 1, 1)
        t = torch.arange(1000, device=dev, dtype=torch.float32)
        r = [torch.frac(torch.abs(torch.sin(t * k) * 43758.5453)) for k in [12.9898, 78.233, 37.719, 4.581, 93.989]]
        x0 = r[0] * float(w - 64)
        y0 = r[1] * float(h - 64)
        boxes = torch.stack([x0, y0, torch.clamp(x0 + 24.0 + r[2] * 240.0, max=float(w)),
                             torch.clamp(y0 + 24.0 + r[3] * 360.0, max=float(h))], dim=1)
        keep = torch.ops.torchvision.nms(boxes, r[4], 0.7)
        props = boxes[keep]
        rois = torch.cat([torch.zeros((props.shape[0], 1), device=dev), props], dim=1)
        box_feats = torch.ops.torchvision.roi_align(feat, rois, 0.25, 7, 7, 0, True)
        scores = box_feats.mean(dim=[1, 2, 3]) * r[4][keep]
        dets = props[torch.ops.torchvision.nms(props, scores, 0.5)[:16]]
        rois = torch.cat([torch.zeros((dets.shape[0], 1), device=dev), dets], dim=1)
        pooled = torch.ops.torchvision.roi_align(feat, rois, 0.25, 28, 28, 2, True)
        coarse = torch.stack([pooled[:, 0] - 0.3, pooled[:, 1]], dim=1)
        return dets, coarse, 4.0 * pooled[:, :25], pooled[:, 1:26], pooled[:, 2:27]
'''


def preprocess_rest_builds() -> dict:
    """net → (the port module's constructor, the published family, the
    card-vs-CPU inputs' shapes, their range: uniform in [0, r), or normal
    where None)."""
    from apex_studio_tpu_torch.preprocess import anime_seg, metric3d, u2net, unimatch

    def gmflow(variant):
        return lambda: unimatch.GMFlow(unimatch.GMFLOW_CONFIGS[variant])

    return {
        "u2net": (u2net.U2Net, "u2net", [(1, 160, 160, 3)], None),
        "u2netp": (lambda: u2net.U2Net(light=True), "u2net", [(1, 160, 160, 3)], None),
        "anime_face": (anime_seg.AnimeFaceUNet, "anime_face", [(1, 128, 128, 3)], 1.0),
        "isnet": (anime_seg.ISNetDIS, "isnet", [(1, 128, 128, 3)], 1.0),
        "gmflow-scale1": (gmflow("gmflow-scale1"), "gmflow", [(1, 128, 128, 3)] * 2, 255.0),
        "gmflow-scale2": (gmflow("gmflow-scale2"), "gmflow", [(1, 128, 128, 3)] * 2, 255.0),
        "metric3d": (lambda: metric3d.Metric3DModel(metric3d.Metric3DConfig.small()), "metric3d",
                     [(1, 112, 196, 3)], None),
    }


def write_preprocess_rest_checkpoints(models: Path) -> dict:
    """The seeded nets (``seeded_detector``) at their published widths under
    their published names and containers: ``isnetis.ckpt`` as Lightning
    writes it (``state_dict`` beside trainer state that ``weights_only``
    refuses, an ``argparse.Namespace``), GMFlow's under ``model``, Metric3D's
    under ``model_state_dict``; and the DensePose stand-in as the export's
    file. Returns the sizes in MiB."""
    import argparse as _argparse

    import torch

    from apex_studio_tpu_torch.loaders.export import published_state_dict
    from apex_studio_tpu_torch.preprocess.torch_shim import install_torchvision_ops

    builds = preprocess_rest_builds()
    sizes = {}
    for seed, (net, name, container) in enumerate(PREPROCESS_REST_FILES, 90):
        build, family = builds[net][:2]
        sd = published_state_dict(family, seeded_detector(build, seed).state_dict())
        if container == "lightning":
            obj = {"state_dict": sd, "epoch": 11, "global_step": 50000, "pytorch-lightning_version": "1.9.4",
                   "hyper_parameters": _argparse.Namespace(net_name="isnet_is", img_size=1024, lr=1e-4)}
        else:
            obj = {container: sd} if container else sd
        path = models / name
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(obj, path)
        sizes[name] = path.stat().st_size / 2 ** 20
        del sd, obj
    check(install_torchvision_ops(), "torchvision::nms / roi_align are not available")
    src = models.parent / "densepose_stand_in.py"
    src.write_text(DENSEPOSE_STAND_IN)
    sys.path.insert(0, str(src.parent))
    try:
        from densepose_stand_in import DensePoseStandIn
    finally:
        sys.path.remove(str(src.parent))
    path = models / "densepose_r50_fpn_dl.torchscript"
    torch.jit.save(torch.jit.script(DensePoseStandIn()), str(path))
    sizes[path.name] = path.stat().st_size / 2 ** 20
    return sizes


def preprocess_rest_card_vs_cpu() -> dict:
    """The phase's nets at their published widths, seeded, f32 on the card
    (products in full f32) against the same module on the CPU at small
    inputs: every output within ``F32_REL_L2``."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine.base import configure_float32_matmul

    configure_float32_matmul()
    rng = np.random.default_rng(100)
    out = {}
    for seed, (net, (build, _, shapes, scale)) in enumerate(preprocess_rest_builds().items(), 101):
        cpu = seeded_detector(build, seed)
        xs = [torch.from_numpy((rng.normal(size=s) if scale is None else rng.random(s) * scale).astype(np.float32))
              for s in shapes]
        with torch.no_grad():
            ref = cpu(*xs)
            card = cpu.cuda()(*(x.cuda() for x in xs))
        ref, card = ((t,) if isinstance(t, torch.Tensor) else tuple(t) for t in (ref, card))
        out[net] = max(rel_l2(c.cpu(), r) for c, r in zip(card, ref))
        del cpu, card
    release()
    emit({"phase": "preprocess_rest", "check": "f32_card_vs_cpu", "max_rel_l2": out, "tol": F32_REL_L2})
    check(len(out) == 7 and all(e <= F32_REL_L2 for e in out.values()),
          f"the nets' f32 forwards on the card are too far from the CPU's: {out}")
    return out


def metric3d_giant2() -> dict:
    """Metric3D giant2 (ViT-g/14, 40 blocks of 1536, SwiGLU, pre-norm taps)
    at full width on the 616x1064 crop, its weights filled on the card from
    a seeded generator: one forward, its seconds and peak memory."""
    import torch

    from apex_studio_tpu_torch.engine.base import configure_float32_matmul, materialize_random
    from apex_studio_tpu_torch.preprocess.metric3d import Metric3DConfig, Metric3DModel

    configure_float32_matmul()
    release()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = materialize_random(lambda: Metric3DModel(Metric3DConfig.giant2()), torch.device("cuda"), seed=104)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    x = torch.randn(1, 616, 1064, 3, generator=torch.Generator("cuda").manual_seed(105), device="cuda")
    secs = []
    with torch.no_grad():
        for _ in range(2):
            t0 = time.perf_counter()
            depth, conf, normal = model(x)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    row = {"phase": "preprocess_rest", "check": "metric3d_giant2", "parameters": sum(p.numel() for p in model.parameters()),
           "fill_seconds": fill_s, "seconds": secs, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "shapes": [list(t.shape) for t in (depth, conf, normal)],
           "finite": bool(all(torch.isfinite(t).all() for t in (depth, conf, normal)))}
    emit(row)
    check(row["shapes"] == [[1, 616, 1064, 1], [1, 616, 1064, 1], [1, 616, 1064, 4]] and row["finite"],
          f"Metric3D giant2: {row}")
    del model, depth, conf, normal
    release()
    return row


def guardrail_check() -> dict:
    """``cosmos.guardrail`` over 33 frames with SigLIP so400m and its MAP head
    at the published widths (synthetic bf16, its f32 twin from the same
    seed) and a seeded classifier in the reference's layout, twice with the
    safe class favoured (the frames back, through OpenCV's Haar face
    detector where it ships one; equal on both runs) and once with class 2
    favoured (blocked: no frames); the pooled output in bf16 within
    ``SIGLIP_POOLED_REL_L2`` of the f32 one."""
    import cv2
    import numpy as np
    import torch

    from apex_studio_tpu_torch.engine.base import materialize_random
    from apex_studio_tpu_torch.models.text_encoders.siglip import (SiglipVisionConfig, SiglipVisionEncoder,
                                                                   preprocess_siglip_image)
    from apex_studio_tpu_torch.postprocess.guardrail import CosmosGuardrailPostprocessor

    cfg = SiglipVisionConfig(use_head=True)
    f32 = materialize_random(lambda: SiglipVisionEncoder(cfg, dtype=torch.float32), torch.device("cuda"), seed=106)
    with torch.device("meta"):
        bf16 = SiglipVisionEncoder(cfg, dtype=torch.bfloat16)
    bf16 = bf16.to_empty(device="cuda").eval().requires_grad_(False)
    bf16.load_state_dict(f32.state_dict())

    def classifier_state(favoured: int) -> dict:
        torch.manual_seed(107)
        seq = torch.nn.Sequential(torch.nn.Linear(1152, 512), torch.nn.BatchNorm1d(512), torch.nn.ReLU(),
                                  torch.nn.Linear(512, 256), torch.nn.BatchNorm1d(256), torch.nn.ReLU(),
                                  torch.nn.Linear(256, 7))
        with torch.no_grad():
            seq[6].bias[favoured] += 50.0
        return {f"network.layers.{k}": v for k, v in seq.state_dict().items()}

    cascade = getattr(getattr(cv2, "data", None), "haarcascades", None)
    detector = Path(cascade) / "haarcascade_frontalface_default.xml" if cascade else None
    frames, _ = disk_clip(GUARDRAIL_FRAMES, seed=108)
    outs, secs = [], []
    for favoured in (0, 0, 2):
        t0 = time.perf_counter()
        guard = CosmosGuardrailPostprocessor(encoder=bf16, classifier_state=classifier_state(favoured),
                                             detector_path=detector, sample_every=GUARDRAIL_SAMPLE_EVERY)
        outs.append(guard(frames))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    px = torch.from_numpy(preprocess_siglip_image(frames[0])).cuda()
    with torch.no_grad():
        err = rel_l2(bf16(px, pooled=True), f32(px, pooled=True))
    row = {"phase": "preprocess_rest", "check": "cosmos_guardrail", "frames": len(frames),
           "sampled": len(range(0, len(frames), GUARDRAIL_SAMPLE_EVERY)), "face_detector": str(detector),
           "seconds": secs, "passed_frames": [len(o) for o in outs],
           "identical": len(outs[0]) == len(outs[1]) and all(np.array_equal(a, b) for a, b in zip(*outs[:2])),
           "pooled_bf16_vs_f32_rel_l2": err, "tol": SIGLIP_POOLED_REL_L2}
    emit(row)
    check(row["passed_frames"] == [len(frames), len(frames), 0] and row["identical"],
          f"the guardrail runs: {row}")
    check(err <= SIGLIP_POOLED_REL_L2, f"SigLIP's pooled output in bf16 is too far from f32: {err}")
    del f32, bf16
    release()
    return row


def phase_preprocess_rest(home: Path):
    """Background removal, anime segmentation, optical flow, Metric3D and
    DensePose on the card, on seeded checkpoints at their published widths,
    names and containers under the preprocessor models dir
    (``write_preprocess_rest_checkpoints``): rembg, anime_face_segment,
    metric3d (depth and normal) and densepose twice each through
    ``run_preprocessor`` on a 720x1280 image (bit-identical, the JAX output's
    shape and dtype), optical_flow and unimatch (scale1, scale2) twice and
    ptlflow once on an 8-frame 480x832 clip; optical_flow and metric3d
    through ``/preprocessor/run``; the nets' f32 forwards against the CPU;
    Metric3D giant2 once at full width; the Cosmos guardrail with SigLIP
    so400m. None of them reaches the flash kernel: 0 launches."""
    import numpy as np
    import torch
    from PIL import Image

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention
    from apex_studio_tpu_torch.preprocess import preprocessor_registry, run_preprocessor
    from apex_studio_tpu_torch.server.app import create_app
    from apex_studio_tpu_torch.utils.media import save_video

    ph = home / "preprocess_rest"
    saved = {k: os.environ.get(k) for k in ("APEX_HOME_DIR", "APEX_PREPROCESSOR_MODELS_PATH")}
    os.environ.update({"APEX_HOME_DIR": str(ph), "APEX_PREPROCESSOR_MODELS_PATH": str(ph / "models")})
    rows = []
    try:
        t0 = time.perf_counter()
        sizes = prewritten("preprocess_rest", home)
        write_s = time.perf_counter() - t0
        image = cv2_smooth(np.random.default_rng(109), (720, 1280))
        clip, _ = disk_clip(8, seed=110)
        flash_attention.launches = 0
        for name, params, channels in PREPROCESS_REST_IMAGE:
            outs, secs = [], []
            release()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(2):
                t0 = time.perf_counter()
                outs.append(run_preprocessor(name, image, dict(params))[0])
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            row = {"phase": "preprocess_rest", "preprocessor": name, "params": params, "seconds": secs,
                   "shape": list(outs[0].shape), "dtype": str(outs[0].dtype),
                   "identical": bool(np.array_equal(*outs)), "distinct_values": int(len(np.unique(outs[0]))),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            emit(row)
            check(row["shape"] == [720, 1280, channels] and outs[0].dtype == np.uint8, f"{name} output {row['shape']}")
            check(row["identical"], f"two identical {name} runs differ")
            check(row["distinct_values"] > 1, f"{name} gave a constant frame")
            rows.append(row)
        for name, variant, runs in PREPROCESS_REST_CLIP:
            outs, secs = [], []
            release()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(runs):
                t0 = time.perf_counter()
                outs.append(run_preprocessor(name, clip, {"variant": variant}))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            row = {"phase": "preprocess_rest", "preprocessor": name, "variant": variant, "frames": len(clip),
                   "seconds": secs, "shape": [len(outs[0])] + list(outs[0][0].shape),
                   "identical": all(all(np.array_equal(a, b) for a, b in zip(outs[0], o)) for o in outs[1:]),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            emit(row)
            check(row["shape"] == [8, 480, 832, 3] and outs[0][0].dtype == np.uint8, f"{name} output {row['shape']}")
            check(row["identical"], f"two identical {name} runs differ")
            rows.append(row)
        release()

        clip_path = save_video(clip, ph / "clip.mp4", fps=16)
        image_path = ph / "image.png"
        Image.fromarray(image).save(image_path)
        base, stop = start_server(create_app())
        try:
            listed = [e["name"] for e in http(base, "GET", "/preprocessor/list")[1]]
            served = {}
            for name, path in (("optical_flow", clip_path), ("metric3d", image_path)):
                t0 = time.perf_counter()
                code, out = http(base, "POST", "/preprocessor/run", {"preprocessor_name": name,
                                                                     "input_path": str(path), "params": {}})
                check(code == 200, f"/preprocessor/run {name} answered {code}: {out}")
                st = wait_job(base, out["job_id"])
                served[name] = {"status": st["status"], "seconds_post_to_complete": time.perf_counter() - t0,
                                "result": Path(st.get("result_path") or "").name, "error": st.get("error")}
        finally:
            stop()
        emit({"phase": "preprocess_rest", "listed": listed, "served": served, "checkpoints_mib": sizes,
              "checkpoint_write_seconds": write_s})
        check({"rembg", "anime_face_segment", "optical_flow", "unimatch", "ptlflow", "metric3d", "densepose"}
              <= set(listed) and set(preprocessor_registry.names()) <= set(listed),
              f"/preprocessor/list lists {listed}")
        check(all(v["status"] == "complete" for v in served.values()), f"/preprocessor/run jobs: {served}")
        rows.append({"card_vs_cpu": preprocess_rest_card_vs_cpu()})
        rows.append(metric3d_giant2())
        rows.append(guardrail_check())
        check(flash_attention.launches == 0,
              f"the preprocess_rest path launched flash {flash_attention.launches} times")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        release()
    return rows


# -- the Hugging Face delegates, DWPose / pose2d and NLF -----------------------------------

# the transformers delegates' published models (the Hub ids their classes
# name, written under the preprocessor models dir as folders: zoe and
# zoe_depth_anything share one, midas and normal_midas another)
HF_DELEGATES = (("midas", "Intel/dpt-large"), ("normal_midas", "Intel/dpt-large"),
                ("zoe", "Intel/zoedepth-nyu-kitti"), ("depth_anything", "LiheYoung/depth-anything-large-hf"),
                ("zoe_depth_anything", "Intel/zoedepth-nyu-kitti"),
                ("segmentation", "nvidia/segformer-b4-finetuned-ade-512-512"),
                ("oneformer", "shi-labs/oneformer_ade20k_swin_tiny"))
POSE_NAMES = ("dwpose", "pose2d", "face2d", "animalpose", "dwpose_nlf")
GATED_NAMES = ("mediapipe_face", "diffusion_edge", "mesh_graphormer")
# two people's DWPose boxes on the 720x1280 image, as (x, y, w, h, score)
NLF_BOXES = ((300.0, 120.0, 260.0, 560.0, 0.9), (760.0, 100.0, 240.0, 580.0, 0.8))


def manifest_defaults(name: str) -> dict:
    """A preprocessor manifest's parameter defaults."""
    import yaml

    doc = yaml.safe_load((REPO / "manifests" / "preprocessor" / f"{name}.yml").read_text())
    return {p["name"]: p["default"] for p in doc.get("parameters", []) if "default" in p}


def write_byte_clip_tokenizer(path: Path) -> None:
    """A byte-level CLIP tokenizer (every byte a token, no merges) written as
    vocab.json / merges.txt and its tokenizer_config.json: OneFormer's
    task-text tokenizer, made here as the engines' byte-level tokenizers are
    (GPT-2's printable map of the 256 bytes)."""
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1), *range(ord("®"), ord("ÿ") + 1)]
    chars = [chr(b) if b in keep else chr(256 + sum(1 for c in range(b) if c not in keep)) for b in range(256)]
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": 256 + i for i, c in enumerate(chars)})
    vocab.update({"<|startoftext|>": 512, "<|endoftext|>": 513})
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n")
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "CLIPTokenizer", "bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
        "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>", "model_max_length": 77}))


def write_hf_delegates(models: Path) -> dict:
    """The delegates' models at their published widths (from ``transformers``'
    config classes, torch's seeded initialisers, built on the CPU) saved
    with their processors (the PIL variants under ``transformers`` 5) by
    ``save_pretrained`` under ``models/<Hub id>``:
    DPT-Large; ZoeDepth NYU-KITTI (BEiT-L/384, the two bin configurations);
    Depth Anything large (DINOv2-L/14 at 518); SegFormer-B4 on ADE20K's 150
    classes; OneFormer ADE20K Swin-Tiny (its text encoder over the byte-level
    CLIP tokenizer's 514 tokens) with that tokenizer and a 150-class info
    file. Returns {Hub id: (parameters, MiB)}."""
    import torch
    import transformers as T

    def processor(name):  # the PIL variant where transformers has one (5.x; its default wants torchvision)
        return getattr(T, name + "Pil", None) or getattr(T, name)

    imagenet = dict(image_mean=[0.485, 0.456, 0.406], image_std=[0.229, 0.224, 0.225])
    large = dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096)
    neck = dict(neck_hidden_sizes=[256, 512, 1024, 1024], fusion_hidden_size=256)
    out = {}

    def save(hub_id, build, processor):
        path = models / hub_id
        torch.manual_seed(len(out) + 140)
        model = build()
        model.eval().save_pretrained(path)
        if isinstance(processor, dict):  # a config written as the published file holds it
            (path / "preprocessor_config.json").write_text(json.dumps(processor))
        else:
            processor.save_pretrained(path)
        out[hub_id] = (sum(p.numel() for p in model.parameters()),
                       sum(f.stat().st_size for f in path.iterdir() if f.is_file()) / 2 ** 20)
        del model
        release()

    save("Intel/dpt-large", lambda: T.DPTForDepthEstimation(T.DPTConfig(
        **large, **neck, image_size=384, patch_size=16, backbone_out_indices=[5, 11, 17, 23])),
         processor("DPTImageProcessor")(size={"height": 384, "width": 384}))
    beit = T.BeitConfig(**large, image_size=384, patch_size=16, use_relative_position_bias=True,
                        reshape_hidden_states=False, out_indices=[6, 12, 18, 24])
    bins = [{"n_bins": 64, "min_depth": 1e-3, "max_depth": 10.0, "name": "nyu"},
            {"n_bins": 64, "min_depth": 1e-3, "max_depth": 80.0, "name": "kitti"}]
    save("Intel/zoedepth-nyu-kitti", lambda: T.ZoeDepthForDepthEstimation(T.ZoeDepthConfig(
        backbone_config=beit, **neck, bottleneck_features=256, num_attractors=[16, 8, 4, 1], bin_embedding_dim=128,
        num_relative_features=32, bin_configurations=bins, num_patch_transformer_layers=4,
        patch_transformer_hidden_size=128, patch_transformer_intermediate_size=1024,
        patch_transformer_num_attention_heads=4)), processor("ZoeDepthImageProcessor")())
    dino = T.Dinov2Config(**large, image_size=518, patch_size=14, out_indices=[5, 12, 18, 24],
                          reshape_hidden_states=False)
    save("LiheYoung/depth-anything-large-hf", lambda: T.DepthAnythingForDepthEstimation(T.DepthAnythingConfig(
        backbone_config=dino, reassemble_hidden_size=1024, head_hidden_size=32, patch_size=14, **neck)),
         processor("DPTImageProcessor")(size={"height": 518, "width": 518}, keep_aspect_ratio=True,
                                        ensure_multiple_of=14, resample=3, **imagenet))
    save("nvidia/segformer-b4-finetuned-ade-512-512", lambda: T.SegformerForSemanticSegmentation(T.SegformerConfig(
        depths=[3, 8, 27, 3], hidden_sizes=[64, 128, 320, 512], num_attention_heads=[1, 2, 5, 8],
        decoder_hidden_size=768, num_labels=150)),
         # nvidia/segformer-b4-finetuned-ade-512-512's preprocessor_config.json: transformers 5
         # builds no SegFormer processor without torchvision (the port reads the file itself)
         {"image_processor_type": "SegformerImageProcessor", "do_resize": True,
          "size": {"height": 512, "width": 512}, "resample": 2, "do_rescale": True, "rescale_factor": 1 / 255,
          "do_normalize": True, "do_reduce_labels": True, **imagenet})
    hub = "shi-labs/oneformer_ade20k_swin_tiny"
    write_byte_clip_tokenizer(models / hub)
    info = models / hub / "ade20k_panoptic.json"
    info.write_text(json.dumps({str(i): {"name": f"class_{i}", "isthing": int(i < 100)} for i in range(150)}))
    save(hub, lambda: T.OneFormerForUniversalSegmentation(T.OneFormerConfig(num_labels=150, text_encoder_vocab_size=514)),
         processor("OneFormerImageProcessor")(size={"shortest_edge": 512, "longest_edge": 2048}, num_labels=150,
                                              repo_path=None, class_info_file=str(info), num_text=134))
    return out


class ScriptedYOLOX:
    """A stand-in for ``cv2.dnn``'s YOLOX-L net (the script writes no ONNX
    file: it would need the ``onnx`` package): a seeded raw head output
    [1, 8400, 85] with two people and one animal above the threshold."""

    def __init__(self, seed: int):
        import numpy as np

        rng = np.random.default_rng(seed)
        pred = np.zeros((1, 8400, 85), np.float32)
        pred[0, :, :2] = rng.uniform(-0.5, 0.5, (8400, 2))
        pred[0, :, 2:4] = rng.uniform(-1, 1, (8400, 2))
        pred[0, :, 4:] = rng.uniform(0, 0.2, (8400, 81))
        for gy, gx, cls, size in ((9, 6, 0, 6.5), (10, 13, 0, 5.0), (8, 10, 15, 4.0)):
            a = 80 * 80 + 40 * 40 + gy * 20 + gx  # the stride-32 grid
            pred[0, a, 2:4] = np.log([size * 0.6, size])
            pred[0, a, 4], pred[0, a, 5 + cls] = 0.95, 0.9
        self.pred = pred

    def setInput(self, blob):
        check(tuple(blob.shape) == (1, 3, 640, 640), f"the detector's input {blob.shape}")

    def forward(self):
        return self.pred.copy()


class ScriptedSimCC:
    """A stand-in for ``cv2.dnn``'s RTMPose net: seeded SimCC outputs
    [1, 133, 576] / [1, 133, 768], drawn anew by the same seed each call."""

    def __init__(self, seed: int):
        self.seed = seed

    def setInput(self, blob):
        check(tuple(blob.shape) == (1, 3, 384, 288), f"the pose net's input {blob.shape}")

    def getUnconnectedOutLayersNames(self):
        return ("simcc_x", "simcc_y")

    def forward(self, names):
        import numpy as np

        rng = np.random.default_rng(self.seed)
        return [rng.uniform(0, 1, (1, 133, 576)).astype(np.float32),
                rng.uniform(0, 1, (1, 133, 768)).astype(np.float32)]


def scripted_dwpose_runner():
    """The port's ``DWPoseRunner`` (its YOLOX decode, NMS, crop affine and
    SimCC decode on the host) over the scripted nets."""
    from apex_studio_tpu_torch.preprocess.dwpose import DWPoseRunner

    runner = DWPoseRunner.__new__(DWPoseRunner)
    runner.det, runner.pose = ScriptedYOLOX(150), ScriptedSimCC(151)
    return runner


def write_nlf_checkpoint(models: Path):
    """The NLF crop model at the ``NLFConfig`` defaults (EfficientNetV2-L, a
    384 crop, 1048 points), seeded (``seeded_detector``, the canonical points
    a body-sized cloud), written as ``nlf_l_multi.safetensors`` under the
    published names (``nlf_published_state_dict``). Returns the CPU module."""
    import torch

    from apex_studio_tpu_torch.loaders.safetensors_io import save_safetensors
    from apex_studio_tpu_torch.preprocess import nlf

    model = seeded_detector(lambda: nlf.NLFCropModel(nlf.NLFConfig()), 152)
    g = torch.Generator().manual_seed(153)
    with torch.no_grad():
        model.canonical.copy_(torch.randn(model.canonical.shape, generator=g) * torch.tensor([0.3, 0.5, 0.15]))
    save_safetensors(models / "nlf_l_multi.safetensors",
                     {k: v.contiguous() for k, v in nlf.nlf_published_state_dict(model).items()})
    return model


def nlf_card_vs_cpu(cpu_model, image) -> dict:
    """The NLF estimator loaded by ``load_nlf`` from the written file onto the
    card: its crop model's f32 outputs (absolute joints, uncertainties) on
    the two boxes' crops against the seeded module on the CPU within
    F32_REL_L2; ``estimate`` twice, bit-identical."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.preprocess import nlf
    from apex_studio_tpu_torch.preprocess.weights import find_local

    boxes = np.array(NLF_BOXES, np.float32)
    t0 = time.perf_counter()
    est = nlf.load_nlf(find_local("nlf_l_multi"))
    load_s = time.perf_counter() - t0
    k = nlf.intrinsics_from_fov(*image.shape[:2])
    with torch.no_grad():
        crops, new_k, _ = nlf.extract_crops((torch.as_tensor(image).float() / 255.0) ** 2.2, boxes, k, 384)
        w, b = cpu_model.field_weights()
        t0 = time.perf_counter()
        ref = cpu_model(crops, w, b, torch.as_tensor(new_k))
        cpu_s = time.perf_counter() - t0
        wc, bc = est._weights()
        card = est.model(crops.cuda(), wc, bc, torch.as_tensor(new_k).cuda())
    errs = [rel_l2(c.cpu(), r) for c, r in zip(card, ref)]
    outs, secs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        outs.append(est.estimate(image, boxes))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    row = {"phase": "preprocess_pose", "check": "nlf_f32_card_vs_cpu", "parameters": sum(
        p.numel() for p in est.model.parameters()), "load_seconds": load_s, "cpu_forward_seconds": cpu_s,
           "rel_l2_abs_joints_and_uncertainty": errs, "tol": F32_REL_L2, "estimate_seconds": secs,
           "people_kept": len(outs[0]), "estimate_identical": len(outs[0]) == len(outs[1]) and all(
               np.array_equal(a, b) for a, b in zip(*outs)),
           "parameters_on_card": all(p.device.type == "cuda" for p in est.model.parameters())}
    emit(row)
    check(max(errs) <= F32_REL_L2, f"NLF's crop model on the card is {errs} from the CPU")
    check(row["estimate_identical"] and row["parameters_on_card"], f"the NLF estimator: {row}")
    del est
    release()
    return row


def phase_preprocess_pose(home: Path):
    """The last preprocessors on the card: the transformers delegates at
    their published widths (``write_hf_delegates``) twice each through their
    preprocessor on a 720x1280 image at the manifests' defaults
    (bit-identical, every parameter on the card), midas and oneformer also
    through ``/preprocessor/run``; the NLF crop model at the NLFConfig
    defaults from a seeded ``nlf_l_multi.safetensors`` against the CPU and
    its estimator twice; dwpose, pose2d, face2d, animalpose and dwpose_nlf
    (through its NLF branch) twice each on the scripted DWPose nets; the
    gated stubs raising; ``/preprocessor/list`` answering the registry's 54
    names and every manifest's. None of them reaches the flash kernel: 0
    launches."""
    import numpy as np
    import torch
    from PIL import Image

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention
    from apex_studio_tpu_torch.preprocess import preprocessor_registry
    from apex_studio_tpu_torch.server.app import create_app

    ph = home / "preprocess_pose"
    saved = {k: os.environ.get(k) for k in ("APEX_HOME_DIR", "APEX_PREPROCESSOR_MODELS_PATH", "HF_HUB_OFFLINE")}
    os.environ.update({"APEX_HOME_DIR": str(ph), "APEX_PREPROCESSOR_MODELS_PATH": str(ph / "models"),
                       "HF_HUB_OFFLINE": "1"})
    rows = []
    try:
        t0 = time.perf_counter()
        sizes = prewritten("preprocess_pose", home)
        nlf_cpu = write_nlf_checkpoint(ph / "models")
        write_s = time.perf_counter() - t0
        image = cv2_smooth(np.random.default_rng(154), (720, 1280))
        flash_attention.launches = 0
        for name, hub in HF_DELEGATES:
            release()
            torch.cuda.reset_peak_memory_stats()
            proc, params = preprocessor_registry.get(name)(), manifest_defaults(name)
            outs, secs = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                outs.append(proc(image, device=None, **params)[0])
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            row = {"phase": "preprocess_pose", "preprocessor": name, "model": hub, "params": params,
                   "seconds": secs, "shape": list(outs[0].shape), "identical": bool(np.array_equal(*outs)),
                   "distinct_values": int(len(np.unique(outs[0]))),
                   "parameters_on_card": all(p.device.type == "cuda" for p in proc._model.parameters()),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            emit(row)
            check(row["shape"] == [720, 1280, 3] and outs[0].dtype == np.uint8, f"{name} output {row['shape']}")
            check(row["identical"] and row["parameters_on_card"], f"{name}: {row}")
            rows.append(row)
            del proc
        rows.append(nlf_card_vs_cpu(nlf_cpu, image))
        del nlf_cpu

        from apex_studio_tpu_torch.preprocess import pose2d

        for name in POSE_NAMES:
            release()
            proc = preprocessor_registry.get(name)(runner=scripted_dwpose_runner())
            outs, secs = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                outs.append(proc(image, device=None, **manifest_defaults(name))[0])
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            row = {"phase": "preprocess_pose", "preprocessor": name, "runner": "scripted cv2.dnn nets",
                   "seconds": secs, "shape": list(outs[0].shape), "identical": bool(np.array_equal(*outs)),
                   "drawn_pixels": int(np.any(outs[0] != 0, axis=-1).sum())}
            if name == "dwpose_nlf":
                row["nlf_branch"] = isinstance(proc, pose2d.DWPoseNLFPreprocessor) and proc._nlf is not None
                row["nlf_on_card"] = row["nlf_branch"] and proc._nlf.device.type == "cuda"
                check(row["nlf_on_card"], "dwpose_nlf did not take its NLF branch on the card")
            emit(row)
            check(outs[0].dtype == np.uint8 and row["identical"] and row["drawn_pixels"] > 0, f"{name}: {row}")
            rows.append(row)
        gated = {}
        for name in GATED_NAMES:
            try:
                preprocessor_registry.get(name)()(image, device=None)
                gated[name] = "ran"
            except RuntimeError as e:
                gated[name] = str(e)
        check(all("requires the optional" in v for v in gated.values()), f"the gated stubs: {gated}")
        release()

        image_path = ph / "image.png"
        Image.fromarray(image).save(image_path)
        base, stop = start_server(create_app())
        try:
            listed = [e["name"] for e in http(base, "GET", "/preprocessor/list")[1]]
            served = {}
            for name in ("midas", "oneformer"):
                t0 = time.perf_counter()
                code, out = http(base, "POST", "/preprocessor/run", {"preprocessor_name": name,
                                                                     "input_path": str(image_path), "params": {}})
                check(code == 200, f"/preprocessor/run {name} answered {code}: {out}")
                st = wait_job(base, out["job_id"])
                served[name] = {"status": st["status"], "seconds_post_to_complete": time.perf_counter() - t0,
                                "result": Path(st.get("result_path") or "").name, "error": st.get("error")}
        finally:
            stop()
        emit({"phase": "preprocess_pose", "listed": listed, "served": served, "gated": gated,
              "models": {k: {"parameters": n, "mib": mib} for k, (n, mib) in sizes.items()},
              "write_seconds": write_s, "flash_launches": flash_attention.launches})
        # the registry's 54 names (the JAX registry's, tests/test_torch_preprocess_hf.py), then the
        # manifest ids that are aliases: every one of the 57 manifests listed
        from apex_studio_tpu_torch.preprocess.manifests import load_preprocessor_manifests

        names = preprocessor_registry.names()
        check(len(names) == 54 and listed[:54] == names and set(load_preprocessor_manifests()) <= set(listed),
              f"/preprocessor/list lists {listed}")
        check(all(v["status"] == "complete" for v in served.values()), f"/preprocessor/run jobs: {served}")
        check(flash_attention.launches == 0,
              f"the preprocess_pose path launched flash {flash_attention.launches} times")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        release()
    return rows


def torch_randn_like(z, seed: int):
    """Seeded normal values of ``z``'s shape on the card."""
    import torch

    return torch.randn(z.shape, generator=torch.Generator("cuda").manual_seed(seed), device="cuda")


# -- prompt extension ------------------------------------------------------------------------


class RecordingTokenizer:
    """The byte-level tokenizer, recording the ids each ``decode`` gets."""

    def __init__(self):
        self.tok, self.decoded = make_tokenizer(), []

    def encode(self, text, **kw):
        return self.tok.encode(text, **kw)

    def decode(self, ids):
        self.decoded.append(list(ids))
        return self.tok.decode(ids)


class plain_attention:
    """Within it, the flash backend runs the kernel's plain version."""

    def __enter__(self):
        from apex_studio_tpu_torch.ops.attention import attention_registry
        from apex_studio_tpu_torch.ops.attention.flash import flash_attention_reference

        self.saved = attention_registry.get("flash")
        attention_registry._entries["flash"] = flash_attention_reference

    def __exit__(self, *exc):
        from apex_studio_tpu_torch.ops.attention import attention_registry

        attention_registry._entries["flash"] = self.saved


def phase_prompt_extension(home: Path):
    """``PromptExtender`` on the resident synthetic Qwen3-4B (int8, the ZImage
    manifest's text encoder), greedy, 32 new tokens, the launches counted
    around ``generate``. Then, from the same prompt: prefill, and each decode
    step on the kernel against the same step on the plain attention route from
    the same caches (logits); and every position's hidden state against a full
    recompute of the padded sequence."""
    import torch

    from apex_studio_tpu_torch.engine import UniversalEngine
    from apex_studio_tpu_torch.ops.attention.flash import flash_attention
    from apex_studio_tpu_torch.prompt_extension import PromptExtender

    os.environ["APEX_SYNTHETIC_WEIGHTS"] = "int8"
    os.environ["APEX_HOME_DIR"] = str(home / "prompt_extension")
    engine = UniversalEngine(ZIMAGE_MANIFEST, device="cuda")
    engine.load_component_by_type("text_encoder")
    model = engine.text_encoder._ensure_model()
    check(len(model.layers) == QWEN3_LAYERS and model.cfg.num_attention_heads == QWEN3_HEADS,
          "the manifest's text encoder is not Qwen3-4B")
    tok = RecordingTokenizer()
    ext = PromptExtender(model, tok)
    prompt = "a lighthouse keeper at dusk"
    ext.generate(prompt, max_new_tokens=2, temperature=0.0)  # warm-up
    tok.decoded.clear()
    stamps = []
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = ext.generate(prompt, max_new_tokens=EXTEND_TOKENS, temperature=0.0,
                        progress_callback=lambda p, m, md: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    total, launches = time.perf_counter() - t0, flash_attention.launches
    generated = tok.decoded[-1]

    ids = list(make_tokenizer().encode(ext._chat(prompt), add_special_tokens=False).ids)
    n, cache_len = len(ids), len(ids) + EXTEND_TOKENS
    emb = model.embed_tokens
    logits = lambda h: torch.matmul(h, emb.t().to(h.dtype)).float()  # noqa: E731
    with torch.inference_mode():
        prompt_ids = torch.tensor([ids], device="cuda")
        ones = torch.ones_like(prompt_ids, dtype=torch.int32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hidden, caches = model.prefill(prompt_ids, ones, cache_len=cache_len)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        hs, step_rel, step_ms, tokens = [hidden[0, n - 1]], [], [], [int(logits(hidden[0, n - 1]).argmax())]
        for i, token in enumerate(generated):
            feed = torch.tensor([[token]], device="cuda")
            same_caches = [(k.clone(), v.clone()) for k, v in caches]
            with plain_attention():
                plain, _ = model.decode_step(feed, n + i, same_caches)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            h, caches = model.decode_step(feed, n + i, caches)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            step_rel.append(rel_l2(logits(h[0, 0]), logits(plain[0, 0])))
            tokens.append(int(logits(h[0, 0]).argmax()))
            hs.append(h[0, 0])
        del same_caches, caches
        # the whole sequence recomputed once, padded by 16 slots the mask hides
        full = torch.zeros(1, cache_len + 16, dtype=torch.long, device="cuda")
        full[0, :cache_len] = torch.tensor(ids + generated, device="cuda")
        mask = torch.zeros_like(full, dtype=torch.int32)
        mask[0, :cache_len] = 1
        recompute = model(full, attention_mask=mask, normalize_last=True)[0]
        recompute_rel = [rel_l2(h, recompute[n - 1 + j]) for j, h in enumerate(hs)]
    row = {"phase": "prompt_extension", "model": "Qwen3-4B (synthetic int8)", "prompt_tokens": n,
           "new_tokens": len(generated), "cache_len": cache_len, "text_chars": len(text),
           "seconds_total": total, "seconds_prefill": prefill_s,
           "ms_per_token": (total - prefill_s) / len(generated) * 1e3, "decode_step_ms": step_ms,
           "median_decode_step_ms": statistics.median(step_ms),
           "seconds_per_step": [(b - a) for a, b in zip([t0] + stamps[:-1], stamps)],
           "flash_launches": launches, "flash_launches_per_token": launches / len(generated),
           "flash_launches_expected": QWEN3_LAYERS * EXTEND_TOKENS,
           "logits_kernel_vs_plain_rel_l2_max": max(step_rel), "logits_rel_l2_by_step": step_rel,
           "cached_vs_recompute_rel_l2_max": max(recompute_rel), "tol_rel_l2": QWEN3_REL_L2,
           "greedy_tokens_reproduced": tokens[:-1] == generated}
    emit(row)
    check(len(generated) == EXTEND_TOKENS, f"prompt extension generated {len(generated)} tokens")
    check(launches == QWEN3_LAYERS * EXTEND_TOKENS,
          f"prompt extension launched the kernel {launches} times, expected {QWEN3_LAYERS * EXTEND_TOKENS}")
    check(row["greedy_tokens_reproduced"], "the decode steps did not reproduce generate's greedy tokens")
    check(max(step_rel) <= QWEN3_REL_L2, f"decode logits on the kernel are {max(step_rel)} from the plain route")
    check(max(recompute_rel) <= QWEN3_REL_L2,
          f"prefill + decode_step are {max(recompute_rel)} from a full recompute")
    del engine, model, ext, recompute, hs
    release()
    return [row]


# -- RIFE ------------------------------------------------------------------------------------


def write_rife_weights(models: Path):
    """The seeded ``rife_v4`` checkpoint (default RIFEConfig, f32, ``torch``'s
    global generator at seed 0) in Practical-RIFE's naming, where the
    postprocessor looks for it under ``models``; returns its path and the net."""
    import torch

    from apex_studio_tpu_torch.loaders.export import published_state_dict
    from apex_studio_tpu_torch.loaders.safetensors_io import save_safetensors
    from apex_studio_tpu_torch.postprocess.rife import IFNet, RIFEConfig

    torch.manual_seed(0)
    net = IFNet(RIFEConfig())
    path = models / "rife_v4.safetensors"
    save_safetensors(path, published_state_dict("rife", net.state_dict()))
    return path, net


def phase_rife(home: Path, frames=None):
    """``rife_v4`` through ``run_postprocessor`` with the default RIFEConfig and
    seeded f32 weights, written in Practical-RIFE's naming where the
    postprocessor looks for them, over 33 frames of 720x1280 (the hyv15
    phase's t2v frames, else seeded ones): multiplier 2 gives 65 frames. One
    interpolated frame is held against the same weights on the CPU. The cv2
    ``frame_interpolation`` runs once first, while no RIFE checkpoint is
    installed (with one it would run RIFE)."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.postprocess import run_postprocessor
    from apex_studio_tpu_torch.postprocess.rife import RIFEPostprocessor, load_rife

    models = home / "rife_models"
    models.mkdir()
    os.environ["APEX_PREPROCESSOR_MODELS_PATH"] = str(models)
    source = "hyv15 t2v frames" if frames else "seeded"
    if frames is None:
        rng = np.random.default_rng(7)
        frames = [cv2_smooth(rng, RIFE_SIZE) for _ in range(RIFE_FRAMES)]
    h, w = RIFE_SIZE
    check(len(frames) == RIFE_FRAMES and frames[0].shape == (h, w, 3), "rife: unexpected input frames")

    t0 = time.perf_counter()
    flow = run_postprocessor("frame_interpolation", frames[:3], {"multiplier": 2})
    cv2_s = time.perf_counter() - t0
    check(len(flow) == 5 and all(f.shape == (h, w, 3) and f.dtype == np.uint8 for f in flow),
          "frame_interpolation: bad frames")

    path, net = write_rife_weights(models)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_postprocessor("rife_v4", frames, {"multiplier": 2})
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    check(len(out) == 2 * RIFE_FRAMES - 1 and all(f.shape == (h, w, 3) and f.dtype == np.uint8 for f in out),
          f"rife: {len(out)} frames, expected {2 * RIFE_FRAMES - 1} of {h}x{w}x3")
    check(all(np.array_equal(out[2 * i], f) for i, f in enumerate(frames)), "rife changed an input frame")

    card, cpu = load_rife(path, "cuda"), load_rife(path, "cpu")
    pad = ((0, -h % 32), (0, -w % 32), (0, 0))
    x0, x1 = (torch.from_numpy(np.pad(f, pad, mode="edge")).permute(2, 0, 1)[None].float() / 255.0
              for f in frames[:2])
    with torch.inference_mode():
        on_card = card(x0.cuda(), x1.cuda(), 0.5).cpu()
        on_cpu = cpu(x0, x1, 0.5)
    float_err = (on_card - on_cpu).abs().max().item()
    cpu_frame = RIFEPostprocessor(model=cpu)._pair(frames[0], frames[1], 0.5)
    level_diff = int(np.abs(out[1].astype(int) - cpu_frame.astype(int)).max())
    row = {"phase": "rife", "frames_source": source, "frames_in": len(frames), "frames_out": len(out),
           "frame_shape": list(out[0].shape), "config": "RIFEConfig() widths (192, 128, 96, 64), scales 8/4/2/1",
           "parameters": sum(p.numel() for p in net.parameters()), "seconds_total": total,
           "seconds_per_interpolated_frame": total / (RIFE_FRAMES - 1),
           "card_vs_cpu_max_abs": float_err, "tol_max_abs": RIFE_MAX_ABS,
           "card_vs_cpu_uint8_max_level_diff": level_diff, "tol_uint8_levels": 1,
           "frame_interpolation_cv2_frames": len(flow), "frame_interpolation_cv2_seconds": cv2_s}
    emit(row)
    check(float_err <= RIFE_MAX_ABS, f"rife on the card is {float_err} from the CPU (limit {RIFE_MAX_ABS})")
    check(level_diff <= 1, f"rife's interpolated frame is {level_diff} levels from the CPU's")
    del card, cpu, out
    release()
    return row


# -- the engine server -----------------------------------------------------------------------


def start_server(app):
    """Serve ``app`` on 127.0.0.1 at an ephemeral port from a thread with its
    own event loop; returns the base URL and a function that stops it (the
    app's cleanup shuts its job executor down)."""
    import asyncio
    import threading

    from aiohttp import web

    loop, started, box = asyncio.new_event_loop(), threading.Event(), {}

    def run():
        asyncio.set_event_loop(loop)

        async def up():
            runner = web.AppRunner(app)
            await runner.setup()
            await web.TCPSite(runner, "127.0.0.1", 0).start()
            box["runner"], box["port"] = runner, runner.addresses[0][1]

        try:
            loop.run_until_complete(up())
        finally:
            started.set()
        loop.run_forever()
        loop.run_until_complete(box["runner"].cleanup())
        loop.close()

    thread = threading.Thread(target=run, daemon=True, name="smoke-server")
    thread.start()
    check(started.wait(60) and "port" in box, "the server did not start")

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        check(not thread.is_alive(), "the server's thread did not stop")

    return f"http://127.0.0.1:{box['port']}", stop


def http(base: str, method: str, path: str, body=None, timeout: float = 120):
    """(status, JSON body or raw bytes) of one request over HTTP."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, ctype, raw = r.status, r.headers.get_content_type(), r.read()
    except urllib.error.HTTPError as e:
        status, ctype, raw = e.code, e.headers.get_content_type(), e.read()
    return status, (json.loads(raw) if ctype == "application/json" else raw)


def served_request(base: str, job_id: str, inputs: dict, cancel_at_first_step: bool = False) -> dict:
    """Subscribe to ``/ws/job/{job_id}``, then ``POST /engine/run`` with that
    id, and read the stream to its terminal message; with
    ``cancel_at_first_step``, ``POST /engine/cancel`` once the first step
    message arrives. Returns the messages with their host times (seconds from
    the POST) and the cancel's time."""
    import asyncio

    import aiohttp

    async def go():
        out = {"messages": [], "cancel_s": None}
        async with aiohttp.ClientSession() as session:
            async with session.ws_connect(f"{base}/ws/job/{job_id}", heartbeat=30) as ws:
                t0 = time.perf_counter()
                async with session.post(f"{base}/engine/run", json={
                        "manifest_id": "zimage-turbo", "job_id": job_id, "inputs": inputs}) as r:
                    check(r.status == 200, f"POST /engine/run answered {r.status}: {await r.text()}")
                while True:
                    msg = await ws.receive_json(timeout=600)
                    out["messages"].append((time.perf_counter() - t0, msg))
                    if (cancel_at_first_step and out["cancel_s"] is None
                            and msg["message"].startswith("Denoising step")):
                        out["cancel_s"] = time.perf_counter() - t0
                        async with session.post(f"{base}/engine/cancel/{job_id}") as r:
                            check(r.status == 200 and (await r.json())["canceled"], "the cancel was refused")
                    if msg["status"] in ("complete", "error", "canceled"):
                        return out

    return asyncio.run(go())


def first_at(messages, pred):
    return next((t for t, m in messages if pred(m)), None)


def process_gone(pid: int) -> bool:
    """The process has exited (a zombie left unreaped counts as exited)."""
    try:
        return Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0] == "Z"
    except (FileNotFoundError, IndexError):
        return True


def server_cli(env: dict) -> dict:
    """``python3 -m apex_studio_tpu_torch.cli start`` on a free port as a
    subprocess with ``env`` (its own home); ``status``, ``/ready`` and
    ``/system/memory`` (in that process, on the card) answer; ``stop`` ends
    it. No engine runs."""
    import socket

    import torch

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])

    def cli(*args, timeout=180):
        out = subprocess.run([sys.executable, "-m", "apex_studio_tpu_torch.cli", *args, "--port", port],
                             cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
        check(out.returncode == 0, f"cli {args[0]} exited {out.returncode}: {out.stderr[-2000:]}")
        return out.stdout.strip()

    t0 = time.perf_counter()
    started = cli("start", "--timeout", "150")
    start_s = time.perf_counter() - t0
    pid = int((Path(env["APEX_HOME_DIR"]) / "apex-engine.pid").read_text())
    try:
        status = json.loads(cli("status"))
        base = f"http://127.0.0.1:{port}"
        ready = http(base, "GET", "/ready")
        memory = http(base, "GET", "/system/memory")
        stopped = cli("stop")
        deadline = time.time() + 60
        while not process_gone(pid) and time.time() < deadline:
            time.sleep(0.2)
        gone = process_gone(pid)
    finally:
        if not process_gone(pid):
            os.kill(pid, 9)
    devices = memory[1].get("devices", []) if memory[0] == 200 else []
    row = {"cli_start": started, "cli_start_seconds": start_s, "cli_status": status, "cli_ready": ready,
           "cli_memory_devices": devices, "cli_stop": stopped, "cli_exited": gone}
    check(started.startswith(f"ready at {base}"), f"cli start: {started}")
    check(status == {"ready": True} and ready == (200, {"ready": True}), f"cli status {status}, /ready {ready}")
    check([d["kind"] for d in devices] == [torch.cuda.get_device_name(0)] * torch.cuda.device_count(),
          f"the CLI server's /system/memory lists {devices}")
    check(stopped == "shutdown requested" and gone, f"cli stop: {stopped}; exited {gone}")
    return row


def phase_server(home: Path, zimage_frame=None) -> list:
    """The port's engine server on the card: ``create_app()`` (device: the
    card) on 127.0.0.1 at an ephemeral port, in a thread with its own loop,
    over the repository's manifests, with synthetic int8 weights and the
    byte-level tokenizer saved where zimage-turbo.yml names its tokenizer.
    Over real HTTP and WS: three ZImage Turbo requests at the manifest's
    defaults (1024², 9 steps; (A, 0), (B, 1), (A, 0)), each read to
    ``complete`` with 2 previews and its PNG fetched over
    ``/files/engine_results``: requests 1 and 3 bit-identical, 2 different, 1
    equal to the zimage phase's frame, 3 served by the pooled engine with no
    component loaded again, 306 flash launches each; a fourth request
    cancelled at its first step message and a fifth that completes;
    ``/mask/create`` against ``mask_from_points``;
    ``/postprocessor/frame-interpolate`` with ``rife_v4`` on 9 seeded
    720x1280 frames against ``run_postprocessor``; ``/system/memory``,
    ``/system/step-trace`` and ``/system/free-memory``; the CLI in a
    subprocess beside them. Returns the completed requests' rows."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np
    import torch
    import yaml
    from PIL import Image

    from apex_studio_tpu_torch.manifest.resolver import ManifestResolver
    from apex_studio_tpu_torch.mask import mask_from_points, mask_to_contours
    from apex_studio_tpu_torch.ops.attention.flash import flash_attention
    from apex_studio_tpu_torch.postprocess import run_postprocessor
    from apex_studio_tpu_torch.preprocess.base import load_frames
    from apex_studio_tpu_torch.server.app import create_app
    from apex_studio_tpu_torch.server.warm_pool import warm_pool
    from apex_studio_tpu_torch.utils.media import save_video

    phase_t0 = time.perf_counter()
    release()
    base_allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sh = home / "server"
    os.environ.update({"APEX_HOME_DIR": str(sh), "APEX_SYNTHETIC_WEIGHTS": "int8", "APEX_STEP_TRACE": "1",
                       "APEX_PREPROCESSOR_MODELS_PATH": str(sh / "rife_models")})
    tok = sh / "components" / "Tongyi-MAI" / "Z-Image-Turbo" / "tokenizer" / "tokenizer.json"
    tok.parent.mkdir(parents=True)
    make_tokenizer().save(str(tok))
    (sh / "rife_models").mkdir()
    write_rife_weights(sh / "rife_models")
    run = yaml.safe_load(ZIMAGE_MANIFEST.read_text())["spec"]["defaults"]["run"]
    check(run["num_inference_steps"] == ZIMAGE_STEPS and run["guidance_scale"] == 0.0
          and run["height"] == run["width"] == SIZE, f"the manifest's defaults changed: {run}")
    expected = ZIMAGE_LAUNCHES * ZIMAGE_STEPS
    # the CLI in a process of its own beside the served requests: host work (its imports and start), no engine
    cli_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="server-cli")
    cli_job = cli_pool.submit(server_cli, {**os.environ, "APEX_HOME_DIR": str(home / "cli")})
    base, stop = start_server(create_app(resolver=ManifestResolver(search_paths=[REPO / "manifests"])))
    rows, frames, loads = [], [], []
    try:
        check(http(base, "GET", "/system/step-trace?clear=1")[0] == 200, "/system/step-trace failed")
        for i, (prompt, seed) in enumerate([(PROMPT_A, 0), (PROMPT_B, 1), (PROMPT_A, 0), (PROMPT_B, 3),
                                            (PROMPT_B, 2)]):
            job_id, cancel = f"served-{i + 1}", i == 3
            flash_attention.launches = 0
            got = served_request(base, job_id, {"prompt": prompt, "seed": seed}, cancel_at_first_step=cancel)
            launches, msgs = flash_attention.launches, got["messages"]
            final_s, final = msgs[-1]
            status = http(base, "GET", f"/jobs/status/{job_id}")[1]["status"]
            step = next(((t, m["message"]) for t, m in msgs if m["message"].startswith("Denoising step")),
                        (None, None))
            row = {"phase": "server", "request": i + 1, "job_id": job_id, "prompt": prompt[:40], "seed": seed,
                   "status": final["status"], "job_status": status, "seconds_post_to_terminal": final_s,
                   "seconds_to_first_step_message": step[0], "first_step_message": step[1],
                   "seconds_to_first_preview": next((t for t, m in msgs if m["status"] == "preview"), None),
                   "previews": sum(m["status"] == "preview" for _, m in msgs), "ws_messages": len(msgs),
                   "flash_launches": launches, "flash_launches_expected": expected, "steps": ZIMAGE_STEPS}
            if cancel:
                row.update(flash_launches_expected=None, seconds_cancel_to_canceled=final_s - got["cancel_s"])
                emit(row)
                check(final["status"] == status == "canceled", f"the cancelled request ended {final['status']}")
                cancel_row = row
                continue
            code, png = http(base, "GET", final["metadata"]["preview_url"])
            frame = np.asarray(Image.open(io.BytesIO(png)).convert("RGB")) if code == 200 else None
            row["frame"] = None if frame is None else list(frame.shape)
            emit(row)
            check(final["status"] == status == "complete", f"served request {i + 1} ended {final['status']}")
            check(row["previews"] == 2, f"served request {i + 1}: {row['previews']} previews, expected 2")
            check(launches == expected, f"served request {i + 1}: flash launched {launches} times, "
                                        f"expected {expected}")
            check(row["frame"] == [SIZE, SIZE, 3], f"served request {i + 1}: GET output.png {code}, {row['frame']}")
            frames.append(frame)
            if i == 0:  # the pooled engine: its components, and every component load from here on
                (engine, _), = warm_pool._entries.values()
                parts = {c: getattr(engine, c) for c in ("transformer", "vae", "text_encoder", "scheduler")}
                load = engine.load_component_by_type
                engine.load_component_by_type = lambda *a, **k: (loads.append(a[0]), load(*a, **k))[1]
            if i == 2:
                (pooled, _), = warm_pool._entries.values()
                same_engine = pooled is engine and all(getattr(pooled, c) is m for c, m in parts.items())
                del pooled
            rows.append(row)
        del engine, parts, load
        records = http(base, "GET", "/system/step-trace")[1]["records"]
        trace = {r["job_id"]: r["wall_s"] for r in records if r["name"] == "engine.run"}
        acquire = {r["job_id"]: r["wall_s"] for r in records if r["name"] == "engine.acquire"}
        memory = http(base, "GET", "/system/memory")[1]

        # the point mask on a seeded 1024² image, over HTTP and directly
        rng = np.random.default_rng(11)
        image = rng.integers(0, 30, (SIZE, SIZE, 3)).astype(np.uint8)
        yy, xx = np.mgrid[:SIZE, :SIZE]
        image[(yy - 400) ** 2 + (xx - 600) ** 2 <= 150 ** 2] = [200, 80, 80]
        Image.fromarray(image).save(sh / "mask_input.png")
        points = [{"x": 600, "y": 400}]
        t0 = time.perf_counter()
        code, mask_out = http(base, "POST", "/mask/create", {"input_path": str(sh / "mask_input.png"),
                                                             "points": points})
        mask_s = time.perf_counter() - t0
        check(code == 200 and mask_out["status"] == "success", f"/mask/create answered {code}: {mask_out}")
        direct = mask_to_contours(mask_from_points(image, points))

        def fill(contours):
            m = np.zeros((SIZE, SIZE), np.uint8)
            for c in contours:
                cv2.fillPoly(m, [np.asarray(c, np.float64).reshape(-1, 2).round().astype(np.int32)], 1)
            return m.astype(bool)

        a, b = fill(mask_out["contours"]), fill(direct)
        mask_iou = float((a & b).sum() / max((a | b).sum(), 1))

        # RIFE 2x on 9 seeded 720x1280 frames, over HTTP and directly
        rng = np.random.default_rng(12)
        clip = save_video([cv2_smooth(rng, RIFE_SIZE) for _ in range(9)], sh / "clip.mp4", fps=16)
        t0 = time.perf_counter()
        code, job = http(base, "POST", "/postprocessor/frame-interpolate",
                         {"input_path": str(clip), "name": "rife_v4", "multiplier": 2, "fps": 16})
        check(code == 200, f"/postprocessor/frame-interpolate answered {code}: {job}")
        deadline = time.time() + 300
        while True:
            st = http(base, "GET", f"/jobs/status/{job['job_id']}")[1]
            if st["status"] in ("complete", "error", "canceled") or time.time() > deadline:
                break
            time.sleep(0.05)
        interp_s = time.perf_counter() - t0
        check(st["status"] == "complete", f"the interpolation job ended {st['status']}: {st.get('error')}")
        served_frames = load_frames(st["result_path"])
        direct_frames = load_frames(save_video(
            run_postprocessor("rife_v4", load_frames(clip), {"multiplier": 2}, device="cuda"),
            sh / "direct.mp4", fps=32))
        interp_equal = len(served_frames) == len(direct_frames) == 17 and all(
            np.array_equal(x, y) for x, y in zip(served_frames, direct_frames))

        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        freed = http(base, "POST", "/system/free-memory")
        after_free = torch.cuda.memory_allocated()
    finally:
        stop()
    cli_row = cli_job.result()
    cli_pool.shutdown()
    served_s = [r["seconds_post_to_terminal"] for r in rows]
    engine_s = [trace.get(r["job_id"]) for r in rows]
    zimage_equal = None if zimage_frame is None else bool(np.array_equal(frames[0], zimage_frame))
    summary = {
        "phase": "server", "manifest": ZIMAGE_MANIFEST.name, "weights": "int8", "size": SIZE,
        "steps": ZIMAGE_STEPS, "requests": [r["request"] for r in rows],
        "seconds_per_served_request": served_s, "engine_run_seconds": engine_s,
        "engine_acquire_seconds": [acquire.get(r["job_id"]) for r in rows],
        "seconds_server_adds": [a - b for a, b in zip(served_s, engine_s) if b is not None],
        "seconds_to_first_preview": {"cold": rows[0]["seconds_to_first_preview"],
                                     "warm": rows[2]["seconds_to_first_preview"]},
        "seconds_to_first_step_message": {"cold": rows[0]["seconds_to_first_step_message"],
                                          "warm": rows[2]["seconds_to_first_step_message"]},
        "seconds_cancel_latency": cancel_row["seconds_cancel_to_canceled"],
        "cancel_flash_launches": cancel_row["flash_launches"], "peak_gib": peak_gib,
        "requests_1_3_identical": bool(np.array_equal(frames[0], frames[2])),
        "requests_1_2_differ": not np.array_equal(frames[0], frames[1]),
        "request_1_equals_zimage_phase_frame": "zimage phase not run" if zimage_equal is None else zimage_equal,
        "request_3_pooled_engine": same_engine, "component_loads_after_request_1": loads,
        "flash_launches_per_request": [r["flash_launches"] for r in rows],
        "memory_devices": memory["devices"], "mask_iou": mask_iou,
        "mask_contours_equal": mask_out["contours"] == direct, "mask_seconds": mask_s,
        "interpolation_frames": len(served_frames), "interpolation_equal_to_run_postprocessor": interp_equal,
        "interpolation_seconds": interp_s, "free_memory": list(freed),
        "allocated_gib_before_phase": base_allocated / 2**30, "allocated_gib_after_free": after_free / 2**30,
        **cli_row, "phase_seconds": time.perf_counter() - phase_t0,
    }
    emit(summary)
    check(summary["requests_1_3_identical"], "served requests 1 and 3 (same prompt and seed) differ")
    check(summary["requests_1_2_differ"], "served requests 1 and 2 (other prompt and seed) are identical")
    check(zimage_equal is not False, "served request 1 differs from the zimage phase's first frame")
    check(same_engine and not loads, f"request 3 did not reuse the pooled engine as it was (loads {loads})")
    check([d["kind"] for d in memory["devices"]] == [torch.cuda.get_device_name(0)],
          f"/system/memory lists {memory['devices']}")
    check(None not in engine_s, f"/system/step-trace lacks engine.run records: {trace}")
    check(mask_iou == 1.0 and summary["mask_contours_equal"], f"/mask/create against mask_from_points: IoU {mask_iou}")
    check(interp_equal, f"the served interpolation ({len(served_frames)} frames) differs from run_postprocessor's")
    check(freed[0] == 200 and abs(after_free - base_allocated) <= 2**30,
          f"/system/free-memory left {after_free / 2**30} GiB allocated ({base_allocated / 2**30} before the phase)")
    return rows


# The preprocess phases' checkpoint files (host work: seeded nets serialised at their published widths) are
# written by one child process, this script with ``--write-checkpoints``, while the card's phases after
# ``timing`` run; the child sees no card (``CUDA_VISIBLE_DEVICES`` empty) and takes CHILD_THREADS of the
# host's cores. Each phase waits for its own files (``prewritten``). Run alone, a phase writes them itself.
CHILD_THREADS = 2
PREWRITERS = {"preprocess": "write_preprocessor_checkpoints", "preprocess_nets": "write_preprocess_net_checkpoints",
              "preprocess_rest": "write_preprocess_rest_checkpoints", "preprocess_pose": "write_hf_delegates"}
_PREWRITE = {"proc": None, "log": None}


def write_checkpoints(home: Path, phases: str) -> None:
    """(The child process.) Each phase's checkpoints under ``home/<phase>/models``,
    then their sizes and seconds in ``home/<phase>/prewritten.json``."""
    import torch

    check(not torch.cuda.is_available(), "the checkpoint writer sees a card")
    torch.set_num_threads(CHILD_THREADS)
    for phase in phases.split(","):
        t0 = time.perf_counter()
        sizes = globals()[PREWRITERS[phase]](home / phase / "models")
        (home / phase / "prewritten.json").write_text(json.dumps({"sizes": sizes,
                                                                  "seconds": time.perf_counter() - t0}))


def start_prewrite(home: Path, phases) -> None:
    """Start the child process that writes the checkpoints of the preprocess
    phases in ``phases``, offline, its output in ``home/prewrite.log``."""
    wanted = [p for p in PREWRITERS if p in phases]
    if not wanted:
        return
    log = open(home / "prewrite.log", "w")
    env = dict(os.environ, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1", CUDA_VISIBLE_DEVICES="")
    _PREWRITE.update(log=log, proc=subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--write-checkpoints", str(home), ",".join(wanted)],
        env=env, stdout=log, stderr=subprocess.STDOUT))


def prewritten(phase: str, home: Path) -> dict:
    """``phase``'s checkpoint sizes, its files under ``home/<phase>/models``:
    the child's, waited for, where one was started; else written now."""
    proc, done = _PREWRITE["proc"], home / phase / "prewritten.json"
    if proc is None:
        return globals()[PREWRITERS[phase]](home / phase / "models")
    while not done.exists() and proc.poll() is None:
        time.sleep(0.1)
    if not done.exists():
        _PREWRITE["log"].flush()
        tail = (home / "prewrite.log").read_text()[-2000:]
        check(False, f"the checkpoint writer exited {proc.returncode} before {phase}'s files: {tail}")
    written = json.loads(done.read_text())
    emit({"phase": phase, "checkpoints_written_beside_the_card_seconds": written["seconds"]})
    return written["sizes"]


def stop_prewrite() -> None:
    """Wait for the child (ending it where a failure cut the run short)."""
    proc, log = _PREWRITE["proc"], _PREWRITE["log"]
    if proc is not None:
        if proc.poll() is None:
            proc.terminate()
        proc.wait()
        log.close()
        _PREWRITE.update(proc=None, log=None)


# the transformers classes the delegates of ``preprocess_pose`` load (their modules import most of
# transformers and torch._dynamo: tens of seconds of host work)
HF_DELEGATE_CLASSES = ("AutoModelForDepthEstimation", "AutoModelForSemanticSegmentation", "AutoTokenizer",
                       "DPTForDepthEstimation", "ZoeDepthForDepthEstimation", "DepthAnythingForDepthEstimation",
                       "SegformerForSemanticSegmentation", "OneFormerForUniversalSegmentation",
                       "OneFormerProcessor", "DPTImageProcessorPil", "ZoeDepthImageProcessorPil",
                       "SegformerImageProcessorPil", "OneFormerImageProcessorPil")


def preload_modules(phases) -> None:
    """Import every family and engine module of the port (their registration
    side effects run as on first use) and, where ``preprocess_pose`` runs,
    the transformers classes of its delegates (``HF_DELEGATE_CLASSES``; a
    name the installed version lacks is skipped: the phase reports it)."""
    import importlib

    from apex_studio_tpu_torch.engine.registry import _ENGINE_MODULES
    from apex_studio_tpu_torch.models.registry import _load_builtin_families

    _load_builtin_families()
    for mod in _ENGINE_MODULES:
        importlib.import_module(mod)
    if "preprocess_pose" in phases:
        import transformers

        for name in HF_DELEGATE_CLASSES:
            try:
                getattr(transformers, name)
            except (AttributeError, ImportError, RuntimeError):
                pass


def ptxas_report(log: str) -> dict:
    """What ptxas said in the build log (``-Xptxas -v``): registers and spill
    bytes of each kernel for sm_90a, and every warning, C7508 (``setmaxnreg``
    ignored) among them."""
    import re

    functions, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)' for 'sm_90a'", line)
        if m:
            name = m.group(1)
            functions.append({"name": name, "registers": None, "spill_bytes": 0})
        elif name and "spill stores" in line:
            functions[-1]["spill_bytes"] = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif name and "Used" in line and "registers" in line:
            functions[-1]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    warnings = [ln.strip() for ln in log.splitlines() if "warning" in ln.lower() or "C75" in ln]
    return {"functions": functions, "warnings": warnings,
            "setmaxnreg_ignored": any("C7508" in w for w in warnings)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=DEFAULT_PHASES)
    ap.add_argument("--write-checkpoints", nargs=2, metavar=("HOME", "PHASES"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if args.write_checkpoints:
        sys.path.insert(0, str(REPO))
        write_checkpoints(Path(args.write_checkpoints[0]), args.write_checkpoints[1])
        return 0

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: CUDA is not available", file=sys.stderr)
        return 2
    if not (REPO / "apex_studio_tpu_torch" / "csrc" / "flash_attn.cu").is_file():
        print("chip_smoke: FAIL: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    (REPO / "build").mkdir(exist_ok=True)
    home = Path(tempfile.mkdtemp(prefix="smoke_home_", dir=REPO / "build"))
    os.environ.update(APEX_HOME_DIR=str(home), HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1")
    wall_start, wall = time.perf_counter(), {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        finish_background_checks()  # the phase's CPU references, before its time is read
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        return out

    try:
        card = card_line()
        from apex_studio_tpu_torch.ops.attention import flash as flash_mod

        preload = threading.Thread(target=preload_modules, args=(phases,), name="preload")
        preload.start()
        t0 = time.perf_counter()
        lib = flash_mod.build()
        build_s = time.perf_counter() - t0
        log = sorted(flash_mod.build_dir().glob("flash_attn_*.log"))
        ptxas = ptxas_report(log[-1].read_text() if log else "")
        emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "kernel_build_seconds": build_s,
              "smem_bytes_a_block": {d: lib.apex_flash_attn_smem_bytes(d) for d in (16, 32, 56, 64, 72, 96, 128)},
              **ptxas})
        check(bool(ptxas["functions"]), "the build log names no kernel")
        spilled = [f["name"] for f in ptxas["functions"] if f["spill_bytes"]]
        check(not spilled, f"ptxas spilled registers in {spilled}")
        # the modules imported beside the kernel's build (``preload_modules``; no other import runs
        # meanwhile), then every object so far frozen: ``release`` collects after each kernel row and
        # request, and a full collection need not scan what lives to the end
        t0 = time.perf_counter()
        preload.join()
        emit({"phase": "preload", "seconds_waited_after_the_build": time.perf_counter() - t0})
        gc.collect()
        gc.freeze()
        flux_err, case_err = timed("kernels", phase_kernels) if "kernels" in phases else (None, {})
        timing, zimage_timing = timed("timing", phase_timing) if "timing" in phases else (None, [])
        start_prewrite(home, phases)
        if "reference" in phases:
            timed("reference", phase_reference)
        if "residency" in phases:
            timed("residency", phase_residency)
        if "checkpoint" in phases:
            timed("checkpoint", phase_checkpoint, home)
        # The paths through the engine, each request with the launch count set
        # to 0 just before it and read just after.
        paths = {}
        if "main" in phases:
            paths["main_int8_lora"], engine = timed("main", phase_main, home)
            if "trace" in phases:
                timed("trace", phase_trace, engine)
            del engine
            release()
        else:
            check("trace" not in phases, "the trace phase runs after the main phase")
        if "bf16" in phases:
            paths["bf16"] = timed("bf16", drive, "bf16", "bf16", [(PROMPT_A, 0)], STEPS, home)[0]
            release()
        if "int4" in phases:
            paths["int4"] = timed("int4", drive, "int4", "int4", [(PROMPT_A, 0)], 2, home)[0]
            release()
        hyv15_rows, hyv15_err, hyv15_frames = [], None, None
        if "hyv15" in phases:
            paths["hyv15"], hyv15_rows, hyv15_err, hyv15_frames = timed("hyv15", phase_hyv15, home)
            release()
        zimage_frame = None
        if "zimage" in phases:
            zimage_paths, _, zimage_frame = timed("zimage", phase_zimage, home, zimage_timing)
            paths.update(zimage_paths)
            release()
        server_rows = []
        if "server" in phases:
            server_rows = timed("server", phase_server, home, zimage_frame)
            del zimage_frame
            release()
        if "qwenimage" in phases:
            qwenimage_paths, _ = timed("qwenimage", phase_qwenimage, home, zimage_timing)
            paths.update(qwenimage_paths)
            release()
        if "wan" in phases:
            wan_paths, _ = timed("wan", phase_wan, home, zimage_timing)
            paths.update(wan_paths)
            release()
        if "wan_edit" in phases:
            paths.update(timed("wan_edit", phase_wan_edit, home, zimage_timing))
            release()
        if "wan_causal" in phases:
            paths.update(timed("wan_causal", phase_wan_causal, home, zimage_timing))
            release()
        if "flux_edit" in phases:
            paths.update(timed("flux_edit", phase_flux_edit, home, zimage_timing))
            release()
        if "flux2" in phases:
            paths.update(timed("flux2", phase_flux2, home, zimage_timing)[0])
            release()
        path_rows, path_err = {}, {}
        for name, phase in (("hyv", phase_hyv), ("humo", phase_humo), ("s2v", phase_s2v),
                            ("multitalk", phase_multitalk), ("avatar", phase_avatar), ("skyreels", phase_skyreels),
                            ("wan_5b", phase_wan_5b), ("wan_more", phase_wan_more),
                            ("image_rest", phase_image_rest), ("video_rest", phase_video_rest),
                            ("hunyuanimage3", phase_hunyuanimage3), ("cogvideox", phase_cogvideox),
                            ("mochi", phase_mochi), ("ltx", phase_ltx), ("ltx2", phase_ltx2),
                            ("magi", phase_magi), ("flashvsr", phase_flashvsr)):
            if name in phases:
                new_paths, path_rows[name], path_err[name] = timed(name, phase, home)
                paths.update(new_paths)
                release()
        if "prompt_extension" in phases:
            paths["prompt_extension"] = timed("prompt_extension", phase_prompt_extension, home)
        if "rife" in phases:
            timed("rife", phase_rife, home, hyv15_frames)
            del hyv15_frames
        if "sam2" in phases:
            new_paths, path_rows["sam2"], path_err["sam2"] = timed("sam2", phase_sam2, home)
            paths.update(new_paths)
        if "preprocess" in phases:
            timed("preprocess", phase_preprocess, home)
        if "preprocess_nets" in phases:
            timed("preprocess_nets", phase_preprocess_nets, home)
        if "preprocess_rest" in phases:
            timed("preprocess_rest", phase_preprocess_rest, home)
        if "preprocess_pose" in phases:
            timed("preprocess_pose", phase_preprocess_pose, home)
        if len(paths) > 1:
            # a one-step request gives its one step
            emit({"phase": "steps", "median_seconds_per_step_after_the_first": {
                name: statistics.median(t for r in ([r for r in rows if not r.get("linear_hooks_on")] or rows)
                                        for t in (r["seconds_per_step"][1:] or r["seconds_per_step"]))
                for name, rows in paths.items()}})
        by_path = {name: sum(r["flash_launches"] for r in rows) for name, rows in paths.items()}
        per_step = {name: by_path[name] // sum(len(r["seconds_per_step"]) for r in rows)
                    for name, rows in paths.items()}
        if server_rows:  # served requests: counted from POST to complete, steps as the manifest sets
            by_path["server"] = sum(r["flash_launches"] for r in server_rows)
            per_step["server"] = by_path["server"] // sum(r["steps"] for r in server_rows)
        launches = sum(by_path.values())
        emit({"phase": "wall", "seconds": time.perf_counter() - wall_start, "limit_seconds": 1200,
              "seconds_by_phase": wall})
        emit({"kernels": [{
            "name": "flash_attention", "route": "cuda",
            "source": "apex_studio_tpu_torch/csrc/flash_attn.cu",
            "replaces": "apex_studio_tpu/ops/attention/pallas_flash.py:218",
            "launches": launches, "launches_by_path": by_path, "launches_per_step_by_path": per_step,
            "max_abs_err": flux_err,
            "ms": timing and timing["ms"], "plain_ms": timing and timing["plain_ms"],
            "bound_ms": timing and timing["bound_ms"], "bound_by": timing and timing["bound_by"],
            "library_ms": timing and timing["library_ms"],
            "max_abs_err_hyv15": hyv15_err,
            "hyv15_rows": [{k: r[k] for k in ROW_KEYS} for r in hyv15_rows],
            **{f"{family}_rows": [{**{k: r[k] for k in ROW_KEYS}, "max_abs_err": case_err.get(r["case"])}
                                  for r in zimage_timing if r["case"].startswith(prefix)]
               for family, prefix in (("zimage", ("zimage", "qwen3")), ("qwenimage", "qwenimage"),
                                      ("wan", "wan"), ("flux_edit", "flux"))},
            **{f"{name}_rows": [{k: r[k] for k in ROW_KEYS} for r in rows] for name, rows in path_rows.items()},
            **{f"max_abs_err_{name}": err for name, err in path_err.items()},
        }]})
        print(card)
    except CheckFailed as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        if _BACKGROUND["pool"] is not None:
            _BACKGROUND["pool"].shutdown(wait=True, cancel_futures=True)
        stop_prewrite()
        shutil.rmtree(home, ignore_errors=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
