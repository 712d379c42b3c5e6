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
             of 4 steps each, the kernels' launch counts read around each
  trace      (only when asked for) one more int8 request under torch.profiler:
             device time by kernel class, by W8A8 pass, and the idle share
  bf16       one request of 4 steps with synthetic bf16 weights
  int4       one request of 2 steps with the DiT packed int4 (encoders int8)
  hyv15      HunyuanVideo 1.5 i2v at 720x1280 from its manifest, full width and
             depth, synthetic int8 weights: the kernel at the path's shapes
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
  qwenimage  QwenImage Edit 2509 at 1024x1024 from its manifest, full width and
             depth, the 20B DiT int4-resident: a 2-block DiT and ControlNet at
             full width on the card (bf16) against the CPU (f32); the bench
             leg's edit request ("make the sky purple", 4 of its 8 steps, true CFG off)
             three times (60 launches a step, requests 1 and 3 identical, the
             repeated prompt a disk-cache hit); one Wan VAE decode against
             float64; the resident Linears at QwenImage's shapes and the int4
             step split; edit_plus with two condition images, t2i with true
             CFG (120 a step), the ControlNet at scales 1 and 0 (65 a step)
             and one bf16 edit, each of 2 steps
  wan        Wan 2.2 A14B from its three manifests, full width and depth,
             both 14B experts int4-resident (UMT5-XXL int8): a 2-block DiT at
             full width on the card (bf16) against the CPU (f32); the fused
             UniPC step against the host step over 30 steps; the bench leg's
             t2v request at one 480x832 frame three times (5 of its 30 steps, CFG 4,
             one expert: 160 launches a step, requests 1 and 3 identical, the
             repeated prompt a disk-cache hit); t2v at 81 frames (3 steps, the
             expert switch at boundary 0.875) with one decode tile against
             float64; the resident Linears at Wan's shapes and the int4 step
             split; the t2i manifest's 1024x1024 request (5 steps, both
             experts, the step split the boundary implies); i2v at 81 frames
             (3 steps, 36-channel DiT, the VAE encode at T = 81); one bf16 t2i
             request (4 steps, no Linear quantized); the point mask and its
             tracking on eight 480x832 frames
  wan_edit   the Wan editing engines from their manifests at 480x832, full
             width, the requests' DiTs cut to 20 of their 40 blocks (VACE
             hints at 0, 5, 10, 15), the 14B DiTs int4-resident (UMT5-XXL int8, CLIP
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
  wan_causal the Self-Forcing manifest (1.3B causal DiT bf16, 15 of its 30
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
             against the CPU (f32); t2i of 4 steps, (A, 0), (B, 1), (A, 0) (56
             launches a step, 1 and 3 identical); a VAE decode against
             float64; edit with one reference image (8704 tokens); the
             resident Linears at FLUX.2's shapes and the int4 step split;
             Turbo at 8 steps with a rank-16 LoRA written at the manifest's
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
             latent frame pinned); 1 step each, 62 launches a forward; the W8A8
             Linears at the 81-frame shapes and the step split
  humo       HuMo 17B from its manifest at the WanHuMoConfig widths (the
             requests' DiT cut to 20 of its 40 blocks), the DiT int4 and
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
             32-frame requests seeded with the image; 2 steps, 92 launches a
             forward and the encoder's 24 a request
  multitalk  Wan 2.1 MultiTalk from its manifest (the Wan2.1-I2V-14B-480P,
             CLIP ViT-H and chinese-wav2vec2-base configs written; DiT int4,
             CLIP bf16): the kernel at the path's shapes (self over 32,760,
             text and CLIP cross, the L-RoPE audio cross over two speakers'
             64 tokens, the encoder's f32 attention); the 2-block DiT with two
             speakers against f32; 81 frames with two speakers and a negative
             prompt (3 forwards a step), then two identical one-speaker
             33-frame requests; 2 steps, 160 launches a forward
  avatar     HunyuanVideo Avatar from its manifest at the family defaults'
             widths, synthetic int8 weights: the kernel at the path's shapes
             (the joint attention over 35,072 tokens and the refiner, each
             with the text bias); the 1 + 1-block DiT with the audio adapter
             against f32; the manifest's defaults (512x512, 125 frames, one
             window of 33 latent frames) with a negative prompt and zero
             Whisper features (no encoder files), then two identical 33-frame
             requests in windows of 9 latent frames; 2 steps, 62 launches a
             forward
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
multitalk, avatar and sam2 phases hold and time the kernel at their own
shapes (``path_kernel_rows``); the kernels phase also holds it at head dims
16, 32, 56, 72 and 96 (ragged, with a bias, on fused-qkv views in bf16 and
f32).
Then a ``wall`` line, a ``kernels`` line, the card and, last,
``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line. Run from the root of a
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
STEPS = 4
SIZE = 1024
BLOCKS = 19 + 38
DEFAULT_PHASES = ("kernels,timing,reference,residency,checkpoint,main,bf16,int4,hyv15,zimage,server,"
                  "qwenimage,wan,wan_edit,wan_causal,flux_edit,flux2,hyv,humo,s2v,multitalk,avatar,prompt_extension,"
                  "rife,sam2,preprocess,preprocess_nets,preprocess_rest")
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
HYV15_LAUNCHES_PER_STEP = 2 * (54 + 2)  # CFG: two forwards of 54 joint + 2 refiner attentions
# rows, in, out and calls a CFG step of the DiT's resident Linears at 121 frames
# (111,600 image rows, 1,857 context rows, adaLN on one row)
HYV15_LINEAR_CALLS = {(111600, 2048, 2048): 432, (111600, 2048, 8192): 108, (111600, 8192, 2048): 108,
                      (1857, 2048, 2048): 432, (1857, 2048, 8192): 108, (1857, 8192, 2048): 108,
                      (1, 2048, 12288): 216}
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
QWENIMAGE_TOKENS, QWENIMAGE_HEADS, QWENIMAGE_LAYERS, QWENIMAGE_CN_LAYERS = 4096, 24, 60, 5
# the bench leg's edit request runs 4 of its 8 steps: a cut of depth
QWENIMAGE_EDIT_PROMPT, QWENIMAGE_EDIT_STEPS = "make the sky purple", 4
# rows, in, out and calls a forward of the edit request's resident Linears: the
# image stream (4096 noise + 4096 condition rows) q/k/v/out, MLP in and out, and
# the two 6·d modulations on one row (the text stream's q/k/v/out are added at
# its bucket's rows)
QWENIMAGE_LINEAR_CALLS = {(8192, 3072, 3072): 240, (8192, 3072, 12288): 60, (8192, 12288, 3072): 60,
                          (1, 3072, 18432): 120}
WAN_T2V_MANIFEST = REPO / "manifests" / "video" / "wan-2.2-a14b-text-to-video.yml"
WAN_T2I_MANIFEST = REPO / "manifests" / "image" / "wan-2.2-a14b-text-to-image.yml"
WAN_I2V_MANIFEST = REPO / "manifests" / "video" / "wan2.2-a14b-image-to-video.yml"
# 40 heads of 128, 40 blocks an expert, 512 UMT5 rows; tokens (patch 1x2x2 over
# 8x-downscaled latents, 4x in time): one 480x832 frame 1x30x52, a 1024² image
# 1x64x64, 81 frames at 480x832 21x30x52
WAN_HEADS, WAN_LAYERS, WAN_TEXT_TOKENS = 40, 40, 512
# the bench leg's and the t2i request's steps in this run: 5 of their 30, a
# cut of depth that keeps the whole script inside its time limit (the
# seconds per step and every check are read as at 30; the t2i schedule still
# crosses the expert boundary)
WAN_SMOKE_STEPS = 5
WAN_TOKENS = {"frame": 1560, "t2i": 4096, "clip": 32760}
# the bench leg's prompts (bench_e2e.py PROMPT, NEG)
WAN_PROMPT = ("A cinematic photograph of a lighthouse on a rocky coast at golden "
              "hour, crashing waves, volumetric light, highly detailed")
WAN_NEG = "blurry, low quality, watermark"
# rows, in, out and calls a forward of the DiT's resident Linears at the bench
# leg's 1560 tokens: self-attention q/k/v/out and cross-attention q/out, the FFN
# in and out; the cross-attention K/V and the text embedder's second Linear over
# the 512 text rows, its first from 4096; time_proj on one row
WAN_LINEAR_CALLS = {(1560, 5120, 5120): 240, (1560, 5120, 13824): 40, (1560, 13824, 5120): 40,
                    (512, 5120, 5120): 81, (512, 4096, 5120): 1, (1, 5120, 30720): 1}
# the same at the 81-frame clip's 32,760 tokens
WAN_CLIP_LINEAR_CALLS = {(32760, 5120, 5120): 240, (32760, 5120, 13824): 40, (32760, 13824, 5120): 40,
                         (512, 5120, 5120): 81, (512, 4096, 5120): 1, (1, 5120, 30720): 1}
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
# the Self-Forcing requests' DiT has 15 of its published 30 blocks (a cut of
# depth that keeps the whole script inside its limit; the 2-block
# full-width check stays)
VACE_LAYERS, CAUSAL_LAYERS, CAUSAL_HEADS, CLIP_TOKENS = 8, 15, 12, 257
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
# the Wan editing requests' 14B DiTs have 20 of the published 40 blocks (a cut
# of depth that keeps the whole script inside its limit; the 2-block
# full-width checks stay); VACE keeps a hint every fifth block
EDIT_LAYERS = 20
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
HYV_LAUNCHES_PER_FORWARD = 20 + 40 + 2
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
HYV_LINEAR_CALLS = {(75856, 3072, 3072): 80 + 120, (75856, 3072, 12288): 20 + 40, (75856, 12288, 3072): 20,
                    (75856, 15360, 3072): 40, (256, 3072, 3072): 80, (256, 3072, 12288): 20,
                    (256, 12288, 3072): 20}
HUMO_MANIFEST = REPO / "manifests" / "video" / "humo-17b.yml"
# HuMo at 480x832: 1560 tokens a latent frame; 97 frames are 25 latent frames
# (the last one the reference's), 33 are 9; 16 audio tokens a latent frame;
# a forward makes 3 launches a block (self, text and audio cross-attention)
HUMO_TOKENS = {97: 25 * 1560, 33: 9 * 1560}
# the requests' DiT has 20 of the published 40 blocks (a cut of depth that
# keeps the whole script inside its limit; the full-width check runs on 2
# blocks)
HUMO_LAYERS = 20
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
S2V_AUDIO_TOKENS, S2V_INJECT_LAYERS = 4 + 1, 12
# a forward: self and text cross-attention in each block, the audio injector's after 12 of them
S2V_LAUNCHES_PER_FORWARD = 2 * 40 + S2V_INJECT_LAYERS
# the 10 s clip's wav2vec2 frames (50 Hz) behind the two 80-frame chunks at 16 fps
S2V_AUDIO_SECONDS, S2V_W2V_FRAMES = 10.0, 499
# MultiTalk at 480x832 and 81 frames: 21 latent frames of 1560 tokens; 32 audio
# tokens a speaker and frame; 257 CLIP tokens; a forward makes self, text,
# CLIP and audio cross-attention launches in each of the 40 blocks
MULTITALK_TOKENS, MULTITALK_AUDIO_TOKENS = 21 * 1560, 2 * 32
MULTITALK_LAUNCHES_PER_FORWARD = 4 * 40
# 3.2 s of each speaker's voice: 80 video frames at 25 fps, the wav2vec2 states resampled to them
MULTITALK_AUDIO_SECONDS, MULTITALK_W2V_FRAMES = 3.2, 80
# the Avatar at 512x512: one window of 33 latent frames of 32 x 32 tokens, the
# reference frame's 1024 in front and the 256 text slots; a forward makes the
# HunyuanVideo DiT's 62 launches
AVATAR_TOKENS = 1024 + 33 * 1024 + HYV_TEXT_TOKENS
AUDIO_VIDEO_STEPS = 1
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    version over its first ``plain_rows`` query rows (all by default, in
    1024-row chunks; 0 for none), ``scaled_dot_product_attention`` (the bias
    as its mask) and its bound; emitted and returned."""
    import torch.nn.functional as F

    from apex_studio_tpu_torch.ops.attention.flash import flash_attention

    b, sq, h, _ = q.shape
    sk = k.shape[1]
    bias = None if bias is None else bias.reshape(bias.shape[0], -1)
    plain_rows = sq if plain_rows is None else plain_rows
    huge, big = sq * sk * h > 1 << 33, sq * sk > 1 << 22
    reps = 5 if huge else 10 if big else 25
    calls = 5 if huge else 20
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = library_mask(bias)
    kernel_ms = time_ms(lambda: flash_attention(q, k, v, bias=bias), reps=reps)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), reps=reps)
    plain_ms = (time_ms(lambda: plain_in_row_chunks(q[:, :plain_rows], k, v, rows=1024, bias=bias),
                        reps=3 if big else reps, warmup=1) if plain_rows else None)
    work = attention_bound(q, k, bias)
    row = {"phase": "timing", "path": path, "kernel": "flash_attention", "case": case, "shape": list(q.shape),
           "sk": sk, "bias": bias is not None, "ms": kernel_ms,
           "queued_ms": queued_ms(lambda: flash_attention(q, k, v, bias=bias), calls=calls),
           "plain_ms": plain_ms, "plain_rows": plain_rows, "library_ms": library_ms,
           "library_queued_ms": queued_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                                          calls=calls),
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
    full width and depth, synthetic int8 weights: two identical 33-frame
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
    attention_s = (2 * 54 * joint["queued_ms"] + 2 * 2 * refiner["queued_ms"]) / 1e3
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
    """QwenImage Edit 2509 at 1024x1024 from its manifest, full width and
    depth, the DiT int4-resident (encoder and VAE int8 / bf16): the 2-block
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
        QWENIMAGE_LAYERS)
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
    calls = {**QWENIMAGE_LINEAR_CALLS, (bucket, 3072, 3072): 240}
    linear_rows = residency_timing(list(calls), phase="qwenimage")
    if kernel_rows:
        queued = {r["case"]: r["queued_ms"] for r in kernel_rows}
        attention_s = QWENIMAGE_LAYERS * queued[f"qwenimage_edit_s{lengths['edit']}_h24"] / 1e3
        by = {key: sum(calls[(r["rows"], r["in"], r["out"])] * r[key] for r in linear_rows) / 1e3
              for key in ("w4_ms", "bf16_ms")}
        emit({"phase": "qwenimage", "step_breakdown_int4": {
            "seconds_per_step": int4_step, "attention_seconds": attention_s,
            "w4_linear_seconds": by["w4_ms"], "bf16_linear_seconds_same_calls": by["bf16_ms"],
            "other_seconds": int4_step - attention_s - by["w4_ms"], "attention_share": attention_s / int4_step,
            "w4_linear_share": by["w4_ms"] / int4_step,
            "reckoning": "queued kernel ms x 60 at the edit length; queued ms x calls of the image stream's "
                         "Linears (8192 rows), the text stream's q/k/v/out (bucket rows) and the modulation "
                         "rows; other = the rest, the text stream's MLPs with it"}})
    paths["qwenimage_edit_plus"] = qwenimage_drive(
        "qwenimage_edit_plus", QWENIMAGE_EDIT_MANIFEST, "edit_plus", "int4",
        [dict(edit, image=[source, second], seed=0)], 2, home, QWENIMAGE_LAYERS)[0]
    release()
    paths["qwenimage_t2i_cfg"] = qwenimage_drive(
        "qwenimage_t2i_cfg", QWENIMAGE_MANIFEST, "t2i", "int4",
        [dict(prompt=PROMPT_A, negative_prompt="blurry, low quality", true_cfg_scale=4.0, seed=2)], 2, home,
        2 * QWENIMAGE_LAYERS)[0]
    release()
    cn_run = dict(prompt=PROMPT_B, control_image=control, true_cfg_scale=1.0, seed=3)
    cn_rows, cn_frames = qwenimage_drive(
        "qwenimage_controlnet", write_qwenimage_controlnet_manifest(home), "controlnet", "int4",
        [dict(cn_run, controlnet_conditioning_scale=1.0), dict(cn_run, controlnet_conditioning_scale=0.0)], 2,
        home, QWENIMAGE_LAYERS + QWENIMAGE_CN_LAYERS)[:2]  # the engine is dropped here
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
            QWENIMAGE_LAYERS)
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


def write_wan_configs(home: Path, i2v: bool = False) -> None:
    """UMT5-XXL's published ``config.json`` where the Wan manifests name it
    (without it T5Config's defaults build T5-XXL: a shared relative bias and
    a 32,128-token vocabulary); with ``i2v``, the A14B I2V transformer's (36
    input channels) where the i2v manifest names both experts' configs."""
    root = home / "components" / "Wan-AI" / "Wan2.2-T2V-A14B-Diffusers"
    files = {"text_encoder": UMT5_XXL}
    if i2v:
        files.update({"transformer": WAN_I2V_TRANSFORMER, "transformer_2": WAN_I2V_TRANSFORMER})
    for sub, cfg in files.items():
        (root / sub).mkdir(parents=True, exist_ok=True)
        (root / sub / "config.json").write_text(json.dumps(cfg))


def wan_engine(label, manifest, model_type, home):
    """A Wan engine on the card with the byte-level tokenizer, its own
    ``APEX_HOME_DIR`` and the configs above, observed: the components each
    request builds, each expert's forwards and the latents each decode gets
    (``engine.wan_smoke``, ``observe``)."""
    from apex_studio_tpu_torch.engine import UniversalEngine

    os.environ["APEX_HOME_DIR"] = str(home / label)
    write_wan_configs(home / label, i2v=model_type == "i2v")
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
        want_launches = 2 * WAN_LAYERS * sum(want_forwards.values())
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
    into attention (queued kernel ms x 80 self + 80 cross launches), the
    ``_w4`` Linears (queued ms x two forwards' ``calls`` by shape) and the
    rest (by difference)."""
    s = WAN_TOKENS[kind]
    queued = {r["case"]: r["queued_ms"] for r in kernel_rows}
    attention_s = 2 * WAN_LAYERS * (queued[f"wan_self_{kind}_s{s}_h40"]
                                    + queued[f"wan_cross_{kind}_sq{s}_sk{WAN_TEXT_TOKENS}_h40"]) / 1e3
    by = {key: 2 * sum(calls.get((r["rows"], r["in"], r["out"]), 0) * r[key] for r in linear_rows) / 1e3
          for key in ("w4_ms", "bf16_ms")}
    return {"tokens": s, "seconds_per_step": step_s, "attention_seconds": attention_s,
            "w4_linear_seconds": by["w4_ms"], "bf16_linear_seconds_same_calls": by["bf16_ms"],
            "other_seconds": step_s - attention_s - by["w4_ms"], "attention_share": attention_s / step_s,
            "w4_linear_share": by["w4_ms"] / step_s,
            "reckoning": f"a CFG step at {s} tokens: queued kernel ms x 80 self + 80 cross launches; queued "
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
    """Wan 2.2 A14B from its three manifests, full width and depth, both 14B
    experts int4-resident unless a request says otherwise (UMT5-XXL int8, the
    Wan VAE bf16): the 2-block card-vs-CPU check and the fused UniPC step; the
    bench leg's request three times (t2v at one 480x832 frame, 5 of its 30 steps, one
    expert); t2v at 81 frames (3 steps, the expert switch) with one decode
    tile against float64; the resident Linears at Wan's shapes and the int4
    step split; the t2i manifest's 1024² request (5 steps, the expert
    switch); i2v at 81 frames (3 steps); one bf16 t2i request (4 steps); the
    point mask."""
    import numpy as np

    from apex_studio_tpu_torch.quantize.residency import count_resident

    wan_reference()
    wan_unipc_check()
    paths = {}
    leg = dict(prompt=WAN_PROMPT, negative_prompt=WAN_NEG, height=480, width=832, num_frames=1,
               num_inference_steps=WAN_SMOKE_STEPS, guidance_scale=4.0, boundary_ratio=None)
    engine = wan_engine("wan_t2v", WAN_T2V_MANIFEST, "t2v", home)
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
    check(rows[0]["flash_launches_per_step"] == 4 * WAN_LAYERS, "a CFG step did not make 160 launches")
    check(rows[0]["tokens"] == WAN_TOKENS["frame"], f"the bench leg's frame gave {rows[0]['tokens']} tokens")
    check(count_resident(engine.transformer) > 0, "no weight of the Wan DiT is resident")
    # t2v at 81 frames on the same engine, with the manifest's expert switch
    clip_kw = dict(leg, num_frames=81, num_inference_steps=3, boundary_ratio=0.875, guidance_scale_2=3.0, seed=0)
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
    engine = wan_engine("wan_t2i", WAN_T2I_MANIFEST, "t2i", home)
    paths["wan_t2i"], _ = wan_drive("wan_t2i", engine, "t2i", "int4", [t2i_kw])
    check(paths["wan_t2i"][0]["tokens"] == WAN_TOKENS["t2i"], "the t2i request's tokens")
    del engine, _
    release()
    i2v_kw = dict(clip_kw, image=cv2_smooth(np.random.default_rng(6), (480, 832)), prompt=PROMPT_B)
    engine = wan_engine("wan_i2v", WAN_I2V_MANIFEST, "i2v", home)
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
        engine = wan_engine("wan_t2i_bf16", WAN_T2I_MANIFEST, "t2i", home)
        paths["wan_t2i_bf16"], _ = wan_drive("wan_t2i_bf16", engine, "t2i", "bf16",
                                             [dict(t2i_kw, num_inference_steps=4)])
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
    relative L2 of the card's output against the CPU's, within ``tol``."""
    import torch

    cpu, card = bf16_card_and_f32_cpu(build, seed)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = forward(cpu, *inputs)
        cpu_s = time.perf_counter() - t0
        out = forward(card, *(x.cuda() if isinstance(x, torch.Tensor) else x for x in inputs)).float().cpu()
    row = {"phase": phase, "check": "card_bf16_vs_cpu_f32", "model": label,
           "parameters": sum(p.numel() for p in cpu.parameters()), **extra, "rel_l2": rel_l2(out, ref),
           "max_abs_err": (out - ref).abs().max().item(), "max_abs_ref": ref.abs().max().item(),
           "finite": bool(torch.isfinite(out).all()), "tol_rel_l2": tol, "cpu_seconds": cpu_s}
    emit(row)
    check(row["finite"] and row["rel_l2"] <= tol, f"{label} on the card is {row['rel_l2']} from the CPU (limit {tol})")
    del cpu, card
    release()
    return row


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


_STEP = re.compile(r"(?:Denoising|Causal) step (\d+)/(\d+)")


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
        "seconds_decode": (first.get("Completed pipeline", first.get("Completed causal pipeline", start)) - denoise_end
                           if denoise_end else None),
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
    name them: the 2-block card-vs-CPU checks; t2i of 4 steps, (A, 0), (B, 1),
    (A, 0) (56 launches a step, 1 and 3 identical, 2 not); one VAE decode
    against float64; edit with one 1024² reference image (2 steps, S = 8704);
    the resident Linears at FLUX.2's shapes and the step split; Turbo at its
    8 steps with a rank-16 LoRA written at the manifest's LoRA source; the
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
                                                     dict(prompt=PROMPT_A, seed=0)], 4, FLUX2_LAYERS)
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
    paths["flux2_turbo"] = image_drive("flux2_turbo", engine, [dict(prompt=PROMPT_B, seed=4)], 8, FLUX2_LAYERS)[0]
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
    biased case also against the plain version over its kept keys alone.
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
        if bias is not None:
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


def hyv_engine(label, manifest, model_type, home):
    """A HunyuanVideo engine on the card as ``image_engine`` builds it, with
    synthetic int8 weights (as the HunyuanVideo 1.5 phase) and, for i2v, the
    I2V transformer config written; observed (``observe``) and with each
    decode's choice of whole or tiled read (``engine.decoded_whole``)."""
    configs = [("transformer", HYV_I2V_TRANSFORMER)] if model_type == "i2v" else []
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
    (75,856 tokens), decoded in tiles; 1 step each, 62 launches a forward;
    the resident Linears at the 81-frame shapes and the step split."""
    import numpy as np
    import torch

    from apex_studio_tpu_torch.quantize.residency import count_resident

    kernel_rows, kernel_err = path_kernel_rows("hyv", hyv_kernel_inputs())
    hyv_reference()
    (height, width), paths = HYV_SIZE, {}
    base = dict(prompt=HYV_PROMPT, height=height, width=width, num_inference_steps=HYV_STEPS, guidance_scale=6.0)
    engine = hyv_engine("hyv_t2v", HYV_T2V_MANIFEST, "t2v", home)
    rows, latents = [], []
    for _ in range(2):  # edit_drive clears the decoded latents before each request
        rows.append(edit_drive("hyv", engine, dict(base, num_frames=33, seed=42), HYV_LAUNCHES_PER_FORWARD,
                               {"transformer": HYV_STEPS}, 33, 9))
        latents.append(engine.wan_smoke["decoded"][-1])
    tf, vae = engine.transformer, engine.vae
    same = bool(torch.equal(*latents)) and bool(np.array_equal(np.stack(rows[0][1]), np.stack(rows[1][1])))
    emit({"phase": "hyv", "requests_1_2_identical_latents_and_frames": same, "resident_weights": count_resident(tf),
          "dit_parameters": sum(p.numel() for p in tf.parameters()), "decoded_whole": engine.decoded_whole,
          "vae_compute_dtype": str(vae.decoder.conv_in.dtype)})
    check(same, "HunyuanVideo t2v requests 1 and 2 (same prompt and seed) differ")
    check(engine.decoded_whole == [True, True], f"the 33-frame decodes were not whole: {engine.decoded_whole}")
    check(tf.cfg.dim == 3072 and len(tf.single_transformer_blocks) == 40 and count_resident(tf) > 0,
          "the HunyuanVideo DiT's widths or residency")
    hyv_vae_precision(vae)
    long_row, frames = edit_drive("hyv_81f", engine, dict(base, num_frames=81, seed=7), HYV_LAUNCHES_PER_FORWARD,
                                  {"transformer": HYV_STEPS}, 81, 21)
    tiled = engine.decoded_whole[-1] is False
    emit({"phase": "hyv_81f", "decode": "tiled" if tiled else "whole", "tokens": HYV_TOKENS[81]})
    check(tiled, "the 81-frame decode did not take the tiled path")
    paths["hyv_t2v"], paths["hyv_t2v_81_frames"] = [r for r, _ in rows], [long_row]
    del engine, tf, vae, frames, rows
    release()

    image = cv2_smooth(np.random.default_rng(17), HYV_SIZE)
    engine = hyv_engine("hyv_i2v", HYV_I2V_MANIFEST, "i2v", home)
    i2v_row, frames = edit_drive("hyv_i2v", engine, dict(base, num_frames=33, seed=42, image=image),
                                 HYV_LAUNCHES_PER_FORWARD, {"transformer": HYV_STEPS}, 33, 9)
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
    attention_s = (60 * queued[f"hyv_joint_81f_s{HYV_TOKENS[81]}_bias_h24"]
                   + 2 * queued[f"hyv_refiner_s{HYV_TEXT_TOKENS}_bias_h24"]) / 1e3
    linear_s = sum(HYV_LINEAR_CALLS[(r["rows"], r["in"], r["out"])] * r["w8a8_ms"] for r in linear_rows) / 1e3
    emit({"phase": "hyv", "step_breakdown_81_frames": {
        "seconds_per_step": step, "attention_seconds": attention_s, "w8a8_linear_seconds": linear_s,
        "other_seconds": step - attention_s - linear_s, "attention_share": attention_s / step,
        "w8a8_linear_share": linear_s / step,
        "reckoning": "queued kernel ms x 60 joint + 2 refiner launches; queued W8A8 ms x calls by shape (the "
                     "dual blocks' 75,600-row image stream at the single blocks' 75,856 rows)"}})
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
    forwards a step), 2 steps a chunk: the first chunk's motion dropped, the
    second's motion buffer re-encoded from the first's last 73 frames; then
    two identical 32-frame requests of one chunk seeded with the image
    (``init_first_frame``), without CFG."""
    import numpy as np

    kernel_rows, kernel_err = path_kernel_rows("s2v", s2v_kernel_inputs())
    s2v_reference()
    engine = observe_decodes(edit_engine("s2v", WAN_S2V_MANIFEST, "s2v", home, "int4",
                                         {"transformer": WAN_S2V_TRANSFORMER, "audio_encoder": WAV2VEC2_LARGE}))
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
    check(dit_bits(tf) == [4] and tf.cfg.dim == 5120 and len(tf.blocks) == 40 and tf.frame_packer is not None
          and len(tf.injector) == S2V_INJECT_LAYERS, "the S2V DiT's widths, bits or audio layers")
    del engine, tf
    release()
    return {"s2v": [main_row], "s2v_pair": pair}, kernel_rows, kernel_err


def phase_multitalk(home: Path):
    """Wan 2.1 MultiTalk from its manifest at the published widths (the
    Wan2.1-I2V-14B-480P transformer, CLIP ViT-H and chinese-wav2vec2-base
    configs written; the DiT int4, UMT5-XXL int8, CLIP bf16): the kernel at
    the path's shapes; one request at 480x832 and 81 frames with two
    speakers' seeded 3.2 s voices (L-RoPE routing over the chunked
    ``ref_attn_maps``) and a negative prompt (3 forwards a step), 2 steps;
    then two identical one-speaker requests of 33 frames (2 forwards a step)."""
    import numpy as np

    kernel_rows, kernel_err = path_kernel_rows("multitalk", multitalk_kernel_inputs())
    multitalk_reference()
    engine = observe_decodes(edit_engine("multitalk", WAN_MULTITALK_MANIFEST, "multitalk", home, "int4",
                                         {"transformer": WAN21_I2V_TRANSFORMER, "image_encoder": CLIP_VISION_H,
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
    check(dit_bits(tf) == [4] and tf.cfg.dim == 5120 and len(tf.blocks) == 40 and tf.cfg.in_channels == 36
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
    engine = hyv_engine("avatar", HYV_AVATAR_MANIFEST, "avatar", home)
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
    check(dit_bits(tf) == [8] and tf.cfg.dim == 3072 and len(tf.single_transformer_blocks) == 40
          and len(tf.audio_adapter_blocks) == 10, "the Avatar DiT's widths or bits")
    check(engine.whisper_files() is None and not zero.any(), "the Avatar's audio features without Whisper files")
    del engine, tf
    release()
    return {"avatar": [main_row], "avatar_pair": pair}, kernel_rows, kernel_err


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
        sizes = write_preprocessor_checkpoints(ph / "models")
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
        sizes = write_preprocess_net_checkpoints(ph / "models")
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
        sizes = write_preprocess_rest_checkpoints(ph / "models")
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


def server_cli(home: Path) -> dict:
    """``python3 -m apex_studio_tpu_torch.cli start`` on a free port as a
    subprocess (its own home); ``status``, ``/ready`` and ``/system/memory``
    (in that process, on the card) answer; ``stop`` ends it. No engine runs."""
    import socket

    import torch

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    env = {**os.environ, "APEX_HOME_DIR": str(home / "cli")}

    def cli(*args, timeout=180):
        out = subprocess.run([sys.executable, "-m", "apex_studio_tpu_torch.cli", *args, "--port", port],
                             cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
        check(out.returncode == 0, f"cli {args[0]} exited {out.returncode}: {out.stderr[-2000:]}")
        return out.stdout.strip()

    t0 = time.perf_counter()
    started = cli("start", "--timeout", "150")
    start_s = time.perf_counter() - t0
    pid = int((home / "cli" / "apex-engine.pid").read_text())
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
    ``/system/step-trace`` and ``/system/free-memory``; then the CLI in a
    subprocess. Returns the completed requests' rows."""
    import io

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
    cli_row = server_cli(home)
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
    args = ap.parse_args()
    phases = set(args.phases.split(","))

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
    os.environ["APEX_HOME_DIR"] = str(home)
    wall_start, wall = time.perf_counter(), {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        return out

    try:
        card = card_line()
        from apex_studio_tpu_torch.ops.attention import flash as flash_mod

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
        flux_err, case_err = timed("kernels", phase_kernels) if "kernels" in phases else (None, {})
        timing, zimage_timing = timed("timing", phase_timing) if "timing" in phases else (None, [])
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
                            ("multitalk", phase_multitalk), ("avatar", phase_avatar)):
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
        shutil.rmtree(home, ignore_errors=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
