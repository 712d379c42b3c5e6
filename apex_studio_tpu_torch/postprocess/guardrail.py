"""Cosmos guardrail: the video content-safety filter and face pixelation
(port of ``apex_studio_tpu/postprocess/guardrail.py``; reference
``src/postprocess/cosmos/guardrail.py``):

- ``VideoContentSafetyFilter`` (guardrail.py:519): every sampled frame is
  embedded by SigLIP's pooled ``get_image_features`` (the port's
  ``SiglipVisionEncoder`` with ``use_head``, ``pooled=True``) and classified
  by a 7-class MLP (Linear / BatchNorm / ReLU ×2 → Linear, guardrail.py:449);
  a frame of any class but 0 blocks the video;
- ``FacePixelator`` (guardrail.py:596 RetinaFaceFilter): faces found by an
  OpenCV detector file (YuNet onnx or a Haar cascade) are pixelated
  (guardrail.py:52);
- ``GuardrailRunner`` (guardrail.py:393) chains the safety models, then the
  postprocessors; ``cosmos.guardrail`` (guardrail.py:783) drops a blocked
  clip entirely.

The encoder runs where it was built (the card in production); the
classifier, f32 with the checkpoint's BatchNorm running statistics (eval
semantics), follows it there. As in JAX, a filter without an encoder passes
every clip as safe with a warning, and the pixelator without a detector
returns the frames untouched with a warning (the reference degrades so
without RetinaFace).
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from apex_studio_tpu_torch.postprocess.base import BasePostprocessor, postprocessor_registry

logger = logging.getLogger("apex.postprocess.guardrail")


def to_ascii(prompt: str) -> str:
    """guardrail.py:47 — strip non-ascii for keyword matching."""
    return re.sub(r"[^\x00-\x7F]+", " ", prompt)


def pixelate_face(face_img: np.ndarray, blocks: int = 5) -> np.ndarray:
    """guardrail.py:52 — shrink to blocks×blocks and nearest-upscale."""
    import cv2

    h, w = face_img.shape[:2]
    temp = cv2.resize(face_img, (blocks, blocks), interpolation=cv2.INTER_LINEAR)
    return cv2.resize(temp, (w, h), interpolation=cv2.INTER_NEAREST)


def read_keyword_list_from_dir(folder: Path) -> List[str]:
    """guardrail.py:26 — every line of every file in the folder."""
    out: List[str] = []
    folder = Path(folder)
    if not folder.is_dir():
        return out
    for f in sorted(folder.iterdir()):
        if f.is_file():
            out.extend(line.strip() for line in f.read_text(errors="ignore").splitlines() if line.strip())
    return out


class KeywordBlocklist:
    """Prompt-side guardrail: case-insensitive whole-word keyword match."""

    def __init__(self, keywords: Sequence[str]):
        self.keywords = [k.lower() for k in keywords if k]

    def is_safe(self, prompt: str) -> Tuple[bool, str]:
        text = to_ascii(prompt).lower()
        words = set(re.findall(r"[a-z0-9']+", text))
        for kw in self.keywords:
            if (" " in kw and kw in text) or (" " not in kw and kw in words):
                return False, f"blocked keyword: {kw}"
        return True, "Prompt is safe"


@dataclass
class SafetyClassifierConfig:
    input_size: int = 1152
    num_classes: int = 7


class SafetyClassifier(nn.Module):
    """guardrail.py:449 — Linear(1152, 512) / BN / ReLU → Linear(512, 256) /
    BN / ReLU → Linear(256, 7), ``layers`` as the reference's
    ``network.layers`` Sequential, in eval mode. Without a state its weights
    are the JAX module's defaults: normal(0, 0.02) from numpy's generator
    seeded 0, drawn in the same order."""

    _PREFIXES = ("network.layers.", "layers.", "model.network.layers.")

    def __init__(self, cfg: Optional[SafetyClassifierConfig] = None):
        super().__init__()
        cfg = cfg or SafetyClassifierConfig()
        self.cfg = cfg
        self.layers = nn.Sequential(nn.Linear(cfg.input_size, 512), nn.BatchNorm1d(512), nn.ReLU(),
                                    nn.Linear(512, 256), nn.BatchNorm1d(256), nn.ReLU(),
                                    nn.Linear(256, cfg.num_classes)).eval()
        rng = np.random.default_rng(0)
        with torch.no_grad():
            for li in (0, 3, 6):
                lin = self.layers[li]
                lin.weight.copy_(torch.from_numpy(rng.normal(0, 0.02, size=tuple(lin.weight.shape[::-1])).T))
                lin.bias.zero_()

    def load_torch_state(self, sd: dict) -> None:
        """The reference's keys ``network.layers.{0,3,6}`` (Linear) and
        ``{1,4}`` (BatchNorm1d: weight, bias, running statistics), under any
        of its prefixes, at the widths the state has (as the JAX module takes
        them); a missing one raises ``KeyError``."""
        def get(k):
            for prefix in self._PREFIXES:
                if prefix + k in sd:
                    return torch.tensor(np.asarray(sd[prefix + k], np.float32))
            raise KeyError(k)

        state = {f"{i}.{name}": get(f"{i}.{name}") for i in (0, 3, 6) for name in ("weight", "bias")}
        state.update({f"{i}.{name}": get(f"{i}.{name}") for i in (1, 4)
                      for name in ("weight", "bias", "running_mean", "running_var")})
        for li in (0, 3, 6):
            out_features, in_features = state[f"{li}.weight"].shape
            self.layers[li] = nn.Linear(in_features, out_features, device="meta")
        for bi in (1, 4):
            self.layers[bi] = nn.BatchNorm1d(state[f"{bi}.weight"].shape[0], device="meta").eval()
        self.layers.load_state_dict(state, strict=False, assign=True)
        for bi in (1, 4):
            self.layers[bi].num_batches_tracked = torch.tensor(0)
        self.cfg = SafetyClassifierConfig(self.layers[0].in_features, self.layers[6].out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x.float())


class VideoContentSafetyFilter:
    """guardrail.py:519 — SigLIP pooled embedding → SafetyClassifier; a video
    is unsafe if any sampled frame classifies to a non-zero class."""

    def __init__(self, encoder=None, classifier: Optional[SafetyClassifier] = None, sample_every: int = 8):
        self.encoder = encoder
        self.classifier = classifier or SafetyClassifier()
        self.sample_every = max(1, sample_every)

    def embed(self, frame: np.ndarray) -> torch.Tensor:
        """The frame's unit-norm pooled SigLIP embedding, f32 on the
        encoder's device."""
        from apex_studio_tpu_torch.models.text_encoders.siglip import preprocess_siglip_image

        dev = next(self.encoder.parameters()).device
        px = torch.from_numpy(preprocess_siglip_image(frame, size=self.encoder.cfg.image_size)).to(dev)
        with torch.no_grad():
            feats = self.encoder(px, pooled=True)
        return (feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)).float()

    def is_safe(self, frames: Sequence[np.ndarray]) -> Tuple[bool, str]:
        if self.encoder is None:
            logger.warning("no SigLIP encoder loaded; passing frames as safe")
            return True, "no encoder (pass-through)"
        for i in range(0, len(frames), self.sample_every):
            emb = self.embed(frames[i])
            with torch.no_grad():
                cls = int(self.classifier.to(emb.device)(emb)[0].argmax())
            if cls != 0:
                return False, f"frame {i} classified unsafe (class {cls})"
        return True, "Video is safe"


class FacePixelator:
    """Face blur. The reference's rides the optional RetinaFace
    (guardrail.py:596-640); here an OpenCV face detector file (YuNet onnx or
    a Haar cascade xml) is used when given, and without one the frames pass
    untouched with a warning, as the reference degrades."""

    def __init__(self, detector_path: Optional[Path] = None, blocks: int = 5):
        self.blocks = blocks
        self.detector = None
        self._yunet = None
        if detector_path is not None and Path(detector_path).exists():
            import cv2

            detector_path = str(detector_path)
            if detector_path.endswith(".onnx"):
                self._yunet = cv2.FaceDetectorYN.create(detector_path, "", (320, 320), 0.6)
            else:
                self.detector = cv2.CascadeClassifier(detector_path)

    def _detect(self, frame: np.ndarray):
        import cv2

        if self._yunet is not None:
            h, w = frame.shape[:2]
            self._yunet.setInputSize((w, h))
            _, faces = self._yunet.detect(frame)
            return [] if faces is None else [f[:4].astype(int) for f in faces]
        if self.detector is not None:
            gray = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
            return [np.asarray(f, int) for f in self.detector.detectMultiScale(gray, 1.1, 4)]
        return None

    def postprocess(self, frames: List[np.ndarray]) -> List[np.ndarray]:
        out = []
        for frame in frames:
            boxes = self._detect(frame)
            if boxes is None:
                logger.warning("no face detector configured; skipping face-blur (the reference degrades so)")
                return list(frames)
            f = frame.copy()
            for (x, y, w, h) in boxes:
                x, y = max(0, x), max(0, y)
                if w > 0 and h > 0:
                    f[y:y + h, x:x + w] = pixelate_face(f[y:y + h, x:x + w], self.blocks)
            out.append(f)
        return out


class GuardrailRunner:
    """guardrail.py:393 — chain the safety models, then the postprocessors."""

    def __init__(self, safety_models: Optional[List[Any]] = None, postprocessors: Optional[List[Any]] = None,
                 generic_block_msg: str = ""):
        self.safety_models = safety_models or []
        self.postprocessors = postprocessors or []
        self.generic_block_msg = generic_block_msg

    def run_safety_check(self, inp: Any) -> Tuple[bool, str]:
        if not self.safety_models:
            logger.warning("no safety models found, returning safe")
            return True, "Prompt is safe"
        for guardrail in self.safety_models:
            safe, msg = guardrail.is_safe(inp)
            if not safe:
                return False, self.generic_block_msg or f"{type(guardrail).__name__.upper()}: {msg}"
        return True, "Input is safe"

    def postprocess(self, frames: List[np.ndarray]) -> List[np.ndarray]:
        for pp in self.postprocessors:
            frames = pp.postprocess(frames)
        return frames


@postprocessor_registry.register("cosmos.guardrail")
class CosmosGuardrailPostprocessor(BasePostprocessor):
    """guardrail.py:783 — frames in, safe (optionally face-blurred) frames
    out; a blocked clip comes back empty. ``encoder``: a
    ``SiglipVisionEncoder`` built with ``use_head`` (none: every clip
    passes); ``classifier_state``: the safety classifier's checkpoint
    (none: the default weights)."""

    name = "cosmos.guardrail"

    def __init__(self, device=None, encoder=None, classifier_state: Optional[dict] = None,
                 detector_path: Optional[Path] = None, keywords: Optional[Sequence[str]] = None,
                 sample_every: int = 8, **_: Any):
        super().__init__(device)
        classifier = SafetyClassifier()
        if classifier_state:
            classifier.load_torch_state(classifier_state)
        self.runner = GuardrailRunner(safety_models=[VideoContentSafetyFilter(encoder, classifier,
                                                                              sample_every=sample_every)],
                                      postprocessors=[FacePixelator(detector_path)])
        self.blocklist = KeywordBlocklist(keywords or [])

    def check_prompt(self, prompt: str) -> Tuple[bool, str]:
        return self.blocklist.is_safe(prompt)

    def __call__(self, frames: Sequence[np.ndarray], progress_callback: Optional[Callable] = None,
                 **params: Any) -> List[np.ndarray]:
        frames = list(frames)
        safe, msg = self.runner.run_safety_check(frames)
        if not safe:
            logger.warning("GUARDRAIL BLOCKED: %s", msg)
            return []
        return self.runner.postprocess(frames)
