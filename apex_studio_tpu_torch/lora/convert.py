"""LoRA checkpoint format handling (copy of ``apex_studio_tpu/lora/convert.py``;
numpy only).

Detect the layout (diffusers-peft ``lora_A/lora_B`` vs kohya
``lora_down/lora_up`` + ``alpha``) and normalize every adapter into
``(module_path, down [r,in], up [out,r], alpha)`` tuples keyed by the *base
model's* torch-style module path, which then flows through the same per-family
key converter the base weights use.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional

import numpy as np


class LoraPair(NamedTuple):
    module_path: str  # torch-style module path of the target Linear
    down: np.ndarray  # [r, in]
    up: np.ndarray    # [out, r]
    alpha: Optional[float]

    @property
    def rank(self) -> int:
        return self.down.shape[0]

    def delta(self, scale: float = 1.0) -> np.ndarray:
        """ΔW = scale · (alpha/r) · up @ down, in torch [out, in] layout."""
        eff = scale * ((self.alpha / self.rank) if self.alpha is not None else 1.0)
        return eff * (self.up.astype(np.float32) @ self.down.astype(np.float32))


def detect_lora_format(sd: Dict[str, np.ndarray]) -> str:
    for k in sd:
        if ".lora_A." in k or ".lora_B." in k or k.endswith(".lora_A.weight"):
            return "peft"
        if ".lora_down." in k or ".lora_up." in k or "lora_down.weight" in k:
            return "kohya"
    return "unknown"


_PEFT_RE = re.compile(r"^(?:base_model\.model\.|transformer\.|diffusion_model\.)?(?P<path>.+?)\.lora_(?P<ab>[AB])\.(?:default\.)?weight$")
_KOHYA_RE = re.compile(r"^(?P<path>.+?)\.lora_(?P<ud>down|up)\.weight$")


def _kohya_path_to_module(path: str) -> str:
    """kohya flattens module paths with underscores: lora_unet_blocks_0_attn1_to_q
    → blocks.0.attn1.to_q. Underscore-in-name modules are re-joined greedily
    against known separators (digits split reliably)."""
    for prefix in ("lora_unet_", "lora_transformer_", "lora_te1_", "lora_te2_", "lora_te_"):
        if path.startswith(prefix):
            path = path[len(prefix):]
            break
    parts = path.split("_")
    out: List[str] = []
    for p in parts:
        if p.isdigit():
            out.append(p)
        elif out and not out[-1].isdigit() and out[-1] not in ("",) and _is_name_fragment(out[-1], p):
            out[-1] = out[-1] + "_" + p
        else:
            out.append(p)
    return ".".join(out)


# Module-name fragments that belong together when kohya split them on "_".
_JOIN_SECOND = {
    "q", "k", "v", "out", "qkv", "proj", "mlp", "add", "embedder", "blocks",
    "block", "norm", "table", "shift", "1", "2", "embed",
}
_JOIN_FIRST = {
    "to", "add", "proj", "single", "transformer", "img", "txt", "time", "text",
    "scale", "patch", "x", "context", "ff", "norm", "attn",
}


def _is_name_fragment(prev: str, cur: str) -> bool:
    return prev in _JOIN_FIRST and cur in _JOIN_SECOND


def lora_pairs_from_state_dict(sd: Dict[str, np.ndarray]) -> List[LoraPair]:
    fmt = detect_lora_format(sd)
    downs: Dict[str, np.ndarray] = {}
    ups: Dict[str, np.ndarray] = {}
    alphas: Dict[str, float] = {}

    if fmt == "peft":
        for key, arr in sd.items():
            m = _PEFT_RE.match(key)
            if not m:
                if key.endswith(".alpha"):
                    alphas[key[: -len(".alpha")]] = float(np.asarray(arr).reshape(-1)[0])
                continue
            path = m.group("path")
            (downs if m.group("ab") == "A" else ups)[path] = np.asarray(arr)
    elif fmt == "kohya":
        for key, arr in sd.items():
            if key.endswith(".alpha"):
                raw = key[: -len(".alpha")]
                alphas[_kohya_path_to_module(raw)] = float(np.asarray(arr).reshape(-1)[0])
                continue
            m = _KOHYA_RE.match(key)
            if not m:
                continue
            path = _kohya_path_to_module(m.group("path"))
            arr = np.asarray(arr)
            if arr.ndim == 4:  # conv lora stored [r,in,1,1]
                arr = arr[:, :, 0, 0]
            (downs if m.group("ud") == "down" else ups)[path] = arr
    else:
        raise ValueError("unrecognized LoRA checkpoint format")

    pairs: List[LoraPair] = []
    for path, down in downs.items():
        up = ups.get(path)
        if up is None:
            continue
        pairs.append(LoraPair(path, down, up, alphas.get(path)))
    return pairs
