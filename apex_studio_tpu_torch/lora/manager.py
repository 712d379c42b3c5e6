"""LoRA resolution and weight merging (port of ``apex_studio_tpu/lora/manager.py``).

Adapters are **merged into the base weights at load time** (W ← W + scale·ΔW)
instead of kept as runtime hooks: the denoise loop stays identical, there is
no per-step cost, and for weights in the compute dtype unmerge subtracts the
same delta. Deltas are ``[out, in]``, the layout of the port's weights, so no
transpose is involved; each is multiplied out from its rank-r factors on the
weight's device.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from apex_studio_tpu_torch.loaders.converters import converter_registry
from apex_studio_tpu_torch.loaders.state_mapping import port_path
from apex_studio_tpu_torch.lora.convert import LoraPair, lora_pairs_from_state_dict
from apex_studio_tpu_torch.models.layers import Linear

logger = logging.getLogger("apex.lora")


def _merge8(q: torch.Tensor, s: torch.Tensor, d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 ``q [out, in]`` with scales ``s [out]`` plus delta ``d [out, in]``:
    dequantize, add, fresh per-channel absmax scales, requantize."""
    w = q.float() * s[:, None] + d
    absmax = w.abs().amax(dim=1)
    new_s = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    q8 = torch.round(w / new_s[:, None]).clamp_(-127, 127).to(torch.int8)
    return q8, new_s.float()


def _merge4(q: torch.Tensor, s: torch.Tensor, d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_merge8`` for packed int4 ``q [out/2, in]`` (residency.py layout):
    unpack the two planes, merge, requantize, repack."""
    half = q.shape[0]
    lo = (q & 0xF).to(torch.int8) - 8
    hi = (q >> 4).to(torch.int8) - 8
    w = torch.cat([lo, hi], dim=0).float() * s[:, None] + d
    absmax = w.abs().amax(dim=1)
    new_s = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 7.0)
    q4 = (torch.round(w / new_s[:, None]).clamp_(-8, 7) + 8).to(torch.uint8)
    return q4[:half] | (q4[half:] << 4), new_s.float()


def _delta(pair: LoraPair, scale: float, device: torch.device) -> torch.Tensor:
    """ΔW = scale · (alpha/r) · up @ down as f32 ``[out, in]``, multiplied on
    ``device``: only the two rank-r factors cross from the host."""
    eff = scale * ((pair.alpha / pair.rank) if pair.alpha is not None else 1.0)
    up = torch.from_numpy(np.asarray(pair.up, np.float32)).to(device)
    down = torch.from_numpy(np.asarray(pair.down, np.float32)).to(device)
    return (up @ down) * eff


@dataclass
class LoraSpec:
    source: str
    scale: float = 1.0
    name: Optional[str] = None

    @classmethod
    def from_manifest_entry(cls, entry: Union[str, Dict[str, Any]]) -> "LoraSpec":
        if isinstance(entry, str):
            return cls(source=entry)
        return cls(
            source=entry.get("source") or entry.get("path") or entry.get("url") or "",
            scale=float(entry.get("scale", 1.0)),
            name=entry.get("name"),
        )


class LoraManager:
    def __init__(self, lora_root: Optional[Path] = None):
        from apex_studio_tpu_torch.utils.defaults import get_lora_path

        self.lora_root = Path(lora_root) if lora_root else get_lora_path()

    # -- resolution ------------------------------------------------------------------

    def resolve(self, source: str) -> Path:
        """Source forms: absolute/relative local path, path under the lora dir,
        'hf:org/repo/file.safetensors' (must already be on disk). An https URL
        or civitai AIR would need the downloads subsystem, which the port
        does not have yet: those raise ``FileNotFoundError``."""
        p = Path(source)
        if p.is_file():
            return p
        local = self.lora_root / source
        if local.is_file():
            return local
        if source.startswith("hf:"):
            from apex_studio_tpu_torch.utils.defaults import get_components_path

            for root in (self.lora_root, get_components_path()):
                cand = root / source[3:]
                if cand.is_file():
                    return cand
        if source.startswith(("http://", "https://", "urn:air:")):
            raise FileNotFoundError(f"remote LoRA sources are not ported (no downloads subsystem): {source}")
        raise FileNotFoundError(f"LoRA source not found locally: {source}")

    # -- application ---------------------------------------------------------------

    @staticmethod
    def _merge_into_quantized(mod: Linear, pair: LoraPair, scale: float, sign: float) -> bool:
        """Merge an adapter into an int8/int4-resident weight on the weight's
        own device: dequantize, add the delta, requantize with fresh
        per-channel scales, repack. Returns False when the shapes do not fit.
        Exact unmerge is NOT preserved across the requantization: a quantized
        base is restored by loading it again."""
        q = mod.weight
        logical = (q.shape[0] * 2, q.shape[1]) if mod.weight_bits == 4 else tuple(q.shape)
        if logical != (pair.up.shape[0], pair.down.shape[1]):
            return False
        merge = _merge4 if mod.weight_bits == 4 else _merge8
        with torch.no_grad():
            new_q, new_s = merge(q, mod.weight_scale.float(), _delta(pair, scale, q.device) * sign)
        mod.set_quantized(new_q, new_s, mod.weight_bits)
        return True

    def pairs_for_model(
        self, sd: Mapping[str, np.ndarray], converter_family: Optional[str]
    ) -> List[Tuple[str, LoraPair]]:
        """Normalize and key-convert adapter pairs to the port's parameter paths."""
        conv = (
            converter_registry.get(converter_family)
            if converter_family and converter_family in converter_registry
            else None
        )
        out: List[Tuple[str, LoraPair]] = []
        for pair in lora_pairs_from_state_dict(sd):
            torch_key = pair.module_path + ".weight"
            converted = conv.convert_key(torch_key) if conv else torch_key
            if converted is not None:
                out.append((port_path(converted), pair))
        return out

    def apply_to_model(
        self,
        model: nn.Module,
        sd: Mapping[str, np.ndarray],
        scale: float = 1.0,
        converter_family: Optional[str] = None,
        sign: float = 1.0,
    ) -> Tuple[int, List[str]]:
        """Merge (or with sign=-1, unmerge) adapters. Returns (applied, skipped)."""
        params = dict(model.named_parameters())
        applied = 0
        skipped: List[str] = []
        for path, pair in self.pairs_for_model(sd, converter_family):
            param = params.get(path)
            if param is None:
                skipped.append(path)
                continue
            owner = model.get_submodule(path.rpartition(".")[0])
            if isinstance(owner, Linear) and owner.weight_scale is not None:
                if self._merge_into_quantized(owner, pair, scale, sign):
                    applied += 1
                else:
                    skipped.append(f"{path} (quantized target shape mismatch)")
                continue
            shape = (pair.up.shape[0], pair.down.shape[1])  # [out, in]
            if tuple(param.shape) != shape:
                skipped.append(f"{path} (shape {shape} vs {tuple(param.shape)})")
                continue
            with torch.no_grad():
                param.add_(_delta(pair, scale, param.device).to(param.dtype), alpha=sign)
            applied += 1
        if skipped:
            logger.warning("LoRA: %d adapters had no target (first: %s)", len(skipped), skipped[:3])
        return applied, skipped

    def load_into(
        self,
        model: nn.Module,
        spec: Union[LoraSpec, str, Dict[str, Any]],
        converter_family: Optional[str] = None,
    ) -> Tuple[int, List[str]]:
        """Resolve, read and merge one LoRA file. Returns (applied, skipped)."""
        if not isinstance(spec, LoraSpec):
            spec = LoraSpec.from_manifest_entry(spec)
        from apex_studio_tpu_torch.loaders.safetensors_io import load_safetensors

        path = self.resolve(spec.source)
        sd = {k: v.float().numpy() for k, v in load_safetensors(path).items()}
        applied, skipped = self.apply_to_model(
            model, sd, scale=spec.scale, converter_family=converter_family)
        logger.info("LoRA %s: merged %d adapters at scale %.3f", path.name, applied, spec.scale)
        return applied, skipped
