"""A VAE decode's peak of live activation bytes, reckoned on the CPU at a
reduced size and scaled back: the latent's height and width divided by
``shrink`` (the pixels' by the same), the VAE's chunk limits divided by
``shrink²``, so that every op splits its frames as at full size and every
tensor holds ``shrink²`` times fewer elements. Live bytes are counted by
storage as the ops make them (a ``TorchDispatchMode``), the parameters and
the latent left out.

    JAX_PLATFORMS=cpu python -m tests.torch_decode_peak [cogvideox|mochi] FRAMES [SHRINK]

prints one JSON line: the reduced run's peak in bytes and that peak times
``shrink²`` in GiB. CogVideoX 5B at 480x720 (latents 60 x 90 at 1 + 4k
frames), Mochi-1 at 480x848 (latents 60 x 106 at 1 + 6k frames); the
padding rows of the convs do not shrink, so the scaled figure is an
estimate to about 10%.
"""

import json
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from apex_studio_tpu_torch.engine.base import materialize_random


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages that the ops under it made and that some
    tensor still holds; ``peak`` their most at once."""

    def __init__(self, skip):
        super().__init__()
        self.skip, self.holders, self.live, self.peak = set(skip), {}, 0, 0

    def _drop(self, ptr):
        entry = self.holders[ptr]
        entry[1] -= 1
        if entry[1] == 0:
            del self.holders[ptr]
            self.live -= entry[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            ptr, nbytes = storage.data_ptr(), storage.nbytes()
            if nbytes == 0 or ptr in self.skip:
                continue
            entry = self.holders.setdefault(ptr, [nbytes, 0])
            if entry[1] == 0:
                self.live += nbytes
                self.peak = max(self.peak, self.live)
            entry[1] += 1
            weakref.finalize(t, self._drop, ptr)
        return out


def reckon(name: str, frames: int, shrink: int) -> dict:
    if name == "cogvideox":
        from apex_studio_tpu_torch.models.vaes import cogvideox_vae as mod

        cfg = mod.CogVideoXVAEConfig.from_dict({"block_out_channels": [128, 256, 256, 512], "layers_per_block": 3,
                                                "latent_channels": 16, "scaling_factor": 0.7})
        build, latent = (lambda: mod.AutoencoderKLCogVideoX(cfg)), (16, (frames - 1) // 4 + 1, 60, 90)
        limits = ("CONV_CHUNK_ELEMENTS", "NORM_CHUNK_ELEMENTS")
    else:
        from apex_studio_tpu_torch.models.vaes import mochi_vae as mod

        build, latent = (lambda: mod.AutoencoderKLMochi(mod.MochiVAEConfig())), (12, (frames - 1) // 6 + 1, 60, 106)
        limits = ("CHUNK_ELEMENTS",)
    for limit in limits:
        setattr(mod, limit, getattr(mod, limit) // shrink**2)
    vae = materialize_random(build, torch.device("cpu"), seed=0)
    c, t, h, w = latent
    z = torch.randn(1, c, t, h // shrink, w // shrink, generator=torch.Generator().manual_seed(1))
    skip = {p.untyped_storage().data_ptr() for p in vae.parameters()} | {z.untyped_storage().data_ptr()}
    mode = LiveBytes(skip)
    with torch.inference_mode(), mode:
        out = vae.decode(z)
    return {"vae": name, "frames": frames, "latent": [1, *latent], "shrink": shrink,
            "out_shape_reduced": list(out.shape), "peak_bytes_reduced": mode.peak,
            "peak_gib_reckoned": mode.peak * shrink**2 / 2**30}


if __name__ == "__main__":
    name = sys.argv[1] if len(sys.argv) > 1 else "cogvideox"
    frames = int(sys.argv[2]) if len(sys.argv) > 2 else 49
    shrink = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    print(json.dumps(reckon(name, frames, shrink)), flush=True)
