"""Where SAM2's mask-logit distance under the flash kernel comes from: the
model is f32, and on the card its attention runs on the kernel's bf16 tiles
(q, k, v and P rounded to bf16, f32 scores and output). On the CPU, at
Hiera-B+ widths (``chip_smoke.py``'s ``SAM2_BASE_PLUS``) with the CPU tests'
weights (``jax_build``):

- the JAX module with bf16-rounded q/k/v against itself in f32;
- the port with the plain version on bf16 q/k/v (what the kernel computes,
  P rounded too) against the port in f32;
- the port in f32 against the JAX module in f32 (the port's own distance).

The first two set the scale of ``SAM2_LOGITS_REL_L2``, the limit the card's
logits with the kernel are held to against the plain attention. At 1024² the
q-pool blocks' global attention scores 16,384 queries against 65,536 keys,
too large for this host, so the script runs at a smaller input (512² by
default; the same trunk and decoder):

    JAX_PLATFORMS=cpu python -m tests.torch_sam2_bf16 [img_size]

It prints one JSON line of relative L2 distances of the mask logits.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from apex_studio_tpu.mask import sam2 as jax_sam2
from apex_studio_tpu_torch.mask import sam2
from apex_studio_tpu_torch.ops.attention import attention_registry
from apex_studio_tpu_torch.ops.attention.flash import flash_attention_reference
from tests.torch_port_helpers import jax_build, port_from_jax

B_PLUS = dict(embed_dim=112, num_heads=2, stages=(2, 3, 16, 3), window_specs=(8, 4, 14, 7),
              global_att_blocks=(12, 16, 20), d_model=256, decoder_depth=2, decoder_heads=8, decoder_mlp_dim=2048)


def rel_l2(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def readings(img_size: int) -> dict:
    cfg = dict(B_PLUS, img_size=img_size)
    jax_model = jax_build(lambda: jax_sam2.SAM2ImageModel(jax_sam2.SAM2Config(**cfg), rngs=nnx.Rngs(0)))
    rng = np.random.default_rng(0)
    img = rng.random((1, img_size, img_size, 3)).astype(np.float32)
    pts = np.array([[[0.4, 0.5], [0.1, 0.1], [0.0, 0.0], [0.0, 0.0]]], np.float32)
    labels = np.array([[1, 0, -1, -1]], np.int32)

    def jax_logits():
        run = nnx.jit(lambda m, x, p, lab: m.predict(x, p, lab)[0])
        return np.asarray(run(jax_model, jnp.asarray(img), jnp.asarray(pts), jnp.asarray(labels)))

    jax_f32 = jax_logits()
    attention_op = jax_sam2.attention_op
    jax_sam2.attention_op = lambda q, k, v, **kw: attention_op(
        *(x.astype(jnp.bfloat16).astype(jnp.float32) for x in (q, k, v)), **kw)
    try:
        jax_bf16 = jax_logits()
    finally:
        jax_sam2.attention_op = attention_op

    port = port_from_jax(lambda: sam2.SAM2ImageModel(sam2.SAM2Config(**cfg)), jax_model)
    inputs = (torch.from_numpy(img), torch.from_numpy(pts), torch.from_numpy(labels))
    with torch.no_grad():
        port_f32 = port.predict(*inputs)[0].numpy()
        flash = attention_registry.get("flash")
        attention_registry._entries["flash"] = lambda q, k, v, **kw: flash_attention_reference(
            q.bfloat16(), k.bfloat16(), v.bfloat16(), **kw).float()
        try:
            port_bf16 = port.predict(*inputs)[0].numpy()
        finally:
            attention_registry._entries["flash"] = flash
    return {"img_size": img_size, "jax_bf16_qkv_vs_f32": rel_l2(jax_bf16, jax_f32),
            "port_bf16_route_vs_f32": rel_l2(port_bf16, port_f32), "port_f32_vs_jax_f32": rel_l2(port_f32, jax_f32),
            "sign_agreement_port_bf16_route": float(((port_bf16 > 0) == (port_f32 > 0)).mean())}


if __name__ == "__main__":
    print(json.dumps(readings(int(sys.argv[1]) if len(sys.argv) > 1 else 512)))
