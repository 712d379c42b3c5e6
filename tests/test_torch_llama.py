"""The port's Llama-architecture text encoder (FLUX.2's Mistral tower) against
the JAX package's, on the CPU in f32.

A tiny GQA model (4 query heads sharing 2 key/value heads, head dim 8) is
built by the JAX package from its seed and carried into the port with
``loaders/from_jax.py``. Two prompts, one padded, run through each way of
reading the hidden states: ``stack_layers`` (FLUX.2: the listed layers'
outputs concatenated, the embeddings as layer 0) and ``skip_last_layers``
with and without the final norm. Tolerance: max|Δ| ≤ 1e-4·max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from apex_studio_tpu.models.text_encoders import llama as jax_llama
from apex_studio_tpu_torch.models.registry import _load_builtin_families, text_encoder_registry
from apex_studio_tpu_torch.models.text_encoders import llama
from tests.torch_port_helpers import assert_close, jax_build, port_from_jax

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, head_dim=8)
F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)

# (stack_layers, skip_last_layers, normalize_last)
READS = {
    "stack_1_2_3": ((1, 2, 3), 2, False),
    "stack_0_and_last": ((0, 4), 2, False),
    "stack_unordered": ((3, 1), 2, False),
    "skip_2": (None, 2, False),
    "skip_0_normed": (None, 0, True),
    "skip_0": (None, 0, False),
}


def ids_and_mask():
    ids = np.zeros((2, 9), np.int32)
    mask = np.zeros((2, 9), np.int32)
    ids[0] = np.arange(3, 12)
    mask[0] = 1
    ids[1, :4] = [7, 1, 60, 5]
    mask[1, :4] = 1
    return ids, mask


@pytest.mark.parametrize("read", list(READS))
def test_hidden_states_match_jax(read):
    stack, skip, normed = READS[read]
    cfg = dict(TINY, stack_layers=stack, skip_last_layers=skip)
    jm = jax_build(lambda: jax_llama.LlamaTextEncoder(jax_llama.LlamaConfig(**cfg), rngs=nnx.Rngs(0), **F32))
    pm = port_from_jax(lambda: llama.LlamaTextEncoder(llama.LlamaConfig(**cfg), dtype=torch.float32), jm)
    ids, mask = ids_and_mask()
    ref = nnx.jit(lambda m, i, k: m(i, attention_mask=k, normalize_last=normed))(jm, jnp.asarray(ids),
                                                                                  jnp.asarray(mask))
    with torch.no_grad():
        out = pm(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask), normalize_last=normed)
    assert tuple(out.shape) == (2, 9, 32 * (len(stack) if stack else 1))
    assert_close(out, ref)


def test_from_dict_matches_jax():
    """Head dim from the widths when absent; ``stack_layers`` as a tuple; a
    nested ``text_config`` (Mistral3's published layout) is not read, in
    either package."""
    for d in ({"hidden_size": 64, "num_attention_heads": 4, "stack_layers": [1, 2]},
              {"text_config": {"hidden_size": 5120}, "vocab_size": 10}):
        assert llama.LlamaConfig.from_dict(d).__dict__ == jax_llama.LlamaConfig.from_dict(d).__dict__
    assert llama.LlamaConfig.from_dict({"text_config": {"hidden_size": 5120}}).hidden_size == 4096


def test_registered_under_the_manifest_names():
    _load_builtin_families()
    for name in ("LlamaModel", "llama", "LlavaForConditionalGeneration", "MistralModel",
                 "Mistral3ForConditionalGeneration"):
        assert text_encoder_registry.get(name) is llama.LlamaTextEncoder
