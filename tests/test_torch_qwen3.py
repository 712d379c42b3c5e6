"""The port's Qwen3 encoder and ``PromptExtender`` against the JAX package's,
on the CPU.

A tiny Qwen3 (GQA 4/2, head dim 16) is built by the JAX package from its seed
and carried into the port with ``loaders/from_jax.py``; both run the same
numpy token ids in f32: the forward with a padding mask (pre-norm and normed),
``prefill`` (hidden states and caches) and ``decode_step`` are held to
max|Δ| ≤ 1e-4·max|ref|, and ``prefill`` + ``decode_step`` against a full
recompute of the sequence within the same limit. ``PromptExtender`` must emit
the JAX package's tokens, greedy and seeded top-p, with a byte-level
tokenizer. Attention routes as JAX routes it: ``decode_step`` through the
flash backend with a ``[B, L]`` key-padding bias (one call a layer), the
encode and ``prefill`` through the plain route (their mask is per query).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from apex_studio_tpu import text_encoder as jax_text_encoder
from apex_studio_tpu.models.text_encoders.qwen3 import Qwen3Config as JaxQwen3Config
from apex_studio_tpu.models.text_encoders.qwen3 import Qwen3TextEncoder as JaxQwen3
from apex_studio_tpu.prompt_extension import PromptExtender as JaxPromptExtender
from apex_studio_tpu_torch import text_encoder
from apex_studio_tpu_torch.models.text_encoders.qwen3 import Qwen3Config, Qwen3TextEncoder
from apex_studio_tpu_torch.ops.attention import attention_registry
from apex_studio_tpu_torch.prompt_extension import PromptExtender
from tests.torch_port_helpers import assert_close, jax_build, port_from_jax

CFG = dict(vocab_size=320, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=16)


def byte_tokenizer():
    """Byte-level BPE without merges: one token a byte, 64 spare ids."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {chr(c): c for c in range(256)}
    vocab.update({f"<{i}>": 256 + i for i in range(64)})
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[], unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    return tok


class Recording:
    """A tokenizer whose ``decode`` records the token ids it is given."""

    def __init__(self):
        self.tok, self.decoded = byte_tokenizer(), []

    def encode(self, text, **kw):
        return self.tok.encode(text, **kw)

    def decode(self, ids):
        self.decoded.append(list(ids))
        return self.tok.decode(ids)


@pytest.fixture(scope="module")
def pair():
    ref = jax_build(lambda: JaxQwen3(JaxQwen3Config(**CFG), dtype=jnp.float32, param_dtype=jnp.float32,
                                     rngs=nnx.Rngs(0)))
    port = port_from_jax(lambda: Qwen3TextEncoder(Qwen3Config(**CFG), dtype=torch.float32), ref)
    return ref, port


def ids_and_mask():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, CFG["vocab_size"], size=(2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 7:] = 0
    ids[1, 7:] = 0  # padding id 0
    return ids, mask


@pytest.fixture
def flash_calls(monkeypatch):
    """Count calls into the flash backend and the bias each one got."""
    calls = []
    flash = attention_registry.get("flash")

    def counting(q, k, v, bias=None, **kw):
        calls.append((tuple(q.shape), None if bias is None else tuple(bias.shape)))
        return flash(q, k, v, bias=bias, **kw)

    monkeypatch.setitem(attention_registry._entries, "flash", counting)
    return calls


class TestForward:
    @pytest.mark.parametrize("normalize_last", [False, True])
    def test_matches_jax_with_padding(self, pair, normalize_last):
        ref, port = pair
        ids, mask = ids_and_mask()
        want = ref(jnp.asarray(ids), attention_mask=jnp.asarray(mask), normalize_last=normalize_last)
        with torch.inference_mode():
            out = port(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask),
                       normalize_last=normalize_last)
        assert_close(out, np.asarray(want), rel=1e-4)

    def test_encode_takes_the_plain_route(self, pair, flash_calls):
        ids, mask = ids_and_mask()
        with torch.inference_mode():
            pair[1](torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))
        assert flash_calls == []


class TestKVCache:
    def test_prefill_matches_jax(self, pair):
        ref, port = pair
        ids, mask = ids_and_mask()
        want_h, want_c = ref.prefill(jnp.asarray(ids), jnp.asarray(mask), cache_len=20)
        with torch.inference_mode():
            h, caches = port.prefill(torch.from_numpy(ids).long(), torch.from_numpy(mask), cache_len=20)
        assert_close(h, np.asarray(want_h), rel=1e-4)
        assert len(caches) == len(want_c) == 2
        for (k, v), (wk, wv) in zip(caches, want_c):
            assert tuple(k.shape) == (2, 20, 2, 16)
            assert_close(k, np.asarray(wk), rel=1e-4)
            assert_close(v, np.asarray(wv), rel=1e-4)

    def test_decode_step_matches_jax_and_recompute(self, pair, flash_calls):
        ref, port = pair
        prefix, nxt = np.arange(1, 9), [11, 7, 300]
        seq, recompute = list(prefix), []
        for tok in nxt:
            seq.append(tok)
            ids = torch.tensor([seq])
            with torch.inference_mode():
                recompute.append(port(ids, attention_mask=torch.ones_like(ids), normalize_last=True)[0, -1])
        ids = prefix[None].astype(np.int32)
        _, jax_caches = ref.prefill(jnp.asarray(ids), jnp.ones_like(jnp.asarray(ids)), cache_len=16)
        with torch.inference_mode():
            _, caches = port.prefill(torch.from_numpy(ids).long(), torch.ones(1, 8, dtype=torch.int32),
                                     cache_len=16)
        flash_calls.clear()
        pos = len(prefix)
        for i, tok in enumerate(nxt):
            want, jax_caches = ref.decode_step(jnp.asarray([[tok]], jnp.int32), jnp.int32(pos), jax_caches)
            with torch.inference_mode():
                got, caches = port.decode_step(torch.tensor([[tok]]), pos, caches)
            assert_close(got[0, 0], np.asarray(want[0, 0]), rel=1e-4)
            assert_close(got[0, 0], recompute[i].numpy(), rel=1e-4)
            pos += 1
        # one flash call a layer a token, a single query over the whole cache
        # with the valid prefix as a key-padding bias
        assert flash_calls == [((1, 1, 4, 16), (1, 1, 1, 16))] * (2 * len(nxt))


class TestPromptExtender:
    @pytest.mark.parametrize("temperature,top_p,seed", [(0.0, 0.9, 0), (0.8, 0.9, 3), (1.2, 0.5, 7)])
    def test_tokens_match_jax(self, pair, temperature, top_p, seed):
        ref, port = pair
        jax_tok, port_tok = Recording(), Recording()
        kw = dict(max_new_tokens=6, temperature=temperature, top_p=top_p, seed=seed)
        want = JaxPromptExtender(ref, jax_tok).generate("a red fox", **kw)
        got = PromptExtender(port, port_tok).generate("a red fox", **kw)
        assert port_tok.decoded == jax_tok.decoded and len(port_tok.decoded[0]) == 6
        assert got == want

    def test_cached_equals_recompute_and_stops_at_eos(self, pair):
        port = pair[1]
        tok = Recording()
        cached = PromptExtender(port, tok).generate("a cat", max_new_tokens=5, temperature=0.0)
        fallback = PromptExtender(port, tok).generate("a cat", max_new_tokens=5, temperature=0.0,
                                                      use_cache=False)
        assert cached == fallback and tok.decoded[0] == tok.decoded[1]
        first = tok.decoded[0][0]
        PromptExtender(port, tok, eos_token_id=first).generate("a cat", max_new_tokens=5, temperature=0.0)
        assert tok.decoded[-1] == []

    def test_progress(self, pair):
        seen = []
        PromptExtender(pair[1], byte_tokenizer()).generate(
            "a cat", max_new_tokens=3, temperature=0.0, progress_callback=lambda p, m, md: seen.append(p))
        assert seen == pytest.approx([1 / 3, 2 / 3, 1.0])


def test_chat_template_and_family_match_jax():
    spec = {"base": "Qwen3ForCausalLM"}
    port = text_encoder.TextEncoder(None, spec)
    ref = jax_text_encoder.TextEncoder(None, spec)
    assert port.apply_chat_template("a cat") == ref.apply_chat_template("a cat")
    assert port._converter_family() == ref._converter_family() == "qwen3"
    assert text_encoder._QWEN3_CHAT == jax_text_encoder._QWEN3_CHAT
