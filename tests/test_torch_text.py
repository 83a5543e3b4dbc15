"""The port's text side (aaclip_tpu_torch/text/, data/registry.py,
models/text_model.py, the text parameters of core/params.py) against the
JAX package's, on the CPU, with the same numpy weights on both sides.

Bars:
* tokens, prompt grammar, vocab: exact (the vocab file has the JAX
  package's sha256).
* ``encode_text`` and ``adapted_encode_text``, tiny-test (32 wide, 4 heads)
  and the real text widths (768, 12 heads) cut to 2 layers: fp32 atol 1e-4,
  rtol 1e-5 (the same math in another summation order). bf16: the output
  is rounded to bf16 on both sides after the same roundings of the stream,
  summed in another order, so within 2 bf16 ulps of the output (rtol 2^-7)
  plus atol 2e-2 of its scale for an entry that flips in an earlier
  rounding (readings: at most 7.7e-3 of the scale). JAX runs jitted with
  XLA's excess precision off (``strict``), so it rounds where the port
  does.
* anchors: fp32 atol 1e-5 (unit vectors).
"""

import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import AdapterConfig as JAdapterConfig
from aaclip_tpu.core.config import DtypePolicy as JPolicy
from aaclip_tpu.core.config import TextConfig as JTextConfig
from aaclip_tpu.core.config import get_config as jget_config
from aaclip_tpu.core.params import init_adapter_params
from aaclip_tpu.data import registry as jreg
from aaclip_tpu.models import layers as JL
from aaclip_tpu.models import text_model as JT
from aaclip_tpu.text import anchors as janchors
from aaclip_tpu.text import bpe as jbpe
from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                          TextConfig, get_config)
from aaclip_tpu_torch.core.params import (init_text_adapter, init_text_params,
                                          text_adapter_from_jax,
                                          text_adapter_to_jax,
                                          text_params_from_jax)
from aaclip_tpu_torch.data import registry
from aaclip_tpu_torch.models import layers as L
from aaclip_tpu_torch.models import text_model as T
from aaclip_tpu_torch.text import anchors, bpe
from tests.test_torch_layers import perturbed_text_tree
from tests.test_torch_train import strict

VOCAB_SHA256 = \
    "924691ac288e54409236115652ad4aa250f48203de50a9e4722a6ecd48d6804a"
POLICIES = {"fp32": (JPolicy.fp32(), DtypePolicy.fp32()),
            "bf16": (JPolicy.bf16(), DtypePolicy.bf16())}


def t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------ tokens and prompts

def test_vocab_is_a_byte_identical_copy():
    digest = [hashlib.sha256(open(p, "rb").read()).hexdigest()
              for p in (bpe.VOCAB_PATH, jbpe.VOCAB_PATH)]
    assert digest == [VOCAB_SHA256] * 2
    assert bpe.VOCAB_PATH != jbpe.VOCAB_PATH


def test_registry_strings_match_jax():
    assert registry.REAL_NAMES == jreg.REAL_NAMES
    assert registry.CLASS_NAMES == jreg.CLASS_NAMES
    for attr in ("NORMAL_STATES", "ABNORMAL_STATES", "TEMPLATES"):
        assert getattr(registry, attr) == getattr(jreg, attr)


@pytest.mark.parametrize("dataset", sorted(jreg.CLASS_NAMES))
def test_dataset_prompt_tokens_match_jax(dataset):
    got = anchors.dataset_prompt_tokens(dataset)
    want = janchors.dataset_prompt_tokens(dataset)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_tokenizer_matches_jax_off_the_prompt_set():
    """Text the prompts never hold: non-ASCII letters and numbers,
    contractions in both cases, runs of punctuation, special tokens."""
    texts = ["Héllo  wörld² 3.5 <|endoftext|>x", "it's A TEST'S ok!!",
             "ümlaut-Ω 中文 ٣ⅷ ''re \t\n tabs", "a" * 40 + " b",
             "&amp;lt;html&gt; entities"]
    np.testing.assert_array_equal(bpe.tokenize(texts), jbpe.tokenize(texts))
    tok = bpe.default_tokenizer()
    assert tok.decode(tok.encode("a broken pill.")) == "a broken pill . "
    with pytest.raises(RuntimeError, match="too long"):
        bpe.tokenize("word " * 80)
    assert bpe.tokenize("word " * 80, truncate=True)[0, -1] == tok.eot_token


def test_resolve_real_name():
    assert registry.resolve_real_name("VisA", "pcb1") == \
        "dual ultrasonic distance sensor pcb module"
    assert registry.resolve_real_name("MVTec", "object") == "object"
    with pytest.raises(KeyError, match="not found"):
        registry.resolve_real_name("MVTec", "nope")


# ------------------------------------------------------------ text tower

def text_configs(width):
    """(JAX config, port config): tiny-test's towers, or tiny-test with the
    real text widths (768, 12 heads) cut to 2 layers."""
    jcfg, cfg = jget_config("tiny-test"), get_config("tiny-test")
    if width == "tiny":
        return jcfg, cfg
    jcfg = dataclasses.replace(jcfg, text=JTextConfig(
        width=768, heads=12, layers=2, output_dim=jcfg.embed_dim))
    cfg = dataclasses.replace(cfg, text=TextConfig(width=768, heads=12,
                                                   layers=2))
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def towers(width):
    """(JAX config, port config, perturbed JAX text tree, the port's text
    tower loaded from it), built once per width."""
    jcfg, cfg = text_configs(width)
    tree = perturbed_text_tree(jcfg, seed=3)
    return jcfg, cfg, tree, text_params_from_jax(tree, cfg, device="cpu")


def prompt_batch():
    return janchors.dataset_prompt_tokens("MVTec", ["pill", "cable"]) \
        .reshape(32, 77)


def close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("width", ["tiny", "real"])
def test_encode_text_matches_jax(width, dtype):
    jcfg, cfg, tree, text_w = towers(width)
    jpol, tpol = POLICIES[dtype]
    tokens = prompt_batch()
    want = strict(jax.jit(lambda p, x: JT.encode_text(p, jcfg, x,
                                                      policy=jpol)),
                  tree, jnp.asarray(tokens))
    got = T.encode_text(text_w, cfg, t(tokens), policy=tpol)
    assert got.shape == (32, cfg.embed_dim)
    assert got.dtype == tpol.compute_dtype
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("width", ["tiny", "real"])
def test_adapted_encode_text_matches_jax(width, dtype):
    jcfg, cfg, tree, text_w = towers(width)
    jpol, tpol = POLICIES[dtype]
    jad = jax.tree.map(np.asarray, init_adapter_params(
        jax.random.PRNGKey(5), jcfg, JAdapterConfig(text_adapt_until=2))
        ["text"])
    acfg = AdapterConfig(text_adapt_until=2)
    ad = text_adapter_from_jax(jad, cfg, acfg, device="cpu")
    tokens = prompt_batch()
    want = strict(jax.jit(lambda p, a, x: JT.adapted_encode_text(
        p, a, jcfg, x, policy=jpol)), tree, jad, jnp.asarray(tokens))
    got = T.adapted_encode_text(text_w, ad, cfg, t(tokens), policy=tpol)
    assert got.shape == (32, cfg.text.width)
    close(got, want, dtype)


def test_causal_mask_and_simple_proj_match_jax():
    np.testing.assert_array_equal(L.causal_mask(7).numpy(),
                                  np.asarray(JL.causal_mask(7)))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    w = (0.3 * rng.standard_normal((32, 32))).astype(np.float32)
    for relu in (False, True):
        want = JL.simple_proj(jnp.asarray(x), {"w": w}, relu, JPolicy.fp32())
        got = L.simple_proj(t(x), t(w.T.copy()), relu, DtypePolicy.fp32())
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_masked_attention_runs_off_the_cpu_and_attention_does_not():
    """The text tower's masked attention is the one plain attention that
    runs on any device; the unmasked reference refuses all but the CPU."""
    cfg = get_config("tiny-test")
    blk = init_text_params(cfg, device="cpu").blocks[0].to("meta")
    x = torch.empty(2, 9, 32, device="meta")
    out = L.masked_attention(x, blk.attn, 4, L.causal_mask(9, device="meta"))
    assert out.shape == (2, 9, 32) and out.device.type == "meta"
    with pytest.raises(ValueError, match="CPU reference"):
        L.attention(x, blk.attn, 4)
    with pytest.raises(ValueError, match="unmasked"):
        L.residual_block(x, blk, 4, mask=L.causal_mask(9, device="meta"),
                         attn_fn=lambda h, p: h)


# ---------------------------------------------------------------- anchors

def test_reduce_to_anchors_matches_jax():
    e = np.random.default_rng(7).standard_normal((3, 16, 24)) \
        .astype(np.float32)
    want = np.asarray(janchors.reduce_to_anchors(jnp.asarray(e)))
    got = anchors.reduce_to_anchors(t(e))
    assert got.shape == (3, 24, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_encode_dataset_anchors_matches_jax():
    jcfg, cfg = text_configs("tiny")
    tree = perturbed_text_tree(jcfg, seed=8)
    text_w = text_params_from_jax(tree, cfg, device="cpu")
    names = ["bottle", "cable", "pill"]
    want = janchors.encode_dataset_anchors(
        lambda x: JT.encode_text(tree, jcfg, x, policy=JPolicy.fp32()),
        "MVTec", names)
    got = anchors.encode_dataset_anchors(
        lambda x: T.encode_text(text_w, cfg, x, policy=DtypePolicy.fp32()),
        "MVTec", names)
    assert list(got) == names
    for name in names:
        assert got[name].shape == (cfg.embed_dim, 2)
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(want[name]), atol=1e-5)


# ------------------------------------------------------- parameters, remat

def test_text_adapter_to_jax_inverts_text_adapter_from_jax():
    jcfg, cfg = text_configs("tiny")
    jad = jax.tree.map(np.asarray, init_adapter_params(
        jax.random.PRNGKey(9), jcfg, JAdapterConfig(text_adapt_until=2))
        ["text"])
    ad = text_adapter_from_jax(jad, cfg, AdapterConfig(text_adapt_until=2),
                               device="cpu")
    back = text_adapter_to_jax(ad)
    assert jax.tree.structure(back) == jax.tree.structure(jad)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jad)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="text_adapt_until"):
        text_adapter_from_jax(jad, cfg, AdapterConfig(text_adapt_until=1),
                              device="cpu")


def test_random_init_is_frozen_seeded_and_shaped():
    cfg = get_config("tiny-test")
    a, b = (init_text_params(cfg, seed=0, device="cpu") for _ in range(2))
    assert not any(p.requires_grad for p in a.parameters())
    assert a.token_embedding.weight.shape == (49408, 32)
    assert a.text_projection.shape == (32, cfg.embed_dim)
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    ad = init_text_adapter(cfg, AdapterConfig(text_adapt_until=2),
                           device="cpu")
    assert [tuple(p.shape) for p in ad.parameters()] == [(32, 32)] * 3
    assert all(p.requires_grad for p in ad.parameters())


def test_text_remat_full_or_selective_changes_nothing():
    cfg = get_config("tiny-test")
    acfg = AdapterConfig(text_adapt_until=2)
    text_w = init_text_params(cfg, device="cpu")
    tokens = t(prompt_batch()[:8])
    grads = []
    for remat in (False, True, "selective"):
        ad = init_text_adapter(cfg, acfg, device="cpu")
        out = T.adapted_encode_text(text_w, ad, cfg, tokens, remat=remat)
        out.square().sum().backward()
        grads.append([p.grad.clone() for p in ad.parameters()])
    for other in grads[1:]:
        for g0, g1 in zip(grads[0], other):
            torch.testing.assert_close(g1, g0, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="remat must be"):
        T.adapted_encode_text(text_w, ad, cfg, tokens, remat="partial")
    with pytest.raises(ValueError, match="exceed"):
        T.adapted_encode_text(
            text_w, init_text_adapter(cfg, AdapterConfig(text_adapt_until=3),
                                      device="cpu"), cfg, tokens)
