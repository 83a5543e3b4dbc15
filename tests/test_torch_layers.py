"""Parity of the port's transformer primitives (aaclip_tpu_torch/models/
layers.py) with the JAX package's (aaclip_tpu/models/layers.py), on the
CPU. Inputs and weights are made with numpy from a seed and loaded into
both sides (weights through ``params_from_jax``).

fp32 bar: atol 1e-4, rtol 1e-5 (the same math in another summation order).
bf16 bar: the two frameworks round at the same places, but sum in another
order, so a bf16 result may differ by one bf16 ulp (2^-8 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import DtypePolicy as JPolicy
from aaclip_tpu.core.config import get_config as jget_config
from aaclip_tpu.core.params import create_clip_params
from aaclip_tpu.models import layers as JL
from aaclip_tpu_torch.core.config import DtypePolicy, get_config
from aaclip_tpu_torch.core.params import params_from_jax
from aaclip_tpu_torch.models import layers as L

ATOL, RTOL = 1e-4, 1e-5
BF16_RTOL = 2 ** -7  # one ulp of either side's rounding, both ways

POLICIES = {"fp32": (JPolicy.fp32(), DtypePolicy.fp32()),
            "bf16": (JPolicy.bf16(), DtypePolicy.bf16())}


def perturbed_clip_tree(cfg, seed: int = 0):
    """The JAX init tree of the vision tower of ``cfg`` (a JAX CLIPConfig
    or its name) with every leaf shifted by seeded numpy noise, a fifth of
    the leaf's spread (0.05 for the constant biases and LayerNorms), so no
    parameter is the trivial 0 or 1."""
    if isinstance(cfg, str):
        cfg = jget_config(cfg)
    # only the vision tower is returned: keep the text tower tiny
    cfg = dataclasses.replace(cfg, text=jget_config("tiny-test").text)
    tree = create_clip_params(cfg, seed=seed)["visual"]
    rng = np.random.default_rng(seed + 100)

    def shift(x):
        x = np.asarray(x, np.float32)
        std = 0.2 * float(x.std()) or 0.05
        return x + rng.normal(0, std, x.shape).astype(np.float32)

    return jax.tree.map(shift, tree)


def perturbed_text_tree(cfg, seed: int = 0):
    """The JAX init tree of the text tower of ``cfg`` (a JAX CLIPConfig or
    its name), every leaf shifted as ``perturbed_clip_tree`` shifts the
    vision tower's."""
    if isinstance(cfg, str):
        cfg = jget_config(cfg)
    tree = create_clip_params(cfg, seed=seed)["text"]
    rng = np.random.default_rng(seed + 200)

    def shift(x):
        x = np.asarray(x, np.float32)
        std = 0.2 * float(x.std()) or 0.05
        return x + rng.normal(0, std, x.shape).astype(np.float32)

    return jax.tree.map(shift, tree)


def block_trees(visual, i=0):
    return jax.tree.map(lambda a: a[i], visual["blocks"])


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def close(got, want, dtype="fp32", atol=ATOL, rtol=RTOL):
    if dtype == "bf16":
        atol, rtol = 1e-3, BF16_RTOL
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layer_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (3, 7, 64)).astype(np.float32)
    w = rng.normal(1.0, 0.1, 64).astype(np.float32)
    b = rng.normal(0.0, 0.1, 64).astype(np.float32)
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = JL.layer_norm(jnp.asarray(x, jd), {"scale": w, "bias": b})
    got = L.layer_norm(torch.from_numpy(x).to(td), torch.from_numpy(w),
                       torch.from_numpy(b))
    assert got.dtype == td
    close(to_np(got), want, dtype)


@pytest.mark.parametrize("name", ["gelu", "gelu_tanh", "quick_gelu"])
def test_activations(name):
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = getattr(JL, name)(jnp.asarray(x))
    got = getattr(L, name)(torch.from_numpy(x))
    close(to_np(got), want, atol=1e-6, rtol=1e-6)


def test_config_act_follows_policy_and_quick_gelu():
    cfg = get_config("tiny-test")
    assert L.config_act(cfg, DtypePolicy.fp32()) is L.gelu
    assert L.config_act(cfg, DtypePolicy.bf16()) is L.gelu_tanh
    assert L.config_act(get_config("ViT-B-16-quickgelu"),
                        DtypePolicy.bf16()) is L.quick_gelu


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_linear_returns_fp32_with_fp32_bias(policy):
    jpol, tpol = POLICIES[policy]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32) * 0.1
    b = rng.standard_normal(48).astype(np.float32)
    want = JL.linear(jnp.asarray(x), {"w": w, "b": b}, jpol)
    got = L.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                   torch.from_numpy(b), tpol)
    assert got.dtype == torch.float32
    # both products are exact bf16 x bf16 in fp32: only the order differs
    close(to_np(got), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_norm_matched_blend(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    a = rng.standard_normal((2, 9, 64)).astype(np.float32) * 3
    a[0, 0] = 0.0  # the clamp keeps an all-zero adapter output finite
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = JL.norm_matched_blend(jnp.asarray(x, jd), jnp.asarray(a, jd), 0.1)
    got = L.norm_matched_blend(torch.from_numpy(x).to(td),
                               torch.from_numpy(a).to(td), 0.1)
    assert got.dtype == td and torch.isfinite(got).all()
    close(to_np(got), want, dtype)


def test_simple_adapter_and_l2_normalize():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64, 64)).astype(np.float32) * 0.2
    want = JL.simple_adapter(jnp.asarray(x), {"w": w}, JPolicy.fp32())
    got = L.simple_adapter(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                           DtypePolicy.fp32())
    close(to_np(got), want)
    close(to_np(L.l2_normalize(torch.from_numpy(x))),
          JL.l2_normalize(jnp.asarray(x)))


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_residual_block(policy):
    """One tiny-test block, weights through params_from_jax: the JAX XLA
    path against the port's default attention hook (the kernel wrapper,
    which runs its plain version on the CPU)."""
    jpol, tpol = POLICIES[policy]
    cfg = get_config("tiny-test")
    visual = perturbed_clip_tree("tiny-test")
    vit = params_from_jax(visual, cfg, device="cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, cfg.vision.seq_len, 64)).astype(np.float32)
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[policy]
    jblk = block_trees(visual)
    tblk = vit.blocks[0]
    if policy == "bf16":  # the predictor's cast of the block weights
        jblk = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jblk)
        tblk = tblk.to(torch.bfloat16)
    act_j = JL.gelu_tanh if jpol.fast_act else JL.gelu
    want = JL.residual_block(jnp.asarray(x, jd), jblk, cfg.vision.heads,
                             act=act_j, policy=jpol)
    got = L.residual_block(torch.from_numpy(x).to(td), tblk,
                           cfg.vision.heads, act=L.config_act(cfg, tpol),
                           policy=tpol)
    assert got.dtype == td
    if policy == "fp32":
        close(to_np(got), want)
    else:
        # bf16 residual stream: compare like the fast-path quality test
        g, w = to_np(got).ravel(), np.asarray(want, np.float32).ravel()
        assert np.corrcoef(g, w)[0, 1] > 0.9999
        np.testing.assert_allclose(g, w, atol=5e-2)
