"""The port's adapted forward and predictor (aaclip_tpu_torch/models/vit.py,
aaclip_tpu_torch/eval/predict.py) against the JAX package's, on the CPU,
with the same weights loaded into both (``params_from_jax``,
``adapter_from_jax``). JAX runs its XLA attention here; the port runs its
kernel wrapper, which takes the plain version on CPU tensors.

fp32 bar: atol 1e-4, rtol 1e-5. bf16 bar, as tests/test_fast_path_quality
judges the fast path: pixel-map correlation > 0.999 and scores atol 5e-3
(the two sides round the bf16 stream at the same points but sum in another
order, and the kernel path defers the softmax division).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import AdapterConfig as JAdapterConfig
from aaclip_tpu.core.config import DtypePolicy as JPolicy
from aaclip_tpu.core.config import get_config as jget_config
from aaclip_tpu.core.params import init_adapter_params
from aaclip_tpu.eval.predict import make_predict_fn as j_make_predict_fn
from aaclip_tpu.models.vit import adapted_forward as j_adapted_forward
from aaclip_tpu.ops.similarity import fused_postproc_matrix
from aaclip_tpu_torch.core.config import AdapterConfig, DtypePolicy, get_config
from aaclip_tpu_torch.core.params import adapter_from_jax, params_from_jax
from aaclip_tpu_torch.eval.predict import make_predict_fn
from aaclip_tpu_torch.models.vit import adapted_forward
from tests.test_torch_layers import perturbed_clip_tree

ATOL, RTOL = 1e-4, 1e-5
TINY_LEVELS = dict(levels=(1, 2), image_adapt_until=1)


def both_models(jcfg, tcfg, levels, seed=0):
    """(JAX visual tree, JAX image-adapter tree, port vit, port adapter)."""
    # the JAX tiny text tower has 2 layers: keep its (unused) text adapters
    # within it
    jacfg = JAdapterConfig(**levels, text_adapt_until=1)
    visual = perturbed_clip_tree(jcfg, seed=seed)
    jad = init_adapter_params(jax.random.PRNGKey(seed + 1), jcfg,
                              jacfg)["image"]
    jad = jax.tree.map(np.asarray, jad)
    tacfg = AdapterConfig(**levels)
    vit = params_from_jax(visual, tcfg, device="cpu")
    tad = adapter_from_jax(jad, tcfg, tacfg, device="cpu")
    return visual, jad, vit, tad, jacfg, tacfg


def forward_pair(jcfg, tcfg, levels, policy, img, batch=2, seed=0):
    visual, jad, vit, tad, jacfg, tacfg = both_models(jcfg, tcfg, levels,
                                                      seed)
    jpol, tpol = {"fp32": (JPolicy.fp32(), DtypePolicy.fp32()),
                  "bf16": (JPolicy.bf16(), DtypePolicy.bf16())}[policy]
    x = np.random.default_rng(seed + 2).standard_normal(
        (batch, 3, img, img)).astype(np.float32)
    jseg, jdet = j_adapted_forward(visual, jad, jcfg, jnp.asarray(x),
                                   levels=jacfg.levels, policy=jpol)
    tseg, tdet = adapted_forward(vit, tad, tcfg, torch.from_numpy(x),
                                 levels=tacfg.levels, policy=tpol)
    return jseg, jdet, tseg, tdet


def test_adapted_forward_tiny_fp32():
    jseg, jdet, tseg, tdet = forward_pair(
        jget_config("tiny-test"), get_config("tiny-test"), TINY_LEVELS,
        "fp32", 70)
    assert len(tseg) == 2 and tseg[0].shape == (2, 25, 32)
    for j, t in zip(jseg, tseg):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tdet.detach().numpy(), np.asarray(jdet),
                               atol=ATOL, rtol=RTOL)


def test_adapted_forward_vit_l_widths():
    """ViT-L geometry (D 1024, 16 heads x 64, adapters, seg/det 768) cut
    to 2 layers at 56 px, fp32."""
    def cut(cfg):
        cfg = cfg.with_image_size(56)
        return dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, layers=2))

    levels = dict(levels=(1, 2), image_adapt_until=2)
    jseg, jdet, tseg, tdet = forward_pair(
        cut(jget_config("ViT-L-14-336")), cut(get_config("ViT-L-14-336")),
        levels, "fp32", 56)
    assert tseg[1].shape == (2, 16, 768) and tdet.shape == (2, 768)
    for j, t in zip(jseg, tseg):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tdet.detach().numpy(), np.asarray(jdet),
                               atol=ATOL, rtol=RTOL)


def predict_pair(policy, uint8, per_sample, batch=4, seed=0):
    jcfg, tcfg = jget_config("tiny-test"), get_config("tiny-test")
    visual, jad, vit, tad, jacfg, tacfg = both_models(jcfg, tcfg,
                                                      TINY_LEVELS, seed)
    jpol, tpol = {"fp32": (JPolicy.fp32(), DtypePolicy.fp32()),
                  "bf16": (JPolicy.bf16(), DtypePolicy.bf16())}[policy]
    rng = np.random.default_rng(seed + 3)
    if uint8:
        x = rng.integers(0, 256, (batch, 3, 70, 70), dtype=np.uint8)
    else:
        x = rng.standard_normal((batch, 3, 70, 70)).astype(np.float32)
    shape = (batch, 32, 2) if per_sample else (32, 2)
    anchors = rng.standard_normal(shape).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=-2, keepdims=True)
    M = fused_postproc_matrix(5, 70, "Industrial")
    jp = j_make_predict_fn({"visual": visual}, jcfg, jacfg, policy=jpol,
                           uint8_inputs=uint8)
    jpix, jscore = jp(jad, jnp.asarray(x), jnp.asarray(anchors),
                      jnp.asarray(M))
    tp = make_predict_fn(vit, tcfg, tacfg, policy=tpol, uint8_inputs=uint8,
                         device="cpu")
    tpix, tscore = tp(tad, torch.from_numpy(x), torch.from_numpy(anchors),
                      torch.from_numpy(M))
    assert tpix.shape == (batch, 70, 70) and tscore.shape == (batch,)
    assert tpix.dtype == tscore.dtype == torch.float32
    return np.asarray(jpix), np.asarray(jscore), tpix.numpy(), tscore.numpy()


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["shared", "per_sample"])
def test_predict_tiny_fp32(uint8, per_sample):
    jpix, jscore, tpix, tscore = predict_pair("fp32", uint8, per_sample)
    np.testing.assert_allclose(tpix, jpix, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tscore, jscore, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["shared", "per_sample"])
def test_predict_tiny_bf16(uint8, per_sample):
    jpix, jscore, tpix, tscore = predict_pair("bf16", uint8, per_sample)
    corr = np.corrcoef(tpix.ravel(), jpix.ravel())[0, 1]
    assert corr > 0.999, corr
    np.testing.assert_allclose(tscore, jscore, atol=5e-3)


def test_predict_rejects_what_is_not_ported():
    cfg = get_config("tiny-test")
    acfg = AdapterConfig(**TINY_LEVELS)
    from aaclip_tpu_torch.core.params import init_vision_params

    vit = init_vision_params(cfg, device="cpu")
    # meshes are ported (tests/test_torch_parallel_*.py); sequence
    # parallelism without a model axis is refused, as in JAX
    with pytest.raises(ValueError, match="sequence_parallel requires"):
        make_predict_fn(vit, cfg, acfg, device="cpu", sequence_parallel=True)
    int8 = DtypePolicy.from_name("int8")  # ported: the bf16 path, int8
    assert int8.quant_int8 and int8.compute_dtype == torch.bfloat16
    assert int8.int8_until == 0 and int8.fast_act
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_predict_fn(vit, cfg, acfg)


@pytest.mark.parametrize("name", ["ViT-L-14-336", "tiny-test", "ViT-L-14",
                                  "ViT-B-16", "ViT-B-16-quickgelu",
                                  "ViT-B-32"])
def test_configs_are_a_faithful_copy(name):
    """The port's own registry gives the JAX package's image-side config
    for every model, built in or read from its copy of the JSON files."""
    j, t = jget_config(name), get_config(name)
    for field in ("image_size", "patch_size", "width", "layers", "heads",
                  "mlp_ratio", "grid", "seq_len", "head_dim"):
        assert getattr(t.vision, field) == getattr(j.vision, field), field
    assert (t.embed_dim, t.quick_gelu) == (j.embed_dim, j.quick_gelu)
    assert get_config(name, 4 * t.vision.patch_size).vision.seq_len == 17


def test_cast_matmul_weights_copies_and_follows_the_jax_cast():
    from aaclip_tpu_torch.core.params import (cast_matmul_weights,
                                              init_vision_params)

    vit = init_vision_params(get_config("tiny-test"), device="cpu")
    assert cast_matmul_weights(vit, DtypePolicy.fp32()) is vit
    cast = cast_matmul_weights(vit, DtypePolicy.bf16())
    assert cast is not vit
    assert all(p.dtype == torch.float32 for p in vit.parameters())
    dtypes = {n: p.dtype for n, p in cast.named_parameters()}
    # every block leaf (stacked, hence >= 2-D, in the JAX tree) is cast
    assert dtypes["blocks.0.ln_1.weight"] == torch.bfloat16
    assert dtypes["blocks.1.attn.in_proj_bias"] == torch.bfloat16
    assert dtypes["conv1.weight"] == torch.bfloat16
    assert dtypes["positional_embedding"] == torch.bfloat16
    assert dtypes["ln_pre.weight"] == torch.float32
    assert dtypes["class_embedding"] == torch.float32
