"""The port's checkpoint loaders against the JAX package's, on the CPU.

* OpenAI-layout CLIP checkpoints (``core/params.py``): a tiny-test tower
  written at a 4x4 grid as a TorchScript archive, an fp16 TorchScript
  archive, a raw state dict and a ``{"state_dict": ...}`` dict, loaded by
  both packages at 70 px (the positional embedding resized to 5x5). The
  port's towers equal, bit for bit, the towers built from JAX's converted
  tree (the same numpy conversion and resize), and ``encode_image``, the
  fp32 predict and ``encode_text`` agree with JAX's at fp32 atol 1e-4
  (rtol 1e-5: the same fp32 math in another summation order).
* ``resize_pos_embed`` at ViT-L's real [577, 1024] -> [1370, 1024]: within
  1e-6 of JAX's (the same float64 numpy products).
* Discovery: ``checkpoint_matches_config``, an ``AACLIP_CKPT`` of another
  architecture falls back to the seeded init, an explicit one fails.
* Adapter checkpoints (``train/checkpoint.py``): npz and reference
  ``.pth`` files written by either package load in the other bit for bit,
  and a shape mismatch raises JAX's message.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.core import params as jparams
from aaclip_tpu.core.config import AdapterConfig as JAdapterConfig
from aaclip_tpu.core.config import DtypePolicy as JPolicy
from aaclip_tpu.core.config import get_config as jget_config
from aaclip_tpu.eval.predict import make_predict_fn as j_make_predict_fn
from aaclip_tpu.models.text_model import encode_text as j_encode_text
from aaclip_tpu.models.vit import encode_image as j_encode_image
from aaclip_tpu.ops.similarity import fused_postproc_matrix
from aaclip_tpu.train import checkpoint as jckpt
from aaclip_tpu_torch.core import params
from aaclip_tpu_torch.core.config import AdapterConfig, DtypePolicy, get_config
from aaclip_tpu_torch.eval.predict import make_predict_fn
from aaclip_tpu_torch.models.text_model import encode_text
from aaclip_tpu_torch.models.vit import encode_image
from aaclip_tpu_torch.train import checkpoint as ckpt
from tests.test_checkpoint_loader import _build_jit_archive
from tests.test_model_parity import _make_state_dict

ATOL, RTOL = 1e-4, 1e-5
JCFG = jget_config("tiny-test")
CFG = get_config("tiny-test")
ACFG = AdapterConfig(levels=(1, 2), image_adapt_until=1, text_adapt_until=1)
JACFG = JAdapterConfig(levels=(1, 2), image_adapt_until=1, text_adapt_until=1)


@pytest.fixture(scope="module")
def sd():
    # written at 56 px (4x4 grid); both loaders resize to 70 px's 5x5
    return _make_state_dict(jget_config("tiny-test", 56), seed=11)


def _write(sd, path, fmt):
    if fmt == "jit":
        _build_jit_archive(sd, path)
    elif fmt == "jit_fp16":
        _build_jit_archive(sd, path, half=True)
    elif fmt == "raw":
        torch.save(sd, path)
    else:
        torch.save({"state_dict": sd, "epoch": 3}, path)


@pytest.fixture(scope="module", params=["jit", "jit_fp16", "raw",
                                        "wrapped"])
def loaded(request, sd, tmp_path_factory):
    """(format, the port's towers, JAX's tree) of one archive format."""
    path = str(tmp_path_factory.mktemp("clip") / f"{request.param}.pt")
    _write(sd, path, request.param)
    vit, text = params.load_openai_checkpoint(path, CFG, device="cpu")
    return request.param, vit, text, jparams.load_openai_checkpoint(path,
                                                                    JCFG)


def test_towers_equal_the_jax_conversion(loaded):
    fmt, vit, text, tree = loaded
    want_vit = params.params_from_jax(tree, CFG, device="cpu")
    want_text = params.text_params_from_jax(tree, CFG, device="cpu")
    for got, want in ((vit, want_vit), (text, want_text)):
        got_sd, want_sd = got.state_dict(), want.state_dict()
        assert list(got_sd) == list(want_sd)
        for k in got_sd:
            assert got_sd[k].dtype == torch.float32, k
            torch.testing.assert_close(got_sd[k], want_sd[k], atol=0, rtol=0)
    assert vit.positional_embedding.shape == (26, 64)
    assert not any(p.requires_grad for p in vit.parameters())
    if fmt == "jit_fp16":  # loaded as fp32, holding the fp16 values
        assert vit.conv1.weight.half().float().equal(vit.conv1.weight)


def test_loaded_towers_compute_as_jax(loaded):
    _, vit, text, tree = loaded
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 70, 70)).astype(np.float32)
    jpooled, jtaps = j_encode_image(tree["visual"], JCFG, jnp.asarray(x),
                                    out_layers=[1, 2])
    pooled, taps = encode_image(vit, CFG, torch.from_numpy(x), [1, 2])
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled),
                               atol=ATOL, rtol=RTOL)
    for got, want in zip(taps, jtaps):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)

    jad = jax.tree.map(np.asarray, jparams.init_adapter_params(
        jax.random.PRNGKey(2), JCFG, JACFG)["image"])
    ad = params.adapter_from_jax(jad, CFG, ACFG, device="cpu")
    anchors = rng.standard_normal((32, 2)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=0, keepdims=True)
    M = fused_postproc_matrix(5, 70, "Industrial")
    jpix, jscore = j_make_predict_fn(tree, JCFG, JACFG,
                                     policy=JPolicy.fp32())(
        jad, jnp.asarray(x), jnp.asarray(anchors), jnp.asarray(M))
    pix, score = make_predict_fn(vit, CFG, ACFG, policy=DtypePolicy.fp32(),
                                 device="cpu")(
        ad, torch.from_numpy(x), torch.from_numpy(anchors),
        torch.from_numpy(M))
    np.testing.assert_allclose(pix.numpy(), np.asarray(jpix), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), atol=ATOL,
                               rtol=RTOL)

    tokens = rng.integers(1, 49000, (3, 77)).astype(np.int32)
    tokens[:, 9] = 49407  # the EOT id, the largest in each sequence
    tokens[:, 10:] = 0
    want = j_encode_text(tree["text"], JCFG, jnp.asarray(tokens))
    got = encode_text(text, CFG, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_resize_pos_embed_vit_l_grid():
    pos = np.random.default_rng(0).standard_normal((577, 1024)).astype(
        np.float32) * 0.02
    got = params.resize_pos_embed(pos, 37)
    want = jparams.resize_pos_embed(pos, 37)
    assert got.shape == (1370, 1024) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[0], pos[0])
    assert params.resize_pos_embed(pos, 24) is pos
    with pytest.raises(ValueError, match="non-square"):
        params.resize_pos_embed(pos[:-1], 37)


def test_discovery_falls_back_on_an_architecture_mismatch(sd, tmp_path,
                                                          monkeypatch):
    other = dataclasses.replace(
        CFG, vision=dataclasses.replace(CFG.vision, width=32, layers=1))
    assert params.checkpoint_matches_config(sd, CFG)
    assert not params.checkpoint_matches_config(sd, other)
    assert not params.checkpoint_matches_config({}, CFG)
    path = str(tmp_path / "weights.pt")
    torch.save(sd, path)
    monkeypatch.setenv("AACLIP_CKPT", path)
    assert params.find_default_checkpoint() == path
    assert params.resolve_clip_checkpoint(other) is None
    assert params.resolve_clip_checkpoint(CFG) == path
    # a mismatched config: the seeded init, as init_vision_params gives it
    vit, _ = params.create_clip_towers(other, seed=4, device="cpu")
    assert vit.conv1.weight.shape == (32, 3 * 14 * 14)
    torch.testing.assert_close(
        vit.conv1.weight,
        params.init_vision_params(other, seed=4, device="cpu").conv1.weight)
    # a matching config: the discovered checkpoint is loaded
    vit, _ = params.create_clip_towers(CFG, seed=4, device="cpu")
    torch.testing.assert_close(vit.class_embedding,
                               sd["visual.class_embedding"])
    # explicit checkpoints load or fail
    with pytest.raises(ValueError, match="does not match"):
        params.create_clip_towers(other, checkpoint=path, device="cpu")
    monkeypatch.delenv("AACLIP_CKPT")
    with pytest.raises(FileNotFoundError, match="AACLIP_CKPT"):
        params.create_clip_towers(other, require_pretrained=True,
                                  device="cpu")


# ---- adapter checkpoints ----------------------------------------------


def _jax_adapters(seed):
    tree = jparams.init_adapter_params(jax.random.PRNGKey(seed), JCFG, JACFG)
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(got, want):
    gl, gs = jax.tree.flatten(got)
    wl, ws = jax.tree.flatten(want)
    assert gs == ws
    for g, w in zip(gl, wl):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("kind", ["image", "text"])
def test_npz_written_by_jax_loads_in_the_port(kind, tmp_path):
    tree = _jax_adapters(3)[kind]
    path = str(tmp_path / "a.npz")
    jckpt.save_adapter_checkpoint(path, 7, tree, opt_state={"m": tree},
                                  step=12)
    template = jax.tree.map(np.zeros_like, tree)
    epoch, got, step = ckpt.load_adapter_checkpoint(path, template)
    assert (epoch, step) == (7, 12)
    _assert_trees_equal(got, tree)
    # and through the port's modules
    to_module = {"image": params.adapter_from_jax,
                 "text": params.text_adapter_from_jax}[kind]
    to_tree = {"image": params.adapter_to_jax,
               "text": params.text_adapter_to_jax}[kind]
    _assert_trees_equal(to_tree(to_module(got, CFG, ACFG, device="cpu")),
                        tree)


@pytest.mark.parametrize("kind", ["image", "text"])
def test_npz_written_by_the_port_loads_in_jax(kind, tmp_path):
    init = {"image": params.init_image_adapter,
            "text": params.init_text_adapter}[kind]
    to_tree = {"image": params.adapter_to_jax,
               "text": params.text_adapter_to_jax}[kind]
    tree = to_tree(init(CFG, ACFG, seed=5, device="cpu"))
    path = str(tmp_path / "a.npz")
    ckpt.save_adapter_checkpoint(path, 2, tree, step=9)
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]
    with np.load(path) as data:
        assert sorted(data.files) == sorted(
            ["__epoch__", "__step__"]
            + ["adapter/" + k for k in ckpt._flatten(tree)])
    template = _jax_adapters(0)[kind]
    epoch, got, opt, step = jckpt.load_adapter_checkpoint(path, template)
    assert (epoch, step, opt) == (2, 9, None)
    _assert_trees_equal(jax.tree.map(np.asarray, got), tree)


def test_npz_keys_are_jax_s_pytree_paths(tmp_path):
    tree = _jax_adapters(1)["image"]
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jckpt.save_adapter_checkpoint(jpath, 1, tree)
    ckpt.save_adapter_checkpoint(ppath, 1, tree)
    with np.load(jpath) as j, np.load(ppath) as p:
        assert j.files == p.files
        for k in j.files:
            np.testing.assert_array_equal(j[k], p[k])
            assert j[k].dtype == p[k].dtype


def test_shape_mismatch_raises_jax_s_message(tmp_path):
    tree = _jax_adapters(1)["image"]
    path = str(tmp_path / "a.npz")
    ckpt.save_adapter_checkpoint(path, 1, tree)
    other = JAdapterConfig(levels=(1, 2), image_adapt_until=2,
                           text_adapt_until=1)
    template = jax.tree.map(np.asarray, jparams.init_adapter_params(
        jax.random.PRNGKey(0), JCFG, other)["image"])
    with pytest.raises(ValueError) as port_err:
        ckpt.load_adapter_checkpoint(path, template)
    with pytest.raises(ValueError) as jax_err:
        jckpt.load_adapter_checkpoint(path, template)
    assert str(port_err.value) == str(jax_err.value)
    assert "adapter flags" in str(port_err.value)
    missing = dict(tree, seg_proj=tree["seg_proj"] + [tree["seg_proj"][0]])
    with pytest.raises(KeyError, match="seg_proj/2/w"):
        ckpt.load_adapter_checkpoint(path, missing)


@pytest.mark.parametrize("proj_relu", [False, True])
def test_reference_pth_round_trips_both_ways(proj_relu, tmp_path):
    adapters = _jax_adapters(6)
    # written by the port, read by JAX
    text_sd, image_sd = ckpt.adapters_to_torch_state_dicts(adapters,
                                                           proj_relu)
    jtext_sd, jimage_sd = jckpt.adapters_to_torch_state_dicts(adapters,
                                                              proj_relu)
    for got, want in ((text_sd, jtext_sd), (image_sd, jimage_sd)):
        assert list(got) == list(want)
        for k in got:
            assert got[k].equal(want[k]), k
    path = str(tmp_path / "ref.pth")
    torch.save({"epoch": 4, "text_adapter": text_sd,
                "image_adapter": image_sd}, path)
    for loader in (ckpt.load_reference_checkpoint,
                   jckpt.load_reference_checkpoint):
        epoch, text = loader(path, "text", n_adapt=1)
        assert epoch == 4
        _assert_trees_equal(text, adapters["text"])
        epoch, image = loader(path, "image", n_adapt=1, n_levels=2)
        _assert_trees_equal(image, adapters["image"])
    with pytest.raises(ValueError, match="kind"):
        ckpt.load_reference_checkpoint(path, "other", n_adapt=1)
    # written by JAX's exporter, read by the port
    torch.save({"epoch": 1, "image_adapter": jimage_sd}, path)
    _, image = ckpt.load_reference_checkpoint(path, "image", n_adapt=1,
                                              n_levels=2)
    _assert_trees_equal(image, adapters["image"])
