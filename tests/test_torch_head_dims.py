"""User model configs at head dims 80 and 128 (``AACLIP_MODEL_CONFIGS``),
the port against the JAX package on the CPU:

* both packages read the same user JSON files (open_clip's ViT-H-14, 16
  heads of 80; a narrow width-160 config in 2 heads of 80; ViT-L in 8
  heads of 128) into the same architecture;
* the fused-block gate: the port's ``maybe_make_block_fn`` gives a block
  on the card exactly where JAX's ``fused_block_supported`` admits the
  geometry (ViT-L, ViT-B, the head-dim-128 ViT-L) and None where it does
  not (tiny-test, ViT-H-14), as JAX's ``maybe_make_block_fn`` does;
* the narrow head-dim-80 config's predict in fp32 (atol 1e-4, rtol 1e-5)
  at 2 blocks and at 32 with the default taps after blocks 6/12/18/24,
  and in bf16 at 2 blocks (pixel-map correlation > 0.999, scores atol
  5e-3: tests/test_torch_model.py's bars), and one stage-2 loss in fp32
  (rtol 1e-5), against JAX's from the same numpy weights through the
  bridge; JAX runs XLA's attention there (its Pallas gate refuses 2 x 80
  columns), the port its kernel wrapper's plain version;
* one fp32 stage-2 step's adapter gradients, leaf by leaf, against JAX's
  (read from an optax transformation that keeps the gradient), at 2
  blocks of NARROW_HD80 (JAX on XLA's attention, as its gate sends hd 80)
  and of NARROW_HD128, 2 heads of 128 (JAX on its Pallas attention and
  backward in interpret mode, as its gate runs hd 128): each leaf within
  1e-5 of its max |gradient| (fp32 through two blocks and back, sums in
  another order; read at 9.1e-7 and 9.0e-7), the losses to rtol 1e-5;
* ViT-H-14's widths (1280 in 16 heads of 80, MLP 5120, seg/det 1280 ->
  1024) cut to 2 blocks at 28 px: the adapted forward in fp32 against
  JAX's, with no code of its own.

The kernels at these head dims run only on the card (``chip_smoke.py``
phase 17).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aaclip_tpu.core import config as jconfig
from aaclip_tpu.core.config import DtypePolicy as JPolicy
from aaclip_tpu.eval.predict import make_predict_fn as j_make_predict_fn
from aaclip_tpu.ops import fused_block as JFB
from aaclip_tpu.ops.similarity import fused_postproc_matrix
from aaclip_tpu.train.steps import init_state
from aaclip_tpu.train.steps import make_stage2_step as j_make_stage2_step
from aaclip_tpu_torch.core import config as tconfig
from aaclip_tpu_torch.core.config import DtypePolicy
from aaclip_tpu_torch.eval.predict import make_predict_fn
from aaclip_tpu_torch.ops import fused_block as FB
from aaclip_tpu_torch.train import optim
from aaclip_tpu_torch.train.steps import make_stage2_step
from chip_smoke import VIT_H_14
from tests.test_torch_attention import NARROW_HD80
from aaclip_tpu.ops.flash_attention import make_attn_fn as j_make_attn_fn
from tests.test_torch_model import ATOL, RTOL, both_models, forward_pair
from tests.test_torch_train import grad_capture, grads_as_jax, strict

# ViT-L-14-336 (the reference's JSON) with its 1024 columns in 8 heads of
# 128, a geometry JAX's gate admits
VIT_L_HW128 = {
    "embed_dim": 768,
    "vision_cfg": {"image_size": 336, "layers": 24, "width": 1024,
                   "head_width": 128, "patch_size": 14},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 768,
                 "heads": 12, "layers": 12},
}
# a narrow tower in 2 heads of 128: JAX's gate runs its Pallas kernels
NARROW_HD128 = {
    "embed_dim": 64,
    "vision_cfg": {"image_size": 70, "layers": 2, "width": 256,
                   "head_width": 128, "patch_size": 14},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 64,
                 "heads": 2, "layers": 2},
}
USER_CONFIGS = {"ViT-H-14": VIT_H_14, "narrow-hd80": NARROW_HD80,
                "ViT-L-14-336-hw128": VIT_L_HW128}
POLICIES = {"fp32": (JPolicy.fp32(), DtypePolicy.fp32()),
            "bf16": (JPolicy.bf16(), DtypePolicy.bf16())}


@pytest.fixture
def user_configs(tmp_path, monkeypatch):
    """USER_CONFIGS as JSON files in a directory that
    ``AACLIP_MODEL_CONFIGS`` names, read into copies of both packages'
    registries (each reads the variable when it is imported)."""
    for name, payload in USER_CONFIGS.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(payload))
    monkeypatch.setenv("AACLIP_MODEL_CONFIGS", str(tmp_path))
    for mod in (jconfig, tconfig):
        monkeypatch.setattr(mod, "MODEL_CONFIGS", dict(mod.MODEL_CONFIGS))
        mod._scan_json_configs()


@pytest.mark.parametrize("name,img,heads,head_dim", [
    ("ViT-H-14", 518, 16, 80), ("narrow-hd80", 70, 2, 80),
    ("ViT-L-14-336-hw128", 518, 8, 128)])
def test_user_configs_read_alike(user_configs, name, img, heads, head_dim):
    j, t = jconfig.get_config(name, img), tconfig.get_config(name, img)
    jv, tv = j.vision, t.vision
    assert (tv.heads, tv.head_dim) == (heads, head_dim)
    assert (jv.heads, jv.width // jv.heads) == (heads, head_dim)
    for field in ("image_size", "patch_size", "width", "layers", "heads",
                  "mlp_ratio", "grid", "seq_len"):
        assert getattr(tv, field) == getattr(jv, field), field
    for field in ("context_length", "vocab_size", "width", "heads",
                  "layers", "mlp_ratio"):
        assert getattr(t.text, field) == getattr(j.text, field), field
    assert t.embed_dim == j.embed_dim and t.quick_gelu == j.quick_gelu
    if name == "ViT-H-14":
        assert (tv.width, tv.layers, tv.seq_len, t.embed_dim,
                int(tv.width * tv.mlp_ratio)) == (1280, 32, 1370, 1024, 5120)


@pytest.mark.parametrize("name", ["ViT-L-14-336", "ViT-B-16", "tiny-test",
                                  "ViT-H-14", "ViT-L-14-336-hw128"])
def test_fused_gate_follows_jax(user_configs, monkeypatch, name):
    """On the card (``resolve_device`` made to answer it) the port's gate
    gives a block under bf16 exactly where JAX's ``fused_block_supported``
    admits the geometry, None where it does not (no raise: ViT-H-14's
    head dim 80), and None under fp32; off the card None."""
    jcfg, tcfg = jconfig.get_config(name), tconfig.get_config(name)
    admitted = JFB.fused_block_supported(jcfg)
    assert admitted == (name not in ("tiny-test", "ViT-H-14"))
    assert FB.reference_gate(tcfg) == admitted
    assert FB.fused_block_supported(tcfg, DtypePolicy.bf16()) == admitted
    bf16, fp32 = DtypePolicy.bf16(), DtypePolicy.fp32()
    assert FB.maybe_make_block_fn(tcfg, bf16, device="cpu") is None
    monkeypatch.setattr(FB, "resolve_device",
                        lambda device: torch.device("cuda"))
    block = FB.maybe_make_block_fn(tcfg, bf16)
    assert (block is not None) == admitted
    assert block is None or callable(block)
    assert FB.maybe_make_block_fn(tcfg, fp32) is None


def narrow_pair(layers: int, narrow=NARROW_HD80):
    """(JAX config, port config) of ``narrow`` at ``layers`` blocks."""
    payload = json.loads(json.dumps(narrow))
    payload["vision_cfg"]["layers"] = layers
    return jconfig.config_from_json(payload), tconfig.config_from_json(payload)


def narrow_predict(policy: str, layers: int, levels: dict, batch: int = 3):
    """The predict of NARROW_HD80 at ``layers`` blocks in both packages
    from the same numpy weights, images (uint8 under bf16) and anchors."""
    jcfg, tcfg = narrow_pair(layers)
    visual, jad, vit, tad, jacfg, tacfg = both_models(jcfg, tcfg, levels)
    jpol, tpol = POLICIES[policy]
    rng = np.random.default_rng(7)
    u8 = policy == "bf16"
    if u8:
        x = rng.integers(0, 256, (batch, 3, 70, 70), dtype=np.uint8)
    else:
        x = rng.standard_normal((batch, 3, 70, 70)).astype(np.float32)
    anchors = rng.standard_normal((64, 2)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=0, keepdims=True)
    M = fused_postproc_matrix(5, 70, "Industrial")
    jp = j_make_predict_fn({"visual": visual}, jcfg, jacfg, policy=jpol,
                           uint8_inputs=u8)
    jpix, jscore = jp(jad, jnp.asarray(x), jnp.asarray(anchors),
                      jnp.asarray(M))
    tp = make_predict_fn(vit, tcfg, tacfg, policy=tpol, uint8_inputs=u8,
                         device="cpu")
    tpix, tscore = tp(tad, torch.from_numpy(x), torch.from_numpy(anchors),
                      torch.from_numpy(M))
    assert tpix.shape == (batch, 70, 70) and tscore.shape == (batch,)
    return np.asarray(jpix), np.asarray(jscore), tpix.numpy(), tscore.numpy()


@pytest.mark.parametrize("policy,layers,levels", [
    ("fp32", 2, dict(levels=(1, 2), image_adapt_until=1)),
    ("bf16", 2, dict(levels=(1, 2), image_adapt_until=1)),
    ("fp32", 32, dict(levels=(6, 12, 18, 24), image_adapt_until=6))],
    ids=["fp32-2-blocks", "bf16-2-blocks", "fp32-32-blocks-default-taps"])
def test_narrow_head_dim_80_predict_matches_jax(policy, layers, levels):
    """The bf16 bar is tests/test_torch_model.py's, read there on a 2-block
    tower; the 32-block tower, which checks the default taps, runs in
    fp32."""
    jpix, jscore, tpix, tscore = narrow_predict(policy, layers, levels)
    if policy == "fp32":
        np.testing.assert_allclose(tpix, jpix, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tscore, jscore, atol=ATOL, rtol=RTOL)
    else:
        corr = np.corrcoef(tpix.ravel(), jpix.ravel())[0, 1]
        assert corr > 0.999, corr
        np.testing.assert_allclose(tscore, jscore, atol=5e-3)


def test_narrow_head_dim_80_stage2_loss_matches_jax():
    """One fp32 stage-2 step of NARROW_HD80 (2 blocks) from the same
    adapter, table and batch: the loss within rtol 1e-5 of JAX's (the
    port's backward at head dim 80 is the plain version on the CPU)."""
    levels = dict(levels=(1, 2), image_adapt_until=1)
    jcfg, tcfg = narrow_pair(2)
    visual, jad, vit, tad, jacfg, tacfg = both_models(jcfg, tcfg, levels)
    jpol, tpol = POLICIES["fp32"]
    rng = np.random.default_rng(8)
    B = 3
    table = rng.standard_normal((2, 64, 2)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    batch = (rng.standard_normal((B, 3, 70, 70)).astype(np.float32),
             (rng.random((B, 70, 70)) > 0.8).astype(np.float32),
             rng.integers(0, 2, B).astype(np.int32),
             rng.integers(0, 2, B).astype(np.int32),
             np.ones(B, np.float32))
    jstep = j_make_stage2_step({"visual": visual}, jcfg, jacfg,
                               optax.adam(1e-3), table, policy=jpol)
    state = init_state(jad, optax.adam(1e-3))
    _, jloss = strict(jstep.raw, state, jstep.visual,
                      *(jnp.asarray(x) for x in batch))
    opt = optim.make_image_optimizer(tad.parameters())
    step = make_stage2_step(vit, tcfg, tacfg, opt, table, policy=tpol,
                            device="cpu")
    loss = step(tad, *(torch.from_numpy(x) for x in batch))
    assert np.isfinite(float(jloss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("head_dim", [80, 128])
def test_narrow_stage2_gradients_match_jax(head_dim):
    """One fp32 stage-2 step at 2 blocks from the same adapter, table and
    batch: the port's adapter gradients (the plain backward at this head
    dim) against JAX's, leaf by leaf, within 1e-5 of each leaf's max; JAX
    takes the attention its gate gives the geometry (XLA's at 80, the
    Pallas custom VJP in interpret mode at 128)."""
    narrow = {80: NARROW_HD80, 128: NARROW_HD128}[head_dim]
    levels = dict(levels=(1, 2), image_adapt_until=1)
    jcfg, tcfg = narrow_pair(2, narrow)
    assert tcfg.vision.head_dim == head_dim and tcfg.vision.heads == 2
    visual, jad, vit, tad, jacfg, tacfg = both_models(jcfg, tcfg, levels)
    jpol, tpol = POLICIES["fp32"]
    rng = np.random.default_rng(9)
    B = 3
    table = rng.standard_normal((2, 64, 2)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    batch = (rng.standard_normal((B, 3, 70, 70)).astype(np.float32),
             (rng.random((B, 70, 70)) > 0.8).astype(np.float32),
             rng.integers(0, 2, B).astype(np.int32),
             rng.integers(0, 2, B).astype(np.int32),
             np.ones(B, np.float32))
    attn_fn = (j_make_attn_fn(2, jpol, differentiable=True, interpret=True)
               if head_dim == 128 else None)
    jstep = j_make_stage2_step({"visual": visual}, jcfg, jacfg,
                               grad_capture(), table, policy=jpol,
                               attn_fn=attn_fn)
    state, jloss = strict(jstep.raw, init_state(jad, grad_capture()),
                          jstep.visual, *(jnp.asarray(x) for x in batch))
    opt = optim.make_image_optimizer(tad.parameters())
    step = make_stage2_step(vit, tcfg, tacfg, opt, table, policy=tpol,
                            device="cpu")
    loss = step(tad, *(torch.from_numpy(x) for x in batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = jax.tree.leaves(grads_as_jax(tad))
    want = [np.asarray(w) for w in jax.tree.leaves(state.opt_state)]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_vit_h_14_widths_adapted_forward_matches_jax(user_configs):
    """ViT-H-14's widths (1280 in 16 heads of 80, MLP 5120, adapters and
    seg/det projections 1280 -> 1024) cut to 2 blocks at 28 px, fp32:
    the taps and projections need no code of their own."""
    def cut(cfg):
        cfg = cfg.with_image_size(28)
        return dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, layers=2))

    levels = dict(levels=(1, 2), image_adapt_until=2)
    jseg, jdet, tseg, tdet = forward_pair(
        cut(jconfig.get_config("ViT-H-14")),
        cut(tconfig.get_config("ViT-H-14")), levels, "fp32", 28)
    assert tseg[1].shape == (2, 4, 1024) and tdet.shape == (2, 1024)
    for j, t in zip(jseg, tseg):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tdet.detach().numpy(), np.asarray(jdet),
                               atol=ATOL, rtol=RTOL)

