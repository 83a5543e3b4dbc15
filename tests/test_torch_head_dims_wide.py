"""User model configs at head dims 88 and 104 (open_clip's ViT-g-14, 16
heads of 88, and ViT-bigG-14, 16 heads of 104, under
``AACLIP_MODEL_CONFIGS``), the port against the JAX package on the CPU:

* both packages read the two published JSON files into the same
  architecture (layers, width, heads, head dim, MLP width 6144 / 8192,
  ``seq_len`` 1370 at 518 px, embed, text tower);
* the fused-block gate: JAX's ``fused_block_supported`` refuses both (2 x
  88 and 2 x 104 columns are no multiple of 128) and the port's
  ``maybe_make_block_fn`` gives None on the card, as JAX's does;
* the packed attention at hd 88 and 104 in its three layouts (B1 packed,
  B3 V-V, B4 on [B, H, S, hd]) with a ragged ``valid_len``: the wrappers'
  plain versions against the JAX package's Pallas kernels in interpret
  mode, fp32 (precision "highest") to atol 1e-5, rtol 1e-5 and bf16 B1 and
  B4 to atol 1e-3, rtol 2^-8 (``tests/test_torch_attention.py``'s bars).
  B3 in bf16 is held to one bf16 ulp of its output, atol 1e-3 and rtol
  2^-7 (``tests/test_torch_stage1.py``'s bar for the V-V hook): each row's
  own key dominates its V-V softmax, so an output is about v itself, up to
  ~4 in size, and a rounding that the two sums' orders break apart is an
  ulp of up to 2^-7 of the value (read: 2 of 62400 elements one ulp apart
  at values just above 1, 7.1e-3 relative);
* narrow towers of 2 heads of 88 (width 176) and 2 of 104 (width 208) at
  2 blocks, weights from the same numpy arrays through the bridge: the
  predict in fp32 (atol 1e-4, rtol 1e-5), fp32_high unstaged (the map
  within 5e-5 of its span, scores 5e-6: ``test_torch_fp32_high.py``'s
  bars; JAX's side on its interpret-mode 3-pass attention, the only true
  3-pass reference on the CPU) and bf16 (map correlation > 0.999, scores
  atol 5e-3: ``test_torch_model.py``'s bars), JAX on XLA's attention in
  fp32 and bf16, where its gate sends these geometries; the stage-1
  spatial features in fp32 (atol 1e-5, rtol 1e-5:
  ``test_torch_stage1.py``'s bar);
* ViT-g-14's and ViT-bigG-14's published widths (1408 and 1664 in 16
  heads of 88 and 104, MLP 6144 and 8192, seg/det to 1024 and 1280) cut
  to 2 vision and 2 text blocks at 28 px: the adapted forward in fp32
  against JAX's, with no code of its own;
* stage 2 (the port's backward at 88 and 104 is the plain version on the
  CPU): one fp32 step of the narrow towers at 2 blocks, the loss (rtol
  1e-5) and every adapter gradient (within 1e-5 of each leaf's max)
  against JAX's step on XLA's attention, where its gate sends these head
  dims (``tests/test_torch_head_dims.py``'s bars at 80); one bf16 step's
  loss within 5e-4 relative and each adapter gradient's cosine above
  0.9999 against JAX's step on its Pallas attention and backward in
  interpret mode, compiled with XLA's excess precision off (``strict``):
  the kernel path's roundings on both sides (``tests/test_torch_train.py``'s
  bf16 bars); and one fp32 step at the published widths cut to 2 blocks at
  28 px, at the fp32 bars;
* ``kernel_route`` at 88 and 104 on every route (the TMA + wgmma kernels
  and their plane routes), and the wrappers' CUDA checks: the forward's
  geometry check and the backward's argument checks admit both head dims,
  and the backward hands the launch to its route's entry point.

The kernels at these head dims run only on the card (``chip_smoke.py``
phase 18).
"""

import contextlib
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.core import config as jconfig
from aaclip_tpu.core.config import DtypePolicy as JPolicy
from aaclip_tpu.eval.predict import make_predict_fn as j_make_predict_fn
from aaclip_tpu.ops import fused_block as JFB
from aaclip_tpu.ops.flash_attention import attention_kernel as \
    j_attention_kernel
from aaclip_tpu.ops.flash_attention import attention_packed as j_attention
from aaclip_tpu.ops.flash_attention import make_attn_fn as j_make_attn_fn
from aaclip_tpu.ops.similarity import fused_postproc_matrix
from aaclip_tpu.train.steps import init_state
from aaclip_tpu.train.steps import make_stage2_step as j_make_stage2_step
from aaclip_tpu.train.steps import stage1_features_fn as j_features_fn
from aaclip_tpu_torch.core import config as tconfig
from aaclip_tpu_torch.core.config import DtypePolicy
from aaclip_tpu_torch.core.params import params_from_jax
from aaclip_tpu_torch.eval.predict import make_predict_fn
from aaclip_tpu_torch.ops import attention as A
from aaclip_tpu_torch.ops import fused_block as FB
from aaclip_tpu_torch.train import optim
from aaclip_tpu_torch.train.steps import make_stage2_step, stage1_features_fn
from chip_smoke import VIT_BIGG_14, VIT_G_14, WIDE_ARCH
from tests.test_torch_layers import perturbed_clip_tree
from tests.test_torch_model import ATOL, RTOL, both_models, forward_pair
from tests.test_torch_train import grad_capture, grads_as_jax, strict

WIDE = {"ViT-g-14": VIT_G_14, "ViT-bigG-14": VIT_BIGG_14}
HEAD_DIMS = (88, 104)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
POLICIES = {"fp32": (JPolicy.fp32(), DtypePolicy.fp32()),
            "fp32_high": (dataclasses.replace(JPolicy.fp32_high(),
                                              bf16_until=0),
                          dataclasses.replace(DtypePolicy.fp32_high(),
                                              bf16_until=0)),
            "bf16": (JPolicy.bf16(), DtypePolicy.bf16())}


def narrow(hd: int) -> dict:
    """A user config in open_clip's schema at head width ``hd``: 2 vision
    blocks of 2 heads, 70 px in patches of 14 (S 26), a 2-block text
    tower."""
    return {"embed_dim": 64,
            "vision_cfg": {"image_size": 70, "layers": 2, "width": 2 * hd,
                           "head_width": hd, "patch_size": 14},
            "text_cfg": {"context_length": 77, "vocab_size": 49408,
                         "width": 64, "heads": 2, "layers": 2}}


@pytest.fixture
def wide_configs(tmp_path, monkeypatch):
    """The two published configs as JSON files in a directory that
    ``AACLIP_MODEL_CONFIGS`` names, read into copies of both packages'
    registries."""
    for name, payload in WIDE.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(payload))
    monkeypatch.setenv("AACLIP_MODEL_CONFIGS", str(tmp_path))
    for mod in (jconfig, tconfig):
        monkeypatch.setattr(mod, "MODEL_CONFIGS", dict(mod.MODEL_CONFIGS))
        mod._scan_json_configs()


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_configs_read_alike(wide_configs, name):
    j, t = jconfig.get_config(name, 518), tconfig.get_config(name, 518)
    jv, tv = j.vision, t.vision
    assert (tv.layers, tv.width, tv.heads, tv.head_dim,
            int(tv.width * tv.mlp_ratio), tv.seq_len,
            t.embed_dim) == WIDE_ARCH[name]
    assert (jv.heads, jv.width // jv.heads) == (tv.heads, tv.head_dim)
    for field in ("image_size", "patch_size", "width", "layers", "heads",
                  "mlp_ratio", "grid", "seq_len"):
        assert getattr(tv, field) == getattr(jv, field), field
    for field in ("context_length", "vocab_size", "width", "heads",
                  "layers", "mlp_ratio"):
        assert getattr(t.text, field) == getattr(j.text, field), field
    assert t.embed_dim == j.embed_dim and t.quick_gelu == j.quick_gelu
    assert int(jv.width * jv.mlp_ratio) == WIDE_ARCH[name][4]
    payload = WIDE[name]["text_cfg"]
    assert (t.text.width, t.text.heads, t.text.layers) == (
        payload["width"], payload["heads"], payload["layers"])


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_fused_gate_is_none(wide_configs, monkeypatch, name):
    """JAX's gate refuses 2 x 88 and 2 x 104 columns; the port's gives
    None off the card and, with ``resolve_device`` made to answer the
    card, None again (no raise: the widths 1408 and 1664 also exceed the
    GEMMs' ``KERNEL_MAX_K``)."""
    jcfg, tcfg = jconfig.get_config(name), tconfig.get_config(name)
    assert not JFB.fused_block_supported(jcfg)
    assert not FB.reference_gate(tcfg)
    bf16, fp32 = DtypePolicy.bf16(), DtypePolicy.fp32()
    assert FB.maybe_make_block_fn(tcfg, bf16, device="cpu") is None
    monkeypatch.setattr(FB, "resolve_device",
                        lambda device: torch.device("cuda"))
    assert FB.maybe_make_block_fn(tcfg, bf16) is None
    assert FB.maybe_make_block_fn(tcfg, fp32) is None


def _close(got: torch.Tensor, want, dtype: str, vv: bool) -> None:
    want = np.asarray(want, np.float32)
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-3,
                                   rtol=2 ** -7 if vv else 2 ** -8)


@pytest.mark.parametrize("layout", ["packed", "vv", "bhsd"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_plain_matches_pallas_interpret_at_wide_head_dims(hd, dtype,
                                                          layout):
    """B1 with keys from 123 of 150 masked, B3 over all 150, B4 with keys
    from 50 of 70 masked (every row a query)."""
    jd, td = DTYPES[dtype]
    prec = "highest" if dtype == "fp32" else None
    rng = np.random.default_rng(hd)
    if layout == "bhsd":
        q, k, v = (rng.standard_normal((2, 3, 70, hd)).astype(np.float32)
                   for _ in range(3))
        want = j_attention_kernel(*(jnp.asarray(x, jd) for x in (q, k, v)),
                                  50, q_blk=32, bh_blk=2, precision=prec,
                                  interpret=True)
        got = A.attention_kernel(*(torch.from_numpy(x).to(td)
                                   for x in (q, k, v)), 50)
        assert got.shape == (2, 3, 70, hd) and got.dtype == td
    elif layout == "vv":
        x = rng.standard_normal((2, 150, 2 * hd)).astype(np.float32)
        want = j_attention(jnp.asarray(x, jd), 2, 150, vv=True,
                           packed_sections=1, q_blk=64, precision=prec,
                           interpret=True)
        got = A.attention_packed_vv(torch.from_numpy(x).to(td), 2, 150)
        assert got.shape == (2, 150, 2 * hd) and got.dtype == td
    else:
        x = rng.standard_normal((2, 150, 6 * hd)).astype(np.float32)
        want = j_attention(jnp.asarray(x, jd), 2, 123, q_blk=64,
                           precision=prec, interpret=True)
        got = A.attention_packed(torch.from_numpy(x).to(td), 2, 123)
        assert got.shape == (2, 150, 2 * hd) and got.dtype == td
    _close(got, want, dtype, layout == "vv")


def _narrow_pair(hd: int):
    payload = narrow(hd)
    return (jconfig.config_from_json(payload),
            tconfig.config_from_json(payload))


@pytest.mark.parametrize("policy", ["fp32", "fp32_high", "bf16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_narrow_wide_predict_matches_jax(hd, policy):
    """2 blocks of 2 heads of ``hd``; JAX on XLA's attention in fp32 and
    bf16 (its gate refuses the geometry), on its interpret-mode Pallas
    attention under fp32_high (the 3-pass reference); the port on its
    wrappers' plain versions."""
    jcfg, tcfg = _narrow_pair(hd)
    assert (tcfg.vision.heads, tcfg.vision.head_dim) == (2, hd)
    levels = dict(levels=(1, 2), image_adapt_until=1)
    visual, jad, vit, tad, jacfg, tacfg = both_models(jcfg, tcfg, levels)
    jpol, tpol = POLICIES[policy]
    rng = np.random.default_rng(7)
    u8 = policy == "bf16"
    if u8:
        x = rng.integers(0, 256, (3, 3, 70, 70), dtype=np.uint8)
    else:
        x = rng.standard_normal((3, 3, 70, 70)).astype(np.float32)
    anchors = rng.standard_normal((64, 2)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=0, keepdims=True)
    M = fused_postproc_matrix(5, 70, "Industrial")
    attn = (j_make_attn_fn(2, jpol, interpret=True)
            if policy == "fp32_high" else None)
    jp = j_make_predict_fn({"visual": visual}, jcfg, jacfg, policy=jpol,
                           uint8_inputs=u8, attn_fn=attn)
    jpix, jscore = (np.asarray(a) for a in jp(
        jad, jnp.asarray(x), jnp.asarray(anchors), jnp.asarray(M)))
    tp = make_predict_fn(vit, tcfg, tacfg, policy=tpol, uint8_inputs=u8,
                         device="cpu")
    tpix, tscore = (a.numpy() for a in tp(
        tad, torch.from_numpy(x), torch.from_numpy(anchors),
        torch.from_numpy(M)))
    assert tpix.shape == (3, 70, 70) and tscore.shape == (3,)
    if policy == "fp32":
        np.testing.assert_allclose(tpix, jpix, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tscore, jscore, atol=ATOL, rtol=RTOL)
    elif policy == "fp32_high":
        assert np.abs(tpix - jpix).max() <= 5e-5 * (jpix.max() - jpix.min())
        np.testing.assert_allclose(tscore, jscore, atol=5e-6, rtol=0)
    else:
        corr = np.corrcoef(tpix.ravel(), jpix.ravel())[0, 1]
        assert corr > 0.999, corr
        np.testing.assert_allclose(tscore, jscore, atol=5e-3)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_narrow_wide_spatial_features_match_jax(hd):
    """Stage 1's spatial V-V features in fp32 at 2 blocks (the V-V tail
    from block 1), the same numpy weights on both sides."""
    jcfg, tcfg = _narrow_pair(hd)
    visual = perturbed_clip_tree(jcfg, seed=3)
    vit = params_from_jax(visual, tcfg, device="cpu")
    x = np.random.default_rng(4).standard_normal(
        (3, 3, 70, 70)).astype(np.float32)
    want = np.asarray(j_features_fn(
        {"visual": visual}, jcfg, surgery_until_layer=2,
        policy=JPolicy.fp32(), vv_mode="spatial")(jnp.asarray(x)))
    got = stage1_features_fn(vit, tcfg, surgery_until_layer=2,
                             policy=DtypePolicy.fp32(), vv_mode="spatial",
                             device="cpu")(torch.from_numpy(x))
    assert got.shape == (3, 25, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def _cut(cfg):
    """A published config cut to 2 vision and 2 text blocks at 28 px (2 x
    2 patches)."""
    cfg = cfg.with_image_size(28)
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, layers=2),
        text=dataclasses.replace(cfg.text, layers=2))


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_widths_adapted_forward_matches_jax(wide_configs, name):
    """The published widths cut to 2 vision and 2 text blocks at 28 px,
    fp32: the taps and projections need no code of their own at 1408 and
    1664."""
    jcfg, tcfg = (_cut(mod.get_config(name)) for mod in (jconfig, tconfig))
    assert (tcfg.vision.head_dim, tcfg.text.layers) == (WIDE_ARCH[name][3],
                                                        2)
    levels = dict(levels=(1, 2), image_adapt_until=2)
    jseg, jdet, tseg, tdet = forward_pair(jcfg, tcfg, levels, "fp32", 28)
    embed = WIDE_ARCH[name][6]
    assert tseg[1].shape == (2, 4, embed) and tdet.shape == (2, embed)
    for j, t in zip(jseg, tseg):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tdet.detach().numpy(), np.asarray(jdet),
                               atol=ATOL, rtol=RTOL)


def _stage2_pair(jcfg, tcfg, policy: str, levels: dict, *, batch: int = 3,
                 seed: int = 9):
    """One stage-2 step of both packages from the same numpy weights,
    adapter, table and batch (images of the configs' size); JAX compiled
    with excess precision off (``strict``), on XLA's attention in fp32
    (its gate's choice at 88 and 104) and on its Pallas attention and
    backward in interpret mode in bf16 (the kernel path's roundings, which
    the port's plain versions take); its gradients read from
    ``grad_capture``. Returns (port loss, JAX loss, port gradients, JAX
    gradients), the gradients as leaves of the JAX adapter tree."""
    visual, jad, vit, tad, jacfg, tacfg = both_models(jcfg, tcfg, levels)
    jpol, tpol = POLICIES[policy]
    img, embed = tcfg.vision.image_size, tcfg.embed_dim
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((2, embed, 2)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    data = (rng.standard_normal((batch, 3, img, img)).astype(np.float32),
            (rng.random((batch, img, img)) > 0.8).astype(np.float32),
            rng.integers(0, 2, batch).astype(np.int32),
            rng.integers(0, 2, batch).astype(np.int32),
            np.ones(batch, np.float32))
    attn_fn = (j_make_attn_fn(tcfg.vision.heads, jpol, differentiable=True,
                              interpret=True) if policy == "bf16" else None)
    jstep = j_make_stage2_step({"visual": visual}, jcfg, jacfg,
                               grad_capture(), table, policy=jpol,
                               attn_fn=attn_fn)
    state, jloss = strict(jstep.raw, init_state(jad, grad_capture()),
                          jstep.visual, *(jnp.asarray(x) for x in data))
    opt = optim.make_image_optimizer(tad.parameters())
    step = make_stage2_step(vit, tcfg, tacfg, opt, table, policy=tpol,
                            device="cpu")
    loss = step(tad, *(torch.from_numpy(x) for x in data))
    got = jax.tree.leaves(grads_as_jax(tad))
    want = [np.asarray(w, np.float32) for w in
            jax.tree.leaves(state.opt_state)]
    assert len(got) == len(want) > 0 and np.isfinite(float(jloss))
    return float(loss), float(jloss), got, want


def _fp32_close(loss, jloss, got, want) -> None:
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_narrow_wide_stage2_gradients_match_jax(hd):
    """One fp32 stage-2 step at 2 blocks of 2 heads of ``hd``: the loss
    and every adapter gradient against JAX's step on XLA's attention."""
    jcfg, tcfg = _narrow_pair(hd)
    _fp32_close(*_stage2_pair(jcfg, tcfg, "fp32",
                              dict(levels=(1, 2), image_adapt_until=1)))


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_narrow_wide_bf16_stage2_loss_matches_jax(hd):
    """One bf16 stage-2 step at 2 blocks of 2 heads of ``hd``: the loss
    within 5e-4 relative and every adapter gradient's cosine above 0.9999
    against JAX's step on its interpret-mode Pallas attention with XLA's
    excess precision off."""
    jcfg, tcfg = _narrow_pair(hd)
    loss, jloss, got, want = _stage2_pair(
        jcfg, tcfg, "bf16", dict(levels=(1, 2), image_adapt_until=1))
    np.testing.assert_allclose(loss, jloss, rtol=5e-4)
    for g, w in zip(got, want):
        g, w = g.astype(np.float64).ravel(), w.astype(np.float64).ravel()
        cos = g @ w / np.linalg.norm(g) / np.linalg.norm(w)
        assert cos > 0.9999, cos


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_widths_stage2_step_matches_jax(wide_configs, name):
    """One fp32 stage-2 step at the published widths cut to 2 blocks at
    28 px (batch 2): the loss and every adapter gradient, the adapters
    1408 or 1664 wide into seg/det of 1024 or 1280, at the fp32 bars."""
    jcfg, tcfg = (_cut(mod.get_config(name)) for mod in (jconfig, tconfig))
    assert tcfg.vision.head_dim == WIDE_ARCH[name][3]
    _fp32_close(*_stage2_pair(jcfg, tcfg, "fp32",
                              dict(levels=(1, 2), image_adapt_until=2),
                              batch=2))


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_kernel_route_at_wide_head_dims(hd):
    """88 and 104 are TMA head dims of the forward and the backward on
    every route: bf16 on the TMA + wgmma kernels, fp32 on their 6-pass
    planes ("highest", None) or 3-pass planes ("high")."""
    assert hd in A.KERNEL_HEAD_DIMS and hd in A.TMA_HEAD_DIMS
    assert hd in A.BWD_HEAD_DIMS
    assert A.kernel_route(torch.bfloat16, hd, None) == "wgmma"
    assert A.kernel_route(torch.bfloat16, hd, "high") == "wgmma"
    assert A.kernel_route(torch.float32, hd, None) == "6pass"
    assert A.kernel_route(torch.float32, hd, "highest") == "6pass"
    assert A.kernel_route(torch.float32, hd, "high") == "3pass_wgmma"
    for route in ("wgmma", "6pass", "3pass_wgmma"):
        assert route in A.MAP_ROUTES
    assert (hd * 2) % A.TMA_ALIGN == 0  # the per-head map's head stride


class _OnTheCard:
    """What the wrappers' CUDA checks read of a contiguous, aligned CUDA
    tensor of ``shape`` and ``dtype``, and nothing more: no kernel can
    run on it, so a check that passed would fail at the launch."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = types.SimpleNamespace(type="cuda")

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 1 << 20

    def element_size(self):
        return torch.tensor([], dtype=self.dtype).element_size()

    def to(self, dtype):
        return _OnTheCard(self.shape, dtype)

    def contiguous(self):
        return self


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_cuda_checks_admit_the_forward_and_the_backward(hd, monkeypatch):
    """On every route: the forward's geometry check admits ``hd`` in the
    packed and V-V layouts, and ``attention_packed_bwd``'s argument checks
    admit it and hand the launch to the route's C entry point (recorded in
    place of the library) with the head dim, the shape, the row strides
    and the section offsets of the packed layout, and on the bf16 route
    the key-outer kernel's workspace (its dQ sums and counters) in the
    query tiles the source's workspace query answers."""
    launched = []

    def entry(route):
        def call(*args):
            launched.append((route, args))
            return 0
        return call

    monkeypatch.setattr(A, "_bwd_kernel", lambda: entry("wgmma"))
    monkeypatch.setattr(A, "_kernels_6pass",
                        lambda: (None, None, entry("6pass")))
    monkeypatch.setattr(A, "_kernels_3pass_wgmma",
                        lambda: (None, None, entry("3pass_wgmma")))
    monkeypatch.setattr(A, "_planes", lambda route, x: _OnTheCard(
        (3 if route == "6pass" else 2, *x.shape), torch.bfloat16))
    monkeypatch.setattr(A.torch, "empty_like",
                        lambda t: _OnTheCard(t.shape, t.dtype))
    queried = []

    def tiles(bf16, head_dim, seq):  # the source's answer at 88 and 104
        queried.append((bf16, head_dim, seq))
        return -(-seq // 64) if bf16 else 0

    monkeypatch.setattr(A, "_bwd_workspace_tiles", lambda: tiles)
    work = (_OnTheCard((2, 16, 1408, hd), torch.float32),
            _OnTheCard((2 * 16 * 22 + 1,), torch.int32))
    monkeypatch.setattr(A, "_bwd_workspace",
                        lambda *a: work if a[:4] == (22, 2, 16, hd) else None)
    monkeypatch.setattr(A.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(A.torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    for counter in ("launches", "launches_6pass", "launches_3pass"):
        monkeypatch.setattr(A.attention_packed_bwd, counter, 0)
    dm = 16 * hd
    for dtype, precision, route in ((torch.bfloat16, None, "wgmma"),
                                    (torch.float32, None, "6pass"),
                                    (torch.float32, "high", "3pass_wgmma")):
        for sections in (3, 1):
            x = _OnTheCard((2, 1370, sections * dm), dtype)
            (B, S, got_dm, got_hd, scale, offs), got = A._check_cuda(
                "attention_packed", x, 16, 1370, sections, precision)
            assert (B, S, got_dm, got_hd, got) == (2, 1370, dm, hd, route)
            assert scale == hd ** -0.5
        qkv = _OnTheCard((2, 1370, 3 * dm), dtype)
        lse = _OnTheCard((2, 16, 1370), torch.float32)
        A.attention_packed_bwd(qkv, _OnTheCard((2, 1370, dm), dtype), lse,
                               16, 1201, precision=precision)
        got_route, args = launched.pop()
        # (..., head_dim, batch, seq, valid_len, heads, ld, q_off, k_off,
        # v_off, do_ld, scale, stream)
        assert got_route == route and not launched
        assert args[-12:-1] == (hd, 2, 1370, 1201, 16, 3 * dm, 0, dm,
                                2 * dm, dm, hd ** -0.5)
        if route == "wgmma":  # bf16: the key-outer kernel's workspace
            assert queried.pop() == (1, hd, 1370) and not queried
            assert args[5:8] == (1 << 20, 1 << 20, 1)
    assert (A.attention_packed_bwd.launches,
            A.attention_packed_bwd.launches_6pass,
            A.attention_packed_bwd.launches_3pass) == (3, 1, 1)
    # a head dim the forward has no kernel for is a ValueError, not B11's
    with pytest.raises(ValueError, match="no kernel instantiation"):
        A._check_cuda("attention_packed",
                      _OnTheCard((2, 77, 3 * 2 * 96), torch.bfloat16), 2, 77)
