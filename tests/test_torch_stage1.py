"""The port's stage-1 path (V-V attention, ``stage1_features_fn``,
``make_stage1_step``) against the JAX package's, on the CPU, where the
kernel wrappers run their plain versions.

Bars:
* V-V attention, plain version vs the Pallas ``attention_packed(vv=True,
  packed_sections=1)`` in interpret mode and the hook vs JAX
  ``layers.attention(vv=True)``: as ``tests/test_torch_attention.py``
  holds the standard mode (fp32 atol 1e-5, rtol 1e-5; bf16 one ulp of the
  output for the kernel's arithmetic, a few input ulps, atol 2e-2, for
  the XLA path's direct division).
* ``attention_vv_batch``: fp32 atol 1e-5, rtol 1e-5; bf16 atol 2e-2.
* features, tiny-test fp32 at surgery_until_layer=2: atol 1e-5, rtol 1e-5
  (unit vectors plus unit vectors; another summation order).
* step, tiny-test fp32: losses rtol 1e-5 over 5 steps, text adapters atol
  1e-5 after steps 1 and 5 (as the stage-2 test rules them); remat on and
  off agree to 1e-6. bf16 one step against JAX's with XLA's excess
  precision off (``strict``: XLA otherwise keeps bf16 intermediates in
  fp32 inside its fusions and rounds at fewer places than the port): loss
  within 2e-6 relative, each adapter gradient's cosine > 0.9999 (readings
  1.9e-7 and 1 - cos 9.6e-6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import AdapterConfig as JAdapterConfig
from aaclip_tpu.core.config import DtypePolicy as JPolicy
from aaclip_tpu.core.config import get_config as jget_config
from aaclip_tpu.core.params import init_adapter_params
from aaclip_tpu.models import layers as JL
from aaclip_tpu.ops.flash_attention import attention_packed as j_attention
from aaclip_tpu.ops.flash_attention import make_attn_fn as j_make_attn_fn
from aaclip_tpu.text.anchors import dataset_prompt_tokens
from aaclip_tpu.train import optim as joptim
from aaclip_tpu.train.steps import init_state
from aaclip_tpu.train.steps import make_stage1_step as j_make_stage1_step
from aaclip_tpu.train.steps import stage1_features_fn as j_features_fn
from aaclip_tpu_torch.core.config import AdapterConfig, DtypePolicy, get_config
from aaclip_tpu_torch.core.params import (params_from_jax,
                                          text_adapter_from_jax,
                                          text_adapter_to_jax,
                                          text_params_from_jax)
from aaclip_tpu_torch.models import layers as L
from aaclip_tpu_torch.ops.attention import (attention_packed_vv,
                                            attention_packed_vv_plain,
                                            make_attn_fn)
from aaclip_tpu_torch.train import optim
from aaclip_tpu_torch.train.steps import make_stage1_step, stage1_features_fn
from tests.test_torch_attention import DTYPES
from tests.test_torch_layers import perturbed_clip_tree, perturbed_text_tree
from tests.test_torch_train import grad_capture, strict

POLICIES = {"fp32": (JPolicy.fp32(), DtypePolicy.fp32()),
            "bf16": (JPolicy.bf16(), DtypePolicy.bf16())}
ACFG = dict(levels=(1, 2), image_adapt_until=1, text_adapt_until=1)


def t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def tiny_clip(seed=0):
    """Perturbed JAX trees of both tiny-test towers, built once."""
    return {"visual": perturbed_clip_tree("tiny-test", seed=seed),
            "text": perturbed_text_tree("tiny-test", seed=seed)}


def tiny_attn(block):
    """(JAX attention params of tiny-test block ``block``, the port's
    module)."""
    visual = tiny_clip()["visual"]
    vit = params_from_jax(visual, get_config("tiny-test"), device="cpu")
    jp = {k: np.asarray(v[block]) for k, v in
          visual["blocks"]["attn"].items()}
    return jp, vit.blocks[block].attn


# ------------------------------------------------------------ V-V attention

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("S", [250, 26])
def test_vv_plain_matches_pallas_interpret(dtype, S):
    jd, td = DTYPES[dtype]
    v = np.random.default_rng(0).standard_normal((2, S, 128)) \
        .astype(np.float32)
    want = j_attention(jnp.asarray(v, jd), 2, S, vv=True, packed_sections=1,
                       q_blk=S if S < 64 else 64,
                       precision="highest" if dtype == "fp32" else None,
                       interpret=True)
    got = attention_packed_vv_plain(t(v).to(td), 2, S)
    assert got.shape == (2, S, 128) and got.dtype == td
    want = np.asarray(want, np.float32)
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-3,
                                   rtol=2 ** -8)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_vv_attn_fn_and_plain_attention_match_jax(policy):
    """tiny-test block 0 (4 heads x 16): the V-V kernel hook (plain version
    on the CPU) and the XLA-path port against JAX ``layers.attention(vv=
    True)``, and the hook against JAX's Pallas V-V hook in interpret
    mode."""
    jpol, tpol = POLICIES[policy]
    jp, attn = tiny_attn(0)
    x = np.random.default_rng(11).standard_normal((2, 26, 64)) \
        .astype(np.float32)
    want = np.asarray(JL.attention(jnp.asarray(x), jp, 4, vv=True,
                                   policy=jpol))
    want_k = np.asarray(j_make_attn_fn(4, jpol, vv=True, interpret=True)(
        jnp.asarray(x), jp))
    hooked = make_attn_fn(4, tpol, vv=True)(t(x), attn)
    plain = L.attention(t(x), attn, 4, vv=True, policy=tpol)
    if policy == "fp32":
        for got in (hooked, plain):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                       rtol=1e-5)
        np.testing.assert_allclose(hooked.numpy(), want_k, atol=1e-5,
                                   rtol=1e-5)
    else:
        for got in (hooked, plain):
            np.testing.assert_allclose(got.numpy(), want, atol=2e-2)
        # the same kernel arithmetic on both sides
        np.testing.assert_allclose(hooked.numpy(), want_k, atol=1e-3,
                                   rtol=2 ** -7)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("valid", [None, [1, 1, 0]], ids=["all", "padded"])
def test_attention_vv_batch_matches_jax(policy, valid):
    jpol, tpol = POLICIES[policy]
    jp, attn = tiny_attn(1)
    x = np.random.default_rng(13).standard_normal((3, 26, 64)) \
        .astype(np.float32)
    jvalid = None if valid is None else jnp.asarray(valid, jnp.float32)
    want = np.asarray(JL.attention_vv_batch(jnp.asarray(x), jp, 4,
                                            policy=jpol, valid=jvalid))
    got = L.make_batch_vv_attn_fn(
        4, tpol, None if valid is None else torch.tensor(valid))(t(x), attn)
    assert got.shape == (3, 26, 64)
    if policy == "fp32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=2e-2)


def test_surgery_vv_start_matches_jax():
    for layers, until in ((24, 20), (24, 1), (24, 30), (2, 2), (12, 5)):
        assert L.surgery_vv_start(layers, until) == \
            JL.surgery_vv_start(layers, until)
    assert L.surgery_vv_start(24, 20) == 5


def test_vv_wrapper_runs_plain_on_cpu_and_refuses_the_rest():
    v = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (2, 33, 64)).astype(np.float32))
    before = attention_packed_vv.launches
    torch.testing.assert_close(attention_packed_vv(v, 4, 33),
                               attention_packed_vv_plain(v, 4, 33),
                               atol=0, rtol=0)
    assert attention_packed_vv.launches == before
    with pytest.raises(ValueError, match="attention_packed_vv: unsupported"):
        attention_packed_vv(torch.empty(1, 8, 64, device="meta"), 4, 8)
    with pytest.raises(ValueError, match="does not split"):
        attention_packed_vv(torch.zeros(1, 8, 50), 4, 8)


# ---------------------------------------------------------------- features

class Stage1Case:
    """Tiny-test towers, text adapters, a batch and the prompts, as numpy
    (JAX side) and loaded into the port."""

    def __init__(self, seed=0, batch=4):
        self.jcfg, self.cfg = jget_config("tiny-test"), get_config("tiny-test")
        self.jacfg = JAdapterConfig(**ACFG)
        self.acfg = AdapterConfig(**ACFG)
        self.clip = tiny_clip(seed)
        self.jad = jax.tree.map(np.asarray, init_adapter_params(
            jax.random.PRNGKey(seed + 1), self.jcfg, self.jacfg)["text"])
        rng = np.random.default_rng(seed + 2)
        self.images = rng.standard_normal((batch, 3, 70, 70)) \
            .astype(np.float32)
        self.mask = (rng.random((batch, 70, 70)) > 0.8).astype(np.float32)
        self.cidx = rng.integers(0, 2, batch).astype(np.int32)
        self.valid = np.ones(batch, np.float32)
        self.tokens = dataset_prompt_tokens("MVTec", ["bottle", "cable"])
        self.vit = params_from_jax(self.clip, self.cfg, device="cpu")
        self.text = text_params_from_jax(self.clip, self.cfg, device="cpu")

    @functools.cached_property
    def jax_feats(self):
        """JAX's fp32 batch-mode features of the batch at
        surgery_until_layer=2 (the steps' input)."""
        return np.asarray(j_features_fn(
            self.clip, self.jcfg, surgery_until_layer=2,
            policy=JPolicy.fp32())(jnp.asarray(self.images)))

    def adapter(self):
        return text_adapter_from_jax(self.jad, self.cfg, self.acfg,
                                     device="cpu")


@pytest.fixture(scope="module")
def case():
    return Stage1Case()


@pytest.mark.parametrize("vv_mode", ["batch", "spatial"])
def test_features_match_jax(case, vv_mode):
    want = case.jax_feats if vv_mode == "batch" else np.asarray(
        j_features_fn(case.clip, case.jcfg, surgery_until_layer=2,
                      policy=JPolicy.fp32(), vv_mode=vv_mode)(
            jnp.asarray(case.images)))
    got = stage1_features_fn(case.vit, case.cfg, surgery_until_layer=2,
                             policy=DtypePolicy.fp32(), vv_mode=vv_mode,
                             device="cpu")(t(case.images))
    assert got.shape == (4, 25, 32) and got.dtype == torch.float32
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_batch_features_valid_mask_matches_jax(case):
    valid = np.array([1, 1, 1, 0], np.float32)
    want = np.asarray(j_features_fn(case.clip, case.jcfg,
                                    surgery_until_layer=2,
                                    policy=JPolicy.fp32())(
        jnp.asarray(case.images), jnp.asarray(valid)))
    fn = stage1_features_fn(case.vit, case.cfg, surgery_until_layer=2,
                            policy=DtypePolicy.fp32(), device="cpu")
    got = fn(t(case.images), t(valid))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # the pad sample leaves the real samples' features as the unpadded
    # batch gives them; unmasked, it moves them
    tail = fn(t(case.images[:3]))
    np.testing.assert_allclose(got[:3].numpy(), tail.numpy(), atol=1e-5)
    assert not np.allclose(fn(t(case.images))[:3].numpy(), tail.numpy(),
                           atol=1e-3)


def test_spatial_chunks_are_exact_and_batch_mode_refuses_them(case):
    whole = stage1_features_fn(case.vit, case.cfg, surgery_until_layer=2,
                               vv_mode="spatial", device="cpu")(
        t(case.images))
    for chunk in (1, 3, 4, 8):
        parts = stage1_features_fn(case.vit, case.cfg, surgery_until_layer=2,
                                   vv_mode="spatial", chunk=chunk,
                                   device="cpu")(t(case.images))
        np.testing.assert_allclose(parts.numpy(), whole.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="requires vv_mode='spatial'"):
        stage1_features_fn(case.vit, case.cfg, chunk=2, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        stage1_features_fn(case.vit, case.cfg, vv_mode="spatial", chunk=0,
                           device="cpu")
    with pytest.raises(ValueError, match="vv_mode must be"):
        stage1_features_fn(case.vit, case.cfg, vv_mode="both", device="cpu")
    with pytest.raises(ValueError, match="custom vv_attn_fn"):
        stage1_features_fn(case.vit, case.cfg, device="cpu",
                           vv_attn_fn=make_attn_fn(4, vv=True))


# -------------------------------------------------------------------- step

def jax_stage1(case, policy, tx, remat=False):
    step = j_make_stage1_step(case.clip, case.jcfg, case.jacfg, tx,
                              case.tokens, policy=policy, remat=remat)
    state = init_state(case.jad, tx)
    return step, state


def port_stage1(case, policy, lr=1e-3, remat=False):
    ad = case.adapter()
    opt = optim.make_text_optimizer(ad.parameters(), lr=lr)
    step = make_stage1_step(case.text, case.cfg, case.acfg, opt,
                            case.tokens, policy=policy, remat=remat,
                            device="cpu")
    return ad, step


def batch(case, feats):
    return [feats, t(case.mask), t(case.cidx), t(case.valid)]


def test_stage1_step_matches_jax_over_five_steps(case):
    jpol, tpol = POLICIES["fp32"]
    feats = case.jax_feats
    jstep, state = jax_stage1(case, jpol, joptim.make_text_optimizer(1e-3))
    ad, step = port_stage1(case, tpol)
    jb = [jnp.asarray(x) for x in (feats, case.mask, case.cidx, case.valid)]
    for i in range(5):
        state, want_loss = jstep(state, *jb)
        got_loss = step(ad, *batch(case, t(feats)))
        assert got_loss.dim() == 0 and got_loss.dtype == torch.float32
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=1e-5)
        if i in (0, 4):
            for g, w in zip(jax.tree.leaves(text_adapter_to_jax(ad)),
                            jax.tree.leaves(state.params)):
                np.testing.assert_allclose(g, np.asarray(w), atol=1e-5,
                                           rtol=0)


def test_stage1_remat_changes_nothing(case):
    feats = stage1_features_fn(case.vit, case.cfg, surgery_until_layer=2,
                               device="cpu")(t(case.images))
    runs = []
    for remat in (False, True, "selective"):
        ad, step = port_stage1(case, DtypePolicy.fp32(), remat=remat)
        losses = [float(step(ad, *batch(case, feats))) for _ in range(2)]
        runs.append((losses, jax.tree.leaves(text_adapter_to_jax(ad))))
    (l0, a0), *rest = runs
    for l1, a1 in rest:
        np.testing.assert_allclose(l1, l0, atol=1e-6, rtol=0)
        for x, y in zip(a1, a0):
            np.testing.assert_allclose(x, y, atol=1e-6, rtol=0)


def test_stage1_selective_step_matches_jax_s(case):
    """Two steps with the text tower under selective remat against JAX's
    step built with ``remat="selective"``: the bars of
    ``test_stage1_step_matches_jax_over_five_steps``."""
    jpol, tpol = POLICIES["fp32"]
    feats = case.jax_feats
    jstep, state = jax_stage1(case, jpol, joptim.make_text_optimizer(1e-3),
                              remat="selective")
    ad, step = port_stage1(case, tpol, remat="selective")
    jb = [jnp.asarray(x) for x in (feats, case.mask, case.cidx, case.valid)]
    for _ in range(2):
        state, want_loss = jstep(state, *jb)
        np.testing.assert_allclose(
            float(step(ad, *batch(case, t(feats)))), float(want_loss),
            rtol=1e-5)
    for g, w in zip(jax.tree.leaves(text_adapter_to_jax(ad)),
                    jax.tree.leaves(state.params)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)


def test_stage1_bf16_step_matches_jax(case):
    """One bf16 step from the same fp32 features: the JAX step's gradients
    (read from a capturing transformation) against the port's."""
    jpol, tpol = POLICIES["bf16"]
    feats = case.jax_feats
    jstep, state = jax_stage1(case, jpol, grad_capture())
    cells = dict(zip(jstep.__code__.co_freevars, jstep.__closure__))
    state, want_loss = strict(
        cells["_step"].cell_contents, state,
        cells["text_params"].cell_contents,
        *[jnp.asarray(x) for x in (feats, case.mask, case.cidx, case.valid)])
    ad, step = port_stage1(case, tpol)
    got_loss = float(step(ad, *batch(case, t(feats))))
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=2e-6)
    grads = [lin.weight.grad.double().numpy().T.ravel()
             for lin in (*ad.layer_adapters, ad.proj)]
    wants = [np.asarray(state.opt_state["layer_adapters"]["w"][0],
                        np.float64).ravel(),
             np.asarray(state.opt_state["proj"]["w"], np.float64).ravel()]
    for gr, w in zip(grads, wants):
        cos = gr @ w / np.linalg.norm(gr) / np.linalg.norm(w)
        assert cos > 0.9999, cos


def test_stage1_rejects_what_is_not_ported(case):
    ad = case.adapter()
    opt = optim.make_text_optimizer(ad.parameters())
    # meshes are ported (tests/test_torch_parallel_*.py); sequence
    # parallelism without a model axis is refused, as in JAX
    with pytest.raises(ValueError, match="sequence_parallel requires"):
        make_stage1_step(case.text, case.cfg, case.acfg, opt, case.tokens,
                         device="cpu", sequence_parallel=True)
    with pytest.raises(ValueError, match="sequence_parallel requires"):
        stage1_features_fn(case.vit, case.cfg, device="cpu",
                           sequence_parallel=True)
    # selective remat steps
    step = make_stage1_step(case.text, case.cfg, case.acfg, opt, case.tokens,
                            remat="selective", device="cpu")
    feats = torch.zeros(4, 25, 32)
    assert np.isfinite(float(step(ad, *batch(case, feats))))
    with pytest.raises(ValueError, match="no differentiable variant"):
        make_attn_fn(4, vv=True, differentiable=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_stage1_step(case.text, case.cfg, case.acfg, opt,
                             case.tokens)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stage1_features_fn(case.vit, case.cfg)
