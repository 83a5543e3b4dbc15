"""The port's training path (aaclip_tpu_torch/train/, ops/losses.py, the
training similarity, ``matmul_f32``'s backward) against the JAX package's,
on the CPU, with the same numpy weights and batches on both sides.

Bars:
* ``matmul_f32`` gradients: fp32 atol 1e-5 / rtol 1e-5; bf16 one bf16 ulp
  (both sides round the same fp32 product to bf16, summed in another
  order), dtypes equal.
* losses and ``train_similarity_logit``: fp32 atol 1e-6, rtol 1e-6.
* Adam + MultiStepLR vs optax: parameters atol 1e-7 over 20 updates.
* stage-2 step, tiny-test fp32: losses rtol 1e-5 over 5 steps; adapters
  atol 1e-5 after steps 1 and 5, leaving out entries whose first gradient
  is below 1e-6 of its leaf's max (Adam turns a gradient's sign into a
  +-lr step, so summation-order noise flips those; their count is
  asserted). remat on and off agree to 1e-6.
* stage-2 step, tiny-test bf16: loss within 5e-4 relative, each adapter
  gradient with cosine > 0.9999 against JAX's (the kernel-path roundings
  in the same places, summed in another order; the readings are 5.8e-5
  and 1 - cos 8.9e-6 at the most).
* stage-2 step, bf16, with block biases and LayerNorm affines that bf16
  cannot hold: JAX keeps them fp32, and so must the port. Loss within 1e-4
  relative and each adapter gradient within 1 - cos <= 1e-5 of JAX's
  (readings 1.5e-5 and 2.7e-6); rounding those leaves to bf16, as the
  predictor's cast does, reads 9.7e-4 and up to 7.4e-4.
* Every JAX step runs with XLA's excess precision off (``strict``), so
  both sides round bf16 at the places the program states.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aaclip_tpu.core.config import AdapterConfig as JAdapterConfig
from aaclip_tpu.core.config import DtypePolicy as JPolicy
from aaclip_tpu.core.config import get_config as jget_config
from aaclip_tpu.core.params import init_adapter_params
from aaclip_tpu.models import layers as JL
from aaclip_tpu.ops import losses as JLL
from aaclip_tpu.ops import similarity as jsim
from aaclip_tpu.ops.flash_attention import make_attn_fn as j_make_attn_fn
from aaclip_tpu.train import optim as joptim
from aaclip_tpu.train.steps import init_state
from aaclip_tpu.train.steps import make_stage2_step as j_make_stage2_step
from aaclip_tpu_torch.core.config import AdapterConfig, DtypePolicy, get_config
from aaclip_tpu_torch.core.params import (adapter_from_jax, adapter_to_jax,
                                          params_from_jax)
from aaclip_tpu_torch.models import layers as L
from aaclip_tpu_torch.ops import losses as LL
from aaclip_tpu_torch.ops import similarity as sim
from aaclip_tpu_torch.train import optim
from aaclip_tpu_torch.train.steps import make_stage2_step
from tests.test_torch_layers import perturbed_clip_tree

TINY = dict(levels=(1, 2), image_adapt_until=1)
LOSS_TOL = dict(atol=1e-6, rtol=1e-6)
POLICIES = {"fp32": (JPolicy.fp32(), DtypePolicy.fp32()),
            "bf16": (JPolicy.bf16(), DtypePolicy.bf16())}


def t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------- matmul_f32

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_linear_backward_matches_jax_vjp(dtype):
    """Gradients of ``layers.linear`` (CPU path of ``matmul_f32``) against
    ``jax.vjp`` of the JAX ``layers.linear`` on the same operands."""
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jpol, tpol = POLICIES[dtype]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32)
    w = (0.1 * rng.standard_normal((48, 24))).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    g = rng.standard_normal((2, 7, 24)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w, b: JL.linear(x, {"w": w, "b": b}, jpol),
                     jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(g))
    xt = t(x).to(td).requires_grad_()
    wt = t(w.T.copy()).to(td).requires_grad_()
    bt = t(b).requires_grad_()
    y = L.linear(xt, wt, bt, tpol)
    assert y.dtype == torch.float32
    y.backward(t(g))
    for got, want in ((xt.grad, jdx), (wt.grad.t(), jdw), (bt.grad, jdb)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype).replace(
            "bfloat16", "bfloat16").replace("float32", "float32")
        want = np.asarray(want, np.float32)
        if dtype == "fp32":
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                       rtol=1e-5)
        else:
            np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6,
                                       rtol=2 ** -7)


@pytest.mark.parametrize("b_shape", [(48, 24), (2, 48, 24)])
@pytest.mark.parametrize("needs", [(True, True), (True, False),
                                   (False, True)])
def test_card_matmul_backward_logic(monkeypatch, b_shape, needs):
    """``_MatmulF32`` (the card's form) with its cuBLAS GEMM replaced by
    the CPU's product of the same operands: its gradients are JAX's
    transpose with the cotangent rounded to bf16 first (the documented
    departure), in the operands' dtype, for 2-D and batched ``b`` and
    either operand frozen."""
    monkeypatch.setattr(L, "_mm_f32",
                        lambda a, b: torch.matmul(a.float(), b.float()))
    rng = np.random.default_rng(1)
    a = t(rng.standard_normal((2, 7, 48)).astype(np.float32))
    b = t((0.1 * rng.standard_normal(b_shape)).astype(np.float32))
    a, b = (v.to(torch.bfloat16).requires_grad_(n) for v, n in zip((a, b),
                                                                     needs))
    g = t(rng.standard_normal((2, 7, 24)).astype(np.float32))
    y = L._MatmulF32.apply(a, b)
    assert y.dtype == torch.float32
    y.backward(g)
    _, vjp = jax.vjp(lambda a, b: jnp.matmul(
        a, b, preferred_element_type=jnp.float32),
        jnp.asarray(a.detach().float().numpy(), jnp.bfloat16),
        jnp.asarray(b.detach().float().numpy(), jnp.bfloat16))
    g16 = jnp.asarray(g.numpy(), jnp.bfloat16).astype(jnp.float32)
    for v, want in zip((a, b), vjp(g16)):
        if not v.requires_grad:
            continue
        assert v.grad.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_allclose(v.grad.float().numpy(),
                                   np.asarray(want, np.float32), atol=1e-6,
                                   rtol=2 ** -7)


# ---------------------------------------------------------- losses, similarity

def loss_inputs(B=3, H=16, pad=False):
    rng = np.random.default_rng(2)
    d = rng.standard_normal((B, H, H)).astype(np.float32)
    # soft mask values: below 1.0 is class 0 for the focal term
    m = rng.choice([0.0, 0.5, 1.0], (B, H, H)).astype(np.float32)
    logits = rng.standard_normal((B, 2)).astype(np.float32)
    labels = np.array([0, 1, 1][:B] + [0] * (B - 3), np.int64)
    anchors = rng.standard_normal((B, 8, 2)).astype(np.float32)
    valid = np.ones(B, np.float32)
    if pad:
        valid[-1] = 0.0
    return d, m, logits, labels, anchors, valid


@pytest.mark.parametrize("name", [
    "seg_loss_from_logit", "seg_loss_probs", "focal_loss_probs",
    "dice_loss", "cross_entropy_logits", "orthogonality_loss"])
def test_unmasked_losses_match_jax(name):
    d, m, logits, labels, anchors, _ = loss_inputs()
    p1 = 1.0 / (1.0 + np.exp(-d))
    probs = np.stack([1.0 - p1, p1], axis=1).astype(np.float32)
    args = {"seg_loss_from_logit": (d, m), "seg_loss_probs": (probs, m),
            "focal_loss_probs": (probs, (m >= 1.0).astype(np.float32)),
            "dice_loss": (p1.astype(np.float32), m),
            "cross_entropy_logits": (logits, labels),
            "orthogonality_loss": (anchors,)}[name]
    want = float(getattr(JLL, name)(*map(jnp.asarray, args)))
    got = getattr(LL, name)(*map(t, args))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, **LOSS_TOL)


@pytest.mark.parametrize("pad", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("name", ["seg_loss_from_logit_masked",
                                  "cross_entropy_logits_masked",
                                  "orthogonality_loss_masked"])
def test_masked_losses_match_jax(name, pad):
    d, m, logits, labels, anchors, valid = loss_inputs(B=4, pad=pad)
    args = {"seg_loss_from_logit_masked": (d, m, valid),
            "cross_entropy_logits_masked": (logits, labels, valid),
            "orthogonality_loss_masked": (anchors, valid)}[name]
    want = float(getattr(JLL, name)(*map(jnp.asarray, args)))
    np.testing.assert_allclose(float(getattr(LL, name)(*map(t, args))), want,
                               **LOSS_TOL)


def test_masked_loss_of_an_all_padding_batch_is_finite():
    d, m, logits, labels, _, _ = loss_inputs()
    v = np.zeros(3, np.float32)
    for name, args in (("seg_loss_from_logit_masked", (d, m, v)),
                       ("cross_entropy_logits_masked", (logits, labels, v))):
        want = float(getattr(JLL, name)(*map(jnp.asarray, args)))
        np.testing.assert_allclose(float(getattr(LL, name)(*map(t, args))),
                                   want, **LOSS_TOL)


@pytest.mark.parametrize("grid,img", [(5, 70), (4, 56)])
def test_train_similarity_matches_jax(grid, img):
    scores = np.random.default_rng(3).standard_normal(
        (2, grid * grid, 2)).astype(np.float32)
    want = np.asarray(jsim.train_similarity_logit(jnp.asarray(scores), img))
    got = sim.train_similarity_logit(t(scores), img)
    assert got.shape == (2, img, img)
    np.testing.assert_allclose(got.numpy(), want, **LOSS_TOL)
    want_p = np.asarray(jsim.train_similarity_probs(jnp.asarray(scores), img))
    np.testing.assert_allclose(
        sim.train_similarity_probs(t(scores), img).numpy(), want_p,
        **LOSS_TOL)


# ---------------------------------------------------------------- optimizer

def test_adam_multistep_matches_optax():
    """20 updates on fixed gradients with milestones (3, 7): both crossed,
    update n at lr * 0.5 ** (milestones <= n)."""
    rng = np.random.default_rng(4)
    p0 = (0.05 * rng.standard_normal((6, 5))).astype(np.float32)
    grads = [(rng.standard_normal((6, 5)) * rng.choice([1e-3, 1.0, 10.0]))
             .astype(np.float32) for _ in range(20)]
    tx = joptim.make_image_optimizer(1e-3, milestones=(3, 7), gamma=0.5)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    param = torch.nn.Parameter(t(p0).clone())
    opt, sched = optim.make_image_optimizer([param], lr=1e-3,
                                            milestones=(3, 7))
    lrs = []
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        lrs.append(opt.param_groups[0]["lr"])
        param.grad = t(g)
        opt.step()
        sched.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp),
                                   atol=1e-7, rtol=0)
    assert lrs[:3] == [1e-3] * 3 and lrs[3:7] == [5e-4] * 4
    assert lrs[7:] == [2.5e-4] * 13
    assert opt.defaults["betas"] == (0.5, 0.999) and opt.defaults["eps"] == 1e-8


def test_text_optimizer_matches_optax():
    """Stage 1's Adam at its constant default LR, 10 updates."""
    rng = np.random.default_rng(5)
    p0 = (0.05 * rng.standard_normal((4, 3))).astype(np.float32)
    tx = joptim.make_text_optimizer()
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    param = torch.nn.Parameter(t(p0).clone())
    opt = optim.make_text_optimizer([param])
    for _ in range(10):
        g = rng.standard_normal((4, 3)).astype(np.float32)
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        param.grad = t(g)
        opt.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp),
                                   atol=1e-7, rtol=0)
    assert opt.param_groups[0]["lr"] == 1e-5


# ---------------------------------------------------------------- the step

@dataclasses.dataclass
class StepCase:
    visual: dict
    jad: dict
    jacfg: JAdapterConfig
    table: np.ndarray
    batch: tuple


def step_case(batch=4, seed=0, valid=None) -> StepCase:
    jcfg = jget_config("tiny-test")
    jacfg = JAdapterConfig(**TINY, text_adapt_until=1)
    visual = perturbed_clip_tree("tiny-test", seed=seed)
    jad = jax.tree.map(np.asarray, init_adapter_params(
        jax.random.PRNGKey(seed + 1), jcfg, jacfg)["image"])
    rng = np.random.default_rng(seed + 2)
    table = rng.standard_normal((2, 32, 2)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    images = rng.standard_normal((batch, 3, 70, 70)).astype(np.float32)
    mask = (rng.random((batch, 70, 70)) > 0.8).astype(np.float32)
    label = rng.integers(0, 2, batch).astype(np.int32)
    cidx = rng.integers(0, 2, batch).astype(np.int32)
    valid = np.ones(batch, np.float32) if valid is None else \
        np.asarray(valid, np.float32)
    return StepCase(visual, jad, jacfg, table,
                    (images, mask, label, cidx, valid))


def port_step(case, policy, *, remat=False, grad_accum=1, lr=1e-3,
              milestones=(2, 4)):
    cfg = get_config("tiny-test")
    acfg = AdapterConfig(**TINY)
    vit = params_from_jax(case.visual, cfg, device="cpu")
    ad = adapter_from_jax(case.jad, cfg, acfg, device="cpu")
    opt = optim.make_image_optimizer(ad.parameters(), lr=lr,
                                     milestones=milestones)
    step = make_stage2_step(vit, cfg, acfg, opt, case.table,
                            policy=policy, remat=remat,
                            grad_accum=grad_accum, device="cpu")
    batch = [t(x) for x in case.batch]
    return ad, lambda: step(ad, *batch)


def strict(jitted, *args):
    """Call a jitted JAX function compiled with XLA's excess precision
    off. By default XLA may keep a bf16 intermediate in fp32 inside a
    fusion, so it rounds at fewer places than the program states; the port
    rounds at every stated place, and so does XLA with the option off."""
    compiled = jitted.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args)


def jax_step(case, policy, tx, *, grad_accum=1, attn_fn=None, remat=False):
    step = j_make_stage2_step({"visual": case.visual}, jget_config("tiny-test"),
                              case.jacfg, tx, case.table, policy=policy,
                              attn_fn=attn_fn, remat=remat,
                              grad_accum=grad_accum)
    state = init_state(case.jad, tx)
    batch = [jnp.asarray(x) for x in case.batch]

    def run():
        nonlocal state
        state, loss = strict(step.raw, state, step.visual, *batch)
        return float(loss), state

    return run


def grads_as_jax(ad) -> dict:
    """The adapter's .grad in the JAX tree layout."""
    g = copy.deepcopy(ad)
    for p, src in zip(g.parameters(), ad.parameters()):
        p.data = src.grad.clone()
    return adapter_to_jax(g)


def assert_adapter_close(ad, jparams, first_grad, atol=1e-5):
    """Leaf by leaf; returns how many entries were left out by the
    near-zero first-gradient rule."""
    got = jax.tree.leaves(adapter_to_jax(ad))
    want = [np.asarray(x) for x in jax.tree.leaves(jparams)]
    left_out = 0
    for g, w, g0 in zip(got, want, jax.tree.leaves(first_grad)):
        keep = np.abs(g0) >= 1e-6 * np.abs(g0).max()
        left_out += int((~keep).sum())
        np.testing.assert_allclose(g[keep], w[keep], atol=atol, rtol=0)
    return left_out


def test_adapter_to_jax_inverts_adapter_from_jax():
    case = step_case()
    ad = adapter_from_jax(case.jad, get_config("tiny-test"),
                          AdapterConfig(**TINY), device="cpu")
    back = adapter_to_jax(ad)
    assert jax.tree.structure(back) == jax.tree.structure(case.jad)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(case.jad)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_stage2_step_matches_jax_over_five_steps():
    case = step_case()
    jpol, tpol = POLICIES["fp32"]
    run = jax_step(case, jpol, joptim.make_image_optimizer(
        1e-3, milestones=(2, 4)))
    ad, step = port_step(case, tpol)
    left_out = []
    for i in range(5):
        want_loss, state = run()
        got_loss = step()
        assert got_loss.dim() == 0 and got_loss.dtype == torch.float32
        np.testing.assert_allclose(float(got_loss), want_loss, rtol=1e-5)
        if i == 0:
            first_grad = grads_as_jax(ad)
        if i in (0, 4):
            left_out.append(assert_adapter_close(ad, state.params,
                                                 first_grad))
    n = sum(x.size for x in jax.tree.leaves(first_grad))
    # near-zero first gradients are rare: a handful of ~6k entries
    assert left_out[0] == left_out[1] <= 0.001 * n, (left_out, n)


def test_stage2_remat_changes_nothing():
    """Full and selective remat against none: the same losses and
    adapters after two steps."""
    case = step_case()
    runs = []
    for remat in (False, True, "selective"):
        ad, step = port_step(case, DtypePolicy.fp32(), remat=remat)
        losses = [float(step()) for _ in range(2)]
        runs.append((losses, jax.tree.leaves(adapter_to_jax(ad))))
    (l0, a0), *rest = runs
    for l1, a1 in rest:
        np.testing.assert_allclose(l1, l0, atol=1e-6, rtol=0)
        for x, y in zip(a1, a0):
            np.testing.assert_allclose(x, y, atol=1e-6, rtol=0)


def test_stage2_selective_step_matches_jax_s():
    """Two steps under selective remat against JAX's step built with
    ``remat="selective"`` (``save_only_these_names``): the bars of
    ``test_stage2_step_matches_jax_over_five_steps``."""
    case = step_case(seed=3)
    jpol, tpol = POLICIES["fp32"]
    run = jax_step(case, jpol, joptim.make_image_optimizer(
        1e-3, milestones=(2, 4)), remat="selective")
    ad, step = port_step(case, tpol, remat="selective")
    for i in range(2):
        want_loss, state = run()
        np.testing.assert_allclose(float(step()), want_loss, rtol=1e-5)
        if i == 0:
            first_grad = grads_as_jax(ad)
    n = sum(x.size for x in jax.tree.leaves(first_grad))
    assert assert_adapter_close(ad, state.params, first_grad) <= 0.001 * n


@pytest.mark.parametrize("valid", [[1, 1, 1, 1], [1, 1, 0, 0]],
                         ids=["full", "all_padding_microbatch"])
def test_stage2_grad_accum_matches_jax(valid):
    """grad_accum 2 on a batch of 4: the mean over live microbatches; a
    ragged batch whose second microbatch is all padding is gated out of
    the loss and of the mean."""
    case = step_case(valid=valid)
    jpol, tpol = POLICIES["fp32"]
    run = jax_step(case, jpol, joptim.make_image_optimizer(1e-3),
                   grad_accum=2)
    ad, step = port_step(case, tpol, grad_accum=2)
    for i in range(2):
        want_loss, state = run()
        np.testing.assert_allclose(float(step()), want_loss, rtol=1e-5)
        if i == 0:
            first_grad = grads_as_jax(ad)
    n = sum(x.size for x in jax.tree.leaves(first_grad))
    assert assert_adapter_close(ad, state.params, first_grad) <= 0.001 * n


def grad_capture():
    """An optax transformation whose state is the last gradient and whose
    update is zero: the JAX step's gradients, read from its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def test_stage2_bf16_step_matches_jax():
    """bf16 policy, JAX's kernel path (the Pallas custom VJP in
    interpret mode) against the port's (the kernels' plain versions)."""
    case = step_case()
    jpol, tpol = POLICIES["bf16"]
    run = jax_step(case, jpol, grad_capture(),
                   attn_fn=j_make_attn_fn(4, jpol, differentiable=True,
                                          interpret=True))
    want_loss, state = run()
    ad, step = port_step(case, tpol)
    got_loss = float(step())
    np.testing.assert_allclose(got_loss, want_loss, rtol=5e-4)
    got = jax.tree.leaves(grads_as_jax(ad))
    for g, w in zip(got, jax.tree.leaves(state.opt_state)):
        w = np.asarray(w, np.float64).ravel()
        g = g.astype(np.float64).ravel()
        cos = g @ w / np.linalg.norm(g) / np.linalg.norm(w)
        assert cos > 0.9999, cos


def off_grid(x, rng):
    """``x`` moved just below half a bf16 ulp off the bf16 grid, away from
    zero or towards it at random: values bf16 rounds by almost the most
    it can."""
    x = np.asarray(x, np.float32)
    b = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    sign = np.where(rng.random(x.shape) < 0.5, -1.0, 1.0)
    return (b + 0.45 * 2.0 ** -8 * np.abs(b) * sign).astype(np.float32)


def test_stage2_bf16_step_keeps_biases_and_layernorms_fp32():
    """JAX's stage-2 step keeps the frozen tower fp32 as stored and casts
    only each matmul operand (``train/steps.py:348``, ``layers.linear``).
    A tower whose block biases and LayerNorm affines are of the stream's
    size and off the bf16 grid shows whether the port rounds them."""
    case = step_case(seed=2)
    rng = np.random.default_rng(13)
    blocks = case.visual["blocks"]
    for grp, key, mean, std in (
            ("ln_1", "scale", 1.0, 0.3), ("ln_2", "scale", 1.0, 0.3),
            ("ln_1", "bias", 0.0, 2.0), ("ln_2", "bias", 0.0, 2.0),
            ("attn", "b_qkv", 0.0, 2.0), ("attn", "b_out", 0.0, 4.0),
            ("mlp", "b_fc", 0.0, 2.0), ("mlp", "b_proj", 0.0, 4.0)):
        shape = np.asarray(blocks[grp][key]).shape
        blocks[grp][key] = off_grid(rng.normal(mean, std, shape), rng)
    jpol, tpol = POLICIES["bf16"]
    run = jax_step(case, jpol, grad_capture(),
                   attn_fn=j_make_attn_fn(4, jpol, differentiable=True,
                                          interpret=True))
    want_loss, state = run()
    ad, step = port_step(case, tpol)
    np.testing.assert_allclose(float(step()), want_loss, rtol=1e-4)
    got = jax.tree.leaves(grads_as_jax(ad))
    for g, w in zip(got, jax.tree.leaves(state.opt_state)):
        w = np.asarray(w, np.float64).ravel()
        g = g.astype(np.float64).ravel()
        cos = g @ w / np.linalg.norm(g) / np.linalg.norm(w)
        assert 1.0 - cos <= 1e-5, cos


def test_stage2_step_rejects_what_is_not_ported():
    case = step_case()
    cfg = get_config("tiny-test")
    acfg = AdapterConfig(**TINY)
    vit = params_from_jax(case.visual, cfg, device="cpu")
    ad = adapter_from_jax(case.jad, cfg, acfg, device="cpu")
    opt = optim.make_image_optimizer(ad.parameters())
    # meshes are ported (tests/test_torch_parallel_*.py); sequence
    # parallelism without a model axis is refused, as in JAX
    with pytest.raises(ValueError, match="sequence_parallel requires"):
        make_stage2_step(vit, cfg, acfg, opt, case.table, device="cpu",
                         sequence_parallel=True)
    with pytest.raises(ValueError, match="grad_accum"):
        make_stage2_step(vit, cfg, acfg, opt, case.table, device="cpu",
                         grad_accum=0)
    with pytest.raises(ValueError, match="remat must be"):
        make_stage2_step(vit, cfg, acfg, opt, case.table, device="cpu",
                         remat="some")(ad, *[t(x) for x in case.batch])
    # selective remat steps
    step = make_stage2_step(vit, cfg, acfg, opt, case.table, device="cpu",
                            remat="selective")
    assert np.isfinite(float(step(ad, *[t(x) for x in case.batch])))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_stage2_step(vit, cfg, acfg, opt, case.table)
