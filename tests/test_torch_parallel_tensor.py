"""The port's tensor and sequence parallelism (aaclip_tpu_torch/parallel/
tensor.py and the differentiable collectives of parallel/sharding.py)
against the JAX package's on its 8-device CPU mesh (``make_mesh_2d(tp,
num_devices=n)``), on the CPU.

The port's ranks run as a 2-process and a 4-process gloo world
(``tests/torch_parallel_worker.py``, 120 s timeout each): tp = 2; tp = 4;
data 2 x model 2. Every rank returns the global result and all ranks must
agree bit for bit. Sequence parallelism runs where S does not divide by tp
(the vision stream's 26 tokens at tp = 4, the text tower's 77 at tp = 2
and 4). Bars:
* Megatron's collectives: the row-parallel sum's input gradient equals
  the single-process one exactly (small integers), where
  ``torch.distributed.nn``'s all-reduce gives tp times it;
* predict: atol 1e-4, rtol 1e-5 (test_torch_model's fp32 bar); the staged
  ``fp32_high`` policy (a bf16 prefix) as test_torch_model's bf16 bar,
  map correlation > 0.999 and scores atol 5e-3;
* steps: losses rtol 1e-5, adapters atol 1e-5 after the last step with
  test_torch_train's near-zero first-gradient rule;
* stage-1 features: atol 1e-5, rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import DtypePolicy as JPolicy
from aaclip_tpu.eval.predict import make_predict_fn as j_make_predict_fn
from aaclip_tpu.parallel import sharding as jsh
from aaclip_tpu.parallel import tensor as jtp
from aaclip_tpu.train import optim as joptim
from aaclip_tpu.train.steps import init_state
from aaclip_tpu.train.steps import make_stage1_step as j_make_stage1_step
from aaclip_tpu.train.steps import make_stage2_step as j_make_stage2_step
from aaclip_tpu.train.steps import stage1_features_fn as j_features_fn
from aaclip_tpu_torch.core.config import AdapterConfig, DtypePolicy, get_config
from aaclip_tpu_torch.core.params import init_vision_params
from aaclip_tpu_torch.eval.predict import make_predict_fn
from aaclip_tpu_torch.parallel import tensor as tpar
from aaclip_tpu_torch.parallel.sharding import Mesh
from aaclip_tpu_torch.train.steps import make_stage2_step
from tests.test_torch_parallel_data import (FULL4, INPUTS, JACFG, JCFG,
                                            RAGGED4, RAGGED8,
                                            assert_adapter_close)
from tests.torch_parallel_worker import run_world

ATOL, RTOL = 1e-4, 1e-5
S1_ACFG = dict(levels=(1, 2), image_adapt_until=1, text_adapt_until=1)
STAGED = dict(policy="fp32_high", bf16_until=1)


def _vis(**kw):
    return dict(visual=INPUTS.visual, **kw)


def _pred(tp, n, **kw):
    return ("predict", _vis(tp=tp, jad=INPUTS.jad, anchors=INPUTS.anchors,
                            M=INPUTS.M, images=INPUTS.images[:n], **kw))


def _s2(tp, batch, **kw):
    return ("stage2", _vis(tp=tp, jad=INPUTS.jad, table=INPUTS.table,
                           batch=batch, **kw))


def _s1(tp, feats, valid, **kw):
    n = len(valid)
    return ("stage1", dict(tp=tp, text=INPUTS.text, tad=INPUTS.tad,
                           tokens=INPUTS.tokens, feats=feats[:n],
                           mask=INPUTS.mask[:n], class_idx=INPUTS.cidx[:n],
                           valid=np.float32(valid), acfg_kwargs=S1_ACFG,
                           **kw))


@pytest.fixture(scope="module")
def jax_feats():
    fn = j_features_fn({"visual": INPUTS.visual}, JCFG, surgery_until_layer=2,
                       policy=JPolicy.fp32())
    return np.asarray(fn(jnp.asarray(INPUTS.images[:4])))


def _world(n, cases):
    ranks = run_world(n, list(cases.values()))
    for other in ranks[1:]:
        for a, b in zip(jax.tree.leaves(ranks[0]), jax.tree.leaves(other)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return dict(zip(cases, ranks[0]))


X = np.arange(6, dtype=np.float32).reshape(2, 3)
W = (np.arange(12, dtype=np.float32).reshape(3, 4) % 5) - 2  # rows split


@pytest.fixture(scope="module")
def world2(jax_feats):
    return _world(2, {
        "grad": ("row_parallel_grad", dict(x=X[:, :2], w=W[:2])),
        "sp_roundtrip": ("sp_roundtrip", dict(s=5)),
        "tp_predict": _pred(2, 2),
        "sp_predict": _pred(2, 2, sp=True),
        "tp_staged": _pred(2, 2, **STAGED),
        "tp_s2": _s2(2, INPUTS.batch(4, RAGGED4)),
        "tp_s2_selective": _s2(2, INPUTS.batch(4, FULL4),
                               remat="selective"),
        "sp_s2": _s2(2, INPUTS.batch(4, RAGGED4), sp=True, remat=True),
        "sp_s2_selective": _s2(2, INPUTS.batch(4, FULL4), sp=True,
                               remat="selective", steps=1),
        "tp_s2_accum": _s2(2, INPUTS.batch(8, RAGGED8), grad_accum=2),
        "tp_f_batch": ("stage1_features", _vis(
            tp=2, images=INPUTS.images[:4], valid=np.float32(RAGGED4))),
        "sp_f_spatial": ("stage1_features", _vis(
            tp=2, images=INPUTS.images[:4], vv_mode="spatial", sp=True)),
        "tp_s1": _s1(2, jax_feats, FULL4),
        "sp_s1": _s1(2, jax_feats, RAGGED4, sp=True, remat="selective"),
    })


@pytest.fixture(scope="module")
def world4(jax_feats):
    return _world(4, {
        "sp_roundtrip": ("sp_roundtrip", dict(s=26)),
        "tp4_sp_predict": _pred(4, 2, sp=True),
        "dp2tp2_predict": _pred(2, 4),
        "dp2tp2_sp_s2": _s2(2, INPUTS.batch(4, RAGGED4), sp=True),
        "tp4_sp_s1": _s1(4, jax_feats, RAGGED4, sp=True),
    })


def jmesh(tp, n):
    return jtp.make_mesh_2d(tp, num_devices=n)


def jpolicy(policy="fp32", bf16_until=None):
    p = JPolicy.from_name(policy)
    return p if bf16_until is None else dataclasses.replace(
        p, bf16_until=bf16_until)


def jax_predict(tp, n_dev, n, sp=False, **pol):
    mesh = jmesh(tp, n_dev)
    fn = j_make_predict_fn({"visual": INPUTS.visual}, JCFG, JACFG,
                           policy=jpolicy(**pol), mesh=mesh,
                           sequence_parallel=sp)
    pix, score = fn(INPUTS.jad, jsh.shard_batch(mesh, INPUTS.images[:n]),
                    jnp.asarray(INPUTS.anchors), jnp.asarray(INPUTS.M))
    return np.asarray(pix), np.asarray(score)


# ---------------------------------------------------------- collectives

def test_row_parallel_sum_gradient_is_megatrons(world2):
    (y, gx), (y_nn, gx_nn) = world2["grad"]
    want_y = X[:, :2] @ W[:2]
    np.testing.assert_array_equal(y, want_y)
    np.testing.assert_array_equal(y_nn, want_y)
    want_g = np.ones((2, 4), np.float32) @ W[:2].T  # d sum(x @ w) / dx
    np.testing.assert_array_equal(gx, want_g)
    np.testing.assert_array_equal(gx_nn, 2 * want_g)  # tp times too large


@pytest.mark.parametrize("world,s,tp", [("world2", 5, 2), ("world4", 26, 4)])
def test_sequence_split_and_gather_with_uneven_length(world, s, tp, request):
    shape, whole, summed, grad = request.getfixturevalue(world)[
        "sp_roundtrip"]
    x = np.arange(2 * s * 3, dtype=np.float32).reshape(2, s, 3)
    assert shape == (2, -(-s // tp), 3)
    np.testing.assert_array_equal(whole, x)
    np.testing.assert_array_equal(summed, tp * x)
    np.testing.assert_array_equal(grad, np.full_like(x, 1 + 0.5 * tp))


# -------------------------------------------------------------- predict

@pytest.mark.parametrize("name,tp,n_dev,n,sp", [
    ("tp_predict", 2, 2, 2, False),
    ("sp_predict", 2, 2, 2, True),
    ("tp4_sp_predict", 4, 4, 2, True),
    ("dp2tp2_predict", 2, 4, 4, False),
])
def test_tp_predict_matches_jax_mesh(world2, world4, name, tp, n_dev, n, sp):
    pix, score = (world2 if name in world2 else world4)[name]
    jpix, jscore = jax_predict(tp, n_dev, n, sp)
    np.testing.assert_allclose(pix, jpix, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(score, jscore, atol=ATOL, rtol=RTOL)


def test_tp_staged_policy_predict_matches_jax_mesh(world2):
    pix, score = world2["tp_staged"]
    jpix, jscore = jax_predict(2, 2, 2, **STAGED)
    corr = np.corrcoef(pix.ravel(), jpix.ravel())[0, 1]
    assert corr > 0.999, corr
    np.testing.assert_allclose(score, jscore, atol=5e-3)


# ---------------------------------------------------------------- steps

def jax_stage2(tp, n_dev, batch, steps=2, grad_accum=1, remat=False,
               sp=False):
    tx = joptim.make_image_optimizer(1e-3, milestones=(2, 4))
    mesh = jmesh(tp, n_dev)
    step = j_make_stage2_step({"visual": INPUTS.visual}, JCFG, JACFG, tx,
                              INPUTS.table, policy=JPolicy.fp32(),
                              remat=remat, grad_accum=grad_accum, mesh=mesh,
                              sequence_parallel=sp)
    state = init_state(INPUTS.jad, tx)
    sharded = jsh.shard_batch(mesh, *batch)
    losses = []
    for _ in range(steps):
        state, loss = step(state, *sharded)
        losses.append(float(loss))
    return losses, state.params


@pytest.mark.parametrize("name,tp,n_dev,batch,kw", [
    ("tp_s2", 2, 2, (4, RAGGED4), {}),
    ("tp_s2_selective", 2, 2, (4, FULL4), dict(remat="selective")),
    ("sp_s2", 2, 2, (4, RAGGED4), dict(sp=True, remat=True)),
    ("sp_s2_selective", 2, 2, (4, FULL4),
     dict(sp=True, remat="selective", steps=1)),
    ("tp_s2_accum", 2, 2, (8, RAGGED8), dict(grad_accum=2)),
    ("dp2tp2_sp_s2", 2, 4, (4, RAGGED4), dict(sp=True)),
])
def test_tp_stage2_step_matches_jax_mesh(world2, world4, name, tp, n_dev,
                                         batch, kw):
    want, params = jax_stage2(tp, n_dev, INPUTS.batch(*batch), **kw)
    losses, first, adapters = (world2 if name in world2 else world4)[name]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert_adapter_close(adapters, params, first)


@pytest.mark.parametrize("name", ["tp_f_batch", "sp_f_spatial"])
def test_tp_stage1_features_match_jax_mesh(world2, name):
    mesh = jmesh(2, 2)
    batch_mode = name == "tp_f_batch"
    fn = j_features_fn({"visual": INPUTS.visual}, JCFG, surgery_until_layer=2,
                       policy=JPolicy.fp32(),
                       vv_mode="batch" if batch_mode else "spatial",
                       mesh=mesh, sequence_parallel=not batch_mode)
    if batch_mode:
        want = fn(*jsh.shard_batch(mesh, INPUTS.images[:4],
                                   np.float32(RAGGED4)))
    else:
        want = fn(jsh.shard_batch(mesh, INPUTS.images[:4]))
    np.testing.assert_allclose(world2[name], np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("name,tp,n_dev,valid,sp", [
    ("tp_s1", 2, 2, FULL4, False),
    ("sp_s1", 2, 2, RAGGED4, True),
    ("tp4_sp_s1", 4, 4, RAGGED4, True),
])
def test_tp_stage1_step_matches_jax_mesh(world2, world4, jax_feats, name, tp,
                                         n_dev, valid, sp):
    tx = joptim.make_text_optimizer(1e-3)
    mesh = jmesh(tp, n_dev)
    clip = {"visual": INPUTS.visual, "text": INPUTS.text}
    step = j_make_stage1_step(clip, JCFG, JACFG, tx, INPUTS.tokens,
                              policy=JPolicy.fp32(), mesh=mesh,
                              sequence_parallel=sp)
    state = init_state(INPUTS.tad, tx)
    batch = jsh.shard_batch(mesh, jax_feats, INPUTS.mask[:4],
                            INPUTS.cidx[:4], np.float32(valid))
    want = []
    for _ in range(2):
        state, loss = step(state, *batch)
        want.append(float(loss))
    losses, first, adapters = (world2 if name in world2 else world4)[name]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert_adapter_close(adapters, state.params, first)


# ----------------------------------------------------------- validation

def fake_tp_mesh(tp):
    """A mesh value with a model axis, for checks that run before any
    collective."""
    return Mesh(dp=1, tp=tp, rank=0, data_rank=0, model_rank=0, data=None,
                model=None, device=torch.device("cpu"))


def test_tp_validation_matches_jax():
    cfg = get_config("tiny-test")
    acfg = AdapterConfig(levels=(1, 2), image_adapt_until=1)
    vit = init_vision_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="must divide head count 4"):
        tpar.shard_tower(vit, 4, fake_tp_mesh(3))
    with pytest.raises(ValueError, match="must divide MLP hidden dim 6"):
        tpar.check_divisible(4, 6, 4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_predict_fn(vit, cfg, acfg, mesh=fake_tp_mesh(2), device="cpu",
                        block_fn=lambda x, p: x)
    with pytest.raises(ValueError, match="tensor parallelism"):
        make_predict_fn(vit, cfg, acfg, mesh=fake_tp_mesh(2), device="cpu",
                        policy=DtypePolicy.from_name("int8"))
    for fn in (make_predict_fn,
               lambda *a, **k: make_stage2_step(*a[:3], None, INPUTS.table,
                                                **k)):
        with pytest.raises(ValueError, match="sequence_parallel requires"):
            fn(vit, cfg, acfg, sequence_parallel=True, device="cpu")
    # JAX refuses the same combinations
    with pytest.raises(ValueError, match="must divide"):
        jtp.make_mesh_2d(3)
