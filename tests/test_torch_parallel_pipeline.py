"""The port's pipeline parallelism (aaclip_tpu_torch/parallel/pipeline.py)
against the JAX package's ``aaclip_tpu.parallel.pipeline`` on its 8-device
CPU mesh, on the same numpy weights, case for case with
``tests/test_pipeline_parallel.py``.

The port's ranks run as one 2-process and one 4-process gloo world
(``tests/torch_parallel_worker.py``, 120 s timeout each), every case of
its size in it; each rank returns the global result, and every rank must
agree bit for bit with rank 0. The 2-rank world runs pp = 2 (and both
CLIs with ``--pipeline_parallel 2``); the 4-rank world pp = 4 on a
4-layer tower with four levels and pp = 2 x dp = 2, which JAX runs on 4
of its devices. Bars, fp32, the JAX file's own:
* maps atol 2e-5, rtol 1e-4; image scores atol 1e-6, rtol 1e-5;
* stage-2 losses rtol 1e-5; adapter entries atol 1e-5 after the last
  step (the JAX file's 2e-5 with rtol 1e-4 is looser);
* stage-1 features atol 2e-5, rtol 1e-4;
* the CLIs: test_torch_parallel_cli's bars (results within 0.01 points,
  scores atol 1e-4, losses rtol 1e-5, saved adapters atol 1e-5).
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import AdapterConfig as JAdapterConfig
from aaclip_tpu.core.config import DtypePolicy as JPolicy
from aaclip_tpu.core.config import get_config as jget_config
from aaclip_tpu.core.params import init_adapter_params
from aaclip_tpu.ops.similarity import fused_postproc_matrix
from aaclip_tpu.parallel import pipeline as jppl
from aaclip_tpu.train import optim as joptim
from aaclip_tpu.train.steps import init_state
from aaclip_tpu.train.steps import make_stage2_step as j_make_stage2_step
from aaclip_tpu.train.steps import stage1_features_fn as j_features_fn
from tests.test_torch_layers import perturbed_clip_tree
from tests.torch_parallel_worker import run_world

JCFG = jget_config("tiny-test")
JCFG4 = dataclasses.replace(JCFG, vision=dataclasses.replace(JCFG.vision,
                                                             layers=4))
JACFG = JAdapterConfig(levels=(1, 2), image_adapt_until=1, text_adapt_until=1)
JACFG4 = JAdapterConfig(levels=(1, 2, 3, 4), image_adapt_until=2,
                        text_adapt_until=1)
ACFG4 = dict(levels=(1, 2, 3, 4), image_adapt_until=2)
MAP = dict(atol=2e-5, rtol=1e-4)
SCORE = dict(atol=1e-6, rtol=1e-5)
FEATS = dict(atol=2e-5, rtol=1e-4)
LOSS_RTOL, ADAPTER_ATOL = 1e-5, 1e-5


class Inputs:
    def __init__(self, seed=0):
        self.visual = perturbed_clip_tree(JCFG, seed=seed)
        self.visual4 = perturbed_clip_tree(JCFG4, seed=seed)
        tree = lambda cfg, acfg: jax.tree.map(  # noqa: E731
            np.asarray, init_adapter_params(jax.random.PRNGKey(seed + 1),
                                            cfg, acfg))["image"]
        self.jad, self.jad4 = tree(JCFG, JACFG), tree(JCFG4, JACFG4)
        rng = np.random.default_rng(seed + 2)
        self.images = rng.standard_normal((8, 3, 70, 70)).astype(np.float32)
        self.mask = (rng.random((8, 70, 70)) > 0.8).astype(np.float32)
        self.label = (np.arange(8) % 2).astype(np.int32)
        self.cidx = rng.integers(0, 2, 8).astype(np.int32)
        a = rng.standard_normal((32, 2)).astype(np.float32)
        self.anchors = a / np.linalg.norm(a, axis=0, keepdims=True)
        b = rng.standard_normal((8, 32, 2)).astype(np.float32)
        self.banchors = b / np.linalg.norm(b, axis=1, keepdims=True)
        self.table = np.stack([self.anchors,
                               self.anchors[:, ::-1]]).astype(np.float32)
        self.M = np.asarray(fused_postproc_matrix(5, 70, "Industrial"))

    def batch(self, n=8, tail=None):
        valid = np.ones(n, np.float32)
        if tail:
            valid[-tail:] = 0.0
        return (self.images[:n], self.mask[:n], self.label[:n],
                self.cidx[:n], valid)


INPUTS = Inputs()
I = INPUTS


def _eval(n, anchors=None, **kw):
    a = I.anchors if anchors is None else anchors
    return ("pp_predict", dict(visual=I.visual, jad=I.jad, images=I.images[:n],
                               anchors=a, M=I.M, **kw))


def _s2(batch, **kw):
    return ("pp_stage2", dict(visual=I.visual, jad=I.jad, table=I.table,
                              batch=batch, **kw))


def _f(n=8, **kw):
    visual = I.visual4 if kw.get("layers") == 4 else I.visual
    return ("pp_features", dict(visual=visual, images=I.images[:n], **kw))


VALID6 = np.float32([1, 1, 1, 1, 1, 1, 0, 0])
WORLD2 = {
    "eval2": _eval(8, pp=2, n_micro=2, raw=True),
    "eval4": _eval(8, pp=2, n_micro=4),
    "per_sample": _eval(4, anchors=I.banchors[:4], pp=2, n_micro=2),
    "bf16": _eval(4, pp=2, n_micro=2, policy="bf16"),
    "s2_2": _s2(I.batch(), pp=2, n_micro=2),
    "s2_4": _s2(I.batch(), pp=2, n_micro=4),
    "s2_remat": _s2(I.batch(), pp=2, n_micro=2, remat=True),
    "f_spatial": _f(pp=2, n_micro=2, vv_mode="spatial"),
    "f_batch": _f(pp=2, n_micro=2),
    "f_batch1": _f(pp=2, n_micro=1),
    "f_masked": _f(pp=2, n_micro=2, valid=VALID6),
    "f_mid": _f(pp=2, n_micro=4, vv_mode="spatial", layers=4),
    "errors": ("pp_errors", dict(visual=I.visual, jad=I.jad, table=I.table,
                                 batch=I.batch())),
    # two taps per stage, as ViT-L's four levels at pp = 2
    "eval_2taps": ("pp_predict", dict(
        visual=I.visual4, jad=I.jad4, images=I.images[:4], anchors=I.anchors,
        M=I.M, pp=2, n_micro=2, layers=4, acfg_kwargs=ACFG4)),
    "s2_2taps": ("pp_stage2", dict(
        visual=I.visual4, jad=I.jad4, table=I.table, batch=I.batch(4),
        pp=2, n_micro=2, layers=4, acfg_kwargs=ACFG4)),
}
WORLD4 = {
    "eval_pp4": ("pp_predict", dict(
        visual=I.visual4, jad=I.jad4, images=I.images[:4], anchors=I.anchors,
        M=I.M, pp=4, n_micro=2, layers=4, acfg_kwargs=ACFG4)),
    "eval_dp": _eval(8, pp=2, n_micro=2, dp=2),
    "eval_dp_ps": _eval(8, anchors=I.banchors, pp=2, n_micro=2, dp=2),
    "s2_pp4": ("pp_stage2", dict(
        visual=I.visual4, jad=I.jad4, table=I.table, batch=I.batch(4),
        pp=4, n_micro=2, steps=2, layers=4, acfg_kwargs=ACFG4)),
    **{f"s2_dp_{t}": _s2(I.batch(tail=t), pp=2, n_micro=2, dp=2)
       for t in (None, 2, 4)},
    "f_spatial_dp": _f(pp=2, n_micro=2, dp=2, vv_mode="spatial"),
    "f_mid4": _f(pp=4, n_micro=2, vv_mode="spatial", layers=4),
    "idle": ("pp_idle", dict(visual=I.visual, jad=I.jad, images=I.images,
                             anchors=I.anchors, M=I.M)),
}


def _agree(ranks):
    for other in ranks[1:]:
        for a, b in zip(jax.tree.leaves(ranks[0]), jax.tree.leaves(other)):
            if isinstance(a, (np.ndarray, float)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ----------------------------------------------------------------- the CLIs

EVAL = ["--model_name", "tiny-test", "--img_size", "70", "--dataset",
        "MVTec", "--text_adapt_until", "1", "--image_adapt_until", "1",
        "--levels", "1", "2", "--num_workers", "2", "--batch_size", "4",
        "--precision", "fp32", "--aupro", "--csv", "--dump_scores",
        "--pipeline_parallel", "2"]
TRAIN = ["--model_name", "tiny-test", "--img_size", "70", "--dataset",
         "MVTec", "--text_adapt_until", "1", "--image_adapt_until", "1",
         "--levels", "1", "2", "--num_workers", "2", "--precision", "fp32",
         "--training_mode", "full_shot", "--surgery_until_layer", "2",
         "--text_batch_size", "4", "--image_batch_size", "3",
         "--text_epoch", "1", "--image_epoch", "1",
         "--pipeline_parallel", "2"]


def _cli_setup(root):
    from aaclip_tpu.core.config import get_config as jax_get_config
    from aaclip_tpu_torch.core.config import AdapterConfig, get_config
    from aaclip_tpu_torch.core.params import (adapter_to_jax,
                                              init_image_adapter,
                                              init_text_adapter,
                                              text_adapter_to_jax)
    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
    from aaclip_tpu_torch.train import checkpoint as ckpt
    from tests.test_model_parity import _make_state_dict

    data_root, meta_root = make_synthetic_dataset(root, img_px=64, hard=True)
    cfg = get_config("tiny-test")
    acfg = AdapterConfig(levels=(1, 2), image_adapt_until=1,
                         text_adapt_until=1)
    clip = os.path.join(root, "tiny.pt")
    torch.save(_make_state_dict(jax_get_config("tiny-test", 56), seed=5),
               clip)
    save = {}
    for k in ("jax", "port"):
        save["eval", k] = os.path.join(root, f"eval_{k}")
        ckpt.save_adapter_checkpoint(
            os.path.join(save["eval", k], "image_adapter_1.npz"), 1,
            adapter_to_jax(init_image_adapter(cfg, acfg, seed=3,
                                              device="cpu")))
        save["train", k] = os.path.join(root, f"train_{k}")
        ckpt.save_adapter_checkpoint(
            os.path.join(save["train", k], "image_adapter.npz"), 0,
            adapter_to_jax(init_image_adapter(cfg, acfg, seed=3,
                                              device="cpu")))
        ckpt.save_adapter_checkpoint(
            os.path.join(save["train", k], "text_adapter.npz"), 0,
            text_adapter_to_jax(init_text_adapter(cfg, acfg, seed=4,
                                                  device="cpu")))
    env = {"AACLIP_DATA": data_root, "AACLIP_METADATA": meta_root}
    return env, clip, save


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pp_cli"))
    env, clip, save = _cli_setup(root)
    names = list(WORLD2) + ["cli_eval", "cli_train"]
    cases = list(WORLD2.values()) + [
        ("cli", dict(kind="test", env=env, argv=EVAL + [
            "--clip_checkpoint", clip, "--save_path", save["eval", "port"],
            "--visualize"])),
        ("cli", dict(kind="train", env=env, argv=TRAIN + [
            "--clip_checkpoint", clip, "--save_path",
            save["train", "port"]]))]
    ranks = run_world(2, cases)
    _agree([r[:-1] for r in ranks])
    assert ranks[0][-1] == ranks[1][-1]  # every rank logs the global loss
    return dict(zip(names, ranks[0])), dict(
        env=env, clip=clip, save=save, ranks=ranks)


@pytest.fixture(scope="module")
def world4():
    ranks = run_world(4, list(WORLD4.values()))
    _agree(ranks)
    by_rank = [dict(zip(WORLD4, r)) for r in ranks]
    coords = [r["eval_dp"]["coords"] for r in by_rank]
    idle = [r["idle"][1] for r in by_rank[2:]]
    return dict(zip(WORLD4, ranks[0])), coords, idle


# ------------------------------------------------------------ JAX's side

def _jclip(visual):
    return {"visual": visual}


_BUILT = {}


def _jbuilt(make, visual, cfg, *args, **kw):
    """JAX's pipeline function for this tower and these arguments, built
    once (each build compiles its own programs)."""
    key = (make.__name__, id(visual), cfg.vision.layers, args,
           tuple(sorted(kw.items())))
    if key not in _BUILT:
        _BUILT[key] = make(_jclip(visual), cfg, *args, **kw)
    return _BUILT[key]


def _jpredict(visual, jad, cfg, acfg, n, anchors, **kw):
    fn = _jbuilt(jppl.make_pipeline_predict_fn, visual, cfg, acfg, **kw)
    pix, score = fn(jad, I.images[:n], anchors, I.M)
    return np.asarray(pix), np.asarray(score)


def _close_predict(got, want):
    np.testing.assert_allclose(got["pix"], want[0], **MAP)
    np.testing.assert_allclose(got["score"], want[1], **SCORE)


@pytest.mark.parametrize("n_micro", [2, 4])
def test_pp_eval_matches_jax(world2, n_micro):
    got = world2[0][f"eval{n_micro}"]
    _close_predict(got, _jpredict(I.visual, I.jad, JCFG, JACFG, 8, I.anchors,
                                  pp=2, n_micro=n_micro))
    assert got["coords"] == (0, 0)
    # each rank holds only its stage's blocks
    assert got["blocks"] == (0, 1) and got["n_blocks"] == 1


def test_pp4_four_stage_four_level_tower(world4):
    got = world4[0]["eval_pp4"]
    _close_predict(got, _jpredict(I.visual4, I.jad4, JCFG4, JACFG4, 4,
                                  I.anchors, pp=4, n_micro=2))
    assert got["n_blocks"] == 1


def test_pp_two_taps_per_stage(world2):
    """A 4-layer tower with levels (1, 2, 3, 4) at pp = 2: each stage
    taps twice (ViT-L's layout, 6/12 and 18/24), an adapter in each of
    stage 0's blocks; the predict and a step against JAX's."""
    got = world2[0]["eval_2taps"]
    _close_predict(got, _jpredict(I.visual4, I.jad4, JCFG4, JACFG4, 4,
                                  I.anchors, pp=2, n_micro=2))
    assert got["n_blocks"] == 2
    _close_step(world2[0]["s2_2taps"],
                _jstage2(I.visual4, I.jad4, JCFG4, JACFG4, I.batch(4), pp=2,
                         n_micro=2))


def test_pp_per_sample_anchors(world2):
    _close_predict(world2[0]["per_sample"],
                   _jpredict(I.visual, I.jad, JCFG, JACFG, 4, I.banchors[:4],
                             pp=2, n_micro=2))


@pytest.mark.parametrize("case", ["eval_dp", "eval_dp_ps"])
def test_pp_dp_composition(world4, case):
    anchors = I.anchors if case == "eval_dp" else I.banchors
    _close_predict(world4[0][case],
                   _jpredict(I.visual, I.jad, JCFG, JACFG, 8, anchors, pp=2,
                             n_micro=2, dp=2))


def test_pp_mesh_stage_neighbours_adjacent(world4):
    """Rank d * pp + s is stage s of replica d, as JAX's ``mesh.devices[s,
    d] = devices[d * pp + s]``."""
    assert world4[1] == [(r % 2, r // 2) for r in range(4)]


def test_pp_predict_raw_matches_eval_contract(world2):
    got = world2[0]["eval2"]
    np.testing.assert_array_equal(got["raw_pix"], got["pix"])
    np.testing.assert_array_equal(got["raw_score"], got["score"])


def test_pp_eval_bf16_no_systematic_excess_error(world2):
    """The bf16 pipeline's distance to JAX's fp32 map stays within the
    port's own single-process bf16 band (the JAX file's rule)."""
    from aaclip_tpu_torch.core.config import AdapterConfig, DtypePolicy
    from aaclip_tpu_torch.core.config import get_config
    from aaclip_tpu_torch.core.params import adapter_from_jax, params_from_jax
    from aaclip_tpu_torch.eval.predict import make_predict_fn

    cfg = get_config("tiny-test")
    acfg = AdapterConfig(levels=(1, 2), image_adapt_until=1)
    vit = params_from_jax(I.visual, cfg, device="cpu")
    ad = adapter_from_jax(I.jad, cfg, acfg, device="cpu")
    pix_b, score_b = make_predict_fn(vit, cfg, acfg, policy=DtypePolicy.bf16(),
                                     device="cpu")(ad, I.images[:4],
                                                   I.anchors, I.M)
    pix_ref, score_ref = _jpredict(I.visual, I.jad, JCFG, JACFG, 4,
                                   I.anchors, pp=2, n_micro=2,
                                   policy=JPolicy.fp32())
    got = world2[0]["bf16"]
    band = np.abs(pix_b.numpy() - pix_ref).max()
    assert np.abs(got["pix"] - pix_ref).max() <= 1.5 * band + 1e-4
    sband = np.abs(score_b.numpy() - score_ref).max()
    assert np.abs(got["score"] - score_ref).max() <= 1.5 * sband + 1e-5


def test_pp_validation(world2):
    """The make_* functions' refusals carry JAX's messages (test_pp_validation,
    test_pp_stage1_validation, test_pp_stage2_validation)."""
    e = world2[0]["errors"]
    for key, match in [
            ("pp3", "must divide the level count"), ("mesh1", "needs 2"),
            ("mesh_dp", "pp*dp"), ("spacing", "evenly spaced"),
            ("staged", "staged-precision"), ("int8", "int8"),
            ("no_levels", "at least one level"),
            ("ragged", "not divisible by n_micro"),
            ("raw_ragged", "not divisible by n_micro"),
            ("depth", "stack depth"), ("s1_pp3", "must divide"),
            ("s1_dp", "dp > 1"), ("s1_vv_fn", "custom vv_attn_fn"),
            ("s1_mode", "vv_mode"), ("s1_ragged", "not divisible by n_micro"),
            ("s2_pp3", "must divide the level count"),
            ("s2_selective", "remat=True/False only"),
            ("s2_ragged", "not divisible by n_micro")]:
        assert match in e.get(key, ""), (key, e)


# ----------------------------------------------------------------- stage 2

TX = joptim.make_image_optimizer(1e-3)


def _jstage2(visual, jad, cfg, acfg, batch, steps=1, **kw):
    tx = TX
    key = ("stage2", id(visual), cfg.vision.layers, tuple(sorted(kw.items())))
    if key not in _BUILT:
        _BUILT[key] = jppl.make_pp_stage2_step(_jclip(visual), cfg, acfg, tx,
                                               I.table, **kw)
    step = _BUILT[key]
    st, losses = init_state(jad, tx), []
    for _ in range(steps):
        st, loss = step(st, *batch)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, st.params)


def _close_step(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    assert not np.isnan(got[0]).any()
    for a, b in zip(jax.tree.leaves(got[1]), jax.tree.leaves(want[1])):
        np.testing.assert_allclose(a, b, atol=ADAPTER_ATOL, rtol=0)


@pytest.mark.parametrize("n_micro", [2, 4])
def test_pp_stage2_step_matches_jax(world2, n_micro):
    _close_step(world2[0][f"s2_{n_micro}"],
                _jstage2(I.visual, I.jad, JCFG, JACFG, I.batch(), pp=2,
                         n_micro=n_micro))


def test_pp_stage2_remat_matches_single_process_grad_accum(world2):
    """Full remat gives the update of JAX's single-process step with
    ``grad_accum = n_micro``."""
    tx = joptim.make_image_optimizer(1e-3)
    step = j_make_stage2_step(_jclip(I.visual), JCFG, JACFG, tx, I.table,
                              grad_accum=2)
    st, loss = step(init_state(I.jad, tx),
                    *(jnp.asarray(a) for a in I.batch()))
    _close_step(world2[0]["s2_remat"],
                ([float(loss)], jax.tree.map(np.asarray, st.params)))


def test_pp_stage2_multi_step_and_cross_stage_adapters(world4):
    """Two steps on four stages, a real adapter on stage 1 (which runs
    before any microbatch reaches the last stage)."""
    _close_step(world4[0]["s2_pp4"],
                _jstage2(I.visual4, I.jad4, JCFG4, JACFG4, I.batch(4),
                         steps=2, pp=4, n_micro=2))


@pytest.mark.parametrize("valid_tail", [None, 2, 4])
def test_pp_dp_stage2_step_matches_jax(world4, valid_tail):
    """pp = 2 x dp = 2, with ragged batches: valid_tail 4 makes the second
    microbatch all padding, out of the loss and the mean."""
    _close_step(world4[0][f"s2_dp_{valid_tail}"],
                _jstage2(I.visual, I.jad, JCFG, JACFG,
                         I.batch(tail=valid_tail), pp=2, n_micro=2, dp=2))


# ----------------------------------------------------------------- stage 1

def _jfeats(visual, cfg, n=8, valid=None, **kw):
    fn = jppl.make_pp_stage1_features_fn(_jclip(visual), cfg,
                                         surgery_until_layer=2, **kw)
    return np.asarray(fn(I.images[:n], valid))


@pytest.mark.parametrize("case,dp", [("f_spatial", 1), ("f_spatial_dp", 2)])
def test_pp_stage1_spatial_matches_jax(world2, world4, case, dp):
    got = (world2 if dp == 1 else world4)[0][case]
    np.testing.assert_allclose(got, _jfeats(I.visual, JCFG, pp=2, n_micro=2,
                                            dp=dp, vv_mode="spatial"),
                               **FEATS)


@pytest.mark.parametrize("n_micro", [2, 1])
def test_pp_stage1_batch_mode_couples_per_microbatch(world2, n_micro):
    """Batch mode couples the V-V softmax per microbatch; one microbatch
    is the single-process batch mode."""
    got = world2[0][f"f_batch{'' if n_micro == 2 else 1}"]
    np.testing.assert_allclose(got, _jfeats(I.visual, JCFG, pp=2,
                                            n_micro=n_micro), **FEATS)
    if n_micro == 1:
        single = j_features_fn(_jclip(I.visual), JCFG, surgery_until_layer=2,
                               policy=JPolicy.fp32())
        np.testing.assert_allclose(got, np.asarray(single(I.images)),
                                   **FEATS)


def test_pp_stage1_reaches_ranks_outside_the_mesh(world4):
    """pp = 2 on a world of 4 (the training CLI's stage 1 in batch mode
    under ``--data_parallel``): ranks 2 and 3 are in no group, receive the
    features of the lead replica's last stage (every rank agrees bit for
    bit) and refuse to build a predictor."""
    feats, (rank, err) = world4[0]["idle"]
    np.testing.assert_allclose(feats, _jfeats(I.visual, JCFG, pp=2,
                                              n_micro=2), **FEATS)
    assert rank == 0 and err is None
    assert world4[2] == [(2, "rank 2 is outside the pp*dp=2 mesh"),
                         (3, "rank 3 is outside the pp*dp=2 mesh")]


def test_pp_stage1_batch_masked_tail(world2):
    keep = VALID6.astype(bool)
    want = _jfeats(I.visual, JCFG, valid=VALID6, pp=2, n_micro=2)
    np.testing.assert_allclose(world2[0]["f_masked"][keep], want[keep],
                               **FEATS)


@pytest.mark.parametrize("pp,n_micro", [(2, 4), (4, 2)])
def test_pp_stage1_mid_stage_vv_boundary(world2, world4, pp, n_micro):
    """A 4-layer tower with the V-V start at 3: inside stage 1 at pp = 2,
    every layout at pp = 4."""
    got = world2[0]["f_mid"] if pp == 2 else world4[0]["f_mid4"]
    np.testing.assert_allclose(got, _jfeats(I.visual4, JCFG4, pp=pp,
                                            n_micro=n_micro,
                                            vv_mode="spatial"), **FEATS)


# --------------------------------------------------------------- the CLIs

@pytest.fixture(scope="module")
def jax_cli(world2):
    """JAX's ``test.py`` and ``train.py`` with the same flags (its
    pipeline on 2 of its 8 devices)."""
    import aaclip_tpu.utils.profiling as jprof

    from tests.test_torch_train_cli import _recording

    ctx = world2[1]
    env, clip, save = ctx["env"], ctx["clip"], ctx["save"]
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    losses = []
    mp = pytest.MonkeyPatch()
    mp.setattr(jprof, "ThrottledLossDrain", _recording(jprof, losses))
    try:
        import test as jax_eval
        import train as jax_train

        jax_eval.main(EVAL + ["--clip_checkpoint", clip, "--save_path",
                              save["eval", "jax"], "--visualize"])
        jax_train.main(TRAIN + ["--clip_checkpoint", clip, "--save_path",
                                save["train", "jax"]])
    finally:
        mp.undo()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return losses


def test_eval_cli_pipeline_matches_jax(world2, jax_cli):
    from tests.test_torch_eval_cli import POINTS_ATOL, SCORE_ATOL, _read_csv

    save = world2[1]["save"]
    j = _read_csv(os.path.join(save["eval", "jax"], "results_1.csv"))
    p = _read_csv(os.path.join(save["eval", "port"], "results_1.csv"))
    assert p[0] == j[0] and [r[0] for r in p] == [r[0] for r in j]
    np.testing.assert_allclose([[float(c) for c in r[1:]] for r in p[1:]],
                               [[float(c) for c in r[1:]] for r in j[1:]],
                               atol=POINTS_ATOL, rtol=0)
    j = _read_csv(os.path.join(save["eval", "jax"], "scores_1.csv"))
    p = _read_csv(os.path.join(save["eval", "port"], "scores_1.csv"))
    assert [r[:3] for r in p] == [r[:3] for r in j] and len(p) == 13
    np.testing.assert_allclose([float(r[3]) for r in p[1:]],
                               [float(r[3]) for r in j[1:]],
                               atol=SCORE_ATOL, rtol=0)
    with open(os.path.join(save["eval", "port"], "test.log")) as f:
        log = f.read()
    assert "mesh: stage=2 x data=1 (GPipe, 2 microbatches)" in log
    # --visualize: one panel per image, the names JAX's
    pan = {k: sorted(os.listdir(os.path.join(
        save["eval", k], "visualization", "MVTec", "bottle")))
        for k in ("jax", "port")}
    assert pan["port"] == pan["jax"] and len(pan["port"]) == 6


def test_train_cli_pipeline_matches_jax(world2, jax_cli):
    """One text epoch (batch-mode V-V coupled per microbatch) and one image
    epoch at batch 3, rounded up to 4 (two microbatches)."""
    save, port_losses = world2[1]["save"], world2[0]["cli_train"]
    assert [len(e) for e in port_losses] == [len(e) for e in jax_cli]
    np.testing.assert_allclose(np.concatenate(port_losses),
                               np.concatenate(jax_cli), rtol=LOSS_RTOL)
    for f in ("text_adapter.npz", "image_adapter_1.npz"):
        with np.load(os.path.join(save["train", "jax"], f)) as j, \
                np.load(os.path.join(save["train", "port"], f)) as p:
            assert sorted(j.files) == sorted(p.files)
            for k in j.files:
                if k.startswith("adapter/"):
                    np.testing.assert_allclose(p[k], j[k], atol=ADAPTER_ATOL,
                                               rtol=0, err_msg=k)
    with open(os.path.join(save["train", "port"], "train.log")) as f:
        log = f.read()
    assert "image_batch_size rounded up to 4" in log
    shutil.rmtree(os.path.join(save["train", "port"]), ignore_errors=True)
