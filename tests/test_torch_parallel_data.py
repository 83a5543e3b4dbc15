"""The port's data parallelism (aaclip_tpu_torch/parallel/sharding.py and
the mesh paths of the predictor, both training steps and the memory bank)
against the JAX package's on its 8-device CPU mesh (``make_data_mesh(2)``),
on the CPU.

The port's ranks run as one 2-process gloo world (``tests/
torch_parallel_worker.py``, 120 s timeout), every case of this file in it;
each rank returns the global result, and both ranks must agree bit for
bit. Bars:
* predict and the memory bank: atol 1e-4, rtol 1e-5 (test_torch_model's
  fp32 bar); the banks atol 1e-5;
* stage-2 and stage-1 steps: losses rtol 1e-5, adapters atol 1e-5 after
  the last step, leaving out entries whose first gradient is below 1e-6 of
  its leaf's max (test_torch_train's rule), at most 0.1% of them;
* stage-1 features: atol 1e-5, rtol 1e-5 (test_torch_stage1's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aaclip_tpu.core.config import AdapterConfig as JAdapterConfig
from aaclip_tpu.core.config import DtypePolicy as JPolicy
from aaclip_tpu.core.config import get_config as jget_config
from aaclip_tpu.core.params import init_adapter_params
from aaclip_tpu.eval import memory_bank as jmb
from aaclip_tpu.eval.predict import make_predict_fn as j_make_predict_fn
from aaclip_tpu.ops.similarity import fused_postproc_matrix
from aaclip_tpu.parallel import sharding as jsh
from aaclip_tpu.text.anchors import dataset_prompt_tokens
from aaclip_tpu.train import optim as joptim
from aaclip_tpu.train.steps import init_state
from aaclip_tpu.train.steps import make_stage1_step as j_make_stage1_step
from aaclip_tpu.train.steps import make_stage2_step as j_make_stage2_step
from aaclip_tpu.train.steps import stage1_features_fn as j_features_fn
from aaclip_tpu_torch.parallel import sharding as sh
from tests.test_torch_layers import perturbed_clip_tree, perturbed_text_tree
from tests.torch_parallel_worker import run_world

JCFG = jget_config("tiny-test")
JACFG = JAdapterConfig(levels=(1, 2), image_adapt_until=1, text_adapt_until=1)
ATOL, RTOL = 1e-4, 1e-5


class Inputs:
    def __init__(self, seed=0):
        self.visual = perturbed_clip_tree("tiny-test", seed=seed)
        self.text = perturbed_text_tree("tiny-test", seed=seed)
        ads = jax.tree.map(np.asarray, init_adapter_params(
            jax.random.PRNGKey(seed + 1), JCFG, JACFG))
        self.jad, self.tad = ads["image"], ads["text"]
        rng = np.random.default_rng(seed + 2)
        self.images = rng.standard_normal((8, 3, 70, 70)).astype(np.float32)
        self.mask = (rng.random((8, 70, 70)) > 0.8).astype(np.float32)
        self.label = rng.integers(0, 2, 8).astype(np.int32)
        self.cidx = rng.integers(0, 2, 8).astype(np.int32)
        table = rng.standard_normal((2, 32, 2)).astype(np.float32)
        self.table = table / np.linalg.norm(table, axis=1, keepdims=True)
        self.anchors = self.table[0]
        self.M = np.asarray(fused_postproc_matrix(5, 70, "Industrial"))
        self.support = rng.standard_normal((5, 3, 70, 70)).astype(np.float32)
        self.tokens = dataset_prompt_tokens("MVTec", ["bottle", "cable"])

    def batch(self, n, valid):
        return (self.images[:n], self.mask[:n], self.label[:n],
                self.cidx[:n], np.asarray(valid, np.float32))


INPUTS = Inputs()
FULL4, RAGGED4 = [1, 1, 1, 1], [1, 1, 1, 0]
RAGGED8 = [1, 1, 1, 1, 1, 0, 0, 0]  # grad_accum 2: a ragged second half


@pytest.fixture(scope="module")
def jax_feats():
    """JAX's batch-mode features of the first 4 images with the masked
    tail (the stage-1 steps' input)."""
    fn = j_features_fn({"visual": INPUTS.visual}, JCFG, surgery_until_layer=2,
                       policy=JPolicy.fp32())
    return np.asarray(fn(jnp.asarray(INPUTS.images[:4]),
                         jnp.asarray(RAGGED4, jnp.float32)))


CASES = {
    "predict": ("predict", dict(images=INPUTS.images[:4])),
    "predict_uint8": ("predict", dict(
        images=(np.abs(INPUTS.images[:4]) * 60).astype(np.uint8),
        uint8=True)),
    "mb": ("mb_predict", dict(support=INPUTS.support,
                              images=INPUTS.images[:4])),
    "s2": ("stage2", dict(batch=INPUTS.batch(4, FULL4))),
    "s2_ragged": ("stage2", dict(batch=INPUTS.batch(4, RAGGED4))),
    "s2_accum": ("stage2", dict(batch=INPUTS.batch(8, RAGGED8),
                                grad_accum=2)),
    "s2_selective": ("stage2", dict(batch=INPUTS.batch(4, RAGGED4),
                                    remat="selective")),
    "s2_full_remat": ("stage2", dict(batch=INPUTS.batch(4, FULL4),
                                     remat=True, steps=1)),
    "f_batch": ("stage1_features", dict(images=INPUTS.images[:4],
                                        valid=np.float32(RAGGED4))),
    "f_spatial": ("stage1_features", dict(images=INPUTS.images[:4],
                                          vv_mode="spatial", chunk=1)),
}


def _kwargs(kind, kw, feats=None):
    base = dict(tp=1)
    if kind in ("predict", "mb_predict", "stage2"):
        base.update(visual=INPUTS.visual, jad=INPUTS.jad)
    if kind in ("predict", "mb_predict"):
        base.update(anchors=INPUTS.anchors, M=INPUTS.M)
    if kind == "stage2":
        base.update(table=INPUTS.table)
    if kind == "stage1_features":
        base.update(visual=INPUTS.visual)
    return {**base, **kw}


@pytest.fixture(scope="module")
def world(jax_feats):
    names = list(CASES)
    cases = [(kind, _kwargs(kind, kw)) for kind, kw in CASES.values()]
    names.append("s1")
    cases.append(("stage1", dict(
        tp=1, text=INPUTS.text, tad=INPUTS.tad, tokens=INPUTS.tokens,
        feats=jax_feats, mask=INPUTS.mask[:4], class_idx=INPUTS.cidx[:4],
        valid=np.float32(RAGGED4),
        acfg_kwargs=dict(levels=(1, 2), image_adapt_until=1,
                         text_adapt_until=1))))
    names.append("errors")
    cases.append(("mesh_errors", {}))
    ranks = run_world(2, cases)
    for other in ranks[1:]:
        for a, b in zip(jax.tree.leaves(ranks[0]), jax.tree.leaves(other)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return dict(zip(names, ranks[0]))


def assert_adapter_close(got_tree, jparams, first_grad, atol=1e-5):
    got = jax.tree.leaves(got_tree)
    want = [np.asarray(x) for x in jax.tree.leaves(jparams)]
    left_out = 0
    for g, w, g0 in zip(got, want, jax.tree.leaves(first_grad)):
        keep = np.abs(g0) >= 1e-6 * np.abs(g0).max()
        left_out += int((~keep).sum())
        np.testing.assert_allclose(g[keep], w[keep], atol=atol, rtol=0)
    n = sum(np.size(x) for x in jax.tree.leaves(first_grad))
    assert left_out <= 0.001 * n, (left_out, n)


def jmesh():
    return jsh.make_data_mesh(2)


@pytest.mark.parametrize("name", ["predict", "predict_uint8"])
def test_dp_predict_matches_jax_mesh(world, name):
    kw = CASES[name][1]
    mesh = jmesh()
    fn = j_make_predict_fn({"visual": INPUTS.visual}, JCFG, JACFG,
                           policy=JPolicy.fp32(), mesh=mesh,
                           uint8_inputs=kw.get("uint8", False))
    jpix, jscore = fn(INPUTS.jad, jsh.shard_batch(mesh, kw["images"]),
                      jnp.asarray(INPUTS.anchors), jnp.asarray(INPUTS.M))
    pix, score = world[name]
    assert pix.shape == (4, 70, 70) and score.shape == (4,)
    np.testing.assert_allclose(pix, np.asarray(jpix), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(score, np.asarray(jscore), atol=ATOL,
                               rtol=RTOL)


def test_dp_memory_bank_matches_jax_mesh(world):
    mesh = jmesh()
    fn = jmb.make_mb_predict_fn({"visual": INPUTS.visual}, JCFG, JACFG,
                                policy=JPolicy.fp32(), bank_weight=0.5,
                                chunk=7, mesh=mesh)
    bank = jmb.collect_bank(fn.features_fn, INPUTS.jad, INPUTS.support,
                            batch_size=3)
    jpix, jscore = fn(INPUTS.jad, jsh.shard_batch(mesh, INPUTS.images[:4]),
                      jnp.asarray(INPUTS.anchors), jnp.asarray(INPUTS.M),
                      bank)
    got_bank, pix, score = world["mb"]
    np.testing.assert_allclose(got_bank, np.asarray(bank), atol=1e-5)
    np.testing.assert_allclose(pix, np.asarray(jpix), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(score, np.asarray(jscore), atol=ATOL,
                               rtol=RTOL)


def jax_stage2(batch, steps, grad_accum=1, remat=False):
    tx = joptim.make_image_optimizer(1e-3, milestones=(2, 4))
    mesh = jmesh()
    step = j_make_stage2_step({"visual": INPUTS.visual}, JCFG, JACFG, tx,
                              INPUTS.table, policy=JPolicy.fp32(),
                              remat=remat, grad_accum=grad_accum)
    state = init_state(jsh.replicate_tree(mesh, INPUTS.jad), tx)
    sharded = jsh.shard_batch(mesh, *batch)
    losses = []
    for _ in range(steps):
        state, loss = step(state, *sharded)
        losses.append(float(loss))
    return losses, state.params


@pytest.mark.parametrize("name", ["s2", "s2_ragged", "s2_accum",
                                  "s2_selective", "s2_full_remat"])
def test_dp_stage2_step_matches_jax_mesh(world, name):
    kw = CASES[name][1]
    want, params = jax_stage2(kw["batch"], kw.get("steps", 2),
                              kw.get("grad_accum", 1),
                              kw.get("remat", False))
    losses, first, adapters = world[name]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert_adapter_close(adapters, params, first)


@pytest.mark.parametrize("name", ["f_batch", "f_spatial"])
def test_dp_stage1_features_match_jax_mesh(world, name, jax_feats):
    kw = CASES[name][1]
    mesh = jmesh()
    fn = j_features_fn({"visual": INPUTS.visual}, JCFG, surgery_until_layer=2,
                       policy=JPolicy.fp32(),
                       vv_mode=kw.get("vv_mode", "batch"))
    if name == "f_batch":
        # the masked tail's features: the cross-batch softmax spans the
        # ranks' rows, masked by the gathered valid
        images, valid = jsh.shard_batch(mesh, kw["images"], kw["valid"])
        want = np.asarray(fn(images, valid))
        np.testing.assert_allclose(want, jax_feats, atol=1e-6)
    else:
        want = np.asarray(fn(jsh.shard_batch(mesh, kw["images"])))
    np.testing.assert_allclose(world[name], want, atol=1e-5, rtol=1e-5)


def test_dp_stage1_step_matches_jax_mesh(world, jax_feats):
    tx = joptim.make_text_optimizer(1e-3)
    mesh = jmesh()
    clip = {"visual": INPUTS.visual, "text": INPUTS.text}
    step = j_make_stage1_step(clip, JCFG, JACFG, tx, INPUTS.tokens,
                              policy=JPolicy.fp32())
    state = init_state(jsh.replicate_tree(mesh, INPUTS.tad), tx)
    batch = jsh.shard_batch(mesh, jax_feats, INPUTS.mask[:4],
                            INPUTS.cidx[:4], np.float32(RAGGED4))
    want = []
    for _ in range(2):
        state, loss = step(state, *batch)
        want.append(float(loss))
    losses, first, adapters = world["s1"]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert_adapter_close(adapters, state.params, first)


def test_mesh_sizes_are_checked_as_in_jax(world):
    errors = world["errors"]
    assert "must divide device count 2" in errors["tp3"]
    assert errors["shape"] == {"data": 1, "model": 2}
    assert errors["rank_order"] == [(0, 0), (0, 1)]
    assert "not divisible by data-parallel size 2" in errors["ragged"]


def test_pad_batch_to_devices_matches_jax():
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((6, 3)).astype(np.float32),
              np.arange(6, dtype=np.int32)]
    valid = np.ones((6,), np.float32)
    for n in (1, 2, 4, 8):
        got, gv = sh.pad_batch_to_devices(arrays, valid, n)
        want, wv = jsh.pad_batch_to_devices(arrays, valid, n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(gv, wv)
    with pytest.raises(ValueError, match="leading dims differ"):
        sh.pad_batch_to_devices([arrays[0], arrays[1][:5]], valid, 4)
    with pytest.raises(ValueError, match="valid mask length"):
        sh.pad_batch_to_devices(arrays, valid[:5], 4)


class _Indexed:
    """A dataset whose sample ``i`` carries ``i`` as its label."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, i, epoch):
        return {"image": np.full((2,), i, np.float32),
                "mask": np.zeros((2,), np.float32), "label": i,
                "class_name": "c", "file_name": str(i)}


@pytest.mark.parametrize("n,batch,hosts", [(12, 4, 2), (12, 3, 2),
                                           (11, 6, 4), (5, 4, 2),
                                           (7, 2, 4)])
def test_loader_deals_each_global_batch(n, batch, hosts):
    """``BatchLoader(deal_batches=True)``: host r takes rows r, r + hosts,
    ... of each global batch, ``ceil(batch / hosts)`` of them, so the
    hosts' batches interleaved are the one-host loader's batches padded
    as JAX's ``pad_batch_to_devices`` pads them, with that validity; a
    host's rows past its valid ones repeat its last loaded row, and the
    hosts together load each sample once."""
    from aaclip_tpu_torch.data.datasets import BatchLoader

    kw = dict(shuffle=True, seed=7, num_workers=1)
    one = list(BatchLoader(_Indexed(n), batch, **kw))
    per_host = [list(BatchLoader(_Indexed(n), batch, host_id=r,
                                 num_hosts=hosts, deal_batches=True, **kw))
                for r in range(hosts)]
    rows = -(-batch // hosts)
    assert [len(h) for h in per_host] == [len(one)] * hosts
    for i, b in enumerate(one):
        valid = (np.arange(batch) < b["n_valid"]).astype(np.float32)
        (labels,), valid = jsh.pad_batch_to_devices([b["label"]], valid,
                                                    hosts)
        got = [h[i] for h in per_host]
        assert all(g["label"].shape == (rows,) for g in got)
        keep = np.stack([np.arange(rows) < g["n_valid"] for g in got],
                        1).reshape(-1)
        np.testing.assert_array_equal(keep, valid.astype(bool))
        np.testing.assert_array_equal(
            np.stack([g["label"] for g in got], 1).reshape(-1)[keep],
            labels[keep])
        for r, g in enumerate(got):
            v = max(g["n_valid"], 1)
            want = labels[r::hosts][v - 1]
            assert (g["label"][v - 1:] == want).all(), (r, g["label"])
    loads = []
    for r in range(hosts):
        loader = BatchLoader(_Indexed(n), batch, host_id=r, num_hosts=hosts,
                             deal_batches=True, **kw)
        loads += [int(i) for b, _ in loader.batches() for i in b]
    empty = sum(h[i]["n_valid"] == 0 for h in per_host
                for i in range(len(one)))
    assert sorted(set(loads)) == list(range(n)) and len(loads) == n + empty
