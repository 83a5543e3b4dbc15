"""The port's on-card augment (``ops/augment.py``) and device-resident
training set (``data/device_cache.py``), run on the CPU, against the JAX
package's ``ops/augment.py`` and the host transforms.

Bars:
* ``_nearest_affine_one`` and ``jitter_chain``: bit for bit against JAX's
  for the same parameters (the JAX twin takes the rotation's cosine in
  float32 where the port takes it in float64 as the host does: the
  gathered pixels are compared, which agree unless a source coordinate
  lands on a rounding tie);
* the composed geometric augment with fixed parameters, float and packed
  uint8 paths, bit for bit against the host's ``apply_geometric`` on the
  normalised image (the uint8 path normalises after its gather); the
  card's ``jitter_chain`` bit for bit against the host's (Pillow's);
* the draws: angles in [-30, 30], integer offsets within 0.15 of the
  side, jitter factors in [0.5, 1.5], each stage both on and off;
* ``DeviceCacheLoader``: its plan is ``BatchLoader``'s (permutation,
  padding, ``valid``) over 3 epochs, its cached pixels the host's, and
  a text-stage batch equals the host path's uint8 batch put through
  ``make_device_augment`` with the same generator;
* ``make_fused_step`` (``--fused_assemble``): an epoch of the fused loop
  equals the unfused loop bit for bit (losses, adapters, the Adam state
  and the schedule), and fed the batches JAX's ``make_fused_step``
  assembled from the same cache and plan (the draws are the two
  packages' own), its losses and adapters follow JAX's fused loop within
  the stage-2 step's bars (``test_torch_train.py``: loss rtol 1e-5,
  adapters atol 1e-5).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.ops import augment as jaug
from aaclip_tpu_torch.data import datasets
from aaclip_tpu_torch.data import transforms as T
from aaclip_tpu_torch.data.device_cache import DeviceCacheLoader, cache_nbytes
from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
from aaclip_tpu_torch.ops import augment as aug


@pytest.mark.parametrize("angle,ty,tx", [
    (17.3, 0.0, 0.0), (-29.9, 0.0, 0.0), (0.0, 4.0, -6.0), (45.0, 0.0, 0.0),
    (-12.25, -3.0, 5.0), (0.0, 0.0, 0.0),
])
def test_nearest_affine_one_equals_jax_and_the_host(angle, ty, tx):
    rng = np.random.default_rng(0)
    x = rng.random((4, 33, 37)).astype(np.float32)
    got = aug._nearest_affine_one(torch.from_numpy(x), angle, ty, tx).numpy()
    want = np.asarray(jaug._nearest_affine_one(
        jnp.asarray(x), jnp.float32(angle), jnp.float32(ty),
        jnp.float32(tx)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, T._affine_nearest(x.copy(), angle,
                                                         (ty, tx)))


def test_nearest_affine_one_at_random_angles_equals_jax():
    rng = np.random.default_rng(1)
    for i in range(30):
        x = rng.random((2, 30, 26)).astype(np.float32)
        angle = float(np.float32(rng.uniform(-30, 30)))
        got = aug._nearest_affine_one(torch.from_numpy(x), angle, 0.0, 0.0)
        want = jaug._nearest_affine_one(jnp.asarray(x), jnp.float32(angle),
                                        jnp.float32(0), jnp.float32(0))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _u8_batch(rng, B, H, W):
    imgs = rng.integers(0, 256, (B, 3, H, W), dtype=np.uint8)
    imgs[0] //= 5  # a dark image: brightness and contrast clip differently
    return imgs


@pytest.mark.parametrize("factors", [(1.0, 1.0, 1.0), (0.5, 1.5, 1.0),
                                     (1.5, 0.5, 1.5), (0.75, 1.25, 0.625)])
def test_jitter_chain_equals_jax_and_the_host(factors):
    rng = np.random.default_rng(2)
    imgs = _u8_batch(rng, 3, 21, 17)
    f = [torch.full((3,), v) for v in factors]
    got = aug.jitter_chain(torch.from_numpy(imgs), *f).numpy()
    for b in range(3):
        want = np.asarray(jaug.jitter_chain(jnp.asarray(imgs[b]),
                                            *map(jnp.float32, factors)))
        np.testing.assert_array_equal(got[b], want)
        host = T.jitter_chain(imgs[b].transpose(1, 2, 0), *factors)
        np.testing.assert_array_equal(got[b], host.transpose(2, 0, 1))


def test_jitter_chain_equals_the_host_at_drawn_factors():
    rng = np.random.default_rng(3)
    imgs = _u8_batch(rng, 64, 9, 11)
    gen = torch.Generator().manual_seed(0)
    fb, fc, fs = aug.jitter_params(gen, 64)
    got = aug.jitter_chain(torch.from_numpy(imgs), fb, fc, fs).numpy()
    for b in range(64):
        host = T.jitter_chain(imgs[b].transpose(1, 2, 0), float(fb[b]),
                              float(fc[b]), float(fs[b]))
        np.testing.assert_array_equal(got[b], host.transpose(2, 0, 1))


def _params(B, H, W, seed):
    return aug.geometric_params(torch.Generator().manual_seed(seed), B, H, W)


def test_composed_augment_equals_the_host_stages():
    rng = np.random.default_rng(4)
    B, H, W = 48, 29, 23
    imgs_u8 = _u8_batch(rng, B, H, W)
    masks_u8 = (rng.random((B, H, W)) > 0.6).astype(np.uint8)
    params = _params(B, H, W, 1)
    norm = np.stack([T.normalize_uint8_chw(im) for im in imgs_u8])
    f_img, f_mask = aug.geometric_augment(
        torch.from_numpy(norm), torch.from_numpy(masks_u8).float(), params)
    u_img, u_mask, valid = aug.geometric_augment_u8(
        torch.from_numpy(imgs_u8), torch.from_numpy(masks_u8), params)
    u_img = aug.normalize_valid(u_img, valid)
    u_mask = u_mask.float() * valid.float()
    for b in range(B):
        p = [float(t[b]) if t.dtype != torch.bool else bool(t[b])
             for t in params]
        host = T.apply_geometric(
            np.concatenate([norm[b], masks_u8[b][None].astype(np.float32)]),
            *p)
        for img, mask in ((f_img, f_mask), (u_img, u_mask)):
            np.testing.assert_array_equal(img[b].numpy(), host[:3])
            np.testing.assert_array_equal(mask[b].numpy(), host[3])
    # and bit for bit, not only equal in value: zero fill keeps the sign
    assert torch.equal(f_img.view(torch.int32), u_img.view(torch.int32))


def test_device_augment_uint8_equals_float_path():
    rng = np.random.default_rng(5)
    B, H, W = 6, 20, 20
    imgs_u8 = _u8_batch(rng, B, H, W)
    masks_u8 = (rng.random((B, H, W)) > 0.5).astype(np.uint8)
    norm = torch.from_numpy(np.stack([T.normalize_uint8_chw(im)
                                      for im in imgs_u8]))
    a = aug.make_device_augment(uint8_inputs=True)(
        torch.Generator().manual_seed(7), torch.from_numpy(imgs_u8),
        torch.from_numpy(masks_u8))
    b = aug.make_device_augment()(torch.Generator().manual_seed(7), norm,
                                  torch.from_numpy(masks_u8).float())
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == torch.float32
        assert torch.equal(x, y)


def test_draws_fall_within_their_ranges():
    B, H, W = 4000, 40, 60
    angle, ty, tx, hflip, vflip = _params(B, H, W, 3)
    assert angle.dtype == torch.float64 and hflip.dtype == torch.bool
    assert angle.abs().max() <= 30 and (angle == 0).any() and \
        (angle != 0).any()
    for t, side in ((ty, H), (tx, W)):
        assert (t == t.round()).all() and t.abs().max() <= round(0.15 * side)
        assert (t == 0).float().mean() > 0.4 and (t != 0).any()
    for flip in (hflip, vflip):
        assert 0.45 < flip.float().mean() < 0.55
    fb, fc, fs = aug.jitter_params(torch.Generator().manual_seed(4), B)
    for f in (fb, fc, fs):
        on = f != 1.0
        assert 0.65 < on.float().mean() < 0.75
        assert f.min() >= 0.5 and f.max() <= 1.5
    g1 = aug.augment_generator(111, 2, 0, 5, "cpu")
    g2 = aug.augment_generator(111, 2, 0, 5, "cpu")
    g3 = aug.augment_generator(111, 2, 1, 5, "cpu")
    x = torch.rand(4, generator=g1)
    assert torch.equal(x, torch.rand(4, generator=g2))
    assert not torch.equal(x, torch.rand(4, generator=g3))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("augment"))
    data_root, meta_root = make_synthetic_dataset(root, img_px=48,
                                                  n_normal=4, n_anomalous=3)
    env = {"AACLIP_DATA": data_root, "AACLIP_METADATA": meta_root}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    yield root
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_cache_loader_plan_is_the_batch_loader_s(synth):
    ds = datasets.get_train_datasets("MVTec", 42, -1, seed=2)[1]
    cls_to_idx = {"bottle": 0, "cable": 1}
    cache = DeviceCacheLoader(ds, cls_to_idx, 4, seed=8, text_stage=False,
                              aug_seed=1, device="cpu", num_workers=2)
    host = datasets.BatchLoader(ds, 4, shuffle=True, seed=8)
    assert cache_nbytes(14, 42) == 14 * 4 * 42 * 42 + 14 * 8
    seen = []
    for _ in range(3):
        plan = host.batches()
        batches = list(cache)
        host.epoch += 1
        assert len(batches) == len(plan) == len(cache) == 4
        for (images, mask, label, cidx, valid), (idx, n_valid) in zip(
                batches, plan):
            assert images.shape == (4, 3, 42, 42) and mask.shape == (4, 42,
                                                                    42)
            assert valid.tolist() == [1.0] * n_valid + [0.0] * (4 - n_valid)
            padded = np.concatenate([idx, np.repeat(idx[-1:],
                                                    4 - idx.size)])
            recs = [ds.records[i] for i in padded]
            assert label.tolist() == [r.label for r in recs]
            assert cidx.tolist() == [cls_to_idx[r.class_name] for r in recs]
        seen.append(plan[0][0].tolist())
    assert cache.epoch == 3 and seen[0] != seen[1]
    # the cache holds the host's resized pre-jitter pixels
    for i in (0, 13):
        r = ds.records[i]
        img, mask = T.preprocess_train(
            os.path.join(ds.spec.data_path, r.image_path),
            os.path.join(ds.spec.data_path, r.mask_path)
            if r.mask_path else None, 42, r.label, None, True,
            geometric=False, uint8=True)
        assert torch.equal(cache._imgs[i], torch.from_numpy(img))
        assert torch.equal(cache._masks[i], torch.from_numpy(mask[0]))


def test_cache_text_batch_equals_the_host_device_augment_path(synth):
    text_ds, _ = datasets.get_train_datasets("MVTec", 42, -1, seed=2,
                                             device_augment=True)
    cache = DeviceCacheLoader(text_ds, {"bottle": 0, "cable": 1}, 4, seed=8,
                              text_stage=True, aug_seed=6, device="cpu")
    got = next(iter(cache))
    host = next(iter(datasets.BatchLoader(text_ds, 4, shuffle=True, seed=8)))
    want = aug.make_device_augment(uint8_inputs=True)(
        aug.augment_generator(6, 1, 0, 0, "cpu"),
        torch.from_numpy(host["image"]),
        torch.from_numpy(host["mask"][:, 0]))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _stage2(cfg, acfg, clip_visual, jad, table, remat=False):
    """The port's stage-2 step on the CPU from JAX trees: (adapter, step,
    optimizer, scheduler)."""
    from aaclip_tpu_torch.core.params import adapter_from_jax, params_from_jax
    from aaclip_tpu_torch.train.optim import make_image_optimizer
    from aaclip_tpu_torch.train.steps import make_stage2_step

    vit = params_from_jax(clip_visual, cfg, device="cpu")
    ad = adapter_from_jax(jad, cfg, acfg, device="cpu")
    opt, sched = make_image_optimizer(ad.parameters(), lr=1e-3,
                                      milestones=(2, 4))
    step = make_stage2_step(vit, cfg, acfg, (opt, sched), table,
                            remat=remat, device="cpu")
    return ad, step, opt, sched


def _fused_epoch(loader, fused, ad):
    """The training CLI's ``--fused_assemble`` loop over one epoch."""
    plan = loader.epoch_plan()
    batch = loader.assemble(plan[0][0], plan[0][1])
    valid, losses = plan[0][2], []
    for it in range(len(plan)):
        nidx, ngen, nvalid = plan[(it + 1) % len(plan)]
        images, mask, label, cidx = batch
        loss, batch = fused(ad, images, mask, label.long(), cidx.long(),
                            valid, nidx, ngen)
        valid = nvalid
        losses.append(loss)
    loader.advance_epoch()
    return losses


@pytest.fixture(scope="module")
def stage2_case(synth):
    import jax

    from aaclip_tpu.core.config import AdapterConfig as JAdapterConfig
    from aaclip_tpu.core.config import get_config as jget_config
    from aaclip_tpu.core.params import create_clip_params, init_adapter_params
    from aaclip_tpu_torch.core.config import AdapterConfig, get_config

    jcfg = jget_config("tiny-test", 42)
    jacfg = JAdapterConfig(levels=(1, 2), image_adapt_until=1,
                           text_adapt_until=1)
    clip = jax.tree.map(np.array, create_clip_params(jcfg, seed=0))
    jad = jax.tree.map(np.array, init_adapter_params(
        jax.random.PRNGKey(1), jcfg, jacfg)["image"])
    rng = np.random.default_rng(5)
    table = rng.standard_normal((2, jcfg.embed_dim, 2)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    return dict(cfg=get_config("tiny-test", 42),
                acfg=AdapterConfig(levels=(1, 2), image_adapt_until=1),
                jcfg=jcfg, jacfg=jacfg, clip=clip, jad=jad, table=table)


def test_fused_assemble_equals_the_unfused_loop(stage2_case):
    c = stage2_case
    ds = datasets.get_train_datasets("MVTec", 42, -1, seed=2,
                                     device_augment=True)[1]
    runs = []
    for fused in (False, True):
        loader = DeviceCacheLoader(ds, {"bottle": 0, "cable": 1}, 4, seed=8,
                                   text_stage=False, aug_seed=3,
                                   device="cpu", num_workers=2)
        ad, step, opt, sched = _stage2(c["cfg"], c["acfg"],
                                       c["clip"]["visual"], c["jad"],
                                       c["table"], remat="selective")
        if fused:
            losses = _fused_epoch(loader, loader.make_fused_step(step), ad)
        else:
            losses = [step(ad, im, mk, lb.long(), ci.long(), v)
                      for im, mk, lb, ci, v in loader]
        assert loader.epoch == 1 and len(losses) == 4
        runs.append((torch.stack(losses), list(ad.parameters()),
                     opt.state_dict(), sched.state_dict()))
    (l0, p0, o0, s0), (l1, p1, o1, s1) = runs
    assert torch.equal(l0, l1) and torch.isfinite(l0).all()
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
    for k, st in o0["state"].items():
        for name, v in st.items():
            assert torch.equal(v, o1["state"][k][name]), name
    assert s0 == s1


def test_fused_step_follows_jax_s_fused_loop(stage2_case):
    import jax

    from aaclip_tpu.data.datasets import get_train_datasets as jget
    from aaclip_tpu.data.device_cache import DeviceCacheLoader as JLoader
    from aaclip_tpu.train.optim import make_image_optimizer as jopt
    from aaclip_tpu.train.steps import init_state
    from aaclip_tpu.train.steps import make_stage2_step as jstage2

    c = stage2_case
    cls_to_idx = {"bottle": 0, "cable": 1}
    jloader = JLoader(jget("MVTec", 42, -1, seed=2, device_augment=True)[1],
                      cls_to_idx, batch_size=4, seed=8, text_stage=False,
                      aug_base=jax.random.PRNGKey(7))
    tx = jopt(1e-3, milestones=(2, 4))
    jfused = jloader.make_fused_step(jstage2(c["clip"], c["jcfg"],
                                             c["jacfg"], tx, c["table"]))
    state = init_state(c["jad"], tx)
    plan = jloader.epoch_plan()
    batch = jloader.assemble(plan[0][0], plan[0][1])
    batches, valids, jlosses = [], [p[2] for p in plan], []
    for it in range(len(plan)):
        batches.append([np.array(x) for x in batch])
        nidx, nkey, _ = plan[(it + 1) % len(plan)]
        state, loss, batch = jfused(state, *batch, jnp.asarray(valids[it]),
                                    nidx, nkey)
        jlosses.append(float(loss))
    batches.append([np.array(x) for x in batch])

    ds = datasets.get_train_datasets("MVTec", 42, -1, seed=2,
                                     device_augment=True)[1]
    loader = DeviceCacheLoader(ds, cls_to_idx, 4, seed=8, text_stage=False,
                               aug_seed=3, device="cpu", num_workers=2)
    fed = iter(batches)
    loader.assemble = lambda idx, gen: tuple(torch.from_numpy(x)
                                             for x in next(fed))
    ad, step, _, _ = _stage2(c["cfg"], c["acfg"], c["clip"]["visual"],
                             c["jad"], c["table"], remat=True)
    fused = loader.make_fused_step(step)
    plan = loader.epoch_plan()
    batch = loader.assemble(None, None)
    losses = []
    for it in range(len(plan)):
        images, mask, label, cidx = batch
        loss, batch = fused(ad, images, mask, label.long(), cidx.long(),
                            torch.from_numpy(valids[it]), None, None)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    from aaclip_tpu_torch.core.params import adapter_to_jax

    for g, w in zip(jax.tree.leaves(adapter_to_jax(ad)),
                    jax.tree.leaves(state.params)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)
