"""The port's object facades (aaclip_tpu_torch/models/clip.py), its
``surgery_patch_features`` and the package's lazy re-exports, on the CPU:

* ``CLIPModel`` and ``AdaptedCLIP`` bit for bit against the port's
  functional path (``models/vit.py``, ``models/text_model.py``);
* against the JAX package's facades (``aaclip_tpu/models/clip.py``) on
  the same numpy weights through the parameter bridge, ``logit_scale``
  included, at fp32 atol 1e-4 (test_torch_model's bar);
* ``AdaptedCLIP.surgery_features`` against JAX's
  ``surgery_patch_features`` in both V-V modes, atol 1e-5 (the stage-1
  features' bar);
* the eight re-exports resolve lazily (the case of tests/test_facade.py).
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import AdapterConfig as JAdapterConfig
from aaclip_tpu.core.config import get_config as jget_config
from aaclip_tpu.core.params import create_clip_params as j_create
from aaclip_tpu.core.params import init_adapter_params as j_init_adapters
from aaclip_tpu.models import clip as jclip
from aaclip_tpu_torch.core import params as P
from aaclip_tpu_torch.core.config import AdapterConfig, get_config
from aaclip_tpu_torch.models import text_model
from aaclip_tpu_torch.models import vit as V
from aaclip_tpu_torch.models.clip import AdaptedCLIP, CLIPModel
from aaclip_tpu_torch.text.bpe import tokenize

REPO = Path(__file__).resolve().parents[1]
CFG = get_config("tiny-test")
ACFG = AdapterConfig(levels=(1, 2), image_adapt_until=1, text_adapt_until=1)
JCFG = jget_config("tiny-test")
JACFG = JAdapterConfig(levels=(1, 2), image_adapt_until=1, text_adapt_until=1)
ATOL, FEATS_ATOL = 1e-4, 1e-5
IMAGES = np.random.default_rng(1).standard_normal(
    (2, 3, 70, 70)).astype(np.float32)
TEXT = ["a photo of dark bottle.", "the cable."]


@pytest.fixture(scope="module")
def both():
    """JAX's ``AdaptedCLIP`` and the port's on the same weights: the JAX
    init with ``logit_scale`` moved off its init value, bridged."""
    params = jax.tree.map(np.asarray, j_create(JCFG, seed=0))
    params["logit_scale"] = np.float32(math.log(1 / 0.05))
    jad = jax.tree.map(np.asarray, j_init_adapters(jax.random.PRNGKey(0),
                                                   JCFG, JACFG))
    jmodel = jclip.AdaptedCLIP(jclip.CLIPModel(params, JCFG), jad, JACFG)
    text = P.text_params_from_jax(params, CFG, device="cpu")
    vis = P.params_from_jax(params, CFG, device="cpu")
    port = AdaptedCLIP(CLIPModel(vis, text, CFG),
                       {"image": P.adapter_from_jax(jad["image"], CFG, ACFG,
                                                    device="cpu"),
                        "text": P.text_adapter_from_jax(jad["text"], CFG,
                                                        ACFG, device="cpu")},
                       ACFG)
    return jmodel, port


def test_facades_match_the_functional_path():
    model = AdaptedCLIP.create(CFG, ACFG, seed=0, device="cpu")
    images = torch.from_numpy(IMAGES)
    seg_f, det_f = V.adapted_forward(
        model.clip.visual, model.adapters["image"], CFG, images,
        levels=ACFG.levels)
    seg_o, det_o = model(images)
    for a, b in zip(seg_f, seg_o):
        assert torch.equal(a, b)
    assert torch.equal(det_f, det_o)
    tokens = torch.as_tensor(tokenize(TEXT[:1]))
    assert torch.equal(model.encode_text(tokens, adapt_text=False),
                       text_model.encode_text(model.clip.text, CFG, tokens))
    assert torch.equal(model.encode_text(tokens),
                       text_model.adapted_encode_text(
                           model.clip.text, model.adapters["text"], CFG,
                           tokens, text_adapt_weight=ACFG.text_adapt_weight))
    assert model.encode_text(tokens).shape == (1, CFG.text.width)
    pooled, taps = model.clip.encode_image(images, out_layers=(1,))
    pooled_f, taps_f = V.encode_image(model.clip.visual, CFG, images, (1,))
    assert torch.equal(pooled, pooled_f) and torch.equal(taps[0], taps_f[0])


def test_contrastive_forward():
    model = AdaptedCLIP.create(CFG, ACFG, seed=0, device="cpu")
    img, txt, scale = model.clip(torch.from_numpy(IMAGES),
                                 torch.as_tensor(tokenize(TEXT)))
    assert img.shape == (2, CFG.embed_dim) and txt.shape == (2, CFG.embed_dim)
    np.testing.assert_allclose(img.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(float(scale), 1.0 / 0.07, rtol=1e-5)
    sf = model.surgery_features(torch.from_numpy(IMAGES), out_layers=(1, 2),
                                surgery_until_layer=2)
    assert len(sf) == 2 and sf[0].shape == (2, 25, CFG.embed_dim)


def test_logit_scale_is_carried_without_disturbing_the_draws():
    """The seeded init sets CLIP's initial scale without a draw: every
    other tensor is what the seed gave before; the bridge and an
    OpenAI-layout checkpoint carry the value."""
    text = P.init_text_params(CFG, seed=3, device="cpu")
    assert float(text.logit_scale) == pytest.approx(math.log(1 / 0.07))
    gen = torch.Generator().manual_seed(3)
    first = torch.empty_like(text.token_embedding.weight).normal_(
        0.0, 0.02, generator=gen)
    assert torch.equal(first, text.token_embedding.weight)
    from tests.test_model_parity import _make_state_dict

    sd = _make_state_dict(jget_config("tiny-test", 56), seed=5)
    sd["logit_scale"] = torch.tensor(2.5)
    path = Path(os.environ.get("TMPDIR", "/tmp")) / f"ls_{os.getpid()}.pt"
    torch.save(sd, path)
    try:
        _, t = P.load_openai_checkpoint(str(path), CFG, device="cpu")
    finally:
        path.unlink()
    assert float(t.logit_scale) == 2.5
    assert not t.logit_scale.requires_grad


def test_facades_match_jaxs(both):
    jmodel, port = both
    jimg = jnp.asarray(IMAGES)
    seg_j, det_j = jmodel(jimg)
    seg_p, det_p = port(torch.from_numpy(IMAGES))
    for a, b in zip(seg_p, seg_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    np.testing.assert_allclose(det_p.numpy(), np.asarray(det_j), atol=ATOL)
    tokens = tokenize(TEXT)
    for adapt in (True, False):
        np.testing.assert_allclose(
            port.encode_text(torch.as_tensor(tokens), adapt).numpy(),
            np.asarray(jmodel.encode_text(jnp.asarray(tokens), adapt)),
            atol=ATOL)
    ij, tj, sj = jmodel.clip(jimg, jnp.asarray(tokens))
    ip, tp, sp = port.clip(torch.from_numpy(IMAGES), torch.as_tensor(tokens))
    np.testing.assert_allclose(ip.numpy(), np.asarray(ij), atol=ATOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), atol=ATOL)
    np.testing.assert_allclose(float(sp), float(sj), rtol=1e-6)
    assert float(sp) == pytest.approx(20.0, rel=1e-5)
    pj, tapj = jmodel.clip.encode_image(jimg, out_layers=(1, 2),
                                        normalize=True)
    pp_, tapp = port.clip.encode_image(torch.from_numpy(IMAGES),
                                       out_layers=(1, 2), normalize=True)
    np.testing.assert_allclose(pp_.numpy(), np.asarray(pj), atol=ATOL)
    for a, b in zip(tapp, tapj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("vv_mode", ["batch", "spatial"])
def test_surgery_features_match_jaxs(both, vv_mode):
    from aaclip_tpu.models.vit import surgery_patch_features as j_surgery

    jmodel, port = both
    want = j_surgery(jmodel.clip.params["visual"], JCFG, jnp.asarray(IMAGES),
                     (1, 2), 2, vv_mode=vv_mode)
    got = port.surgery_features(torch.from_numpy(IMAGES), (1, 2), 2,
                                vv_mode=vv_mode)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=FEATS_ATOL)


def test_reexports_resolve_lazily():
    """``import aaclip_tpu_torch`` loads none of the re-exported modules;
    each of the eight names resolves to the port's object of that name
    (the two parameter functions to thin functions over the towers' and
    the adapters' initialisers); an unknown name raises AttributeError."""
    code = (
        "import sys\n"
        "import aaclip_tpu_torch as p\n"
        "mods = ('aaclip_tpu_torch.models.clip', "
        "'aaclip_tpu_torch.core.params', 'aaclip_tpu_torch.text.bpe')\n"
        "assert not any(m in sys.modules for m in mods)\n"
        "from aaclip_tpu_torch.models import clip\n"
        "from aaclip_tpu_torch.core import config, params\n"
        "from aaclip_tpu_torch.text import bpe\n"
        "assert p.CLIPModel is clip.CLIPModel\n"
        "assert p.AdaptedCLIP is clip.AdaptedCLIP\n"
        "assert p.get_config is config.get_config\n"
        "assert p.AdapterConfig is config.AdapterConfig\n"
        "assert p.DtypePolicy is config.DtypePolicy\n"
        "assert p.tokenize is bpe.tokenize\n"
        "cfg = p.get_config('tiny-test')\n"
        "acfg = p.AdapterConfig(levels=(1, 2), image_adapt_until=1,\n"
        "                       text_adapt_until=1)\n"
        "t = p.create_clip_params(cfg, device='cpu')\n"
        "assert set(t) == {'visual', 'text', 'logit_scale'}\n"
        "a = p.init_adapter_params(cfg, acfg, device='cpu')\n"
        "assert set(a) == {'image', 'text'}\n"
        "try:\n"
        "    p.nothing\n"
        "except AttributeError:\n"
        "    print('LAZY_OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert "LAZY_OK" in out.stdout, out.stderr[-2000:]
