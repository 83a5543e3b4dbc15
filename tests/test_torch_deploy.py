"""The port's serving artifacts (``aaclip_tpu_torch/deploy.py``: export,
load, the engine's ``artifact=`` path, ``test --artifact``, ``bench --mode
serve --artifact``), the cases of the JAX package's ``tests/test_deploy.py``
on the CPU at tiny-test, buckets (1, 2).

Bars: the artifact against the live predictor it was exported from, bit
for bit (the same ops on the same device; the memory-bank programs too);
the engine serving an artifact against the live engine, bit for bit; the
port's fp32 artifact against the JAX package's artifact exported from the
same checkpoint and adapters, within atol 1e-4 (fp32 through both towers
in another summation order, then the 100x similarity scale).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from aaclip_tpu_torch import deploy
from aaclip_tpu_torch.core.config import AdapterConfig, get_config
from aaclip_tpu_torch.core.params import (adapter_to_jax, init_image_adapter,
                                          init_text_adapter,
                                          text_adapter_to_jax)
from aaclip_tpu_torch.deploy import (ARTIFACT_VERSION,
                                     export_serving_artifact,
                                     load_serving_artifact)
from aaclip_tpu_torch.train import checkpoint as ckpt

ACFG = dict(levels=(1, 2), image_adapt_until=1, text_adapt_until=1)
IMG, SEED = 70, 7
JAX_ATOL = 1e-4


def _export(tmp_path, **kw):
    kw.setdefault("model_name", "tiny-test")
    kw.setdefault("img_size", IMG)
    kw.setdefault("precision", "fp32")
    kw.setdefault("adapter_cfg", ACFG)
    kw.setdefault("seed", SEED)
    kw.setdefault("datasets", ("MVTec",))
    kw.setdefault("batch_sizes", (1, 2))
    kw.setdefault("device", "cpu")
    out = str(tmp_path / "artifact")
    return out, export_serving_artifact(out, **kw)


def _load(path, **kw):
    return load_serving_artifact(path, device="cpu", **kw)


def _imgs(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 255, (n, 3, IMG, IMG), dtype=np.uint8)


def _adapter_dir(path, seed=1):
    cfg, acfg = get_config("tiny-test"), AdapterConfig(**ACFG)
    os.makedirs(path, exist_ok=True)
    ckpt.save_adapter_checkpoint(
        os.path.join(path, "image_adapter_1.npz"), 1,
        adapter_to_jax(init_image_adapter(cfg, acfg, seed=seed,
                                          device="cpu")))
    return str(path)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    return _export(tmp_path_factory.mktemp("deploy"))


def _live_predict(imgs, class_name="bottle", precision="fp32"):
    """The live path the artifact must reproduce, built as the exporter
    builds it."""
    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.core.params import create_clip_towers
    from aaclip_tpu_torch.eval.predict import (make_anchor_encoder,
                                               make_predict_fn)
    from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix
    from aaclip_tpu_torch.text.anchors import encode_dataset_anchors

    policy = DtypePolicy.from_name(precision)
    cfg, acfg = get_config("tiny-test", IMG), AdapterConfig(**ACFG)
    vit, text = create_clip_towers(cfg, seed=SEED, device="cpu")
    ad = init_image_adapter(cfg, acfg, seed=SEED, device="cpu")
    pred = make_predict_fn(vit, cfg, acfg, policy=policy, uint8_inputs=True,
                           device="cpu")
    anchors = encode_dataset_anchors(
        make_anchor_encoder(text, cfg, acfg, policy=policy),
        "MVTec")[class_name]
    M = torch.from_numpy(fused_postproc_matrix(cfg.vision.grid, IMG,
                                               "Industrial"))
    pix, score = pred(ad, torch.from_numpy(imgs),
                      anchors.expand(imgs.shape[0], -1, -1), M)
    return pix.numpy(), score.numpy()


def test_artifact_matches_live_path_bit_exactly(exported):
    out, manifest = exported
    art = _load(out)
    imgs = _imgs(2)
    got_maps, got_scores = art.predict_class(imgs, "MVTec", "bottle")
    want_maps, want_scores = _live_predict(imgs)
    np.testing.assert_array_equal(got_maps, want_maps)
    np.testing.assert_array_equal(got_scores, want_scores)
    assert manifest["untrained"] is True and art.untrained is True
    assert manifest["platforms"] == ["cpu"]
    assert manifest["native_kernels"] is False
    assert manifest["torch_version"] == torch.__version__


def test_graphs_carry_the_attention_op_and_no_weights(exported):
    """Each program calls ``aaclip::attention_packed`` once per block and
    takes every weight as an input: no parameter, buffer or constant in
    the program, and each .pt2 far smaller than params.npz."""
    out, manifest = exported
    art = _load(out)
    layers = get_config("tiny-test").vision.layers
    for b, ep in art.programs.items():
        nodes = [n for n in ep.graph.nodes
                 if n.target is torch.ops.aaclip.attention_packed.default]
        assert len(nodes) == layers, b
        assert not ep.state_dict and not ep.constants
    inputs = [s for s in art.programs[1].graph_signature.input_specs]
    assert len(inputs) == len(art.visual) + len(art.image_adapter) + 3
    params = os.path.getsize(os.path.join(out, "params.npz"))
    for name in manifest["graphs"].values():
        # the tiny tower's weights are small beside its graph: the
        # programs here are of the params' order, ViT-L's under 5%
        assert os.path.getsize(os.path.join(out, name)) < params


def test_padding_and_chunking_match_exact_buckets(exported):
    out, _ = exported
    art = _load(out)
    # n=3 with buckets (1, 2): a chunk of 2 and a chunk of 1
    imgs = _imgs(3, seed=3)
    got_maps, got_scores = art.predict_class(imgs, "MVTec", "bottle")
    assert got_maps.shape == (3, IMG, IMG) and got_scores.shape == (3,)
    m2, s2 = art.predict_class(imgs[:2], "MVTec", "bottle")
    np.testing.assert_array_equal(got_maps[:2], m2)
    np.testing.assert_array_equal(got_scores[:2], s2)
    m1, s1 = art.predict_class(imgs[2:], "MVTec", "bottle")
    np.testing.assert_array_equal(got_maps[2], m1[0])
    # padding is invisible: one image padded to bucket 2 by edge
    # replication against the same image beside another in bucket 2
    art.batch_sizes = [2]  # as if only the b=2 program were exported
    mp, sp = art.predict_class(imgs[2:], "MVTec", "bottle")
    mo, so = art.predict_class(np.stack([imgs[2], imgs[0]]), "MVTec",
                               "bottle")
    np.testing.assert_array_equal(mp[0], mo[0])
    assert sp[0] == so[0]


def test_mixed_class_per_sample_anchors(exported):
    out, _ = exported
    art = _load(out)
    imgs = _imgs(2, seed=5)
    a = np.stack([art.anchors["MVTec"]["bottle"],
                  art.anchors["MVTec"]["cable"]])
    maps, scores = art.predict(imgs, a, "MVTec")
    mb, sb = art.predict(imgs, np.stack([a[0], a[0]]), "MVTec")
    mc, sc = art.predict(imgs, np.stack([a[1], a[1]]), "MVTec")
    np.testing.assert_array_equal(maps[0], mb[0])
    np.testing.assert_array_equal(maps[1], mc[1])
    np.testing.assert_array_equal(scores, [sb[0], sc[1]])


def test_unknown_dataset_and_class_raise(exported):
    out, _ = exported
    art = _load(out)
    with pytest.raises(KeyError, match="VisA"):
        art.predict_class(_imgs(1), "VisA", "bottle")
    with pytest.raises(KeyError, match="nope"):
        art.predict_class(_imgs(1), "MVTec", "nope")
    with pytest.raises(ValueError, match="empty"):
        art.predict(_imgs(1)[:0], np.zeros((0, art.embed_dim, 2)), "MVTec")


def test_platform_and_version_validation(exported, tmp_path):
    out, _ = exported
    bad = str(tmp_path / "badplat")
    shutil.copytree(out, bad)
    mpath = os.path.join(bad, "manifest.json")
    with open(mpath) as f:
        m = json.load(f)
    m["platforms"] = ["cuda"]
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="exported for platforms"):
        _load(bad)
    m["platforms"] = ["cpu"]
    m["artifact_version"] = ARTIFACT_VERSION + 1
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="artifact version"):
        _load(bad)


@pytest.mark.parametrize("precision,dtype", [("bf16", torch.bfloat16),
                                             ("int8", torch.int8)])
def test_bf16_and_int8_leaves_survive_and_run(tmp_path, precision, dtype):
    """npz has no bf16: the raw-byte store keeps bf16 and int8 tensors bit
    for bit, and the reloaded programs run them as the live predictor
    does."""
    out, m = _export(tmp_path, precision=precision, batch_sizes=(2,),
                     verify=True)
    assert m["precision"] == precision and m["verify"]["bit_equal"]
    art = _load(out)
    assert dtype in {t.dtype for t in art.visual.values()}
    with np.load(os.path.join(out, "params.npz")) as z:
        assert len(z.files) == len(art.visual) + len(art.image_adapter)
    maps, scores = art.predict_class(_imgs(2), "MVTec", "bottle")
    assert maps.shape == (2, IMG, IMG) and np.isfinite(maps).all()
    want, _ = _live_predict(_imgs(2), precision=precision)
    np.testing.assert_array_equal(maps, want)


def test_integrity_digests(tmp_path, exported):
    src, manifest = exported
    assert set(manifest["sha256"]) >= {"params.npz", "anchors_MVTec.npz",
                                       "graph_b1.pt2", "postproc_MVTec.npy"}
    bad = str(tmp_path / "tampered")
    shutil.copytree(src, bad)
    gname = manifest["graphs"]["1"]
    with open(os.path.join(bad, gname), "r+b") as f:
        f.seek(128)
        b = f.read(1)
        f.seek(128)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="sha256"):
        _load(bad)
    gone = str(tmp_path / "missing")
    shutil.copytree(src, gone)
    os.remove(os.path.join(gone, "params.npz"))
    with pytest.raises(ValueError, match="missing"):
        _load(gone)
    legacy = str(tmp_path / "legacy")
    shutil.copytree(src, legacy)
    with open(os.path.join(legacy, "manifest.json")) as f:
        m = json.load(f)
    del m["sha256"]
    with open(os.path.join(legacy, "manifest.json"), "w") as f:
        json.dump(m, f)
    maps, _ = _load(legacy).predict_class(_imgs(1), "MVTec", "bottle")
    assert maps.shape == (1, IMG, IMG)


def test_trained_adapters_are_exported_with_provenance(tmp_path):
    """An adapter checkpoint under save_path changes the maps, clears the
    untrained flag and is named in the manifest; a re-export into the same
    directory replaces the manifest."""
    out, m0 = _export(tmp_path, batch_sizes=(2,))
    assert m0["untrained"] is True and m0["image_adapter_ckpt"] is None
    imgs = _imgs(2, seed=9)
    m_plain, _ = _load(out).predict_class(imgs, "MVTec", "bottle")
    _, m1 = _export(tmp_path, batch_sizes=(2,),
                    save_path=_adapter_dir(tmp_path / "run", seed=999))
    assert m1["untrained"] is False
    assert m1["clip_checkpoint"] == f"seed{SEED}"
    assert m1["image_adapter_ckpt"].endswith("image_adapter_1.npz")
    assert m1["text_adapter_ckpt"] is None
    art = _load(out)  # the same directory, re-exported
    assert art.untrained is False and art.manifest["image_adapter_ckpt"]
    m_trained, _ = art.predict_class(imgs, "MVTec", "bottle")
    assert not np.array_equal(m_plain, m_trained)


def test_native_kernels_off_the_card_raises(tmp_path):
    """The hand-written kernels exist on the card only: asking for them
    off it raises rather than writing a manifest that says otherwise; on
    the CPU the default resolves to False, and on the card False raises."""
    with pytest.raises(ValueError, match="native_kernels"):
        _export(tmp_path, batch_sizes=(2,), native_kernels=True)
    assert deploy.resolve_native_kernels(None, torch.device("cpu")) is False
    assert deploy.resolve_native_kernels(None, torch.device("cuda")) is True
    with pytest.raises(ValueError, match="native_kernels=False"):
        deploy.resolve_native_kernels(False, torch.device("cuda"))
    with pytest.raises(ValueError, match="platforms"):
        _export(tmp_path, batch_sizes=(2,), platforms=("cuda",))


def test_export_cli_runs_and_verifies(tmp_path, capsys):
    deploy.main(["--out", str(tmp_path / "art"), "--model_name",
                 "tiny-test", "--img_size", str(IMG), "--precision", "fp32",
                 "--levels", "1", "2", "--image_adapt_until", "1",
                 "--text_adapt_until", "1", "--batch_sizes", "2",
                 "--verify"], device="cpu")
    out, err = capsys.readouterr()
    assert "verify OK" in out and "bit for bit" in out
    last = json.loads(out.strip().splitlines()[-1])
    assert last["graphs"] == 1 and last["untrained"] is True
    assert last["platforms"] == ["cpu"] and not last["native_kernels"]
    assert "RANDOM-INIT" in err


def test_engine_serves_artifact(tmp_path):
    """The engine on an artifact equals the live engine bit for bit, and
    refuses buckets and datasets the artifact lacks."""
    from aaclip_tpu_torch.serve.server import InferenceEngine

    out, _ = _export(tmp_path, batch_sizes=(1, 2, 4))
    live = InferenceEngine(model_name="tiny-test", img_size=IMG,
                           datasets=("MVTec",), precision="fp32",
                           max_batch=4, seed=SEED, adapter_cfg=ACFG,
                           device="cpu")
    try:
        img = _imgs(1, seed=11)[0]
        want_map, want_score = live.submit(img, "MVTec", "bottle")
    finally:
        live.shutdown()
    eng = InferenceEngine(artifact=out, max_batch=4, device="cpu")
    try:
        assert eng.untrained is True and sorted(eng.anchors) == ["MVTec"]
        assert set(eng.startup_s) == {"load", "warmup"}
        got_map, got_score = eng.submit(img, "MVTec", "bottle")
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(got_map, want_map)
    assert got_score == want_score
    with pytest.raises(ValueError, match="lacks graphs"):
        InferenceEngine(artifact=out, max_batch=8, device="cpu")
    with pytest.raises(ValueError, match="lacks datasets"):
        InferenceEngine(artifact=out, datasets=("MVTec", "VisA"),
                        max_batch=4, device="cpu")


def test_engine_pads_to_larger_exported_bucket(tmp_path):
    """An artifact with only b=2 serves the engine's bucket 1 by padding
    up, as a direct artifact call pads it."""
    from aaclip_tpu_torch.serve.server import InferenceEngine

    out, _ = _export(tmp_path, batch_sizes=(2,))
    eng = InferenceEngine(artifact=out, max_batch=2, device="cpu")
    try:
        img = _imgs(1, seed=13)[0]
        got_map, got_score = eng.submit(img, "MVTec", "bottle")
    finally:
        eng.shutdown()
    want_map, want_score = _load(out).predict_class(img[None], "MVTec",
                                                    "bottle")
    np.testing.assert_array_equal(got_map, want_map[0])
    assert got_score == want_score[0]


def test_bench_serve_on_an_artifact(exported, capsys):
    from aaclip_tpu_torch import bench

    out, _ = exported
    bench.main(["--mode", "serve", "--artifact", out, "--batch_size", "2",
                "--steps", "1", "--clients", "2"], device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["errors"] == 0 and line["served"] > 0
    assert "fp32+artifact" in line["unit"] and "tiny-test" in line["unit"]


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset

    root = tmp_path_factory.mktemp("synth")
    data_root, meta_root = make_synthetic_dataset(str(root), img_px=IMG,
                                                  class_names=["bottle"])
    old = {k: os.environ.get(k) for k in ("AACLIP_DATA", "AACLIP_METADATA")}
    os.environ.update(AACLIP_DATA=data_root, AACLIP_METADATA=meta_root)
    yield root
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_memory_bank_artifact(tmp_path, synthetic):
    """memory_bank_shot=2: the banks and the bank programs in the
    artifact; predict_class uses the bank, bit for bit the live mb
    predictor on the same support draw; use_bank=True without a bank
    raises."""
    from aaclip_tpu_torch.core.config import DtypePolicy
    from aaclip_tpu_torch.core.params import create_clip_towers
    from aaclip_tpu_torch.eval import memory_bank as mb
    from aaclip_tpu_torch.eval.predict import make_anchor_encoder
    from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix
    from aaclip_tpu_torch.text.anchors import encode_dataset_anchors

    out, manifest = _export(tmp_path, memory_bank_shot=2)
    mbm = manifest["memory_bank"]
    assert mbm["shot"] == 2 and set(mbm["graphs"]) == {"1", "2"}
    art = _load(out)
    assert art.shot == 2 and art.bank_weight == 0.5
    assert tuple(art.banks["MVTec"]["bottle"].shape) == \
        tuple(mbm["bank_shape"])
    for ep in art.bank_programs.values():
        assert any(n.target is torch.ops.aaclip.attention_packed.default
                   for n in ep.graph.nodes)
    imgs = _imgs(2)
    pix_b, sc_b = art.predict_class(imgs, "MVTec", "bottle")
    pix_t, _ = art.predict_class(imgs, "MVTec", "bottle", use_bank=False)
    assert np.abs(pix_b - pix_t).max() > 1e-6

    cfg, acfg = get_config("tiny-test", IMG), AdapterConfig(**ACFG)
    vit, text = create_clip_towers(cfg, seed=SEED, device="cpu")
    ad = init_image_adapter(cfg, acfg, seed=SEED, device="cpu")
    live = mb.make_mb_predict_fn(vit, cfg, acfg, policy=DtypePolicy.fp32(),
                                 uint8_inputs=True, bank_weight=0.5,
                                 device="cpu")
    support = mb.collect_support_sets("MVTec", 2, IMG, uint8=True)
    bank = mb.collect_bank(live.features_fn, ad, support["bottle"])
    bank = mb.pad_banks_to_common_size({"bottle": bank},
                                       mbm["bank_shape"][1])["bottle"]
    np.testing.assert_array_equal(art.banks["MVTec"]["bottle"],
                                  bank.numpy())
    anchors = encode_dataset_anchors(make_anchor_encoder(
        text, cfg, acfg, policy=DtypePolicy.fp32()), "MVTec")["bottle"]
    M = torch.from_numpy(fused_postproc_matrix(cfg.vision.grid, IMG,
                                               "Industrial"))
    pix_l, sc_l = live(ad, torch.from_numpy(imgs), anchors.expand(2, -1, -1),
                       M, bank)
    np.testing.assert_array_equal(pix_b, pix_l.numpy())
    np.testing.assert_array_equal(sc_b, sc_l.numpy())

    nobank, _ = _export(tmp_path / "nobank", batch_sizes=(2,))
    with pytest.raises(KeyError, match="no bank"):
        _load(nobank).predict_class(imgs, "MVTec", "bottle", use_bank=True)


def test_eval_cli_on_an_artifact(tmp_path, synthetic, exported):
    """``test --artifact``: the artifact's scores per image, bit for bit a
    direct artifact predict of the same batches; with --memory_bank it
    needs bundled banks."""
    from aaclip_tpu_torch import test as port_cli
    from aaclip_tpu_torch.data.datasets import BatchLoader, get_test_datasets

    out, _ = exported
    save = str(tmp_path / "eval")
    port_cli.main(["--artifact", out, "--save_path", save, "--batch_size",
                   "2", "--dump_scores", "--num_workers", "1"], device="cpu")
    with open(os.path.join(save, "scores_artifact.csv")) as f:
        rows = [line.strip().split(",") for line in f][1:]
    art = _load(out)
    direct = []
    ds = get_test_datasets("MVTec", IMG, uint8=True)["bottle"]
    for batch in BatchLoader(ds, 2):
        _, sc = art.predict_class(batch["image"], "MVTec", "bottle")
        direct += [float(x) for x in sc[:batch["n_valid"]]]
    assert [float(r[3]) for r in rows] == direct
    log = open(os.path.join(save, "test.log")).read()
    assert "artifact manifest: model tiny-test @ 70px, precision fp32" in log
    with pytest.raises(SystemExit, match="banks"):
        port_cli.main(["--artifact", out, "--save_path", save,
                       "--memory_bank"], device="cpu")


def test_port_artifact_matches_the_jax_artifact(tmp_path):
    """The port's fp32 artifact against the JAX package's, both exported on
    the CPU from one OpenAI-layout checkpoint and one adapter directory."""
    from aaclip_tpu.core.config import get_config as jget_config
    from aaclip_tpu.deploy import export_serving_artifact as j_export
    from aaclip_tpu.deploy import load_serving_artifact as j_load
    from tests.test_model_parity import _make_state_dict

    ck = str(tmp_path / "tiny.pt")
    torch.save(_make_state_dict(jget_config("tiny-test", 56), seed=5), ck)
    adapters = _adapter_dir(tmp_path / "adapters", seed=3)
    cfg, acfg = get_config("tiny-test"), AdapterConfig(**ACFG)
    ckpt.save_adapter_checkpoint(
        os.path.join(adapters, "text_adapter.npz"), 0,
        text_adapter_to_jax(init_text_adapter(cfg, acfg, seed=4,
                                              device="cpu")))
    kw = dict(model_name="tiny-test", img_size=IMG, precision="fp32",
              adapter_cfg=ACFG, clip_checkpoint=ck, save_path=adapters,
              datasets=("MVTec",), batch_sizes=(2,))
    j_out = str(tmp_path / "jax")
    j_export(j_out, **kw)
    t_out = str(tmp_path / "port")
    export_serving_artifact(t_out, device="cpu", **kw)
    imgs = _imgs(2, seed=17)
    jm, js = j_load(j_out).predict_class(imgs, "MVTec", "bottle")
    tm, ts = _load(t_out).predict_class(imgs, "MVTec", "bottle")
    np.testing.assert_allclose(tm, np.asarray(jm), atol=JAX_ATOL)
    np.testing.assert_allclose(ts, np.asarray(js), atol=JAX_ATOL)
