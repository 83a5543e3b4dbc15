"""The port's practitioner tools and examples (``aaclip_tpu_torch/tools``,
``aaclip_tpu_torch/examples``) against the JAX package's ``tools/`` and
``examples/``, on the CPU at tiny-test @ 70 px, levels 1 2: one seeded
OpenAI-layout checkpoint (``AACLIP_CKPT``, written at a 4x4 grid so both
loaders resize the positional embedding) and one npz adapter dir, run
through JAX's tool and the port's tool; and ``AACLIP_MODEL_CONFIGS`` in
fresh interpreters of both packages.

Bars: predict_folder at fp32, every ``scores.csv`` row within atol 1e-5
of JAX's (fp32 through both towers in another summation order); its
heatmaps, decoded, equal JAX's on at least 99% of the pixels, and every
other pixel is the blend of a JET colour one 8-bit score level away from
JAX's (a map value on a rounding edge of the 255 levels); ``--artifact``
within atol 1e-6 of the artifact's own ``predict_class``; zero_shot's
printed score within the bf16 bar of ``test_torch_model.py`` (5e-3, plus
the print's 5e-5 rounding); make_few_shot's files byte for byte;
export_torch_ckpt's ``.pth`` files with the same keys and equal tensors;
compare_golden the same printed table and exit code. predict_folder and
zero_shot take adapt depths clamped to the 2-layer tower (2 and 2), so
their adapters are written at that depth; the evaluation CLI and
export_torch_ckpt at depth 1.
"""

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import get_config as jax_get_config
from aaclip_tpu_torch.core.config import AdapterConfig, get_config
from aaclip_tpu_torch.core.params import (adapter_to_jax, init_image_adapter,
                                          init_text_adapter,
                                          text_adapter_to_jax)
from aaclip_tpu_torch.data import image
from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
from aaclip_tpu_torch.eval.visualize import JET
from aaclip_tpu_torch.train import checkpoint as ckpt
from tests.test_model_parity import _make_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_ATOL = 1e-5
ARTIFACT_ATOL = 1e-6
BF16_SCORE_ATOL = 5e-3 + 5e-5
HEATMAP_EQUAL_FRAC = 0.99
TINY = ["--model_name", "tiny-test", "--img_size", "70", "--levels", "1",
        "2"]
SIZES = [(48, 60), (70, 70), (90, 40), (33, 81), (120, 120)]


def _write_adapters(path, until, seed, epochs=(1,)):
    cfg = get_config("tiny-test")
    acfg = AdapterConfig(levels=(1, 2), image_adapt_until=until,
                         text_adapt_until=until)
    os.makedirs(path)
    for e in epochs:
        ckpt.save_adapter_checkpoint(
            os.path.join(path, f"image_adapter_{e}.npz"), e,
            adapter_to_jax(init_image_adapter(cfg, acfg, seed=seed + e,
                                              device="cpu")))
    ckpt.save_adapter_checkpoint(
        os.path.join(path, "text_adapter.npz"), 0,
        text_adapter_to_jax(init_text_adapter(cfg, acfg, seed=seed,
                                              device="cpu")))
    return path


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """(root, checkpoint, image folder, depth-2 adapters, depth-1
    adapters)."""
    root = str(tmp_path_factory.mktemp("tools"))
    ckpt_path = os.path.join(root, "tiny.pt")
    torch.save(_make_state_dict(jax_get_config("tiny-test", 56), seed=5),
               ckpt_path)
    imgs = os.path.join(root, "imgs")
    os.makedirs(imgs)
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(SIZES):
        with open(os.path.join(imgs, f"im{i}.png"), "wb") as f:
            f.write(image.encode_png(rng.integers(0, 255, (h, w, 3),
                                                  dtype=np.uint8)))
    deep = _write_adapters(os.path.join(root, "adapters2"), 2, 3)
    shallow = _write_adapters(os.path.join(root, "adapters1"), 1, 7,
                              epochs=(1, 2))
    return root, ckpt_path, imgs, deep, shallow


@pytest.fixture
def ckpt_env(assets, monkeypatch):
    monkeypatch.setenv("AACLIP_CKPT", assets[1])
    return assets


def _jax_tool(module: str):
    """The JAX package's tool module, its persistent compile cache off
    (the tool turns it on for the process)."""
    import importlib

    import aaclip_tpu.utils.cache as cache

    cache.enable_compilation_cache = lambda *a, **k: None
    return importlib.import_module(module)


def _run(fn, *a, **kw):
    """fn's stdout and stderr, as it prints them."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = fn(*a, **kw)
    return result, out.getvalue(), err.getvalue()


def _read_scores(out_dir):
    rows = open(os.path.join(out_dir, "scores.csv")).read().split()
    return rows[0], [r.split(",")[0] for r in rows[1:]], \
        np.array([float(r.split(",")[1]) for r in rows[1:]])


@pytest.fixture(scope="module")
def folder_runs(assets):
    """Both tools at fp32 with --heatmaps on the folder, batch 2 (the last
    batch padded), from the depth-2 adapters; {"jax"|"port": (out dir,
    stderr)}."""
    root, ckpt_path, imgs, deep, _ = assets
    from aaclip_tpu_torch.tools import predict_folder

    jax_tool = _jax_tool("tools.predict_folder")
    argv = [imgs, "--class_name", "bottle", "--precision", "fp32",
            "--batch_size", "2", "--heatmaps", "--save_path", deep] + TINY
    old = os.environ.get("AACLIP_CKPT")
    os.environ["AACLIP_CKPT"] = ckpt_path
    try:
        runs = {}
        for name, fn, kw in (("jax", jax_tool.main, {}),
                             ("port", predict_folder.main,
                              {"device": "cpu"})):
            out = os.path.join(root, f"folder_{name}")
            _, _, err = _run(fn, argv + ["--out", out], **kw)
            runs[name] = (out, err)
    finally:
        if old is None:
            os.environ.pop("AACLIP_CKPT", None)
        else:
            os.environ["AACLIP_CKPT"] = old
    return runs


def test_predict_folder_scores_match_jax(folder_runs):
    (jout, jerr), (pout, perr) = folder_runs["jax"], folder_runs["port"]
    jhead, jfiles, jscores = _read_scores(jout)
    phead, pfiles, pscores = _read_scores(pout)
    assert phead == jhead == "file,image_score"
    assert pfiles == jfiles == [f"im{i}.png" for i in range(len(SIZES))]
    np.testing.assert_allclose(pscores, jscores, atol=SCORE_ATOL, rtol=0)
    # trained adapters found: neither warns; the same progress lines
    assert "WARNING" not in jerr + perr
    assert [l for l in perr.splitlines() if "images" in l] == \
        [l for l in jerr.splitlines() if "images" in l] == \
        ["2/5 images", "4/5 images", "5/5 images"]


def _levels_matching(panel, orig):
    """[H, W, 256]: whether the blend of ``orig`` with JET's colour of
    each level gives ``panel``'s pixel."""
    blends = (0.5 * orig[:, :, None, :] + 0.5 * JET[None, None]
              ).astype(np.uint8)
    return (blends == panel[:, :, None, :]).all(-1)


def test_predict_folder_heatmaps_match_jax(assets, folder_runs):
    imgs = assets[2]
    (jout, _), (pout, _) = folder_runs["jax"], folder_runs["port"]
    names = sorted(os.listdir(pout))
    assert names == sorted(os.listdir(jout)) == sorted(
        [f"im{i}_heatmap.png" for i in range(len(SIZES))] + ["scores.csv"])
    for i in range(len(SIZES)):
        jp = image.load_rgb(os.path.join(jout, f"im{i}_heatmap.png"))
        pp = image.load_rgb(os.path.join(pout, f"im{i}_heatmap.png"))
        assert jp.shape == pp.shape == (70, 70, 3)
        same = (jp == pp).all(-1)
        assert same.mean() >= HEATMAP_EQUAL_FRAC, (i, same.mean())
        orig = image.resize_bicubic(
            image.load_rgb(os.path.join(imgs, f"im{i}.png")), 70)
        jl = _levels_matching(jp, orig)
        pl = _levels_matching(pp, orig)
        assert jl.any(-1).all() and pl.any(-1).all()
        near = pl.copy()
        near[..., 1:] |= pl[..., :-1]
        near[..., :-1] |= pl[..., 1:]
        assert (jl & near).any(-1)[~same].all(), i


@pytest.mark.parametrize("case", ["no_save_path", "no_image_adapter"])
def test_predict_folder_warns_as_jax(assets, ckpt_env, tmp_path, case):
    """Without trained image adapters both tools warn on stderr, with the
    same words, and still write every row."""
    imgs = assets[2]
    from aaclip_tpu_torch.tools import predict_folder

    extra = []
    if case == "no_image_adapter":
        empty = tmp_path / "empty"
        empty.mkdir()
        extra = ["--save_path", str(empty)]
    argv = [imgs, "--class_name", "cable", "--batch_size", "4"] + TINY \
        + extra
    warnings = []
    for name, fn, kw in (("jax", _jax_tool("tools.predict_folder").main,
                          {}), ("port", predict_folder.main,
                                {"device": "cpu"})):
        out = str(tmp_path / name)
        _, _, err = _run(fn, argv + ["--out", out], **kw)
        warnings.append([l for l in err.splitlines() if "WARNING" in l])
        assert len(_read_scores(out)[1]) == len(SIZES)
    assert warnings[0] == warnings[1] and len(warnings[0]) == 1
    assert "zero-shot with random" in warnings[0][0]


def test_predict_folder_rejects_an_unknown_class(assets):
    from aaclip_tpu_torch.tools import predict_folder

    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        predict_folder.main([assets[2], "--class_name", "nope"] + TINY,
                            device="cpu")


def test_predict_folder_artifact_matches_predict_class(assets, tmp_path):
    from aaclip_tpu_torch.data.transforms import load_rgb_chw
    from aaclip_tpu_torch.deploy import (export_serving_artifact,
                                         load_serving_artifact)
    from aaclip_tpu_torch.tools import predict_folder

    imgs = assets[2]
    art = str(tmp_path / "art")
    export_serving_artifact(
        art, model_name="tiny-test", img_size=70, precision="fp32",
        adapter_cfg=dict(levels=(1, 2), image_adapt_until=1,
                         text_adapt_until=1),
        datasets=("MVTec",), batch_sizes=(2,), device="cpu")
    out = str(tmp_path / "out")
    _, _, err = _run(predict_folder.main,
                     [imgs, "--class_name", "bottle", "--artifact", art,
                      "--batch_size", "2", "--out", out], device="cpu")
    assert "RANDOM-INIT" in err
    _, files, got = _read_scores(out)
    loaded = load_serving_artifact(art, device="cpu")
    want = []
    for start in range(0, len(files), 2):
        batch = np.stack([load_rgb_chw(os.path.join(imgs, f), 70, uint8=True)
                          for f in files[start:start + 2]])
        want += list(loaded.predict_class(batch, "MVTec", "bottle")[1])
    np.testing.assert_allclose(got, want, atol=ARTIFACT_ATOL, rtol=0)


def test_zero_shot_score_matches_jax(assets, ckpt_env, monkeypatch):
    imgs, deep = assets[2], assets[3]
    from aaclip_tpu_torch.examples import zero_shot

    argv = [os.path.join(imgs, "im1.png"), "--save_path", deep] + TINY
    monkeypatch.setattr(sys, "argv", ["zero_shot.py"] + argv)
    _, jout, _ = _run(_jax_tool("examples.zero_shot").main)
    _, pout, _ = _run(zero_shot.main, argv, device="cpu")

    def parse(out):
        lines = out.strip().splitlines()
        assert len(lines) == 2 and lines[1].startswith(
            "anomaly map: shape (70, 70), min ")
        return float(re.fullmatch(r"image score: (\S+)", lines[0])[1])

    assert abs(parse(pout) - parse(jout)) <= BF16_SCORE_ATOL


@pytest.mark.parametrize("include_anomalous", [False, True],
                         ids=["normals_first", "include_anomalous"])
def test_make_few_shot_files_match_jax(tmp_path, monkeypatch,
                                       include_anomalous):
    from aaclip_tpu_torch.tools import make_few_shot

    _, meta = make_synthetic_dataset(str(tmp_path / "data"), n_normal=3,
                                     n_anomalous=4, img_px=40)
    argv = ["--dataset", "MVTec", "--shots", "1", "2", "4"] + (
        ["--include_anomalous"] if include_anomalous else [])
    dirs = {}
    for name, fn, kw in (("jax", _jax_tool("tools.make_few_shot").main, {}),
                         ("port", make_few_shot.main, {"device": "cpu"})):
        dirs[name] = tmp_path / f"meta_{name}"
        shutil.copytree(meta, dirs[name])
        monkeypatch.setenv("AACLIP_METADATA", str(dirs[name]))
        _, out, _ = _run(fn, argv, **kw)
        # the 4-shot files of a class of 3 normals: filled or warned
        assert out.count("wrote ") == 3
    for k in (1, 2, 4):
        want = (dirs["jax"] / "MVTec" / f"{k}-shot.jsonl").read_bytes()
        assert (dirs["port"] / "MVTec" / f"{k}-shot.jsonl").read_bytes() \
            == want
        assert len(want.splitlines()) == 2 * k


def test_export_torch_ckpt_matches_jax(assets, tmp_path):
    from aaclip_tpu_torch.tools import export_torch_ckpt

    argv = ["--text_adapt_until", "1", "--image_adapt_until", "1",
            "--levels", "1", "2", "--model_name", "tiny-test"]
    dirs = {}
    for name, fn, kw in (("jax", _jax_tool("tools.export_torch_ckpt").main,
                          {}), ("port", export_torch_ckpt.main,
                                {"device": "cpu"})):
        dirs[name] = str(tmp_path / name)
        shutil.copytree(assets[4], dirs[name])
        _, out, _ = _run(fn, argv + ["--save_path", dirs[name]], **kw)
        assert out.count("wrote ") == 3
    for f in ("image_adapter_1.pth", "image_adapter_2.pth",
              "text_adapter.pth"):
        want = torch.load(os.path.join(dirs["jax"], f), weights_only=False)
        got = torch.load(os.path.join(dirs["port"], f), weights_only=False)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, dict) and k != "text_optimizer":
                assert list(got[k]) == list(v)
                for name, t in v.items():
                    assert torch.equal(got[k][name], t), (f, name)
            else:
                assert got[k] == v, (f, k)


@pytest.fixture(scope="module")
def port_log(assets, tmp_path_factory):
    """A test.log of the port's evaluation CLI (fp32, --aupro) on a
    synthetic set, from the depth-1 adapters."""
    from aaclip_tpu_torch import test as port_cli

    root = str(tmp_path_factory.mktemp("golden"))
    data_root, meta_root = make_synthetic_dataset(root, img_px=64)
    save = os.path.join(root, "save")
    shutil.copytree(assets[4], save)
    old = {k: os.environ.get(k) for k in ("AACLIP_DATA", "AACLIP_METADATA")}
    os.environ.update(AACLIP_DATA=data_root, AACLIP_METADATA=meta_root)
    try:
        _run(port_cli.main, ["--text_adapt_until", "1",
                             "--image_adapt_until", "1", "--batch_size", "4",
                             "--aupro", "--save_path", save,
                             "--clip_checkpoint", assets[1]] + TINY,
             device="cpu")
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return os.path.join(save, "test.log")


@pytest.mark.parametrize("case", ["identity", "regression", "truncated"])
def test_compare_golden_matches_jax(port_log, tmp_path, case):
    from aaclip_tpu_torch.tools import compare_golden

    text = open(port_log).read()
    ours = tmp_path / "ours.log"
    if case == "regression":
        # the Average row's first metric one point lower
        row = next(l for l in text.splitlines()
                   if l.strip().startswith("Average"))
        first = row.split()[1]
        text = text.replace(row, row.replace(
            first, f"{float(first) - 1:.3f}", 1))
    elif case == "truncated":
        text = "\n".join(l for l in text.splitlines() if "Average" not in l)
    ours.write_text(text)
    argv = ["--ours", str(ours), "--golden", port_log, "--table_index",
            "0"]
    results = [_run(_jax_tool("tools.compare_golden").main, argv),
               _run(compare_golden.main, argv, device="cpu")]
    assert results[0] == results[1]
    rc, out, err = results[1]
    assert rc == {"identity": 0, "regression": 1, "truncated": 2}[case]
    if case == "truncated":
        assert "Average" in err and not out
    else:
        rows = out.splitlines()
        assert rows[0].split()[1:4] == ["pixel", "AUC", "pixel"]
        assert {r.split()[0] for r in rows[1:-2]} == {
            "bottle", "cable", "Average"}
        assert "AUPRO" in rows[0]


def test_compare_golden_needs_a_golden_log(port_log):
    """JAX's default golden path is a reference checkout's; the port asks
    for it."""
    from aaclip_tpu_torch.tools import compare_golden

    with pytest.raises(SystemExit), contextlib.redirect_stderr(
            io.StringIO()) as err:
        compare_golden.main(["--ours", port_log])
    assert "--golden" in err.getvalue()


CONFIG_PROBE = r"""
import dataclasses, importlib, json, os, sys, warnings
case = sys.argv[1]
out = {}
for pkg in ("aaclip_tpu", "aaclip_tpu_torch"):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mod = importlib.import_module(pkg + ".core.config")
    res = {"warnings": [str(w.message) for w in caught
                        if "model config" in str(w.message)]}
    if case == "builtin_raises":
        # a built-in directory with one unreadable file: the scan of the
        # package's own directory, pointed at it
        mod.__file__ = os.path.join(sys.argv[2], "config.py")
        try:
            mod._scan_json_configs()
            res["error"] = None
        except RuntimeError as e:
            res["error"] = str(e)
    else:
        for name in ("user-model", "ViT-L-14-336", "ViT-B-16", "broken",
                     "no-keys"):
            try:
                c = mod.get_config(name)
            except KeyError:
                res[name] = None
                continue
            v, t = c.vision, c.text
            res[name] = {
                "vision": [v.image_size, v.patch_size, v.width, v.layers,
                           v.heads, v.mlp_ratio],
                "text": [t.context_length, t.vocab_size, t.width, t.heads,
                         t.layers, t.mlp_ratio],
                "embed_dim": c.embed_dim, "quick_gelu": c.quick_gelu}
    out[pkg] = res
print(json.dumps(out))
"""


def _config_json(width, layers, quick_gelu=False, head_width=64):
    return json.dumps({
        "embed_dim": 512, "quick_gelu": quick_gelu,
        "vision_cfg": {"image_size": 224, "layers": layers, "width": width,
                       "patch_size": 16, "head_width": head_width},
        "text_cfg": {"context_length": 77, "vocab_size": 49408,
                     "width": 512, "heads": 8, "layers": 12}})


@pytest.fixture(scope="module")
def config_cases(tmp_path_factory):
    """Each case's JSON result, from one fresh interpreter per case that
    imports both packages' config modules (all started together)."""
    root = tmp_path_factory.mktemp("configs")
    user_a, user_b = root / "user_a", root / "user_b"
    for d in (user_a, user_b):
        d.mkdir()
    (user_a / "user-model.json").write_text(_config_json(384, 6, True, 32))
    (user_b / "ViT-L-14-336.json").write_text(_config_json(1024, 3))
    (user_b / "ViT-B-16.json").write_text(_config_json(768, 4))
    (user_a / "broken.json").write_text("{not json")
    (user_a / "no-keys.json").write_text(json.dumps({"embed_dim": 3}))
    builtin = root / "builtin"
    (builtin / "model_configs").mkdir(parents=True)
    (builtin / "model_configs" / "bad.json").write_text(
        '{"embed_dim": 1, "vision_cfg": {}, "text_cfg": {}}')
    cases = {
        "user_dir": [str(user_a)],
        "override": [str(user_a), str(user_b)],
        "builtin_raises": None,
    }
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "AACLIP_MODEL_CONFIGS")}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = {}
    for case, dirs in cases.items():
        e = dict(env)
        if dirs:
            e["AACLIP_MODEL_CONFIGS"] = os.pathsep.join(dirs)
        procs[case] = subprocess.Popen(
            [sys.executable, "-c", CONFIG_PROBE, case, str(builtin)],
            cwd=REPO, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    results = {}
    for case, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        results[case] = json.loads(out.strip().splitlines()[-1])
    return results, builtin


@pytest.mark.parametrize("case", ["user_dir", "override"])
def test_model_configs_env_gives_jax_registry(config_cases, case):
    got = config_cases[0][case]
    assert got["aaclip_tpu_torch"] == got["aaclip_tpu"]
    res = got["aaclip_tpu_torch"]
    assert res["user-model"]["vision"] == [224, 16, 384, 6, 12, 4.0]
    assert res["user-model"]["quick_gelu"] is True
    if case == "override":
        # a user file replaces a built-in name, hard-coded or JSON
        assert res["ViT-L-14-336"]["vision"][2:4] == [1024, 3]
        assert res["ViT-B-16"]["vision"][2:4] == [768, 4]
    else:
        assert res["ViT-L-14-336"]["vision"][:4] == [518, 14, 1024, 24]
        assert res["ViT-B-16"]["vision"][2:4] == [768, 12]


def test_model_configs_env_warns_and_skips_unreadable_user_files(
        config_cases):
    got = config_cases[0]["user_dir"]
    for pkg in ("aaclip_tpu", "aaclip_tpu_torch"):
        res = got[pkg]
        # unreadable: skipped with a warning naming it; without the three
        # keys: skipped silently
        assert res["broken"] is None and res["no-keys"] is None
        assert len(res["warnings"]) == 1
        assert res["warnings"][0].startswith(
            "skipping unreadable model config") \
            and "broken.json" in res["warnings"][0]


def test_model_configs_unreadable_builtin_raises(config_cases):
    got, builtin = config_cases[0]["builtin_raises"], config_cases[1]
    bad = str(builtin / "model_configs" / "bad.json")
    for pkg in ("aaclip_tpu", "aaclip_tpu_torch"):
        assert got[pkg]["error"].startswith(
            f"could not load model config {bad!r}"), got[pkg]


TOOLS = ["compare_golden", "make_few_shot", "export_torch_ckpt",
         "predict_folder", "few_shot_soak", "precision_ab", "int8_ab",
         "serve_smoke"]
EXAMPLES = ["zero_shot", "synthetic_end_to_end"]


@pytest.mark.parametrize("module", [f"tools.{t}" for t in TOOLS]
                         + [f"examples.{e}" for e in EXAMPLES])
def test_modules_run_as_python_m(module):
    """``python -m aaclip_tpu_torch.<module> --help`` prints the JAX
    tool's flags."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", f"aaclip_tpu_torch.{module}", "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # the shim's flags are precision_ab's
    jax_path = os.path.join(REPO, *module.replace(
        "int8_ab", "precision_ab").split(".")) + ".py"
    jax_flags = set(re.findall(r"add_argument\(\s*\"(--\w+)\"",
                               open(jax_path).read()))
    assert jax_flags and jax_flags <= set(re.findall(r"--\w+", out.stdout))
