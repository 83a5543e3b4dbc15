"""The port's tools that drive its CLIs, on the CPU at tiny-test @ 70 px
(levels 1 2, adapt depth 1), held against the JAX package's tools:
``precision_ab`` as JAX's ``tests/test_tools.py::test_precision_ab_smoke``
runs its own (fp32 against fp32_high at the staged default, the stash,
``--compare_only`` and the "exactly one" rejection), its verdict the JAX
tool's verdict on the same stash there and in every way a verdict fails,
its Spearman helper against JAX's; the ``int8_ab`` shim's defaults;
``few_shot_soak --shots 2 4 --memory_bank`` and the synthetic two-stage
demo beside JAX's, from one checkpoint and the same epoch-0 adapter files
(the two packages' seeded inits differ), their tables within the
evaluation CLI tests' 0.01 points; the demo alone with its stage 1; and
``serve_smoke`` against a server child on the CPU. Each drives the port's
CLIs (``train/cli.py``, ``test.py``, ``serve/server.py``) with
``device="cpu"``."""

import contextlib
import glob
import http.server
import io
import json
import os
import re
import shutil
import threading

import numpy as np
import pytest

TINY = ["--model_name", "tiny-test", "--img_size", "70", "--levels", "1",
        "2", "--text_adapt_until", "1", "--image_adapt_until", "1"]
# the evaluation CLI tests' bar on a table cell (test_torch_eval_cli.py)
POINTS_ATOL = 0.01


@pytest.fixture
def data_env(monkeypatch):
    """The tools point AACLIP_DATA / AACLIP_METADATA at their synthetic
    sets; restored after each test."""
    for k in ("AACLIP_DATA", "AACLIP_METADATA"):
        monkeypatch.setenv(k, "")


def _quiet(fn, *a, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*a, **kw)
    return out.getvalue()


def _jax_pab(monkeypatch):
    """The JAX package's precision_ab, its CLIs' persistent compile cache
    off (train.py and test.py turn it on for the process)."""
    import aaclip_tpu.utils.cache as cache
    import tools.precision_ab as jax_pab

    monkeypatch.setattr(cache, "enable_compilation_cache",
                        lambda *a, **k: None)
    return jax_pab


def _verdict(fn, argv, **kw):
    """(the verdict's printed lines, from its per-column header on, less
    the line naming the kept directory; the SystemExit message or
    None)."""
    out = io.StringIO()
    code = None
    with contextlib.redirect_stdout(out):
        try:
            fn(argv, **kw)
        except SystemExit as e:
            code = str(e.code)
    text = out.getvalue()
    lines = text[text.index("per-column max"):].splitlines()
    return [l for l in lines if not l.startswith("artifacts kept under")], \
        code


def test_precision_ab_smoke(tmp_path, data_env, monkeypatch):
    """JAX's smoke (``tests/test_tools.py::test_precision_ab_smoke``) with
    its arguments: fp32 against fp32_high at the staged default. The
    port's run stashes one table and one score dump per precision, and its
    verdict on them (lines, Spearman rho, exit) is JAX's tool's verdict on
    the same stash; ``--compare_only`` reproduces it; an ambiguous stash
    is rejected. The outcome itself is not held: the tables come from the
    port's seeded weights, and at the staged default both of tiny-test's
    blocks run bf16, where a near-tie of the eight scores may swap."""
    from aaclip_tpu_torch.tools import precision_ab as pab

    jax_pab = _jax_pab(monkeypatch)
    work = str(tmp_path / "ab")
    common = [
        "--workdir", work, "--keep",
        "--model_name", "tiny-test", "--img_size", "70",
        "--levels", "1", "2",
        "--text_adapt_until", "1", "--image_adapt_until", "1",
        "--n_classes", "1", "--n_normal", "4", "--n_anomalous", "4",
        "--hard", "--baseline", "fp32", "--candidate", "fp32_high",
        "--text_batch_size", "4", "--image_batch_size", "4",
        "--eval_batch_size", "4", "--num_workers", "2",
        "--pixel_tol", "0.5",
    ]
    ran = _verdict(pab.main, common, device="cpu")
    assert any("Spearman rho" in l for l in ran[0])
    ckpt = os.path.join(work, "ckpt_ab")
    for tag in ("fp32", "fp32_high"):
        assert len(glob.glob(os.path.join(
            ckpt, f"ab__{tag}__results_*.csv"))) == 1
        assert len(glob.glob(os.path.join(
            ckpt, f"ab__{tag}__scores_*.csv"))) == 1
    compare = ["--compare_only", ckpt, "--baseline", "fp32", "--candidate",
               "fp32_high", "--n_normal", "4", "--n_anomalous", "4",
               "--pixel_tol", "0.5"]
    want = _verdict(jax_pab.main, compare)
    assert _verdict(pab.main, compare, device="cpu") == want
    assert ran == want
    dup = glob.glob(os.path.join(ckpt, "ab__fp32__results_*.csv"))[0]
    shutil.copy(dup, dup.replace("results_1", "results_2"))
    with pytest.raises(SystemExit, match="exactly one"):
        pab.main(["--compare_only", ckpt, "--baseline", "fp32",
                  "--candidate", "fp32_high", "--n_normal", "4",
                  "--n_anomalous", "4"], device="cpu")


def _stash(path, tag, rows, scores):
    """A results / scores stash pair as the evaluation CLI writes them."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, f"ab__{tag}__results_1.csv"), "w") as f:
        f.write("class name,pixel AUC,pixel AP,image AUC,image AP,"
                "pixel AUPRO\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")
    if scores is None:
        return
    with open(os.path.join(path, f"ab__{tag}__scores_1.csv"), "w") as f:
        f.write("class name,file,label,image_score\n")
        for cls, name, score in scores:
            f.write(f"{cls},{name},0,{score}\n")


VERDICT_CASES = ["agree", "image_flips", "pixel", "ranking", "files",
                 "strict", "no_scores", "staged_tags"]


@pytest.mark.parametrize("case", VERDICT_CASES)
def test_precision_ab_verdict_matches_jax(tmp_path, monkeypatch, case):
    """Both tools' ``--compare_only`` on one stash: the same printed
    verdict (every per-column line, the Spearman line, the differing
    cells) and the same exit, in the passing case and in each way the
    verdict fails."""
    from aaclip_tpu_torch.tools import precision_ab as pab

    jax_pab = _jax_pab(monkeypatch)
    rng = np.random.default_rng(VERDICT_CASES.index(case))
    classes = ("bottle", "cable")
    rows = [[c] + [float(np.round(rng.uniform(40, 99), 4))
                   for _ in range(5)] for c in classes]
    rows.append(["Average"] + [float(np.mean([r[j] for r in rows]))
                               for j in range(1, 6)])
    scores = [(c, f"{c}_{i:02d}.png", float(rng.random()))
              for c in classes for i in range(8)]
    other_rows = [[r[0]] + [x + float(rng.uniform(-0.004, 0.004))
                            for x in r[1:]] for r in rows]
    other_scores = [(c, f, s + 1e-9) for c, f, s in scores]
    base, cand, extra = "bf16", "int8", []
    if case == "image_flips":
        other_rows[1][3] += 4 * 100 / 16
    elif case == "pixel":
        other_rows[0][1] += 0.3
    elif case == "ranking":
        other_scores = [(c, f, 1.0 - s) if c == "cable" else (c, f, s)
                        for c, f, s in scores]
    elif case == "files":
        other_scores[3] = (other_scores[3][0], "renamed.png",
                           other_scores[3][2])
    elif case == "strict":
        extra = ["--strict"]
    elif case == "staged_tags":
        base, cand = "fp32", "fp32_high@6"
        extra = ["--baseline", "fp32", "--candidate", "fp32_high",
                 "--candidate_bf16_until", "6"]
        other_rows[0][4] += 2 * 100 / 16
    no_scores = case == "no_scores"
    _stash(str(tmp_path), base, rows, None if no_scores else scores)
    _stash(str(tmp_path), cand, other_rows,
           None if no_scores else other_scores)
    argv = ["--compare_only", str(tmp_path), "--n_normal", "4",
            "--n_anomalous", "4"] + extra
    want = _verdict(jax_pab.main, argv)
    got = _verdict(pab.main, argv, device="cpu")
    assert got == want
    passes = case in ("agree", "no_scores", "staged_tags")
    assert (got[1] is None) == passes, got


def test_precision_ab_rejects_bad_pairs():
    from aaclip_tpu_torch.tools import precision_ab as pab

    with pytest.raises(SystemExit, match="same configuration"):
        pab.main(["--baseline", "bf16", "--candidate", "bf16"])
    with pytest.raises(SystemExit, match="requires --candidate int8"):
        pab.main(["--candidate", "fp32", "--candidate_int8_until", "2"])
    with pytest.raises(SystemExit, match="out of range"):
        pab.main(["--model_name", "tiny-test", "--candidate_int8_until",
                  "3"])


def test_spearman_matches_jax():
    import tools.precision_ab as jax_pab

    from aaclip_tpu_torch.tools import precision_ab as pab

    rng = np.random.default_rng(0)
    x = np.arange(10, dtype=float)
    assert pab._spearman(x, x) == pytest.approx(1.0)
    assert pab._spearman(x, -x) == pytest.approx(-1.0)
    assert pab._spearman(x, np.exp(x / 3)) == pytest.approx(1.0)
    for n in (2, 7, 50):
        for ties in (False, True):
            a, b = rng.random(n), rng.random(n)
            if ties:
                a, b = np.round(a, 1), np.round(b, 1)
            assert pab._spearman(a, b) == jax_pab._spearman(a, b)
            assert pab._spearman(b, a) == pab._spearman(a, b)
    const = np.ones(5)
    assert pab._spearman(const, x[:5]) == jax_pab._spearman(const, x[:5])


def test_int8_ab_keeps_its_defaults(monkeypatch):
    from aaclip_tpu_torch.tools import int8_ab, precision_ab

    seen = []
    monkeypatch.setattr(precision_ab, "main",
                        lambda argv, device=None: seen.append((argv, device)))
    int8_ab.main(["--keep"], device="cpu")
    int8_ab.main(["--n_normal", "3"], device="cpu")
    assert seen == [
        (["--keep", "--n_normal", "8", "--n_anomalous", "8"], "cpu"),
        (["--n_normal", "3", "--n_anomalous", "8"], "cpu")]


def _start_from(save, seed):
    """Epoch-0 adapter files in ``save``, which each package's training
    CLI resumes from (their seeded inits differ)."""
    from aaclip_tpu_torch.core.config import AdapterConfig, get_config
    from aaclip_tpu_torch.core.params import (adapter_to_jax,
                                              init_image_adapter,
                                              init_text_adapter,
                                              text_adapter_to_jax)
    from aaclip_tpu_torch.train import checkpoint as ckpt

    cfg = get_config("tiny-test")
    acfg = AdapterConfig(levels=(1, 2), image_adapt_until=1,
                         text_adapt_until=1)
    ckpt.save_adapter_checkpoint(
        os.path.join(save, "image_adapter.npz"), 0,
        adapter_to_jax(init_image_adapter(cfg, acfg, seed=seed,
                                          device="cpu")))
    ckpt.save_adapter_checkpoint(
        os.path.join(save, "text_adapter.npz"), 0,
        text_adapter_to_jax(init_text_adapter(cfg, acfg, seed=seed + 1,
                                              device="cpu")))


@pytest.fixture
def clip_env(tmp_path, data_env, monkeypatch):
    """One seeded OpenAI-layout checkpoint for both packages' towers
    (``AACLIP_CKPT``), the CLIs' compile cache off on the JAX side."""
    import torch

    import aaclip_tpu.utils.cache as cache
    from aaclip_tpu.core.config import get_config as jax_get_config
    from tests.test_model_parity import _make_state_dict

    path = str(tmp_path / "tiny.pt")
    torch.save(_make_state_dict(jax_get_config("tiny-test", 56), seed=5),
               path)
    monkeypatch.setenv("AACLIP_CKPT", path)
    monkeypatch.setattr(cache, "enable_compilation_cache",
                        lambda *a, **k: None)


def _metrics(line):
    """The metric values of a few_shot_soak summary line."""
    return [float(v) for v in re.findall(
        r"(?:pixel_auroc|pixel_ap|image_auroc|image_ap|aupro) (\S+)",
        line)]


def test_few_shot_soak_with_memory_bank(tmp_path, clip_env):
    """JAX's tool and the port's, ``--shots 2 4 --memory_bank`` (each
    draw holds a normal image of both classes, which a bank needs), fp32
    on the host augment path, from one checkpoint and the same epoch-0
    adapter files in each K's save dir: the same four summary lines and
    the OK, each metric within the CLI tests' 0.01 points."""
    import tools.few_shot_soak as jax_soak

    from aaclip_tpu_torch.tools import few_shot_soak

    argv = ["--shots", "2", "4", "--memory_bank", "--precision", "fp32",
            "--host_augment", "--surgery_until_layer", "2",
            "--text_epoch", "2", "--image_epoch", "1",
            "--text_batch_size", "4", "--image_batch_size", "4",
            "--eval_batch_size", "4", "--num_workers", "2"] + TINY
    summaries = {}
    for name, fn, kw in (("jax", jax_soak.main, {}),
                         ("port", few_shot_soak.main, {"device": "cpu"})):
        work = str(tmp_path / name)
        for k in (2, 4):
            _start_from(os.path.join(work, f"ckpt_{k}shot"), 10 * k)
        out = _quiet(fn, argv + ["--workdir", work], **kw)
        summaries[name] = [l for l in out.split(
            "=== few-shot soak summary ===")[1].split("\n") if l.strip()]
        for k in (2, 4):
            recs = [json.loads(l) for l in open(os.path.join(
                work, "metadata", "MVTec", f"{k}-shot.jsonl"))]
            assert len(recs) == 2 * k
    got, want = summaries["port"], summaries["jax"]
    assert got[-1] == want[-1] == "FEW-SHOT SOAK OK"
    assert [l.split(":")[0] for l in got] == [l.split(":")[0] for l in want]
    assert [l.split(":")[0] for l in got[:-1]] == [
        "2-shot", "2-shot +memory_bank(w=0.5)", "4-shot",
        "4-shot +memory_bank(w=0.5)"]
    for g, w in zip(got[:-1], want[:-1]):
        assert len(_metrics(g)) == 5
        np.testing.assert_allclose(_metrics(g), _metrics(w),
                                   atol=POINTS_ATOL + 1e-9, rtol=0)


def test_few_shot_soak_refuses_more_shots_than_images():
    from aaclip_tpu_torch.tools import few_shot_soak

    with pytest.raises(SystemExit, match="12 images"):
        few_shot_soak.main(["--shots", "1", "13"], device="cpu")


def test_synthetic_demo(tmp_path, data_env):
    from aaclip_tpu_torch.examples import synthetic_end_to_end

    work = str(tmp_path / "demo")
    out = _quiet(synthetic_end_to_end.main, ["--workdir", work],
                 device="cpu")
    assert "done — metrics table in" in out
    log = open(os.path.join(work, "ckpt", "test.log")).read()
    # one table per image-adapter snapshot (2 epochs), with AUPRO
    assert log.count("Average") == 2 and "pixel AUPRO" in log
    assert sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(work, "ckpt", "image_adapter_*.npz"))) == [
        "image_adapter_1.npz", "image_adapter_2.npz"]


def _tables(log_path):
    """Every metric row of an evaluation-CLI log: (class, values)."""
    rows = []
    for line in open(log_path):
        m = re.match(r"^\s*(\w+)((?:\s+-?\d+\.\d+)+)\s*$", line)
        if m:
            rows.append((m.group(1), [float(v) for v in m.group(2).split()]))
    return rows


def test_synthetic_demo_matches_jax(tmp_path, clip_env):
    """JAX's demo and the port's from one checkpoint and the same epoch-0
    adapter files in ``{workdir}/ckpt``: every row of both snapshots'
    tables within the CLI tests' 0.01 points. With the text file at epoch
    0 and one text epoch, both skip stage 1 (the reference's resume
    quirk); ``test_synthetic_demo`` runs the port's demo with it."""
    import examples.synthetic_end_to_end as jax_demo

    from aaclip_tpu_torch.examples import synthetic_end_to_end

    tables = {}
    for name, fn, kw in (("jax", jax_demo.main, {}),
                         ("port", synthetic_end_to_end.main,
                          {"device": "cpu"})):
        work = str(tmp_path / name)
        _start_from(os.path.join(work, "ckpt"), 40)
        _quiet(fn, ["--workdir", work], **kw)
        tables[name] = _tables(os.path.join(work, "ckpt", "test.log"))
    got, want = tables["port"], tables["jax"]
    assert [c for c, _ in got] == [c for c, _ in want]
    assert [c for c, _ in got].count("Average") == 2
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, atol=POINTS_ATOL + 1e-9, rtol=0)


def test_synthetic_demo_takes_tiny_test_only():
    from aaclip_tpu_torch.examples import synthetic_end_to_end

    with pytest.raises(SystemExit, match="tiny-test only"):
        synthetic_end_to_end.main(["--model_name", "ViT-L-14-336"],
                                  device="cpu")


def test_serve_smoke_against_a_cpu_child(tmp_path, monkeypatch):
    from aaclip_tpu_torch.tools import serve_smoke
    from tests.torch_parallel_worker import free_port

    monkeypatch.setenv("AACLIP_ANCHOR_CACHE", str(tmp_path / "anchors"))
    out = _quiet(serve_smoke.main, [
        "--model_name", "tiny-test", "--img_size", "70", "--tiny_adapters",
        "--port", str(free_port()), "--startup_timeout", "240"],
        device="cpu")
    assert out.strip().endswith("SERVE HTTP SMOKE OK")
    assert out.count("untrained=True") == 4
    assert "unknown class -> HTTP 400" in out


def test_serve_smoke_refuses_a_port_in_use():
    from aaclip_tpu_torch.tools import serve_smoke

    httpd = http.server.HTTPServer(("127.0.0.1", 0),
                                   http.server.BaseHTTPRequestHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        with pytest.raises(SystemExit, match="already serving"):
            serve_smoke.main(["--port", str(httpd.server_address[1])],
                             device="cpu")
    finally:
        httpd.shutdown()
        httpd.server_close()
