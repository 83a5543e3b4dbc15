"""The port's evaluation CLI (``python -m aaclip_tpu_torch.test``) against
the JAX package's ``test.py``, end to end on the CPU: the same synthetic
MVTec dataset (2 classes), the same tiny-test OpenAI-layout checkpoint
(written at a 4x4 grid, so both loaders resize the positional embedding
to 5x5), an npz image adapter and a reference ``.pth`` text adapter, at
fp32 with ``--aupro --csv --dump_scores``, and again with
``--memory_bank --shot 2`` (the synthetic set's 2-shot metadata as each
class's support).

Bars: every cell of ``results_1.csv`` within 0.01 points (the table is
rounded to 0.01 points, so a score moved by fp32 ulps may flip one
rounding), every per-image score within atol 1e-4 (fp32 through both
towers in another summation order). Every flag of a path not ported yet
raises at parse time naming its ROADMAP item.
"""

import csv
import os
import shutil

import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import get_config as jax_get_config
from aaclip_tpu_torch import test as port_cli
from aaclip_tpu_torch.core.config import AdapterConfig, get_config
from aaclip_tpu_torch.core.params import (adapter_to_jax, init_image_adapter,
                                          init_text_adapter,
                                          text_adapter_to_jax)
from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
from aaclip_tpu_torch.train import checkpoint as ckpt
from tests.test_model_parity import _make_state_dict

COMMON = [
    "--model_name", "tiny-test", "--img_size", "70", "--dataset", "MVTec",
    "--text_adapt_until", "1", "--image_adapt_until", "1",
    "--levels", "1", "2", "--num_workers", "2", "--batch_size", "4",
    "--precision", "fp32", "--aupro", "--csv", "--dump_scores",
]
SCORE_ATOL = 1e-4
POINTS_ATOL = 0.01


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """(root, data env, checkpoint path, adapter dir) shared by the runs."""
    root = str(tmp_path_factory.mktemp("eval_cli"))
    data_root, meta_root = make_synthetic_dataset(root, img_px=64,
                                                  hard=True)
    cfg = get_config("tiny-test")
    acfg = AdapterConfig(levels=(1, 2), image_adapt_until=1,
                         text_adapt_until=1)
    ckpt_path = os.path.join(root, "tiny.pt")
    torch.save(_make_state_dict(jax_get_config("tiny-test", 56), seed=5),
               ckpt_path)
    adapters = os.path.join(root, "adapters")
    os.makedirs(adapters)
    ckpt.save_adapter_checkpoint(
        os.path.join(adapters, "image_adapter_1.npz"), 1,
        adapter_to_jax(init_image_adapter(cfg, acfg, seed=3, device="cpu")))
    text_sd, _ = ckpt.adapters_to_torch_state_dicts(
        {"text": text_adapter_to_jax(init_text_adapter(cfg, acfg, seed=4,
                                                       device="cpu")),
         "image": adapter_to_jax(init_image_adapter(cfg, acfg,
                                                    device="cpu"))},
        proj_relu=False)
    torch.save({"epoch": 0, "text_adapter": text_sd},
               os.path.join(adapters, "text_adapter.pth"))
    env = {"AACLIP_DATA": data_root, "AACLIP_METADATA": meta_root}
    return root, env, ckpt_path, adapters


def _run_both(assets, name, extra):
    """Both CLIs with COMMON + ``extra`` from copies of the adapter dir;
    returns {"jax": save_path, "port": save_path}."""
    root, env, ckpt_path, adapters = assets
    save = {k: os.path.join(root, f"{name}_{k}") for k in ("jax", "port")}
    for path in save.values():
        shutil.copytree(adapters, path)
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        import test as jax_cli

        argv = COMMON + extra + ["--clip_checkpoint", ckpt_path]
        jax_cli.main(argv + ["--save_path", save["jax"]])
        port_cli.main(argv + ["--save_path", save["port"]], device="cpu")
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return save


@pytest.fixture(scope="module")
def runs(assets):
    return _run_both(assets, "plain", [])


@pytest.fixture(scope="module")
def mb_runs(assets):
    """``--memory_bank --shot 2``: the synthetic set's 2-shot metadata
    (each class's first two normal images) as the support."""
    return _run_both(assets, "mb", ["--memory_bank", "--shot", "2"])


def _tables_agree(runs):
    jax_rows = _read_csv(os.path.join(runs["jax"], "results_1.csv"))
    port_rows = _read_csv(os.path.join(runs["port"], "results_1.csv"))
    assert port_rows[0] == jax_rows[0] == [
        "class name", "pixel AUC", "pixel AP", "image AUC", "image AP",
        "pixel AUPRO"]
    assert [r[0] for r in port_rows[1:]] == [r[0] for r in jax_rows[1:]] \
        == ["bottle", "cable", "Average"]
    got = np.array([[float(x) for x in r[1:]] for r in port_rows[1:]])
    want = np.array([[float(x) for x in r[1:]] for r in jax_rows[1:]])
    np.testing.assert_allclose(got, want, atol=POINTS_ATOL, rtol=0)
    # the synthetic task is not degenerate: the table compares real curves
    assert (want[:2, :4] > 0).all()


def _scores_agree(runs):
    jax_rows = _read_csv(os.path.join(runs["jax"], "scores_1.csv"))
    port_rows = _read_csv(os.path.join(runs["port"], "scores_1.csv"))
    assert port_rows[0] == jax_rows[0] == ["class name", "file", "label",
                                           "image_score"]
    assert len(port_rows) == len(jax_rows) == 1 + 12
    assert [r[:3] for r in port_rows] == [r[:3] for r in jax_rows]
    np.testing.assert_allclose([float(r[3]) for r in port_rows[1:]],
                               [float(r[3]) for r in jax_rows[1:]],
                               atol=SCORE_ATOL, rtol=0)


def test_results_tables_agree(runs):
    _tables_agree(runs)


def test_scores_agree(runs):
    _scores_agree(runs)


def test_memory_bank_results_tables_agree(mb_runs):
    _tables_agree(mb_runs)


def test_memory_bank_scores_agree(mb_runs):
    _scores_agree(mb_runs)


def test_memory_bank_moves_the_scores_and_logs_its_banks(runs, mb_runs):
    plain = _read_csv(os.path.join(runs["port"], "scores_1.csv"))
    fused = _read_csv(os.path.join(mb_runs["port"], "scores_1.csv"))
    assert [r[:3] for r in plain] == [r[:3] for r in fused]
    assert any(a[3] != b[3] for a, b in zip(plain[1:], fused[1:]))
    log = open(os.path.join(mb_runs["port"], "test.log")).read()
    assert "memory_bank: fusing 2-shot nearest-neighbor scores at weight " \
        "0.50" in log
    # 2 support images x 25 patches per class, 2 levels
    assert log.count("memory bank: 50 patch vectors/level x 2 levels "
                     "(2-shot)") == 2


def test_log_has_the_table_and_the_rate(runs):
    log = open(os.path.join(runs["port"], "test.log")).read()
    assert "load model from epoch 1" in log
    assert "final results" in log and "Average" in log
    assert "eval throughput:" in log
    assert "Sample number: 6" in log
    # the host paths that ran, once, and each class's metrics time
    from aaclip_tpu_torch import native
    from aaclip_tpu_torch.native import image

    assert log.count("host paths: metrics ") == 1
    assert f"host paths: metrics {native.metrics_path()} " in log
    # 12 images and the 6 anomalous ones' masks
    decoded = "decode native 18, fallback 0" \
        if image.image_native_available() else "decode native 0, fallback 18"
    assert decoded in log, log[log.index("host paths"):]
    assert log.count("metrics_eval: ") == 2


@pytest.mark.parametrize("flags,label", [
    # the pipeline and visualization flags are ported (ROADMAP A12, A15)
    # and follow JAX's rules (test.py:128-138, :422-456): in one process
    # the pipeline exceeds the devices, as JAX's exits at one device
    (["--pipeline_parallel", "2"], "exceeds the 1 available devices"),
    (["--pp_microbatches", "4"], None),
    (["--artifact", "somewhere", "--pipeline_parallel", "2"],
     "--artifact serves"),
    (["--data_parallel", "--pipeline_parallel", "2"],
     "exceeds the 1 available devices"),
    (["--visualize"], None),
])
def test_unported_flags_raise_naming_their_item(flags, label, capsys,
                                                tmp_path):
    """Each flag parses, is refused at parse time with JAX's message
    (``--artifact`` with the pipeline), or exits at the start of ``main``
    as JAX's CLI does in a world of one device."""
    if flags[0] == "--artifact":
        with pytest.raises(SystemExit):
            port_cli.parse_args(flags)
        assert label in capsys.readouterr().err
        return
    args = port_cli.parse_args(flags)
    assert args.visualize == ("--visualize" in flags)
    if label is None:
        return
    with pytest.raises(SystemExit, match=label):
        port_cli.main(flags + ["--save_path", str(tmp_path / "run")],
                      device="cpu")
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("flags,refusal", [
    # JAX's rules (test.py:128-137, eval/predict.py:76-80, :136-138)
    (["--artifact", "somewhere", "--data_parallel"], "--artifact serves"),
    (["--artifact", "somewhere", "--tensor_parallel", "2"],
     "--artifact serves"),
    (["--precision", "int8", "--tensor_parallel", "2"], "int8 quantized"),
    (["--sequence_parallel"], "requires --tensor_parallel"),
    (["--data_parallel", "--sequence_parallel"],
     "requires --tensor_parallel"),
    (["--memory_bank", "--tensor_parallel", "2"], "--memory_bank runs"),
    # ported: these parse
    (["--data_parallel"], None),
    (["--tensor_parallel", "2"], None),
    (["--tensor_parallel", "2", "--sequence_parallel"], None),
    (["--memory_bank", "--data_parallel"], None),
    (["--precision", "int8", "--data_parallel"], None),
])
def test_parallel_flags_follow_jax_rules(flags, refusal, capsys):
    """The parallel flags parse, or are refused at parse time with JAX's
    message, combination by combination."""
    if refusal is None:
        args = port_cli.parse_args(flags)
        assert args.data_parallel == ("--data_parallel" in flags)
        return
    with pytest.raises(SystemExit):
        port_cli.parse_args(flags)
    assert refusal in capsys.readouterr().err


@pytest.mark.parametrize("flags,want", [
    (["--precision", "int8"], dict(precision="int8", int8_until=None)),
    (["--precision", "int8", "--int8_until", "2"],
     dict(precision="int8", int8_until=2)),
    (["--artifact", "somewhere"], dict(artifact="somewhere")),
])
def test_int8_and_artifact_flags_parse(flags, want):
    """int8, --int8_until and --artifact are ported: they parse (the runs
    are in test_torch_quant.py and test_torch_deploy.py); --int8_until
    without int8 is refused, as JAX's CLI refuses it."""
    args = vars(port_cli.parse_args(flags))
    assert {k: args[k] for k in want} == want
    with pytest.raises(SystemExit):
        port_cli.parse_args(["--int8_until", "2"])


def test_defaults_and_snapshot_order_match_the_jax_cli():
    import test as jax_cli

    port, jax = vars(port_cli.parse_args([])), vars(jax_cli.parse_args([]))
    jax.pop("shot_explicit")
    assert port == jax
    paths = [f"d/image_adapter_{e}.npz" for e in (10, 2, 1)]
    assert sorted(paths, key=port_cli._snap_epoch) == [
        "d/image_adapter_1.npz", "d/image_adapter_2.npz",
        "d/image_adapter_10.npz"]


def test_orbax_snapshot_raises_naming_a6(tmp_path):
    d = tmp_path / "image_adapter_1.orbax"
    d.mkdir()
    assert ckpt.find_adapter_checkpoint(
        str(tmp_path / "image_adapter_1.npz")) == str(d)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        ckpt.load_adapter_checkpoint_any(str(d), {})
