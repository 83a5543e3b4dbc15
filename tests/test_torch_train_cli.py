"""The port's training CLI (``python -m aaclip_tpu_torch.train``) against
the JAX package's ``train.py``, end to end on the CPU, then both
evaluation CLIs on what each trained.

Both CLIs train tiny-test at fp32 on one synthetic MVTec set (2 classes,
12 images) from one OpenAI-layout checkpoint written by the test, with
``--text_epoch 2 --image_epoch 2`` at batch 4 on the host input path
(colour jitter and geometric augment included). Both start from the same
epoch-0 adapter files placed in each ``save_path``, which each CLI's
resume reads (the seeded inits of the two packages differ). Two text
epochs, because the reference's resume quirk skips the text stage when
the checkpoint's epoch is ``text_epoch - 1``.

Bars: every per-step loss within rtol 1e-5 and every adapter entry of
each checkpoint within atol 1e-5 (``test_torch_train.py``'s bars for the
stage-2 step; here no entry needs leaving out), the optimizer state
under the same keys with the same counts; the evaluation tables within
0.01 points and the per-image scores within atol 1e-4
(``test_torch_eval_cli.py``'s bars). A run stopped after one image epoch
and resumed equals the uninterrupted run bit for bit (adapters, Adam's
moments and count, the schedule's count). Every flag of a path not
ported yet raises at parse time naming its ROADMAP item.
"""

import csv
import os
import re
import shutil

import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import get_config as jax_get_config
from aaclip_tpu_torch import test as port_eval
from aaclip_tpu_torch.core.config import AdapterConfig, get_config
from aaclip_tpu_torch.core.params import (adapter_to_jax, init_image_adapter,
                                          init_text_adapter,
                                          text_adapter_to_jax)
from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
from aaclip_tpu_torch.train import checkpoint as ckpt
from aaclip_tpu_torch.train import cli
from tests.test_model_parity import _make_state_dict

COMMON = [
    "--model_name", "tiny-test", "--img_size", "70", "--dataset", "MVTec",
    "--text_adapt_until", "1", "--image_adapt_until", "1",
    "--levels", "1", "2", "--num_workers", "2", "--precision", "fp32",
]
STAGES = ["--training_mode", "full_shot", "--surgery_until_layer", "2",
          "--text_batch_size", "4", "--image_batch_size", "4"]
TRAIN = STAGES + ["--text_epoch", "2", "--image_epoch", "2",
                  "--profile_input"]
EVAL = ["--batch_size", "4", "--aupro", "--csv", "--dump_scores"]
LOSS_RTOL, ADAPTER_ATOL = 1e-5, 1e-5
SCORE_ATOL, POINTS_ATOL = 1e-4, 0.01


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _recording(module, into):
    """``module.ThrottledLossDrain`` with ``drain`` recording each epoch's
    per-step losses into ``into``."""
    base = module.ThrottledLossDrain

    class Recording(base):
        def drain(self):
            vals = super().drain()
            into.append(vals)
            return vals

    return Recording


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_cli"))
    data_root, meta_root = make_synthetic_dataset(root, img_px=64,
                                                  hard=True)
    cfg = get_config("tiny-test")
    acfg = AdapterConfig(levels=(1, 2), image_adapt_until=1,
                         text_adapt_until=1)
    clip = os.path.join(root, "tiny.pt")
    torch.save(_make_state_dict(jax_get_config("tiny-test", 56), seed=5),
               clip)
    save = {k: os.path.join(root, k) for k in ("jax", "port", "resumed")}
    os.makedirs(save["jax"])
    ckpt.save_adapter_checkpoint(
        os.path.join(save["jax"], "image_adapter.npz"), 0,
        adapter_to_jax(init_image_adapter(cfg, acfg, seed=3, device="cpu")))
    ckpt.save_adapter_checkpoint(
        os.path.join(save["jax"], "text_adapter.npz"), 0,
        text_adapter_to_jax(init_text_adapter(cfg, acfg, seed=4,
                                              device="cpu")))
    shutil.copytree(save["jax"], save["port"])
    shutil.copytree(save["jax"], save["resumed"])
    env = {"AACLIP_DATA": data_root, "AACLIP_METADATA": meta_root}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    losses = {"jax": [], "port": []}
    import aaclip_tpu.utils.profiling as jprof
    import aaclip_tpu_torch.utils.profiling as pprof

    mp = pytest.MonkeyPatch()
    mp.setattr(jprof, "ThrottledLossDrain", _recording(jprof, losses["jax"]))
    mp.setattr(pprof, "ThrottledLossDrain",
               _recording(pprof, losses["port"]))
    try:
        import test as jax_eval
        import train as jax_train

        base = COMMON + ["--clip_checkpoint", clip]
        jax_train.main(base + TRAIN + ["--save_path", save["jax"]])
        cli.main(base + TRAIN + ["--save_path", save["port"]], device="cpu")
        # stopped after one image epoch, then resumed
        first = STAGES + ["--text_epoch", "2", "--save_path",
                          save["resumed"]]
        cli.main(base + first + ["--image_epoch", "1"], device="cpu")
        cli.main(base + first + ["--image_epoch", "2"], device="cpu")
        for k in ("jax", "port"):
            os.makedirs(os.path.join(root, "eval", k))
            for f in ("text_adapter.npz", "image_adapter_2.npz"):
                shutil.copy(os.path.join(save[k], f),
                            os.path.join(root, "eval", k, f))
        evals = {k: os.path.join(root, "eval", k) for k in ("jax", "port")}
        jax_eval.main(base + EVAL + ["--save_path", evals["jax"]])
        port_eval.main(base + EVAL + ["--save_path", evals["port"]],
                       device="cpu")
    finally:
        mp.undo()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return save, evals, losses


def test_per_step_losses_agree(runs):
    _, _, losses = runs
    # JAX: 2 text + 2 image epochs; the port: the same, then the resumed
    # run's 2 text + 1 image epochs and its resumed image epoch
    assert [len(e) for e in losses["jax"]] == [3, 3, 3, 3]
    assert [len(e) for e in losses["port"]] == [3] * 8
    got = np.array(losses["port"][:4])
    want = np.array(losses["jax"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("name", ["text_adapter.npz", "image_adapter.npz",
                                  "image_adapter_1.npz",
                                  "image_adapter_2.npz"])
def test_checkpoints_agree(runs, name):
    save, _, _ = runs
    with np.load(os.path.join(save["jax"], name)) as j, \
            np.load(os.path.join(save["port"], name)) as p:
        assert sorted(j.files) == sorted(p.files)
        assert any(k.startswith("opt_state/0/.mu/") for k in p.files)
        for k in j.files:
            assert j[k].dtype == p[k].dtype, k
            if k.startswith("adapter/"):
                np.testing.assert_allclose(p[k], j[k], atol=ADAPTER_ATOL,
                                           rtol=0, err_msg=k)
            elif k.endswith(".count") or k.startswith("__"):
                assert int(p[k]) == int(j[k]), k
        assert int(p["__epoch__"]) == {"text_adapter.npz": 2,
                                       "image_adapter_1.npz": 1}.get(name, 2)
        assert int(p["__step__"]) == 3 * int(p["__epoch__"])


@pytest.mark.parametrize("name", ["text_adapter.npz", "image_adapter.npz",
                                  "image_adapter_2.npz"])
def test_resumed_run_equals_the_uninterrupted_one(runs, name):
    save, _, _ = runs
    with np.load(os.path.join(save["resumed"], name)) as r, \
            np.load(os.path.join(save["port"], name)) as p:
        assert r.files == p.files
        for k in p.files:
            assert r[k].dtype == p[k].dtype
            np.testing.assert_array_equal(r[k], p[k], err_msg=k)
    log = open(os.path.join(save["resumed"], "train.log")).read()
    assert log.count("training image epoch 0:") == 1
    assert log.count("training image epoch 1:") == 1
    assert log.count("training text epoch 1:") == 1


def test_logs_name_the_epochs_rates_and_phases(runs):
    save, _, _ = runs
    log = open(os.path.join(save["port"], "train.log")).read()
    for line in ("training text epoch 1:", "training image epoch 1:",
                 "remat auto: stage 1 (text tower) selective, stage 2 full",
                 "host-loop phase decomposition",
                 "features_dispatch", "step_dispatch", "loader_wait",
                 "done"):
        assert line in log, line
    rates = [float(r) for r in re.findall(r"throughput: ([\d.]+) img/s",
                                          log)]
    assert len(rates) == 4 and all(r > 0 for r in rates)


def test_evaluations_of_both_runs_agree(runs):
    _, evals, _ = runs
    j = _read_csv(os.path.join(evals["jax"], "results_2.csv"))
    p = _read_csv(os.path.join(evals["port"], "results_2.csv"))
    assert p[0] == j[0] and [r[0] for r in p] == [r[0] for r in j] == [
        "class name", "bottle", "cable", "Average"]
    np.testing.assert_allclose(
        np.array([[float(x) for x in r[1:]] for r in p[1:]]),
        np.array([[float(x) for x in r[1:]] for r in j[1:]]),
        atol=POINTS_ATOL, rtol=0)
    j = _read_csv(os.path.join(evals["jax"], "scores_2.csv"))
    p = _read_csv(os.path.join(evals["port"], "scores_2.csv"))
    assert [r[:3] for r in p] == [r[:3] for r in j] and len(p) == 13
    np.testing.assert_allclose([float(r[3]) for r in p[1:]],
                               [float(r[3]) for r in j[1:]],
                               atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("flags,label", [
    # the pipeline flags are ported (ROADMAP A12) and follow JAX's rules
    # (train.py:316-345): in one process the pipeline exceeds the
    # devices, as JAX's exits at one device
    (["--pipeline_parallel", "2"], "exceeds the 1 available devices"),
    (["--pp_microbatches", "4"], None),
    (["--data_parallel", "--pipeline_parallel", "2"],
     "exceeds the 1 available devices"),
    (["--ckpt_backend", "orbax"], "ROADMAP A6"),
])
def test_unported_flags_raise_naming_their_item(flags, label, tmp_path):
    """The orbax backend still raises naming its item at parse time;
    the pipeline flags parse, and exit at the start of ``main`` in a
    world of one, before anything is written."""
    if label is not None and label.startswith("ROADMAP"):
        with pytest.raises(NotImplementedError, match=label):
            cli.parse_args(flags)
        return
    args = cli.parse_args(flags)
    assert args.pipeline_parallel == (2 if "--pipeline_parallel" in flags
                                      else 1)
    if label is None:
        return
    with pytest.raises(SystemExit, match=label):
        cli.main(flags + ["--save_path", str(tmp_path / "run")],
                 device="cpu")
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("flags,refusal", [
    # JAX's rules (train.py:193-197; steps.py's sequence_parallel check)
    (["--sequence_parallel"], "requires --tensor_parallel"),
    (["--data_parallel", "--sequence_parallel"],
     "requires --tensor_parallel"),
    (["--cache_device", "--device_augment", "--data_parallel"],
     "--cache_device assembles single-device batches"),
    (["--cache_device", "--device_augment", "--tensor_parallel", "2"],
     "--cache_device assembles single-device batches"),
    # ported: these parse
    (["--data_parallel"], None),
    (["--tensor_parallel", "2"], None),
    (["--tensor_parallel", "2", "--sequence_parallel"], None),
    (["--data_parallel", "--grad_accum", "2"], None),
])
def test_parallel_flags_follow_jax_rules(flags, refusal, capsys):
    if refusal is None:
        args = cli.parse_args(flags)
        assert args.data_parallel == ("--data_parallel" in flags)
        return
    with pytest.raises(SystemExit):
        cli.parse_args(flags)
    assert refusal in capsys.readouterr().err


@pytest.mark.parametrize("flags,key,value", [
    (["--remat", "selective"], "remat", "selective"),
    (["--fused_assemble", "--cache_device", "--device_augment"],
     "fused_assemble", True),
])
def test_selective_remat_and_fused_assemble_parse(flags, key, value):
    """Selective remat and fused assembly: their flags parse as JAX's."""
    import train as jax_train

    assert getattr(cli.parse_args(flags), key) == value
    assert vars(cli.parse_args(flags)) == vars(jax_train.parse_args(flags))


@pytest.mark.parametrize("flags", [["--fused_assemble"], ["--cache_device"]])
def test_jax_s_flag_rules_hold(flags):
    with pytest.raises(SystemExit):
        cli.parse_args(flags)


def test_defaults_match_the_jax_cli_and_the_card_is_the_default():
    import train as jax_train

    assert vars(cli.parse_args([])) == vars(jax_train.parse_args([]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--model_name", "tiny-test"])
