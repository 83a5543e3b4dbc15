"""Both of the port's CLIs under ``--precision fp32_high`` against the JAX
package's ``train.py`` and ``test.py``, end to end on the CPU, on the
synthetic MVTec set and tiny-test checkpoint of ``test_torch_eval_cli.py``
and ``test_torch_train_cli.py``.

JAX on this CPU runs its XLA dots at "high" as true fp32 and its CLIs take
the XLA attention (no TPU), so the JAX side is the fp32 function; the port
runs every fp32 product 3-pass and the plain 3-pass attention. So the
bars are the 3-pass error against fp32, carried through the runs:

* training, 2 text epochs and 1 image epoch at batch 4 from the same
  epoch-0 adapter files: each epoch's per-step losses within 1e-4 of the
  epoch's largest (read: 3.3e-5) and every adapter entry of both
  checkpoints within atol 1e-4 (read: 3.0e-5).
* evaluation of JAX's trained checkpoints, ``--bf16_until 0`` (every block
  3-pass): the tables within 0.01 points and the scores within atol 1e-5
  (read: 0 and 1.1e-6).
* evaluation with the staged prefix, fp32_high's own ``bf16_until`` (6,
  so both tiny-test blocks run at bf16) and ``--bf16_until 1``: the bf16
  bars, the scores within atol 5e-3 (``test_torch_model.py``) and each
  table cell within 1.0 point (``chip_smoke.py`` phase 9's bf16 table bar;
  read: at most 1.5e-4 and 0.12). The two sides' bf16 attention rounds at
  other places (JAX's XLA softmax divides before P.V, the port's kernel
  arithmetic after).
"""

import csv
import os
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
from tests.test_torch_train_cli import _recording

COMMON = [
    "--model_name", "tiny-test", "--img_size", "70", "--dataset", "MVTec",
    "--text_adapt_until", "1", "--image_adapt_until", "1",
    "--levels", "1", "2", "--num_workers", "2", "--precision", "fp32_high",
]
TRAIN = ["--training_mode", "full_shot", "--surgery_until_layer", "2",
         "--text_batch_size", "4", "--image_batch_size", "4",
         "--text_epoch", "2", "--image_epoch", "1"]
EVAL = ["--batch_size", "4", "--aupro", "--csv", "--dump_scores"]
# --bf16_until of each evaluation run (None: the policy's own, 6)
STAGING = {"unstaged": ["--bf16_until", "0"], "staged": [],
           "staged_1": ["--bf16_until", "1"]}
BARS = {"unstaged": (1e-5, 0.01), "staged": (5e-3, 1.0),
        "staged_1": (5e-3, 1.0)}  # (scores atol, table points)


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fp32_high_cli"))
    data_root, meta_root = make_synthetic_dataset(root, img_px=64,
                                                  hard=True)
    cfg = get_config("tiny-test")
    acfg = AdapterConfig(levels=(1, 2), image_adapt_until=1,
                         text_adapt_until=1)
    clip = os.path.join(root, "tiny.pt")
    torch.save(_make_state_dict(jax_get_config("tiny-test", 56), seed=5),
               clip)
    save = {k: os.path.join(root, k) for k in ("jax", "port")}
    os.makedirs(save["jax"])
    ckpt.save_adapter_checkpoint(
        os.path.join(save["jax"], "image_adapter.npz"), 0,
        adapter_to_jax(init_image_adapter(cfg, acfg, seed=3, device="cpu")))
    ckpt.save_adapter_checkpoint(
        os.path.join(save["jax"], "text_adapter.npz"), 0,
        text_adapter_to_jax(init_text_adapter(cfg, acfg, seed=4,
                                              device="cpu")))
    shutil.copytree(save["jax"], save["port"])
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
    evals = {}
    try:
        import test as jax_eval
        import train as jax_train

        base = COMMON + ["--clip_checkpoint", clip]
        jax_train.main(base + TRAIN + ["--save_path", save["jax"]])
        cli.main(base + TRAIN + ["--save_path", save["port"]], device="cpu")
        # both evaluation CLIs on the checkpoints JAX trained
        for run, flags in STAGING.items():
            evals[run] = {}
            for k in ("jax", "port"):
                d = evals[run][k] = os.path.join(root, "eval", run, k)
                os.makedirs(d)
                for f in ("text_adapter.npz", "image_adapter_1.npz"):
                    shutil.copy(os.path.join(save["jax"], f),
                                os.path.join(d, f))
            argv = base + EVAL + flags
            jax_eval.main(argv + ["--save_path", evals[run]["jax"]])
            port_eval.main(argv + ["--save_path", evals[run]["port"]],
                           device="cpu")
    finally:
        mp.undo()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return save, evals, losses


def test_fp32_high_training_losses_agree(runs):
    _, _, losses = runs
    assert [len(e) for e in losses["port"]] == \
        [len(e) for e in losses["jax"]] == [3, 3, 3]
    for got, want in zip(losses["port"], losses["jax"]):
        got, want = np.asarray(got), np.asarray(want)
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("name", ["text_adapter.npz", "image_adapter.npz"])
def test_fp32_high_trained_adapters_agree(runs, name):
    save, _, _ = runs
    with np.load(os.path.join(save["jax"], name)) as j, \
            np.load(os.path.join(save["port"], name)) as p:
        assert sorted(p.files) == sorted(j.files)
        params = [k for k in j.files if not k.startswith(("opt_state",
                                                          "__"))]
        assert params
        for k in params:
            np.testing.assert_allclose(p[k], j[k], atol=1e-4, rtol=0)
        for k in j.files:
            if k.endswith(".count") or k.startswith("__"):
                assert int(p[k]) == int(j[k]), k


@pytest.mark.parametrize("run", list(STAGING))
def test_fp32_high_evaluation_agrees(runs, run):
    _, evals, _ = runs
    score_atol, points = BARS[run]
    j = _read_csv(os.path.join(evals[run]["jax"], "results_1.csv"))
    p = _read_csv(os.path.join(evals[run]["port"], "results_1.csv"))
    assert p[0] == j[0] and [r[0] for r in p] == [r[0] for r in j]
    np.testing.assert_allclose(
        np.array([[float(x) for x in r[1:]] for r in p[1:]]),
        np.array([[float(x) for x in r[1:]] for r in j[1:]]),
        atol=points, rtol=0)
    j = _read_csv(os.path.join(evals[run]["jax"], "scores_1.csv"))
    p = _read_csv(os.path.join(evals[run]["port"], "scores_1.csv"))
    assert [r[:3] for r in p] == [r[:3] for r in j] and len(p) == 13
    np.testing.assert_allclose([float(r[3]) for r in p[1:]],
                               [float(r[3]) for r in j[1:]],
                               atol=score_atol, rtol=0)
    log = open(os.path.join(evals[run]["port"], "test.log")).read()
    assert "'precision': 'fp32_high'" in log


def test_fp32_high_flags_parse_and_the_rest_still_raise():
    args = port_eval.parse_args(["--precision", "fp32_high",
                                 "--bf16_until", "3"])
    assert (args.precision, args.bf16_until) == ("fp32_high", 3)
    assert cli.parse_args(["--precision", "fp32_high"]).precision == \
        "fp32_high"
    assert cli.parse_args(["--precision", "fp32_high", "--remat",
                           "selective"]).remat == "selective"
    assert port_eval.parse_args(["--precision", "int8"]).precision == \
        "int8"
    # data parallelism is ported: it composes with fp32_high, as in JAX
    args = port_eval.parse_args(["--precision", "fp32_high",
                                 "--data_parallel"])
    assert (args.precision, args.data_parallel) == ("fp32_high", True)
    # so does the pipeline (ported, ROADMAP A12): JAX's CLI turns the
    # staged trunk off for it at run time, and at one device it exits
    args = port_eval.parse_args(["--precision", "fp32_high",
                                 "--pipeline_parallel", "2"])
    assert (args.precision, args.pipeline_parallel) == ("fp32_high", 2)
    with pytest.raises(SystemExit, match="exceeds the 1 available devices"):
        port_eval.main(["--precision", "fp32_high", "--pipeline_parallel",
                        "2"], device="cpu")
