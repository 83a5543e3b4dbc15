"""Both of the port's CLIs under a 2-rank gloo world on the CPU (each rank
runs ``main(argv, device="cpu")`` with ``torchrun``'s variables set,
``tests/torch_parallel_worker.py``, one world with a 120 s timeout)
against the JAX package's ``test.py`` and ``train.py`` with the same
parallel flags on its 8-device CPU mesh, on the synthetic MVTec set of
``test_torch_eval_cli.py`` and ``test_torch_train_cli.py``:

* ``test --data_parallel``, with ``--memory_bank --shot 2``, and
  ``--tensor_parallel 2 --sequence_parallel``: every cell of the results
  CSV within 0.01 points and every per-image score within atol 1e-4
  (test_torch_eval_cli's bars);
* ``train --data_parallel``, two text epochs and one image epoch at
  batch 4:
  every per-step loss within rtol 1e-5 (test_torch_train_cli's bar) and
  the saved adapters within atol 1e-5.

Only rank 0 writes: the other rank's log stays empty.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import get_config as jax_get_config
from aaclip_tpu_torch.core.config import AdapterConfig, get_config
from aaclip_tpu_torch.core.params import (adapter_to_jax, init_image_adapter,
                                          init_text_adapter,
                                          text_adapter_to_jax)
from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
from aaclip_tpu_torch.train import checkpoint as ckpt
from tests.test_model_parity import _make_state_dict
from tests.test_torch_eval_cli import COMMON as EVAL_COMMON
from tests.test_torch_eval_cli import POINTS_ATOL, SCORE_ATOL, _read_csv
from tests.test_torch_train_cli import COMMON as TRAIN_COMMON
from tests.test_torch_train_cli import STAGES, _recording
from tests.torch_parallel_worker import run_world

EVALS = {
    "dp": ["--data_parallel"],
    "dp_mb": ["--data_parallel", "--memory_bank", "--shot", "2"],
    "tp_sp": ["--tensor_parallel", "2", "--sequence_parallel"],
}
TRAIN = STAGES + ["--text_epoch", "2", "--image_epoch", "1",
                  "--data_parallel"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel_cli"))
    data_root, meta_root = make_synthetic_dataset(root, img_px=64,
                                                  hard=True)
    cfg = get_config("tiny-test")
    acfg = AdapterConfig(levels=(1, 2), image_adapt_until=1,
                         text_adapt_until=1)
    clip = os.path.join(root, "tiny.pt")
    torch.save(_make_state_dict(jax_get_config("tiny-test", 56), seed=5),
               clip)
    adapters = os.path.join(root, "adapters")
    ckpt.save_adapter_checkpoint(
        os.path.join(adapters, "image_adapter_1.npz"), 1,
        adapter_to_jax(init_image_adapter(cfg, acfg, seed=3, device="cpu")))
    train0 = os.path.join(root, "train0")
    ckpt.save_adapter_checkpoint(
        os.path.join(train0, "image_adapter.npz"), 0,
        adapter_to_jax(init_image_adapter(cfg, acfg, seed=3, device="cpu")))
    ckpt.save_adapter_checkpoint(
        os.path.join(train0, "text_adapter.npz"), 0,
        text_adapter_to_jax(init_text_adapter(cfg, acfg, seed=4,
                                              device="cpu")))
    env = {"AACLIP_DATA": data_root, "AACLIP_METADATA": meta_root}
    save, cases = {}, []
    for name, flags in EVALS.items():
        for k in ("jax", "port"):
            save[name, k] = os.path.join(root, f"{name}_{k}")
            shutil.copytree(adapters, save[name, k])
        cases.append(("cli", dict(kind="test", env=env, argv=(
            EVAL_COMMON + flags + ["--clip_checkpoint", clip,
                                   "--save_path", save[name, "port"]]))))
    for k in ("jax", "port"):
        save["train", k] = os.path.join(root, f"train_{k}")
        shutil.copytree(train0, save["train", k])
    base = TRAIN_COMMON + ["--clip_checkpoint", clip]
    cases.append(("cli", dict(kind="train", env=env, argv=(
        base + TRAIN + ["--save_path", save["train", "port"]]))))
    ranks = run_world(2, cases)
    assert ranks[0][-1] == ranks[1][-1]  # every rank logs the global loss

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    jax_losses = []
    import aaclip_tpu.utils.profiling as jprof

    mp = pytest.MonkeyPatch()
    mp.setattr(jprof, "ThrottledLossDrain", _recording(jprof, jax_losses))
    try:
        import test as jax_eval
        import train as jax_train

        for name, flags in EVALS.items():
            jax_eval.main(EVAL_COMMON + flags + [
                "--clip_checkpoint", clip, "--save_path", save[name, "jax"]])
        jax_train.main(base + TRAIN + ["--save_path", save["train", "jax"]])
    finally:
        mp.undo()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return save, ranks[0][-1], jax_losses


@pytest.mark.parametrize("name", list(EVALS))
def test_eval_cli_under_two_ranks_matches_jax(runs, name):
    save = runs[0]
    jax_rows = _read_csv(os.path.join(save[name, "jax"], "results_1.csv"))
    port_rows = _read_csv(os.path.join(save[name, "port"], "results_1.csv"))
    assert port_rows[0] == jax_rows[0]
    assert [r[0] for r in port_rows] == [r[0] for r in jax_rows]
    np.testing.assert_allclose(
        [[float(c) for c in r[1:]] for r in port_rows[1:]],
        [[float(c) for c in r[1:]] for r in jax_rows[1:]],
        atol=POINTS_ATOL, rtol=0)
    j = _read_csv(os.path.join(save[name, "jax"], "scores_1.csv"))
    p = _read_csv(os.path.join(save[name, "port"], "scores_1.csv"))
    assert [r[:3] for r in p] == [r[:3] for r in j] and len(p) == 13
    np.testing.assert_allclose([float(r[3]) for r in p[1:]],
                               [float(r[3]) for r in j[1:]],
                               atol=SCORE_ATOL, rtol=0)
    with open(os.path.join(save[name, "port"], "test.log")) as f:
        log = f.read()
    assert "mesh: data=" in log and log.count("final results") == 1


def test_train_cli_under_two_ranks_matches_jax(runs):
    save, port_losses, jax_losses = runs
    assert [len(e) for e in port_losses] == [len(e) for e in jax_losses]
    assert len(port_losses) == 3  # two text epochs and one image epoch
    np.testing.assert_allclose(np.concatenate(port_losses),
                               np.concatenate(jax_losses), rtol=1e-5)
    for f in ("text_adapter.npz", "image_adapter_1.npz"):
        with np.load(os.path.join(save["train", "jax"], f)) as j, \
                np.load(os.path.join(save["train", "port"], f)) as p:
            assert sorted(j.files) == sorted(p.files)
            for k in j.files:
                if k.startswith("adapter/"):
                    np.testing.assert_allclose(p[k], j[k], atol=1e-5,
                                               rtol=0, err_msg=k)
