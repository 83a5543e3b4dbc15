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
  batch 4 and at batch 3 (which the ranks do not divide: each global
  batch is padded with ``valid = 0`` rows and dealt): every per-step loss
  within rtol 1e-5 (test_torch_train_cli's bar) and the saved adapters
  within atol 1e-5.

Each data rank loads, decodes and predicts only its rows of each global
batch (its loader's ``host_id`` / ``num_hosts``): under ``test
--data_parallel`` and ``train --data_parallel`` each rank loads exactly
half the samples the same CLI loads in one process without a mesh, and
the two ranks' decoded files (``data/transforms.py::DECODE_COUNTS``) add
up to the one process's (the masks need not split evenly: only anomalous
samples have one); the results above are the global batch's. The device
augment draws each row's parameters from the global batch's draws, so a
row's augment does not depend on how many ranks share the batch.

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
# global batches of 3 on two data ranks: each rank's share padded to 2
RAGGED = TRAIN + ["--text_batch_size", "3", "--image_batch_size", "3"]


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
        cases.append(("decoded", dict(case="cli", kwargs=dict(
            kind="test", env=env, argv=(
                EVAL_COMMON + flags + ["--clip_checkpoint", clip,
                                       "--save_path", save[name, "port"]])))))
    for name, k in [("train", "one")] + [
            (name, k) for name in ("train", "ragged") for k in ("jax", "port")]:
        save[name, k] = os.path.join(root, f"{name}_{k}")
        shutil.copytree(train0, save[name, k])
    save["dp", "one"] = os.path.join(root, "dp_one")
    shutil.copytree(adapters, save["dp", "one"])
    base = TRAIN_COMMON + ["--clip_checkpoint", clip]
    # the last case is the batch-4 training run (what each rank decodes)
    for name, flags in (("ragged", RAGGED), ("train", TRAIN)):
        cases.append(("decoded", dict(case="cli", kwargs=dict(
            kind="train", env=env, argv=(
                base + flags + ["--save_path", save[name, "port"]])))))
    ranks = run_world(2, cases)
    # every rank logs the global loss
    assert ranks[0][-1][0] == ranks[1][-1][0]
    # what each rank loaded and decoded: the "dp" evaluation, the training
    decodes = [(r[0][1], r[-1][1]) for r in ranks]

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    jax_losses, jax_ragged = [], []
    import aaclip_tpu.utils.profiling as jprof

    from aaclip_tpu_torch import test as port_eval
    from aaclip_tpu_torch.train import cli as port_train
    from tests.torch_parallel_worker import count_loads

    mp = pytest.MonkeyPatch()
    mp.setattr(jprof, "ThrottledLossDrain", _recording(jprof, jax_losses))
    try:
        import test as jax_eval
        import train as jax_train

        for name, flags in EVALS.items():
            jax_eval.main(EVAL_COMMON + flags + [
                "--clip_checkpoint", clip, "--save_path", save[name, "jax"]])
        jax_train.main(base + TRAIN + ["--save_path", save["train", "jax"]])
        mp.undo()
        mp.setattr(jprof, "ThrottledLossDrain",
                   _recording(jprof, jax_ragged))
        jax_train.main(base + RAGGED + ["--save_path",
                                        save["ragged", "jax"]])
        # the port in one process without a mesh: what it loads and decodes
        one = []
        for module, argv in (
                (port_eval, EVAL_COMMON + ["--clip_checkpoint", clip,
                                           "--save_path", save["dp", "one"]]),
                (port_train, base + TRAIN[:-1] + [
                    "--save_path", save["train", "one"]])):
            with count_loads() as got:
                module.main(argv, device="cpu")
            one.append(got)
    finally:
        mp.undo()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return save, ranks[0][-1][0], jax_losses, decodes, tuple(one), \
        ranks[0][-2][0], jax_ragged


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


@pytest.mark.parametrize("name", ["train", "ragged"])
def test_train_cli_under_two_ranks_matches_jax(runs, name):
    """Batch 4 (two rows a rank) and batch 3, which the two ranks do not
    divide: each global batch is padded to 4 with a ``valid = 0`` row and
    dealt, as JAX pads it to its 8 devices."""
    save = runs[0]
    port_losses, jax_losses = (runs[1], runs[2]) if name == "train" \
        else (runs[5], runs[6])
    assert [len(e) for e in port_losses] == [len(e) for e in jax_losses]
    assert len(port_losses) == 3  # two text epochs and one image epoch
    assert len(port_losses[-1]) == (3 if name == "train" else 4)
    np.testing.assert_allclose(np.concatenate(port_losses),
                               np.concatenate(jax_losses), rtol=1e-5)
    for f in ("text_adapter.npz", "image_adapter_1.npz"):
        with np.load(os.path.join(save[name, "jax"], f)) as j, \
                np.load(os.path.join(save[name, "port"], f)) as p:
            assert sorted(j.files) == sorted(p.files)
            for k in j.files:
                if k.startswith("adapter/"):
                    np.testing.assert_allclose(p[k], j[k], atol=1e-5,
                                               rtol=0, err_msg=k)


def test_each_rank_decodes_half_of_one_process(runs):
    """Under two data ranks each rank's loader reads, decodes and augments
    only its rows: in ``test --data_parallel`` and in ``train
    --data_parallel`` each rank loads half the samples the same CLI loads
    in one process (12 a class or an epoch), and the two ranks decode as
    many files together as the one process (``DECODE_COUNTS``: the
    evaluation's images and masks, the training's masks; 6 of the 12
    samples are anomalous, with a mask, and 3 and 3, or 2 and 4, fall to
    a rank)."""
    decodes, one = runs[3], runs[4]
    for i, what in enumerate(("test", "train")):
        assert one[i]["rows"] > 0 and one[i]["decodes"] > 0
        for rank, got in enumerate(decodes):
            assert 2 * got[i]["rows"] == one[i]["rows"], (what, rank, got)
        assert sum(got[i]["decodes"] for got in decodes) \
            == one[i]["decodes"], (what, decodes, one)


def test_device_augment_draws_follow_the_global_batch():
    """A rank's device augment of its rows (``part = (rank, 2)``, rows
    rank, rank + 2, ... as ``sharding.shard_rows`` deals them) equals the
    global batch's augment at those rows, bit for bit, whatever the
    world size: the draws are the global batch's."""
    from aaclip_tpu_torch.ops.augment import (augment_generator,
                                              make_device_augment)
    from aaclip_tpu_torch.parallel.sharding import shard_rows

    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, (6, 3, 20, 20),
                                           dtype=np.uint8))
    masks = torch.from_numpy(rng.integers(0, 2, (6, 20, 20),
                                          dtype=np.uint8))
    aug = make_device_augment(uint8_inputs=True)

    def gen():
        return augment_generator(111, 2, 0, 3, "cpu")

    whole = aug(gen(), images, masks)

    class Mesh:
        dp = 2

    for rank in range(2):
        Mesh.data_rank = rank
        part = aug(gen(), shard_rows(images, Mesh), shard_rows(masks, Mesh),
                   (rank, 2))
        for got, want in zip(part, whole):
            assert torch.equal(got, shard_rows(want, Mesh))
