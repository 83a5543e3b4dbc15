"""Rank code of the port's multi-process tests: ``run_world(n, cases)``
starts ``n`` processes that join one gloo world on the CPU (as
``torchrun`` would describe it: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), runs each ``(name, kwargs)`` case of
this module in every rank, in order, and returns each rank's results.

The module imports neither JAX nor the JAX package, so a spawned rank
stays free of them; the tests compute their references with JAX in their
own process and send numpy trees and batches here. Each world has its own
timeout, so a hung collective fails its test instead of the suite. Not
collected by pytest (no ``test_`` prefix).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
import traceback

import numpy as np

TINY = dict(levels=(1, 2), image_adapt_until=1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, cases, out) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        from aaclip_tpu_torch.parallel.sharding import initialize_multihost

        initialize_multihost(device="cpu")
        results = [globals()[name](**kwargs) for name, kwargs in cases]
        dist.destroy_process_group()
        out.put((rank, "ok", results))
    except BaseException:  # reported to the parent, which fails the test
        out.put((rank, "error", traceback.format_exc()))


def run_world(n: int, cases, timeout: float = 120.0) -> list:
    """Each rank's list of case results, rank order; raises with a rank's
    traceback if one failed, or after ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n, port, cases, out),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(n):
            rank, status, payload = out.get(timeout=timeout)
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            results[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(n)]


# ---------------------------------------------------------------- helpers

def _mesh(tp: int):
    from aaclip_tpu_torch.parallel import sharding as sh

    if tp == 0:
        return None
    if tp == 1:
        return sh.make_data_mesh(device="cpu")
    return sh.make_mesh_2d(tp, device="cpu")


def _policy(name: str, bf16_until=None):
    import dataclasses

    from aaclip_tpu_torch.core.config import DtypePolicy

    policy = DtypePolicy.from_name(name)
    if bf16_until is not None:
        policy = dataclasses.replace(policy, bf16_until=bf16_until)
    return policy


def _tiny(visual=None, jad=None, text=None, tad=None, acfg_kwargs=None):
    from aaclip_tpu_torch.core import params as P
    from aaclip_tpu_torch.core.config import AdapterConfig, get_config

    cfg = get_config("tiny-test")
    acfg = AdapterConfig(**(acfg_kwargs or TINY))
    return dict(
        cfg=cfg, acfg=acfg,
        vit=None if visual is None else P.params_from_jax(visual, cfg,
                                                          device="cpu"),
        ad=None if jad is None else P.adapter_from_jax(jad, cfg, acfg,
                                                       device="cpu"),
        text=None if text is None else P.text_params_from_jax(
            text, cfg, device="cpu"),
        tad=None if tad is None else P.text_adapter_from_jax(
            tad, cfg, acfg, device="cpu"))


def _grads(module, to_jax):
    """The module's gradients in the JAX tree layout of ``to_jax``."""
    import copy

    g = copy.deepcopy(module)
    for p, src in zip(g.parameters(), module.parameters()):
        p.data = src.grad.clone()
    return to_jax(g)


# ---------------------------------------------------------------- cases

def predict(tp, visual, jad, images, anchors, M, policy="fp32", sp=False,
            bf16_until=None, uint8=False):
    """The predictor on a mesh (``tp`` 0: none; 1: data; > 1: data x
    model): the global map and scores."""
    from aaclip_tpu_torch.eval.predict import make_predict_fn

    m = _tiny(visual, jad)
    fn = make_predict_fn(m["vit"], m["cfg"], m["acfg"],
                         policy=_policy(policy, bf16_until),
                         uint8_inputs=uint8, mesh=_mesh(tp),
                         sequence_parallel=sp, device="cpu")
    pix, score = fn(m["ad"], images, anchors, M)
    return pix.numpy(), score.numpy()


def mb_predict(tp, visual, jad, support, images, anchors, M, weight=0.5):
    """The memory bank: the bank collected through the mesh's features (a
    ragged support batch included) and the fused predict."""
    from aaclip_tpu_torch.eval import memory_bank as mb

    m = _tiny(visual, jad)
    fn = mb.make_mb_predict_fn(m["vit"], m["cfg"], m["acfg"],
                               policy=_policy("fp32"), bank_weight=weight,
                               chunk=7, mesh=_mesh(tp), device="cpu")
    bank = mb.collect_bank(fn.features_fn, m["ad"], support, batch_size=3)
    pix, score = fn(m["ad"], images, anchors, M, bank)
    return bank.numpy(), pix.numpy(), score.numpy()


def stage2(tp, visual, jad, table, batch, steps=2, sp=False, remat=False,
           grad_accum=1, policy="fp32", lr=1e-3, milestones=(2, 4)):
    """``steps`` stage-2 updates on the global batch, each rank given its
    rows of it (``shard_rows``, as the training CLI's loader reads them):
    the losses, the reduced gradients of the first and the adapters after
    the last (JAX tree layout)."""
    import torch

    from aaclip_tpu_torch.core.params import adapter_to_jax
    from aaclip_tpu_torch.parallel.sharding import shard_rows
    from aaclip_tpu_torch.train import optim
    from aaclip_tpu_torch.train.steps import make_stage2_step

    m = _tiny(visual, jad)
    ad = m["ad"]
    opt = optim.make_image_optimizer(ad.parameters(), lr=lr,
                                     milestones=milestones)
    mesh = _mesh(tp)
    step = make_stage2_step(m["vit"], m["cfg"], m["acfg"], opt, table,
                            policy=_policy(policy), remat=remat,
                            mesh=mesh, sequence_parallel=sp,
                            grad_accum=grad_accum, device="cpu")
    batch = [shard_rows(torch.from_numpy(np.asarray(x)), mesh)
             for x in batch]
    losses, first = [], None
    for i in range(steps):
        losses.append(float(step(ad, *batch)))
        if i == 0:
            first = _grads(ad, adapter_to_jax)
    return losses, first, adapter_to_jax(ad)


def stage1_features(tp, visual, images, valid=None, vv_mode="batch",
                    sp=False, surgery_until_layer=2, chunk=None):
    """The features of the global batch: each rank's of its rows
    (``shard_rows``), gathered back into global order."""
    import torch

    from aaclip_tpu_torch.parallel.sharding import (gather_rows,
                                                    shard_rows)
    from aaclip_tpu_torch.train.steps import stage1_features_fn

    m = _tiny(visual)
    mesh = _mesh(tp)
    fn = stage1_features_fn(m["vit"], m["cfg"],
                            surgery_until_layer=surgery_until_layer,
                            policy=_policy("fp32"), vv_mode=vv_mode,
                            chunk=chunk, mesh=mesh,
                            sequence_parallel=sp, device="cpu")
    images = torch.as_tensor(images)
    feats = fn(shard_rows(images, mesh),
               None if valid is None
               else shard_rows(torch.as_tensor(valid), mesh))
    return gather_rows(feats, mesh).numpy()


def stage1(tp, text, tad, tokens, feats, mask, class_idx, valid, steps=2,
           sp=False, remat=True, acfg_kwargs=None):
    """``steps`` stage-1 updates on the global batch, each rank given its
    rows of it (``shard_rows``): the losses, the first reduced gradients
    and the text adapters after the last (JAX tree layout)."""
    import torch

    from aaclip_tpu_torch.core.params import text_adapter_to_jax
    from aaclip_tpu_torch.parallel.sharding import shard_rows
    from aaclip_tpu_torch.train import optim
    from aaclip_tpu_torch.train.steps import make_stage1_step

    m = _tiny(text=text, tad=tad, acfg_kwargs=acfg_kwargs)
    ad = m["tad"]
    opt = optim.make_text_optimizer(ad.parameters(), lr=1e-3)
    mesh = _mesh(tp)
    step = make_stage1_step(m["text"], m["cfg"], m["acfg"], opt, tokens,
                            img_size=70, policy=_policy("fp32"),
                            remat=remat, mesh=mesh,
                            sequence_parallel=sp, device="cpu")
    feats, mask, class_idx, valid = (
        shard_rows(torch.as_tensor(np.asarray(t)), mesh)
        for t in (feats, mask, class_idx, valid))
    losses, first = [], None
    for i in range(steps):
        losses.append(float(step(ad, feats, mask, class_idx, valid)))
        if i == 0:
            first = _grads(ad, text_adapter_to_jax)
    return losses, first, text_adapter_to_jax(ad)


def row_parallel_grad(x, w):
    """Megatron's pair on a row-parallel product: ``y = sum over ranks of
    copy_to(x)[:, part] @ w[part]`` with ``reduce_from`` as the sum. The
    input gradient of ``y.sum()`` must equal the single-process one; the
    torch.distributed.nn all-reduce's is returned beside it (tp times
    too large)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce as nn_all_reduce

    from aaclip_tpu_torch.parallel import sharding as sh

    mesh = _mesh(dist.get_world_size())
    k = w.shape[0] // mesh.tp
    part = slice(mesh.model_rank * k, (mesh.model_rank + 1) * k)
    out = []
    for reduce in (lambda t: sh.reduce_from(t, mesh.model),
                   lambda t: nn_all_reduce(t, group=mesh.model)):
        xt = torch.from_numpy(x).requires_grad_(True)
        h = sh.copy_to(xt, mesh.model)
        y = reduce(h[:, part] @ torch.from_numpy(w)[part])
        y.sum().backward()
        out.append((y.detach().numpy(), xt.grad.numpy()))
    return out


def sp_roundtrip(s, d=3):
    """Sequence-parallel split, enter, exit and gather on a stream of
    ``s`` tokens (``s`` need not divide by tp) against the identity, and
    their gradients: ``gather(split(x))`` is ``x``; ``exit`` of the
    entered stream sums it over the ranks."""
    import torch
    import torch.distributed as dist

    from aaclip_tpu_torch.parallel.tensor import ModelAxis

    mesh = _mesh(dist.get_world_size())
    axis = ModelAxis(mesh, sequence_parallel=True)
    x = torch.arange(2 * s * d, dtype=torch.float32).reshape(2, s, d)
    x.requires_grad_(True)
    part = axis.split(x)
    whole = axis.gather(part)
    summed = axis.gather(axis.exit(axis.enter(part)))
    (whole.sum() + 0.5 * summed.sum()).backward()
    return (tuple(part.shape), whole.detach().numpy(),
            summed.detach().numpy(), x.grad.numpy())


def mesh_errors():
    """The mesh constructors' size errors (JAX's), a mesh's shape and every
    rank's (data, model) coordinates."""
    import torch
    import torch.distributed as dist

    from aaclip_tpu_torch.parallel import sharding as sh

    out = {}
    try:
        sh.make_mesh_2d(3, device="cpu")
    except ValueError as e:
        out["tp3"] = str(e)
    mesh = sh.make_mesh_2d(dist.get_world_size(), device="cpu")
    out["shape"] = mesh.shape
    coords = [None] * dist.get_world_size()
    dist.all_gather_object(coords, (mesh.data_rank, mesh.model_rank))
    out["rank_order"] = coords
    try:
        sh.shard_rows(torch.zeros(3), sh.make_data_mesh(device="cpu"))
    except ValueError as e:
        out["ragged"] = str(e)
    return out


def count_loads():
    """A context that counts the samples the datasets load (each
    ``TestDataset.get`` / ``TrainDataset.get``: one image, and its mask
    where it has one) and the images and masks decoded
    (``data/transforms.py::DECODE_COUNTS``, both paths); yields a dict
    whose ``rows`` and ``decodes`` hold the counts on exit."""
    import contextlib
    import threading

    from aaclip_tpu_torch.data import datasets as D
    from aaclip_tpu_torch.data.transforms import DECODE_COUNTS

    @contextlib.contextmanager
    def counting():
        got = {"rows": 0}
        lock = threading.Lock()
        originals = {cls: cls.get for cls in (D.TestDataset, D.TrainDataset)}

        def wrap(get):
            def counted(self, *args, **kwargs):
                with lock:  # the loaders' thread pools call it
                    got["rows"] += 1
                return get(self, *args, **kwargs)
            return counted

        before = sum(DECODE_COUNTS.values())
        for cls, get in originals.items():
            cls.get = wrap(get)
        try:
            yield got
        finally:
            for cls, get in originals.items():
                cls.get = get
            got["decodes"] = sum(DECODE_COUNTS.values()) - before

    return counting()


def decoded(case, kwargs):
    """Another case of this module, run in this rank, and the samples the
    rank loaded and the images and masks it decoded meanwhile
    (``count_loads``)."""
    with count_loads() as got:
        out = globals()[case](**kwargs)
    return out, got


def cli(kind, argv, env):
    """One rank of a CLI run (``kind`` "test" or "train", ``main(argv,
    device="cpu")``) with ``env`` set; returns the per-epoch losses the
    training CLI drained (each rank's, all the global losses)."""
    os.environ.update(env)
    import aaclip_tpu_torch.utils.profiling as prof

    losses = []
    base = prof.ThrottledLossDrain

    class Recording(base):
        def drain(self):
            vals = super().drain()
            losses.append(vals)
            return vals

    prof.ThrottledLossDrain = Recording
    try:
        if kind == "test":
            from aaclip_tpu_torch import test as module
        else:
            from aaclip_tpu_torch.train import cli as module
        module.main(argv, device="cpu")
    finally:
        prof.ThrottledLossDrain = base
    return losses



# ---------------------------------------------------------------- pipeline

def _pp_tiny(visual=None, jad=None, layers=None, acfg_kwargs=None):
    """``_tiny`` on a tiny-test tower of ``layers`` blocks (default its
    own 2)."""
    import dataclasses

    from aaclip_tpu_torch.core import params as P
    from aaclip_tpu_torch.core.config import AdapterConfig, get_config

    cfg = get_config("tiny-test")
    if layers is not None:
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, layers=layers))
    acfg = AdapterConfig(**(acfg_kwargs or TINY))
    return dict(
        cfg=cfg, acfg=acfg,
        vit=None if visual is None else P.params_from_jax(visual, cfg,
                                                          device="cpu"),
        ad=None if jad is None else P.adapter_from_jax(jad, cfg, acfg,
                                                       device="cpu"))


def pp_predict(pp, visual, jad, images, anchors, M, n_micro=None, dp=1,
               layers=None, acfg_kwargs=None, policy="fp32", raw=False):
    """The pipeline predictor on the global batch: the map and scores
    every rank returns, this rank's (stage, data) coordinates, its blocks
    and, with ``raw``, ``predict.raw``'s map and scores too."""
    import torch

    from aaclip_tpu_torch.eval.predict import adapter_tensors
    from aaclip_tpu_torch.parallel.pipeline import make_pipeline_predict_fn

    m = _pp_tiny(visual, jad, layers, acfg_kwargs)
    fn = make_pipeline_predict_fn(m["vit"], m["cfg"], m["acfg"], pp=pp,
                                  n_micro=n_micro, dp=dp,
                                  policy=_policy(policy), device="cpu")
    pix, score = fn(m["ad"], images, anchors, M)
    out = dict(pix=pix.numpy(), score=score.numpy(),
               coords=(fn.pp_mesh.stage_rank, fn.pp_mesh.data_rank),
               blocks=fn.stage_blocks,
               n_blocks=len({k.split(".")[2] for k in fn.visual
                             if k.startswith("visual.blocks.")}))
    if raw:
        with torch.no_grad():
            rp, rs = fn.raw(fn.visual, adapter_tensors(m["ad"]),
                            *map(torch.as_tensor, (images, anchors, M)))
        out.update(raw_pix=rp.numpy(), raw_score=rs.numpy())
    return out


def pp_stage2(pp, visual, jad, table, batch, n_micro=None, dp=1, steps=1,
              layers=None, acfg_kwargs=None, remat=False, lr=1e-3):
    """``steps`` pipeline stage-2 updates on the global batch: the losses
    and the adapters after the last (JAX tree layout), on every rank."""
    from aaclip_tpu_torch.core.params import adapter_to_jax
    from aaclip_tpu_torch.parallel.pipeline import make_pp_stage2_step
    from aaclip_tpu_torch.train import optim

    m = _pp_tiny(visual, jad, layers, acfg_kwargs)
    ad = m["ad"]
    opt = optim.make_image_optimizer(ad.parameters(), lr=lr)
    step = make_pp_stage2_step(m["vit"], m["cfg"], m["acfg"], opt, table,
                               pp=pp, n_micro=n_micro, dp=dp,
                               policy=_policy("fp32"), remat=remat,
                               device="cpu")
    losses = [float(step(ad, *batch)) for _ in range(steps)]
    return losses, adapter_to_jax(ad)


def pp_features(pp, visual, images, valid=None, n_micro=None, dp=1,
                vv_mode="batch", layers=None, surgery_until_layer=2):
    """The pipeline stage-1 features of the global batch, on every
    rank."""
    from aaclip_tpu_torch.parallel.pipeline import make_pp_stage1_features_fn

    m = _pp_tiny(visual, layers=layers)
    fn = make_pp_stage1_features_fn(
        m["vit"], m["cfg"], pp=pp, n_micro=n_micro, dp=dp,
        surgery_until_layer=surgery_until_layer, policy=_policy("fp32"),
        vv_mode=vv_mode, device="cpu")
    return fn(images, valid).numpy()


def pp_idle(visual, jad, images, anchors, M):
    """A world larger than the mesh (pp = 2, dp = 1 on 4 ranks): the
    stage-1 features on every rank (the ranks outside the mesh receive
    them) and, outside the mesh, the predictor's refusal."""
    import torch.distributed as dist

    from aaclip_tpu_torch.parallel import pipeline as ppl

    feats = pp_features(2, visual, images, n_micro=2)
    m = _pp_tiny(visual, jad)
    err = None
    try:
        ppl.make_pipeline_predict_fn(m["vit"], m["cfg"], m["acfg"], pp=2,
                                     device="cpu")
    except ValueError as e:
        err = str(e)
    return feats, (dist.get_rank(), err)


def pp_errors(visual, jad, table, batch):
    """The pipeline's refusals, as ``{name: message}``; every rank runs
    each make_* function (the mesh's groups are collective)."""
    import dataclasses

    import torch

    from aaclip_tpu_torch.core.params import init_image_adapter
    from aaclip_tpu_torch.parallel import pipeline as ppl
    from aaclip_tpu_torch.train import optim

    m = _pp_tiny(visual, jad)
    cfg, acfg, vit, ad = m["cfg"], m["acfg"], m["vit"], m["ad"]
    cfg4 = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, layers=4))
    out = {}

    def catch(name, fn):
        try:
            fn()
        except ValueError as e:
            out[name] = str(e)

    world = torch.distributed.get_world_size()
    catch("pp3", lambda: ppl.make_pipeline_predict_fn(vit, cfg, acfg, pp=3,
                                                      device="cpu"))
    catch("mesh1", lambda: ppl.make_pp_mesh(1, device="cpu"))
    catch("mesh_dp", lambda: ppl.make_pp_mesh(2, world, device="cpu"))
    catch("spacing", lambda: ppl.make_pipeline_predict_fn(
        vit, cfg4,
        dataclasses.replace(acfg, levels=(1, 4)), pp=2, device="cpu"))
    catch("staged", lambda: ppl.make_pipeline_predict_fn(
        vit, cfg, acfg, pp=2, policy=_policy("fp32", bf16_until=1),
        device="cpu"))
    catch("int8", lambda: ppl.make_pipeline_predict_fn(
        vit, cfg, acfg, pp=2, policy=_policy("int8"), device="cpu"))
    catch("no_levels", lambda: ppl.make_pipeline_predict_fn(
        vit, cfg, dataclasses.replace(acfg, levels=()), pp=2,
        device="cpu"))
    fn = ppl.make_pipeline_predict_fn(vit, cfg, acfg, pp=2, n_micro=2,
                                      device="cpu")
    z = lambda *s: torch.zeros(s)  # noqa: E731
    catch("ragged", lambda: fn(ad, z(3, 3, 70, 70), z(32, 2), z(70, 5)))
    catch("raw_ragged", lambda: fn.raw(fn.visual, {}, z(3, 3, 70, 70),
                                       z(32, 2), z(70, 5)))
    deep = init_image_adapter(cfg, dataclasses.replace(
        acfg, image_adapt_until=2), seed=1, device="cpu")
    catch("depth", lambda: fn(deep, z(4, 3, 70, 70), z(32, 2), z(70, 5)))
    catch("s1_pp3", lambda: ppl.make_pp_stage1_features_fn(vit, cfg, pp=3,
                                                           device="cpu"))
    catch("s1_dp", lambda: ppl.make_pp_stage1_features_fn(
        vit, cfg, pp=2, dp=2, surgery_until_layer=2, device="cpu"))
    catch("s1_vv_fn", lambda: ppl.make_pp_stage1_features_fn(
        vit, cfg, pp=2, surgery_until_layer=2, vv_attn_fn=lambda h, p: h,
        device="cpu"))
    catch("s1_mode", lambda: ppl.make_pp_stage1_features_fn(
        vit, cfg, pp=2, vv_mode="typo", device="cpu"))
    feats = ppl.make_pp_stage1_features_fn(vit, cfg, pp=2, n_micro=2,
                                           surgery_until_layer=2,
                                           device="cpu")
    catch("s1_ragged", lambda: feats(z(3, 3, 70, 70)))
    opt = optim.make_image_optimizer(ad.parameters(), lr=1e-3)
    catch("s2_pp3", lambda: ppl.make_pp_stage2_step(
        vit, cfg, acfg, opt, table, pp=3, device="cpu"))
    catch("s2_selective", lambda: ppl.make_pp_stage2_step(
        vit, cfg, acfg, opt, table, pp=2, remat="selective", device="cpu"))
    step = ppl.make_pp_stage2_step(vit, cfg, acfg, opt, table, pp=2,
                                   n_micro=4, device="cpu")
    catch("s2_ragged", lambda: step(ad, *(np.asarray(x)[:6]
                                          for x in batch)))
    return out
