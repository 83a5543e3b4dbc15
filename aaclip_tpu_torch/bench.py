"""Throughput of the port on one card, random weights from a fixed seed:
anomaly maps per second of the inference path (adapted ViT-L/14-336
forward at 518 px + fused anomaly map), or images per second of the
stage-2 training step, or of the stage-1 iteration (surgery features +
text-adapter update), or the time of a trunk of identical blocks, unfused
against the fused block.

    python -m aaclip_tpu_torch.bench [--batch_size 32] [--precision bf16]
    python -m torch.distributed.run --nproc_per_node K \
        -m aaclip_tpu_torch.bench --data_parallel [--batch_size 32]
    python -m aaclip_tpu_torch.bench --precision fp32_high [--bf16_until K]
    python -m aaclip_tpu_torch.bench --precision int8 [--int8_until K]
    python -m aaclip_tpu_torch.bench --mode train [--batch_size 8] \
        [--remat full|selective|off]
    python -m aaclip_tpu_torch.bench --mode train_stage1 [--batch_size 16] \
        [--vv_mode batch|spatial] [--feature_chunk N] \
        [--remat full|selective|off]
    python -m aaclip_tpu_torch.bench --mode block [--batch_size 32]
    python -m aaclip_tpu_torch.bench --mode serve [--batch_size 8] \
        [--clients 8 --steps REQUESTS | --open_loop RPS --steps SECONDS] \
        [--map_stride S] [--artifact DIR]

Prints ONE JSON line in the format of the repo's ``bench.py``:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
(``--mode block`` adds ``unfused_ms`` and ``max_rel_dev``; ``--mode
serve`` adds the served and failed counts and the latency percentiles.)
The unit names the card and its power limit. Timed with CUDA events
around ``--steps`` calls after ``--warmup`` calls; ``--mode serve`` runs
the serving engine (``serve/server.py``) under load, as JAX's bench does:
``--clients`` closed-loop threads, each submitting its next request when
its last one returns, ``--steps`` requests each, or ``--open_loop RPS``
arrivals at a fixed rate for ``--steps`` seconds of wall time, each its
own thread, whose rejections (the engine's admission control) are counted
apart; ``--artifact DIR`` serves
an exported artifact (``deploy.py``) instead of building the model. The
infer mode takes uint8 images under bf16 and int8 (JAX's bench), and
``--data_parallel`` (infer only) runs it over ``torchrun``'s ranks, one
card each: ``--batch_size`` is per card, every rank times the global batch
of ``batch_size`` x world through the data-parallel predictor, and rank 0
prints the global maps/s over the slowest rank's time and the per-card
rate (``dp=K`` in the unit); and
``--int8_until K`` tags its stage ``+int8xK``. The train modes refuse
int8 (inference only). Needs a card: without one
it raises and prints nothing (``main(argv, device="cpu")`` runs the serve
mode on the CPU, for the tests).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from aaclip_tpu_torch.device import card_line

# The reference publishes no throughput; bench.py's constant is an analytic
# estimate of the reference PyTorch pipeline on an A100 (derivation in
# docs/PERFORMANCE.md, "Reference baseline derivation"). Kept so the two
# benches report the same ratio.
REFERENCE_BASELINE_MAPS_PER_SEC = 40.0
REFERENCE_BASELINE_STAGE2_IMG_PER_SEC = 10.0
REFERENCE_BASELINE_STAGE1_IMG_PER_SEC = 20.0

# kernel-name fragments of the profile's device rows, by class
_PROFILE_CLASSES = (
    ("attention forward kernel (standard and V-V; the 6-pass and 3-pass "
     "splits)",
     ("attn_fwd_wgmma", "attn_bf16_kernel", "attn_f32_kernel",
      "attn_fwd_3pass", "attn_fwd_6pass", "split3_kernel", "split2_kernel")),
    ("attention backward kernel", ("attn_bwd_",)),
    ("fused-block kernels (ln_linear, linear_residual, mlp_fused; the "
     "3-pass and 6-pass splits)",
     ("gemm_wgmma", "row_stats_kernel", "gemm_planes_wgmma",
      "split_kernel")),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
)

# --remat -> the steps' ``remat`` (the JAX bench's mapping)
REMAT = {"full": True, "selective": "selective", "off": False}


def profile_calls(fn, calls: int) -> None:
    """Trace ``calls`` calls of ``fn`` and print, to stderr, the device
    time by op and the share of the traced wall time the card was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # device time is the kernels' own rows, as the table's total counts it
    # (the aten rows repeat their kernels' time)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(events.table(sort_by="self_device_time_total", row_limit=25),
          file=sys.stderr)
    print(f"profile: {calls} calls, device busy {busy_us / 1e3:.2f} ms of "
          f"{wall_us / 1e3:.2f} ms traced wall time "
          f"({busy_us / wall_us:.3f})", file=sys.stderr)
    by_class = {}
    for e in kernels:
        cls = next((c for c, keys in _PROFILE_CLASSES
                    if any(k in e.key for k in keys)),
                   "other (elementwise, reductions, copies)")
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"profile: {cls}: {us / 1e3 / calls:.2f} ms per call "
              f"({us / busy_us:.3f} of device time)", file=sys.stderr)


def bench_train(args, cfg, acfg, policy, vit, adapter, dev):
    """Stage-2 update steps per second, as images/s: the JAX package's
    ``bench_train`` batch (random float images, mask > 0.9, random labels
    and classes, a random 2-class table of unit anchors)."""
    import torch

    from aaclip_tpu_torch.train.optim import make_image_optimizer
    from aaclip_tpu_torch.train.steps import make_stage2_step

    B, img = args.batch_size, args.img_size
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn(B, 3, img, img, generator=gen, device=dev)
    mask = (torch.rand(B, img, img, generator=gen, device=dev) > 0.9).float()
    label = torch.randint(0, 2, (B,), generator=gen, device=dev)
    cidx = torch.randint(0, 2, (B,), generator=gen, device=dev)
    valid = torch.ones(B, device=dev)
    table = torch.randn(2, cfg.embed_dim, 2, generator=gen, device=dev)
    table = table / table.norm(dim=1, keepdim=True)
    step = make_stage2_step(vit, cfg, acfg,
                            make_image_optimizer(adapter.parameters()), table,
                            policy=policy, remat=REMAT[args.remat],
                            device=dev)

    def call():
        return step(adapter, images, mask, label, cidx, valid)

    imgs_per_sec = timed(call, args) * B
    if args.profile:
        profile_calls(call, 2)
    print(json.dumps({
        "metric": "stage2_train_images_per_sec_per_chip",
        "value": round(imgs_per_sec, 2),
        "unit": f"img/s/chip ({args.model_name} @ {img}px stage-2 update, "
                f"{args.precision}, batch {B}, remat {args.remat}, "
                f"{card_line()})",
        "vs_baseline": round(
            imgs_per_sec / REFERENCE_BASELINE_STAGE2_IMG_PER_SEC, 3),
    }))


def bench_train_stage1(args, cfg, acfg, policy, vit, dev):
    """Stage-1 iterations per second, as images/s: surgery features of the
    batch, then one text-adapter update over every prompt sentence. The
    JAX package's ``bench_train_stage1`` batch: normal images and a mask >
    0.9 from numpy seed 0, random classes among the first 12 VisA classes
    (2 MVTec classes for tiny-test)."""
    import numpy as np
    import torch

    from aaclip_tpu_torch.core.params import (init_text_adapter,
                                              init_text_params)
    from aaclip_tpu_torch.text.anchors import dataset_prompt_tokens
    from aaclip_tpu_torch.train.optim import make_text_optimizer
    from aaclip_tpu_torch.train.steps import (make_stage1_step,
                                              stage1_features_fn)

    B, img = args.batch_size, args.img_size
    tiny = args.model_name == "tiny-test"
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal(
        (B, 3, img, img)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(
        (rng.random((B, img, img)) > 0.9).astype(np.float32)).to(dev)
    n_cls = 2 if tiny else 12
    cidx = torch.from_numpy(rng.integers(0, n_cls, B)).to(dev)
    valid = torch.ones(B, device=dev)
    tokens = dataset_prompt_tokens("MVTec" if tiny else "VisA")[:n_cls]
    text = init_text_params(cfg, seed=0, device=dev)
    adapter = init_text_adapter(cfg, acfg, seed=2, device=dev)
    features = stage1_features_fn(vit, cfg, policy=policy,
                                  vv_mode=args.vv_mode,
                                  chunk=args.feature_chunk or None,
                                  device=dev)
    step = make_stage1_step(text, cfg, acfg,
                            make_text_optimizer(adapter.parameters()), tokens,
                            img_size=img, policy=policy,
                            remat=REMAT[args.remat], device=dev)

    def call():
        # the production loop passes valid (train.py)
        return step(adapter, features(images, valid), mask, cidx, valid)

    imgs_per_sec = timed(call, args) * B
    if args.profile:
        profile_calls(call, 2)
    chunk = f", chunk {args.feature_chunk}" if args.feature_chunk else ""
    print(json.dumps({
        "metric": "stage1_train_images_per_sec_per_chip",
        "value": round(imgs_per_sec, 2),
        "unit": f"img/s/chip ({args.model_name} @ {img}px stage-1: surgery "
                f"feats + text update, {args.precision}, batch {B}, vv "
                f"{args.vv_mode}{chunk}, remat {args.remat}, {card_line()})",
        "vs_baseline": round(
            imgs_per_sec / REFERENCE_BASELINE_STAGE1_IMG_PER_SEC, 3),
    }))


def bench_block(args, cfg, policy, vit, dev):
    """Milliseconds per trunk of ``cfg.vision.layers`` identical blocks
    (block 0 of the seeded tower, cast as the predictor casts it) on a
    random [batch, seq_len, width] stream: the fused block
    (``ops.fused_block.make_block_fn``) against the unfused block
    (``residual_block`` with the packed-attention hook), and the largest
    deviation of the fused trunk's output relative to the unfused one's
    largest value. The port's counterpart of ``tools/microbench_block.py``.
    """
    import torch

    from aaclip_tpu_torch.core.params import cast_matmul_weights
    from aaclip_tpu_torch.models import layers as L
    from aaclip_tpu_torch.ops.fused_block import make_block_fn

    v = cfg.vision
    blk = cast_matmul_weights(vit, policy).blocks[0]
    act = L.config_act(cfg, policy)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(args.batch_size, v.seq_len, v.width, generator=gen,
                    device=dev).to(policy.compute_dtype)
    blocks = {
        "fused": make_block_fn(v.heads, policy, act=act),
        "unfused": lambda h, b: L.residual_block(h, b, v.heads, act=act,
                                                 policy=policy),
    }

    def trunk(block):
        def run():
            h = x
            for _ in range(v.layers):
                h = block(h, blk)
            return h
        return run

    with torch.inference_mode():
        ms = {name: 1e3 / timed(trunk(block), args)
              for name, block in blocks.items()}
        out = {name: trunk(block)().float() for name, block in blocks.items()}
        if args.profile:
            profile_calls(trunk(blocks["fused"]), 2)
    rel = ((out["fused"] - out["unfused"]).abs().max()
           / out["unfused"].abs().max()).item()
    print(json.dumps({
        "metric": "fused_block_trunk_ms",
        "value": round(ms["fused"], 3),
        "unit": f"ms per {v.layers}-block trunk ({args.model_name} block @ "
                f"{args.img_size}px, seq {v.seq_len}, {args.precision}, "
                f"batch {args.batch_size}, {card_line()}); vs_baseline = "
                f"unfused ms / fused ms",
        "vs_baseline": round(ms["unfused"] / ms["fused"], 3),
        "unfused_ms": round(ms["unfused"], 3),
        "max_rel_dev": rel,
    }))


def bench_serve(args, dev):
    """Anomaly maps per second of the serving engine under load: a
    ``max_batch`` ``--batch_size`` engine on MVTec's anchors (random
    weights from the seeded init; ``AACLIP_ANCHOR_CACHE`` names an anchor
    cache) or on an exported artifact (``--artifact``, its first bundled
    dataset), pre-decoded random uint8 images, one warm-up request; the
    JAX package's ``bench_serve``: ``--steps`` is the requests of each
    closed-loop client and the seconds of the open loop's arrivals."""
    import os

    import numpy as np

    from aaclip_tpu_torch.serve.server import (EngineOverloadedError,
                                               InferenceEngine)

    tiny = args.model_name == "tiny-test"
    if args.artifact:
        engine = InferenceEngine(artifact=args.artifact,
                                 max_batch=args.batch_size, precompile=True,
                                 device=dev)
        args.img_size = engine.img_size  # clients send the artifact's size
        m = engine._artifact.manifest     # the line names what ran
        args.model_name = m["model_name"]
        args.precision = f"{m['precision']}+artifact"
    else:
        engine = InferenceEngine(
            model_name=args.model_name, img_size=args.img_size,
            datasets=("MVTec",), precision=args.precision,
            max_batch=args.batch_size, precompile=True,
            anchor_cache=os.environ.get("AACLIP_ANCHOR_CACHE") or None,
            adapter_cfg=(dict(levels=(1, 2), image_adapt_until=1,
                              text_adapt_until=1) if tiny else None),
            device=dev)
    try:
        rng = np.random.default_rng(0)
        ds = sorted(engine.anchors)[0]
        classes = sorted(engine.anchors[ds])[:2]
        imgs = [rng.integers(0, 256, (3, args.img_size, args.img_size),
                             dtype=np.uint8)
                for _ in range(max(args.clients, 1))]
        engine.submit(imgs[0], ds, classes[0], timeout=600)  # warm-up
        loop = _serve_closed_loop if args.open_loop is None else \
            _serve_open_loop
        counts, elapsed, extra = loop(args, engine, imgs, ds, classes,
                                      EngineOverloadedError)
    finally:
        engine.shutdown()
    stats = engine.stats()
    rate = counts["ok"] / elapsed
    card = card_line() if dev.type == "cuda" else "cpu"
    stride = f", map_stride={args.map_stride}" if args.map_stride != 1 \
        else ""
    print(json.dumps({
        "metric": "serve_maps_per_sec_per_chip",
        "value": round(rate, 2),
        "unit": f"maps/s/chip (serving engine, {args.model_name} @ "
                f"{args.img_size}px, {args.precision}, max_batch "
                f"{args.batch_size}, {extra}, occupancy "
                f"{stats['mean_batch_occupancy']}, p95 "
                f"{stats['latency_ms']['p95']}ms{stride}, {card})",
        # the reference has no serving path: its inference constant is the
        # only yardstick of maps/s
        "vs_baseline": round(rate / REFERENCE_BASELINE_MAPS_PER_SEC, 3),
        "served": counts["ok"],
        "rejected": counts["rejected"],
        "errors": counts["err"],
        "seconds": elapsed,
        "latency_ms": stats["latency_ms"],
        "mean_batch_occupancy": stats["mean_batch_occupancy"],
    }))


def _serve_closed_loop(args, engine, imgs, ds, classes, overloaded):
    """``--clients`` threads, each submitting again when its result
    returns, ``--steps`` requests each (JAX's ``bench.py``
    ``_serve_closed_loop``)."""
    import threading

    per_client = max(1, int(args.steps))
    counts = {"ok": 0, "rejected": 0, "err": 0}
    lock = threading.Lock()
    t0 = time.perf_counter()

    def client(i):
        for k in range(per_client):
            try:
                engine.submit(imgs[i], ds, classes[k % len(classes)],
                              timeout=600, map_stride=args.map_stride)
                outcome = "ok"
            except overloaded:
                outcome = "rejected"
            except Exception:
                outcome = "err"
            with lock:
                counts[outcome] += 1

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(args.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    return counts, elapsed, (f"{args.clients} closed-loop clients x "
                             f"{per_client} requests")


def _serve_open_loop(args, engine, imgs, ds, classes, overloaded):
    """Arrivals at ``--open_loop`` per second for ``--steps`` seconds,
    whatever completes; rejections are counted, not retried (each arrival
    is its own thread, as each HTTP request would be)."""
    import threading

    rps = args.open_loop
    duration = max(1.0, float(args.steps))
    n_total = max(1, int(rps * duration))
    counts = {"ok": 0, "rejected": 0, "err": 0}
    lock = threading.Lock()
    threads = []

    def fire(k):
        try:
            engine.submit(imgs[k % len(imgs)], ds,
                          classes[k % len(classes)], timeout=600,
                          map_stride=args.map_stride)
            outcome = "ok"
        except overloaded:
            outcome = "rejected"
        except Exception:
            outcome = "err"
        with lock:
            counts[outcome] += 1

    t0 = time.perf_counter()
    for k in range(n_total):
        delay = t0 + k / rps - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t = threading.Thread(target=fire, args=(k,))
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    return counts, elapsed, (
        f"open-loop {rps:g} rps x {duration:g}s: {counts['ok']} ok, "
        f"{counts['rejected']} rejected, {counts['err']} errors")


def timed(call, args) -> float:
    """Calls per second of ``call`` over ``args.steps`` calls after
    ``args.warmup``, between CUDA events."""
    import torch

    for _ in range(args.warmup):
        call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        call()
    end.record()
    torch.cuda.synchronize()
    return args.steps / (start.elapsed_time(end) / 1e3)


def main(argv=None, *, device=None) -> None:
    from aaclip_tpu_torch.core.config import PRECISION_CHOICES

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mode", default="infer",
                        choices=("infer", "train", "train_stage1", "block",
                                 "serve"),
                        help="infer = anomaly maps/s (default); train = "
                             "stage-2 update steps, as images/s; "
                             "train_stage1 = stage-1 iterations (features "
                             "+ text update), as images/s; block = ms per "
                             "trunk of identical blocks, fused vs unfused; "
                             "serve = maps/s of the serving engine under "
                             "concurrent requests")
    parser.add_argument("--model_name", default="ViT-L-14-336")
    parser.add_argument("--img_size", type=int, default=518)
    parser.add_argument("--batch_size", type=int, default=None,
                        help="default 32 (infer, block), 8 (train) or 16 "
                             "(train_stage1, the reference's text batch)")
    parser.add_argument("--precision", default="bf16",
                        choices=PRECISION_CHOICES,
                        help="int8 = the trunk's big products int8 x int8 "
                             "-> int32 (inference only)")
    parser.add_argument("--steps", type=int, default=10,
                        help="timed calls; serve: requests per "
                             "closed-loop client, or seconds of open-loop "
                             "arrivals")
    parser.add_argument("--bf16_until", type=int, default=None,
                        help="override the policy's staged trunk depth "
                             "(leading vision blocks at single-pass bf16 "
                             "products; inference path only)")
    parser.add_argument("--int8_until", type=int, default=None,
                        help="with --precision int8: quantize only the "
                             "first K vision blocks (mixed prefix), the "
                             "rest bf16; default 0 = the whole trunk")
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--profile", action="store_true",
                        help="after the timed loop, trace two more calls "
                             "with torch.profiler and print device time by "
                             "op to stderr")
    parser.add_argument("--remat", default="full", choices=tuple(REMAT),
                        help="train modes: checkpoint each block (default "
                             "full, as the JAX package's bench), keep "
                             "JAX's selective set, or keep everything")
    parser.add_argument("--vv_mode", default="batch",
                        choices=("batch", "spatial"),
                        help="train_stage1: 'batch' = the reference-exact "
                             "V-V attention across the batch (plain); "
                             "'spatial' = per-image V-V through the kernel")
    parser.add_argument("--feature_chunk", type=int, default=0,
                        help="train_stage1: extract features N images at a "
                             "time (needs --vv_mode spatial)")
    parser.add_argument("--clients", type=int, default=8,
                        help="serve: concurrent closed-loop clients")
    parser.add_argument("--open_loop", type=float, default=None,
                        metavar="RPS",
                        help="serve: arrivals at a fixed rate (requests/s) "
                             "for --steps seconds instead of closed-loop "
                             "clients; the engine's rejections are counted "
                             "apart")
    parser.add_argument("--map_stride", type=int, default=1,
                        help="serve: clients request map[::s, ::s], sliced "
                             "on the card before the copy to the host")
    parser.add_argument("--data_parallel", action="store_true",
                        help="infer mode: one rank per card under torchrun; "
                             "--batch_size is per card, the report the "
                             "global and the per-card rate")
    parser.add_argument("--artifact", default=None,
                        help="serve: an exported artifact directory "
                             "(python -m aaclip_tpu_torch.deploy); the "
                             "model and precision come from its manifest")
    args = parser.parse_args(argv)
    if args.mode != "train_stage1" and (args.vv_mode != "batch"
                                        or args.feature_chunk):
        parser.error("--vv_mode and --feature_chunk apply to --mode "
                     "train_stage1 only")
    if args.mode != "serve" and (args.open_loop is not None
                                 or args.map_stride != 1
                                 or args.artifact is not None):
        parser.error("--open_loop, --map_stride and --artifact apply to "
                     "--mode serve only")
    if args.int8_until is not None and args.precision != "int8":
        parser.error("--int8_until requires --precision int8")
    if args.mode in ("train", "train_stage1") and args.precision == "int8":
        parser.error("--precision int8 is inference-only: the training "
                     "steps never quantize")
    if args.data_parallel and args.mode != "infer":
        parser.error("--data_parallel applies to --mode infer only "
                     "(train --data_parallel runs data-parallel training)")
    if args.batch_size is None:
        args.batch_size = {"infer": 32, "block": 32, "train": 8,
                           "train_stage1": 16, "serve": 8}[args.mode]

    import torch

    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_vision_params)
    from aaclip_tpu_torch.device import resolve_device
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix

    from aaclip_tpu_torch.parallel import sharding as sh

    mesh = sh.cli_mesh(args.data_parallel, 1, device)
    dev = mesh.device if mesh is not None else resolve_device(device)
    if args.mode == "serve":
        return bench_serve(args, dev)
    if dev.type != "cuda":
        raise ValueError(f"--mode {args.mode} times with CUDA events: it "
                         f"needs the card")
    policy = DtypePolicy.from_name(args.precision)
    if args.bf16_until is not None:
        policy = dataclasses.replace(policy, bf16_until=args.bf16_until)
    if args.int8_until is not None:
        policy = dataclasses.replace(policy, int8_until=args.int8_until)
    cfg = get_config(args.model_name, args.img_size)
    acfg = AdapterConfig() if args.model_name != "tiny-test" else \
        AdapterConfig(levels=(1, 2), image_adapt_until=1, text_adapt_until=1)
    vit = init_vision_params(cfg, seed=0, device=dev)
    if args.mode == "train_stage1":
        return bench_train_stage1(args, cfg, acfg, policy, vit, dev)
    if args.mode == "block":
        return bench_block(args, cfg, policy, vit, dev)
    adapter = init_image_adapter(cfg, acfg, seed=1, device=dev)
    if args.mode == "train":
        return bench_train(args, cfg, acfg, policy, vit, adapter, dev)
    uint8_inputs = args.precision in ("bf16", "int8")
    predict = make_predict_fn(vit, cfg, acfg, policy=policy,
                              uint8_inputs=uint8_inputs, mesh=mesh,
                              device=None if mesh else dev)
    n_cards = mesh.dp if mesh is not None else 1
    batch = args.batch_size * n_cards  # the global batch

    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (batch, 3, args.img_size, args.img_size)
    if uint8_inputs:
        images = torch.randint(0, 256, shape, generator=gen, device=dev,
                               dtype=torch.uint8)
    else:
        images = torch.randn(shape, generator=gen, device=dev)
    anchors = torch.randn(cfg.embed_dim, 2, generator=gen, device=dev)
    anchors = anchors / anchors.norm(dim=0, keepdim=True)
    M = torch.from_numpy(fused_postproc_matrix(
        cfg.vision.grid, args.img_size, "Industrial")).to(dev)

    seconds = args.steps / timed(
        lambda: predict(adapter, images, anchors, M), args)
    if mesh is not None:  # the slowest rank's time
        t = torch.tensor([seconds], dtype=torch.float64, device=dev)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
        seconds = float(t)
    maps_per_sec = batch * args.steps / seconds
    per_card = maps_per_sec / n_cards
    if args.profile:
        profile_calls(lambda: predict(adapter, images, anchors, M), 2)
    if mesh is not None and not mesh.is_lead:
        return
    stage = f"+bf16x{policy.bf16_until}" if policy.bf16_until else ""
    if policy.quant_int8 and policy.int8_until:
        stage += f"+int8x{policy.int8_until}"
    dp = f", dp={n_cards} cards, global {maps_per_sec:.2f} maps/s" \
        if mesh is not None else ""
    print(json.dumps({
        "metric": "anomaly_maps_per_sec_per_chip",
        "value": round(per_card, 2),
        "unit": f"maps/s/chip ({args.model_name} @ {args.img_size}px, "
                f"adapted fwd + fused map, {args.precision}{stage}, "
                f"batch {args.batch_size}{dp}, "
                f"{card_line()})",
        "vs_baseline": round(per_card / REFERENCE_BASELINE_MAPS_PER_SEC, 3),
    }))


if __name__ == "__main__":
    main()
