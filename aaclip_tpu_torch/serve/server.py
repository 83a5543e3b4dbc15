"""Anomaly-detection inference server on the card (the JAX package's
``aaclip_tpu/serve/server.py``).

One process holds the model; HTTP requests carry encoded images and get a
pixel anomaly map and an image score back. A collector thread drains the
request queue up to ``max_batch`` within a batch window and pads the
batch, by repeating its last image, to the next power of two (a BUCKET),
so concurrent clients share forward passes while the work stays
proportional to the occupancy. ``precompile=True`` runs every bucket once
at start-up, so that no request waits for a kernel build or a first call.

The engine is a two-stage pipeline. The dispatch thread uploads a batch
from pinned memory, launches the forward, and queues the copies of the
scores and of each requested stride's map slice into pinned host memory,
each followed by a CUDA event; the completion thread waits on those events
(``device_wait``, then ``map_fetch``) while the dispatch thread already
launches the next batch. So no stage waits on a later batch, as a
``tensor.cpu()`` there would. Off the card the stages copy plainly.

Endpoints
---------
POST /predict?dataset=MVTec&class_name=bottle
    body: PNG/JPEG bytes. Response JSON:
    {"image_score": float, "map_shape": [h, w], "anomaly_map": [[...]]}
    (the map downsampled by the "map_stride" query argument if given,
    values rounded to 4 decimals). "map_encoding=f16" / "map_encoding=u8"
    send the map as the raw body instead (application/octet-stream;
    little-endian C-order float16, or uint8 with value = X-Map-Offset +
    X-Map-Scale * byte), with the score, shape and untrained flag in X-*
    headers. 429 (Retry-After: 1) when the request queue is at max_queue;
    413 for a body over MAX_BODY_BYTES; 400 for a bad argument or an
    undecodable body; 404 for an unknown dataset or class.
GET /healthz          -> {"status": "ok", "img_size": N, "datasets": [...],
                          "untrained": bool, "map_encodings": [...]}
GET /classes?dataset= -> {"dataset": ..., "classes": [...]}
GET /statz            -> requests, errors, rejected, batches, mean batch
                         occupancy, request latency p50/p95/max (ms) and
                         the wall time by phase: http_read / decode /
                         queue_wait / stack_pad / dispatch / device_wait
                         (a CUDA event's wait: the forward and the score's
                         copy) / map_fetch / respond, each with n, total_s
                         and mean/p50/p95 ms (AACLIP_SERVE_PHASE_PROBE=1
                         splits the input upload out as h2d_probe)

Start with ``python -m aaclip_tpu_torch.serve``. The engine runs on the
card unless ``device="cpu"`` is passed (the tests); ``data_parallel``,
``artifact`` and ``precision="int8"`` are not ported (ROADMAP A12).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

# request-body allocation cap (bytes); AACLIP_SERVE_MAX_BODY_MB overrides
MAX_BODY_BYTES = int(float(os.environ.get(
    "AACLIP_SERVE_MAX_BODY_MB", "64")) * 1024 * 1024)

_A12 = "ROADMAP A12, 'int8, mesh and export'"
_log = logging.getLogger("aaclip.serve")


def _path_digest(path: str, content: bool = True) -> str:
    """Identity of a checkpoint file for anchor-cache keys: a small file
    (an adapter npz) by its content; a large one (``content=False``, the
    CLIP checkpoint) by its path, size and mtime."""
    import hashlib

    path = os.path.abspath(path)
    if content and os.path.getsize(path) <= 256 * 1024 * 1024:
        from aaclip_tpu_torch.utils.hashing import sha256_file

        return sha256_file(path)[:24]
    st = os.stat(path)
    return hashlib.sha256(f"{path}|{st.st_size}|{st.st_mtime_ns}|".encode()
                          ).hexdigest()[:24]


class EngineOverloadedError(RuntimeError):
    """``submit`` found the request queue at ``max_queue``: admission
    control sheds the load (HTTP 429) instead of queueing requests that
    would only burn their timeout."""


class _Readback:
    """A dispatched batch's results on their way to host memory: the
    scores, then each stride's map, each copy followed by an event (None
    off the card, where the copies are done)."""

    def __init__(self, pix: torch.Tensor, score: torch.Tensor, strides):
        cuda = pix.is_cuda
        self.score = self._copy(score, cuda)
        self.score_event = self._event(cuda)
        self.maps = {s: self._copy(pix if s == 1 else pix[:, ::s, ::s], cuda)
                     for s in sorted(strides)}
        self.maps_event = self._event(cuda)

    @staticmethod
    def _copy(t: torch.Tensor, cuda: bool) -> torch.Tensor:
        if not cuda:
            return t.contiguous()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    @staticmethod
    def _event(cuda: bool):
        if not cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def wait_scores(self) -> np.ndarray:
        if self.score_event is not None:
            self.score_event.synchronize()
        return self.score.numpy()

    def wait_maps(self) -> Dict[int, np.ndarray]:
        if self.maps_event is not None:
            self.maps_event.synchronize()
        return {s: m.numpy() for s, m in self.maps.items()}


class InferenceEngine:
    """Holds the predict function, the anchors and the post-processing
    matrices of each dataset; serves micro-batched requests from a queue.

    Towers from ``clip_checkpoint`` (an OpenAI-layout checkpoint) or the
    seeded init; adapters from ``save_path`` (``train/checkpoint.py::
    discover_serving_adapters``), else random and flagged ``untrained``.
    ``anchor_cache`` keeps the text anchors on disk, keyed by everything
    that determines them. ``startup_s`` holds the seconds of the towers
    (with the adapters), the anchors and the warm-up."""

    def __init__(self, model_name: str = "ViT-L-14-336", img_size: int = 518,
                 datasets=None, save_path: Optional[str] = None,
                 precision: str = "bf16", max_batch: Optional[int] = 8,
                 batch_window_ms: float = 5.0, seed: int = 111,
                 clip_checkpoint: Optional[str] = None,
                 adapter_cfg: Optional[dict] = None,
                 data_parallel: bool = False,
                 precompile: bool = True,
                 max_queue: Optional[int] = None,
                 anchor_cache: Optional[str] = None,
                 artifact: Optional[str] = None, device=None):
        if artifact is not None:
            raise NotImplementedError(
                f"serving an exported artifact is not ported yet: {_A12}")
        if data_parallel:
            raise NotImplementedError(
                f"data-parallel serving is not ported yet: {_A12}")
        from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                                  get_config)
        from aaclip_tpu_torch.core.params import (adapter_from_jax,
                                                  adapter_to_jax,
                                                  create_clip_towers,
                                                  init_image_adapter,
                                                  init_text_adapter,
                                                  resolve_clip_checkpoint,
                                                  text_adapter_from_jax,
                                                  text_adapter_to_jax)
        from aaclip_tpu_torch.data.registry import DOMAINS
        from aaclip_tpu_torch.device import resolve_device
        from aaclip_tpu_torch.eval.predict import (make_anchor_encoder,
                                                   make_predict_fn)
        from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix
        from aaclip_tpu_torch.text.anchors import (
            encode_dataset_anchors, encode_dataset_anchors_cached)
        from aaclip_tpu_torch.train import checkpoint as ckpt

        policy = DtypePolicy.from_name(precision)   # int8 raises (A12)
        self.device = resolve_device(device)
        self.policy = policy
        self.img_size = img_size
        self.max_batch = 8 if max_batch is None else max_batch
        self.batch_window_s = batch_window_ms / 1000.0
        datasets = tuple(datasets) if datasets is not None else ("MVTec",)
        cfg = get_config(model_name, img_size)
        self.cfg = cfg
        acfg = AdapterConfig(**(adapter_cfg or {}))
        if max(acfg.levels) > cfg.vision.layers:
            raise ValueError(
                f"adapter levels {acfg.levels} exceed the {cfg.vision.layers}"
                f"-layer tower of {model_name}; pass adapter_cfg/--levels "
                f"matching the model")
        self.startup_s = {}
        t0 = time.perf_counter()
        vit, text = create_clip_towers(cfg, checkpoint=clip_checkpoint,
                                       seed=seed, device=self.device)
        image_tree = adapter_to_jax(init_image_adapter(cfg, acfg, seed=seed,
                                                       device="cpu"))
        text_tree = text_adapter_to_jax(init_text_adapter(
            cfg, acfg, seed=seed, device="cpu"))
        img_path = text_path = None
        if save_path:
            image_tree, text_tree, img_path, text_path = \
                ckpt.discover_serving_adapters(save_path, image_tree,
                                               text_tree)
        self.untrained = img_path is None
        text_adapter, text_adapter_id = None, "none"
        if text_path:
            text_adapter = text_adapter_from_jax(text_tree, cfg, acfg,
                                                 device=self.device)
            text_adapter_id = _path_digest(text_path)
        elif not self.untrained:
            # trained image adapters were fitted against adapted-text
            # anchors (unless --text_epoch 0): say that these are not
            _log.warning(
                "image adapter loaded but no text_adapter checkpoint under "
                "save_path=%r — anchors come from the FROZEN text encoder "
                "(only correct for --text_epoch 0 runs)", save_path)
        if self.untrained:
            _log.warning(
                "serving with RANDOM-INIT adapters (no image_adapter_*.npz "
                "under save_path=%r) — /predict responses are not anomaly "
                "detections; responses carry \"untrained\": true", save_path)
        self.image_adapter = adapter_from_jax(image_tree, cfg, acfg,
                                              device=self.device)
        self._predict = make_predict_fn(vit, cfg, acfg, policy=policy,
                                        uint8_inputs=True,
                                        device=self.device)
        self._sync()
        self.startup_s["towers"] = time.perf_counter() - t0

        # anchors and post-processing matrices per dataset; the cache key
        # names the checkpoint the towers actually loaded (one may have
        # been discovered without --clip_checkpoint)
        t0 = time.perf_counter()
        enc = make_anchor_encoder(text, cfg, acfg, text_adapter,
                                  policy=policy)
        if anchor_cache:
            effective = resolve_clip_checkpoint(cfg, clip_checkpoint)
            clip_id = (_path_digest(effective, content=False)
                       if effective else f"seed{seed}")
            kind = (torch.cuda.get_device_name(self.device)
                    if self.device.type == "cuda" else "cpu")
            identity = "|".join([
                model_name, f"clip={clip_id}", f"text_ad={text_adapter_id}",
                f"acfg={acfg!r}", f"policy={policy!r}",
                # device-computed numerics: the library and the hardware
                # can both shift them
                f"torch={torch.__version__}", f"cuda={torch.version.cuda}",
                f"device={kind}"])
        self.anchors: Dict[str, Dict[str, np.ndarray]] = {}
        self.postproc: Dict[str, np.ndarray] = {}
        for ds in datasets:
            if anchor_cache:
                self.anchors[ds] = encode_dataset_anchors_cached(
                    enc, ds, identity, anchor_cache)
            else:
                self.anchors[ds] = {
                    k: v.cpu().numpy()
                    for k, v in encode_dataset_anchors(enc, ds).items()}
            self.postproc[ds] = fused_postproc_matrix(cfg.vision.grid,
                                                      img_size, DOMAINS[ds])
        self.startup_s["anchors"] = time.perf_counter() - t0
        del enc, text, text_adapter

        self._start_runtime(max_queue, precompile)

    # -- device plumbing ----------------------------------------------------

    def _device_guard(self):
        """The engine's card as the calling thread's current device (the
        kernels launch on its current stream)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device; on the card through pinned
        memory without waiting (a pageable copy would first wait for the
        stream, that is for the previous batch's forward)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _start_runtime(self, max_queue: Optional[int],
                       precompile: bool) -> None:
        # stats first: the warm-up goes through _dispatch
        self._stats_lock = threading.Lock()
        self._phase_stats: Dict[str, list] = {}   # name -> ring of ms
        self._phase_total: Dict[str, list] = {}   # name -> [count, sum_ms]
        self._phase_probe = False  # on after the warm-up
        self._probe_wait_s = 0.0
        t0 = time.perf_counter()
        with self._device_guard(), torch.inference_mode():
            self._postproc_dev = {
                ds: torch.from_numpy(m).to(self.device)
                for ds, m in self.postproc.items()}
            if precompile:
                # every bucket once, its scores on the host, before the
                # first request: on the card the first call of each shape
                # loads (or builds) the kernels
                ds0 = next(iter(self.anchors))
                a0 = np.asarray(next(iter(self.anchors[ds0].values())))
                for b in sorted({self._bucket(n)
                                 for n in range(1, self.max_batch + 1)}):
                    imgs = np.zeros((b, 3, self.img_size, self.img_size),
                                    np.uint8)
                    anch = np.tile(a0[None], (b, 1, 1))
                    pix, sc = self._dispatch(imgs, anch, ds0)
                    _Readback(pix, sc, {1}).wait_scores()
        self.startup_s["warmup"] = time.perf_counter() - t0

        # admission control: fast-fail past max_queue pending requests
        self.max_queue = (max_queue if max_queue is not None
                          else 4 * self.max_batch)
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.max_queue)
        # bounded: the dispatch thread blocks when the completion stage
        # falls behind, so at most two batches of results are in flight
        self._completion_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._n_requests = 0
        self._n_errors = 0
        self._n_rejected = 0
        self._n_batches = 0
        self._n_batched_requests = 0
        self._latencies_ms: list = []  # ring buffer, last 1024 requests
        # the /statz phases: http_read and decode are the handler's,
        # queue_wait the batching wait, stack_pad and dispatch the host's
        # batch assembly and launch, device_wait the wait on the event
        # after the scores' copy (upload + forward + score), map_fetch the
        # wait for the maps' copies; AACLIP_SERVE_PHASE_PROBE=1 waits for
        # each upload in _dispatch and reports it as h2d_probe, which the
        # dispatch phase then excludes
        self._phase_probe = os.environ.get(
            "AACLIP_SERVE_PHASE_PROBE", "") == "1"
        self._worker = threading.Thread(target=self._serve_loop, daemon=True)
        self._worker.start()
        self._completer = threading.Thread(target=self._completion_loop,
                                           daemon=True)
        self._completer.start()

    def _dispatch(self, imgs: np.ndarray, anch: np.ndarray, ds: str):
        """One padded host micro-batch -> (maps, scores) on the device,
        launched and not waited on."""
        imgs_dev = self._upload(imgs)
        if self._phase_probe:
            # measurement mode: wait for the upload and time it; one extra
            # synchronisation per batch, so off by default
            t0 = time.perf_counter()
            self._sync()
            dt = time.perf_counter() - t0
            self._note_phase("h2d_probe", dt * 1e3)
            self._probe_wait_s = dt
        return self._predict(self.image_adapter, imgs_dev, self._upload(anch),
                             self._postproc_dev[ds])

    def _bucket(self, n: int) -> int:
        """Smallest power of 2 >= n, at most max_batch: log2(max_batch)
        shapes, with the work proportional to the occupancy."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    # -- request plumbing ---------------------------------------------------

    def submit(self, image_u8: np.ndarray, dataset: str, class_name: str,
               timeout: float = 30.0, map_stride: int = 1):
        """``image_u8``: [3, img_size, img_size] uint8. Blocks for
        ``(map, score)``.

        Shape and dtype are checked here: requests share batches, so one
        malformed array in the serve loop would fail its whole group.
        ``map_stride > 1`` returns ``map[::s, ::s]``, sliced on the device
        before the copy to the host (strides share batches; the values
        equal the full map's, sliced)."""
        map_stride = int(map_stride)
        if map_stride < 1:
            raise ValueError(f"map_stride must be >= 1, got {map_stride}")
        image_u8 = np.asarray(image_u8)
        want = (3, self.img_size, self.img_size)
        if image_u8.dtype != np.uint8 or image_u8.shape != want:
            raise ValueError(
                f"image must be uint8 {list(want)}, got {image_u8.dtype} "
                f"{list(image_u8.shape)}")
        if dataset not in self.anchors:
            raise KeyError(f"dataset {dataset} not loaded; have "
                           f"{sorted(self.anchors)}")
        if class_name not in self.anchors[dataset]:
            raise KeyError(
                f"class {class_name} unknown for {dataset}; have "
                f"{sorted(self.anchors[dataset])}")
        done = threading.Event()
        slot: dict = {"stride": map_stride}
        t0 = time.perf_counter()
        slot["t_enq"] = t0  # queue_wait starts here (read by _serve_loop)
        try:
            self._queue.put_nowait((image_u8, dataset, class_name, slot, done))
        except queue.Full:
            with self._stats_lock:
                self._n_requests += 1
                self._n_rejected += 1
            raise EngineOverloadedError(
                f"request queue full ({self.max_queue} pending); retry "
                f"later") from None
        if not done.wait(timeout):
            with self._stats_lock:
                self._n_requests += 1
                self._n_errors += 1
            raise TimeoutError("inference timed out")
        with self._stats_lock:
            self._n_requests += 1
            if "error" in slot:
                self._n_errors += 1
            else:
                self._latencies_ms.append((time.perf_counter() - t0) * 1e3)
                del self._latencies_ms[:-1024]
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["map"], slot["score"]

    def _note_phase(self, name: str, ms: float) -> None:
        with self._stats_lock:
            ring = self._phase_stats.setdefault(name, [])
            ring.append(ms)
            del ring[:-512]
            tot = self._phase_total.setdefault(name, [0, 0.0])
            tot[0] += 1
            tot[1] += ms

    def stats(self) -> dict:
        """The /statz counters: the mean batch occupancy says how well
        micro-batching shares forwards under the current load; "phases"
        splits where the request wall time goes."""
        with self._stats_lock:
            lat = sorted(self._latencies_ms)
            nb, nr = self._n_batches, self._n_batched_requests
            total, errors = self._n_requests, self._n_errors
            rejected = self._n_rejected
            phases = {
                name: (sorted(ring), list(self._phase_total[name]))
                for name, ring in self._phase_stats.items()
            }

        def pct(p):
            return round(lat[min(len(lat) - 1, int(p * len(lat)))], 2) \
                if lat else None

        def phase_row(ring, tot):
            n, s = tot
            return {
                "n": n,
                "total_s": round(s / 1e3, 3),
                "mean_ms": round(s / n, 2) if n else None,
                "p50_ms": round(ring[min(len(ring) - 1,
                                         len(ring) // 2)], 2),
                "p95_ms": round(ring[min(len(ring) - 1,
                                         int(0.95 * len(ring)))], 2),
            }

        return {
            "requests": total,
            "errors": errors,
            "rejected": rejected,
            "batches": nb,
            "mean_batch_occupancy": round(nr / nb, 3) if nb else None,
            "max_batch": self.max_batch,
            "max_queue": self.max_queue,
            "latency_ms": {"p50": pct(0.50), "p95": pct(0.95),
                           "max": round(lat[-1], 2) if lat else None},
            "phases": {name: phase_row(ring, tot)
                       for name, (ring, tot) in sorted(phases.items())},
        }

    def _serve_loop(self):
        with self._device_guard(), torch.inference_mode():
            while not self._stop.is_set():
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                batch = [first]
                deadline = time.perf_counter() + self.batch_window_s
                while len(batch) < self.max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(self._queue.get(timeout=remaining))
                    except queue.Empty:
                        break
                # group by dataset only: classes share a forward through
                # per-sample anchors [B, D, 2]; the post-processing matrix
                # is the dataset's domain's
                groups: Dict[str, list] = {}
                for item in batch:
                    groups.setdefault(item[1], []).append(item)
                for ds, items in groups.items():
                    self._run_group(ds, items)

    def _run_group(self, ds: str, items: list) -> None:
        with self._stats_lock:
            self._n_batches += 1
            self._n_batched_requests += len(items)
        try:
            t_group = time.perf_counter()
            for it in items:  # queue_wait: enqueue -> group start
                self._note_phase("queue_wait",
                                 (t_group - it[3]["t_enq"]) * 1e3)
            imgs = np.stack([it[0] for it in items])
            anch = np.stack([self.anchors[ds][it[2]] for it in items])
            n = imgs.shape[0]
            bucket = self._bucket(n)
            if n < bucket:  # pad to the bucket by repeating the last image
                pad = bucket - n
                imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
                anch = np.concatenate([anch, np.repeat(anch[-1:], pad, 0)])
            t_stacked = time.perf_counter()
            self._note_phase("stack_pad", (t_stacked - t_group) * 1e3)
            self._probe_wait_s = 0.0
            pix, score = self._dispatch(imgs, anch, ds)
            # the copies to the host, queued behind the forward; each
            # stride slices the whole padded bucket on the device
            readback = _Readback(pix, score,
                                 {it[3]["stride"] for it in items})
            self._note_phase("dispatch", (time.perf_counter() - t_stacked
                                          - self._probe_wait_s) * 1e3)
            self._completion_q.put((items, readback))
        except Exception as e:  # every waiter of the group gets the error
            for _, _, _, slot, done in items:
                slot["error"] = f"{type(e).__name__}: {e}"
                done.set()

    def _completion_loop(self):
        while not self._stop.is_set():
            try:
                items, readback = self._completion_q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                # the scores' event first: it passes when the forward (and
                # its upload) is done, so this wait is the device phase;
                # the maps' copies follow it on the stream
                t0 = time.perf_counter()
                score = readback.wait_scores()
                t1 = time.perf_counter()
                self._note_phase("device_wait", (t1 - t0) * 1e3)
                maps = readback.wait_maps()
                for i, (_, _, _, slot, done) in enumerate(items):
                    slot["map"] = maps[slot["stride"]][i].copy()
                    slot["score"] = float(score[i])
                self._note_phase("map_fetch",
                                 (time.perf_counter() - t1) * 1e3)
                for _, _, _, _, done in items:
                    done.set()
            except Exception as e:
                for _, _, _, slot, done in items:
                    slot["error"] = f"{type(e).__name__}: {e}"
                    done.set()

    def shutdown(self):
        self._stop.set()
        self._worker.join(timeout=2)
        self._completer.join(timeout=2)
        # fail whatever is still queued so no waiter sits out its timeout;
        # loop until both threads are gone: a dispatch thread blocked in
        # the bounded _completion_q.put may enqueue one more batch once a
        # drain unblocks it
        deadline = time.perf_counter() + 5.0
        while True:
            drained = False
            for q in (self._queue, self._completion_q):
                while True:
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        break
                    drained = True
                    items = item[0] if q is self._completion_q else [item]
                    for _, _, _, slot, done in items:
                        slot["error"] = "engine shutting down"
                        done.set()
            workers_dead = (not self._worker.is_alive()
                            and not self._completer.is_alive())
            if (workers_dead and not drained) or \
                    time.perf_counter() > deadline:
                break
            time.sleep(0.01)


def _decode_image(body: bytes, img_size: int) -> np.ndarray:
    """Request body -> uint8 [3, img_size, img_size], as the evaluation
    path decodes a file: the host library where it is built, else PNG in
    numpy (PIL only for other formats), Pillow's bicubic resize."""
    from aaclip_tpu_torch.data import image
    from aaclip_tpu_torch.data.transforms import to_uint8_chw
    from aaclip_tpu_torch.native import image as native_image

    chw = native_image.decode_rgb_resize_chw(body, img_size)
    if chw is None:
        chw = to_uint8_chw(image.resize_bicubic(
            image.decode_rgb(body, "request body"), img_size))
    return chw


def make_handler(engine: InferenceEngine):
    class Handler(BaseHTTPRequestHandler):
        # a client that announces more Content-Length than it sends would
        # otherwise hold this handler thread in rfile.read forever
        timeout = 65

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict,
                  headers: Optional[dict] = None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "img_size": engine.img_size,
                    "datasets": sorted(engine.anchors),
                    "untrained": engine.untrained,
                    "map_encodings": ["json", "f16", "u8"],
                })
            elif url.path == "/statz":
                self._json(200, engine.stats())
            elif url.path == "/classes":
                q = parse_qs(url.query)
                ds = q.get("dataset", [next(iter(engine.anchors))])[0]
                if ds not in engine.anchors:
                    self._json(404, {"error": f"dataset {ds} not loaded"})
                    return
                self._json(200, {"dataset": ds,
                                 "classes": sorted(engine.anchors[ds])})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/predict":
                self._json(404, {"error": "unknown path"})
                return
            q = parse_qs(url.query)
            ds = q.get("dataset", [next(iter(engine.anchors))])[0]
            cls = q.get("class_name", [None])[0]
            if cls is None:
                self._json(400, {"error": "class_name query arg required"})
                return
            # every client-controlled number is parsed before any work
            try:
                stride = max(1, int(q.get("map_stride", ["1"])[0]))
            except ValueError:
                self._json(400, {"error": "map_stride must be an integer"})
                return
            encoding = q.get("map_encoding", ["json"])[0]
            if encoding not in ("json", "f16", "u8"):
                self._json(400, {"error": "map_encoding must be one of "
                                          "json, f16, u8"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._json(400, {"error": "bad Content-Length header"})
                return
            if length <= 0:
                self._json(400, {"error": "empty body (expected image bytes)"})
                return
            if length > MAX_BODY_BYTES:
                # refuse before allocating; then drain a bounded amount of
                # the body, since closing with unread data resets the
                # socket and the client would not see the 413
                self._json(413, {"error": f"body {length} bytes exceeds "
                                          f"the {MAX_BODY_BYTES} limit"})
                remaining = min(length, 4 * MAX_BODY_BYTES)
                while remaining > 0:
                    chunk = self.rfile.read(min(65536, remaining))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                self.close_connection = True
                return
            t0 = time.perf_counter()
            body = self.rfile.read(length)
            t1 = time.perf_counter()
            engine._note_phase("http_read", (t1 - t0) * 1e3)
            try:
                img = _decode_image(body, engine.img_size)
            except Exception as e:
                self._json(400, {"error": f"could not decode image: {e}"})
                return
            engine._note_phase("decode", (time.perf_counter() - t1) * 1e3)
            try:
                amap, score = engine.submit(img, ds, cls,
                                            map_stride=stride)
            except KeyError as e:
                self._json(404, {"error": str(e)})
                return
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            except EngineOverloadedError as e:
                self._json(429, {"error": str(e)},
                           headers={"Retry-After": "1"})
                return
            except Exception as e:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            t2 = time.perf_counter()
            if encoding == "json":
                payload = {
                    "image_score": score,
                    "map_shape": list(amap.shape),  # already strided
                    "anomaly_map": np.round(amap, 4).tolist(),
                }
                if engine.untrained:
                    payload["untrained"] = True
                self._json(200, payload)
            else:
                # the map as the body (2 or 1 bytes a pixel instead of ~7
                # ASCII bytes), everything scalar in headers; u8 is affine:
                # value = offset + scale * byte, error at most scale / 2
                amap = np.ascontiguousarray(amap, np.float32)
                if encoding == "f16":
                    body = amap.astype("<f2").tobytes()
                    headers = {"X-Map-Dtype": "float16"}
                else:
                    lo = float(amap.min()) if amap.size else 0.0
                    hi = float(amap.max()) if amap.size else 0.0
                    scale = (hi - lo) / 255.0
                    qmap = (np.zeros(amap.shape, np.uint8) if scale == 0.0
                            else np.clip(np.rint((amap - lo) / scale),
                                         0, 255).astype(np.uint8))
                    body = qmap.tobytes()
                    headers = {"X-Map-Dtype": "uint8",
                               "X-Map-Scale": repr(scale),
                               "X-Map-Offset": repr(lo)}
                headers["X-Image-Score"] = repr(float(score))
                headers["X-Map-Shape"] = ",".join(
                    str(d) for d in amap.shape)
                if engine.untrained:
                    headers["X-Untrained"] = "1"
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)
            engine._note_phase("respond", (time.perf_counter() - t2) * 1e3)

    return Handler


def serve(engine: InferenceEngine, host: str = "127.0.0.1",
          port: int = 8400) -> ThreadingHTTPServer:
    """The HTTP server over ``engine`` (port 0 picks a free one); call its
    ``serve_forever()``."""
    return ThreadingHTTPServer((host, port), make_handler(engine))


def parse_args(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="aaclip_tpu_torch inference server")
    parser.add_argument("--artifact", default=None,
                        help="serve an exported artifact directory (not "
                             "ported yet: ROADMAP A12)")
    parser.add_argument("--model_name", default="ViT-L-14-336")
    parser.add_argument("--img_size", type=int, default=518)
    parser.add_argument("--datasets", nargs="+", default=None,
                        help="datasets to build anchors for (default: "
                             "MVTec)")
    parser.add_argument("--save_path", default=None,
                        help="adapter checkpoint dir (optional)")
    parser.add_argument("--precision", default="bf16",
                        choices=["fp32", "fp32_high", "bf16", "int8"],
                        help="int8 is not ported yet (ROADMAP A12)")
    parser.add_argument("--max_batch", type=int, default=None,
                        help="largest micro-batch (default 8)")
    parser.add_argument("--max_queue", type=int, default=None,
                        help="pending-request cap (default 4 x max_batch); "
                             "submits beyond it fast-fail with HTTP 429")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8400)
    parser.add_argument("--clip_checkpoint", default=None)
    parser.add_argument("--data_parallel", action="store_true",
                        help="not ported yet (ROADMAP A12)")
    parser.add_argument("--no_precompile", action="store_true",
                        help="skip running every batch bucket at start-up: "
                             "the first request of each bucket size then "
                             "pays for its first call")
    parser.add_argument("--anchor_cache", default=os.environ.get(
                            "AACLIP_ANCHOR_CACHE",
                            os.path.expanduser(
                                "~/.cache/aaclip_tpu_torch/anchors")),
                        help="disk cache dir for the text anchors (keyed by "
                             "their inputs); default from "
                             "AACLIP_ANCHOR_CACHE; --anchor_cache '' "
                             "disables")
    parser.add_argument("--levels", type=int, nargs="+",
                        default=[6, 12, 18, 24])
    parser.add_argument("--image_adapt_until", type=int, default=6)
    parser.add_argument("--text_adapt_until", type=int, default=3)
    parser.add_argument("--relu", action="store_true")
    args = parser.parse_args(argv)
    unported = [("--artifact", args.artifact is not None),
                ("--data_parallel", args.data_parallel),
                ("--precision int8", args.precision == "int8")]
    for flag, given in unported:
        if given:
            raise NotImplementedError(f"{flag} is not ported yet: {_A12}")
    return args


def main(argv=None, *, device=None):
    args = parse_args(argv)
    engine = InferenceEngine(
        model_name=args.model_name, img_size=args.img_size,
        datasets=tuple(args.datasets) if args.datasets else None,
        save_path=args.save_path, precision=args.precision,
        max_batch=args.max_batch, max_queue=args.max_queue,
        clip_checkpoint=args.clip_checkpoint,
        precompile=not args.no_precompile,
        anchor_cache=args.anchor_cache or None,
        adapter_cfg=dict(levels=tuple(args.levels),
                         image_adapt_until=args.image_adapt_until,
                         text_adapt_until=args.text_adapt_until,
                         proj_relu=args.relu),
        device=device)
    httpd = serve(engine, args.host, args.port)
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(datasets: {sorted(engine.anchors)}; start-up "
          + ", ".join(f"{k} {v:.2f} s" for k, v in engine.startup_s.items())
          + ")", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        engine.shutdown()
