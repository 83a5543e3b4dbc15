"""Self-contained serving artifacts: the prediction graph frozen with
``torch.export`` per batch bucket, plus every derived constant needed to
serve it, in one directory (the JAX package's ``aaclip_tpu/deploy.py``).

A serving host then skips the checkpoint parse, the text tower and the
model-building code: ``load_serving_artifact(dir).predict(...)``, or
``python -m aaclip_tpu_torch.serve --artifact DIR``.

Artifact layout::

    manifest.json       version, config echo, tensor skeletons, platforms,
                        sha256 of every payload file, provenance
    graph_b{N}.pt2      torch.export program per batch bucket
    graph_mb_b{N}.pt2   the memory-bank programs (``memory_bank_shot``)
    params.npz          the prepared tower and adapter tensors as raw
                        bytes (bf16 and int8 survive; npz has no bf16)
    banks_{ds}.npz      per-class memory banks, padded to one size
    anchors_{ds}.npz    [D, 2] text anchors per class
    postproc_{ds}.npy   fused blur + upsample matrix per dataset domain

The weights are the programs' inputs, as in JAX's graphs: they live once,
in ``params.npz``, and no ``.pt2`` file holds a copy. Each program carries
the packed attention as the ``aaclip::attention_packed`` operator
(``ops/attention.py``): on the card its body launches the hand-written
kernel, on the CPU it runs the plain version. A program runs on the device
type it was exported on (``platforms``), which the loader checks.

Run as ``python -m aaclip_tpu_torch.deploy --out DIR`` (the flags of the
JAX package's ``tools/export_artifact.py``; ``--verify`` reloads the
artifact and holds one batch bit for bit against the live predictor).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from aaclip_tpu_torch.utils.hashing import sha256_file

ARTIFACT_VERSION = 1
_MANIFEST = "manifest.json"


# ---------------------------------------------------------------------------
# name -> tensor dicts <-> (JSON skeleton, raw-byte leaves): the exported
# programs take the exact dicts they were traced with, so their structure
# ships in the manifest and the tensors as raw bytes in params.npz


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _skeletonize(tree: dict, leaves: list) -> dict:
    items = {}
    for k in sorted(tree):
        t = tree[k]
        leaves.append(t)
        items[k] = {"t": "leaf", "i": len(leaves) - 1,
                    "shape": list(t.shape), "dtype": _dtype_name(t)}
    return {"t": "dict", "items": items}


def _leaf_bytes(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().reshape(-1).view(
        torch.uint8).numpy()


def _leaf_from_bytes(buf: np.ndarray, shape, dtype_name: str,
                     device) -> torch.Tensor:
    dt = getattr(torch, dtype_name)
    flat = torch.from_numpy(np.array(buf, np.uint8, copy=True)).view(dt)
    return flat.reshape(shape).to(device)


def _rebuild(skel: dict, z, prefix: str, device) -> dict:
    """The name -> tensor dict of a skeleton, keys in the skeleton's
    (sorted) order, from the npz ``z`` keys ``{prefix}{i}``."""
    return {k: _leaf_from_bytes(z[f"{prefix}{leaf['i']}"], leaf["shape"],
                                leaf["dtype"], device)
            for k, leaf in skel["items"].items()}


class _Program(torch.nn.Module):
    """A predictor's raw form as the module ``torch.export`` traces: the
    raw function is held outside the module tree, so its tensors are the
    program's inputs, never its state."""

    def __init__(self, raw):
        super().__init__()
        object.__setattr__(self, "_raw", raw)

    def forward(self, visual, adapter, images, anchors, M, *bank):
        return self._raw(visual, adapter, images, anchors, M, *bank)


def _export(raw, path: str, args) -> float:
    """``torch.export`` of ``raw`` on ``args`` into ``path``, without the
    example inputs (they would be the weights); returns the seconds."""
    t0 = time.perf_counter()
    with torch.no_grad():
        ep = torch.export.export(_Program(raw), args, strict=False)
    ep.example_inputs = None
    torch.export.save(ep, path)
    return time.perf_counter() - t0


def resolve_native_kernels(native_kernels: Optional[bool],
                           device: torch.device) -> bool:
    """The manifest's ``native_kernels``: whether the programs run the
    hand-written kernels. None resolves to "the export device is the
    card". True off the card raises, as JAX's does off the TPU: the kernels
    exist on the card only. False on the card raises: the port has no
    library attention there, and the plain version is for CPU tensors
    only."""
    on_card = device.type == "cuda"
    if native_kernels is None:
        return on_card
    if native_kernels and not on_card:
        raise ValueError(
            f"native_kernels=True but the export device is {device}: the "
            "hand-written attention kernels run on the card only; export "
            "there, or leave native_kernels unset")
    if not native_kernels and on_card:
        raise ValueError(
            "native_kernels=False on the card: the port has no library "
            "attention there (the plain version is for CPU tensors); leave "
            "native_kernels unset")
    return bool(native_kernels)


# ---------------------------------------------------------------------------
# export


def export_serving_artifact(
        out_dir: str, *,
        model_name: str = "ViT-L-14-336", img_size: int = 518,
        precision: str = "bf16", adapter_cfg: Optional[dict] = None,
        clip_checkpoint: Optional[str] = None, seed: int = 111,
        save_path: Optional[str] = None,
        datasets: Sequence[str] = ("MVTec",),
        batch_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32),
        platforms: Optional[Sequence[str]] = None,
        native_kernels: Optional[bool] = None,
        memory_bank_shot: int = 0, bank_weight: float = 0.5,
        bank_chunk: int = 1024, verify: bool | int = False,
        device=None) -> dict:
    """Build the serving pipeline as the live engine builds it
    (``serve/server.py``: the towers, adapters from ``save_path``, the
    anchors through the text tower) and freeze it into ``out_dir``.
    Returns the manifest; ``manifest["export_s"]`` holds the seconds of
    each program's export.

    ``platforms`` may only name the export device's type (the programs run
    where they were traced); ``native_kernels`` as
    ``resolve_native_kernels``. ``memory_bank_shot=K`` also bundles the
    few-shot banks (the support draw of ``test --memory_bank``, so the
    export host needs AACLIP_DATA/METADATA), padded to one size, and the
    bank programs ``graph_mb_b{N}.pt2``, which ``predict_class`` then
    uses. ``verify`` (True, or a batch size) reloads the artifact and runs
    one batch (True: of the largest bucket up to 4) through it and through
    the live predictor; ``manifest["verify"]`` says whether they agree bit
    for bit (``_verify``). ``device=None`` means the card."""
    import logging

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
    from aaclip_tpu_torch.eval.predict import (adapter_tensors,
                                               make_anchor_encoder,
                                               make_predict_fn)
    from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix
    from aaclip_tpu_torch.text.anchors import encode_dataset_anchors
    from aaclip_tpu_torch.train import checkpoint as ckpt

    if not datasets:
        raise ValueError("datasets must be non-empty: the artifact's "
                         "anchors and postproc are its serving surface")
    dev = resolve_device(device)
    if platforms and tuple(platforms) != (dev.type,):
        raise ValueError(f"platforms {list(platforms)}: a program runs on "
                         f"the device type it was exported on ({dev.type})")
    native = resolve_native_kernels(native_kernels, dev)
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive, got {batch_sizes}")
    policy = DtypePolicy.from_name(precision)
    cfg = get_config(model_name, img_size)
    acfg = AdapterConfig(**(adapter_cfg or {}))
    vit, text = create_clip_towers(cfg, checkpoint=clip_checkpoint, seed=seed,
                                   device=dev)
    image_tree = adapter_to_jax(init_image_adapter(cfg, acfg, seed=seed,
                                                   device="cpu"))
    text_tree = text_adapter_to_jax(init_text_adapter(cfg, acfg, seed=seed,
                                                      device="cpu"))
    img_path = text_path = None
    if save_path:
        image_tree, text_tree, img_path, text_path = \
            ckpt.discover_serving_adapters(save_path, image_tree, text_tree)
    untrained = img_path is None
    if img_path and not text_path:
        # an artifact bakes the frozen-text anchors in for good: say so
        logging.getLogger("aaclip.deploy").warning(
            "image adapter found but no text_adapter checkpoint under "
            "save_path=%r: the anchors are encoded with the FROZEN text "
            "encoder and frozen into the artifact (only correct for "
            "--text_epoch 0 runs)", save_path)
    image_adapter = adapter_from_jax(image_tree, cfg, acfg, device=dev)
    text_adapter = (text_adapter_from_jax(text_tree, cfg, acfg, device=dev)
                    if text_path else None)
    predict = make_predict_fn(vit, cfg, acfg, policy=policy,
                              uint8_inputs=True, device=dev)
    enc = make_anchor_encoder(text, cfg, acfg, text_adapter, policy=policy)
    anchors = {ds: {k: v.cpu().numpy()
                    for k, v in encode_dataset_anchors(enc, ds).items()}
               for ds in datasets}
    postproc = {ds: fused_postproc_matrix(cfg.vision.grid, img_size,
                                          DOMAINS[ds]) for ds in datasets}
    del enc, text, text_adapter
    D = cfg.embed_dim
    M_shapes = {postproc[ds].shape for ds in datasets}
    if len(M_shapes) != 1:
        raise ValueError(f"postproc matrix shapes differ across datasets "
                         f"({M_shapes}): one program per bucket takes one M")
    M = torch.from_numpy(postproc[datasets[0]]).to(dev)

    os.makedirs(out_dir, exist_ok=True)
    # re-export into an artifact directory: the old manifest goes FIRST,
    # so a crash mid-rewrite leaves an unloadable directory, never an old
    # manifest vouching for a mix of old and new files
    stale = os.path.join(out_dir, _MANIFEST)
    if os.path.exists(stale):
        os.remove(stale)
    visual = predict.visual
    adapter = adapter_tensors(image_adapter)
    visual_leaves: list = []
    visual_skel = _skeletonize(visual, visual_leaves)
    adapter_leaves: list = []
    adapter_skel = _skeletonize(adapter, adapter_leaves)

    def example(b):
        return (visual, adapter,
                torch.zeros(b, 3, img_size, img_size, dtype=torch.uint8,
                            device=dev),
                torch.zeros(b, D, 2, device=dev), M)

    graph_files, export_s = {}, {}
    for b in batch_sizes:
        name = f"graph_b{b}.pt2"
        export_s[name] = _export(predict.raw, os.path.join(out_dir, name),
                                 example(b))
        graph_files[str(b)] = name

    bank_graph_files: dict = {}
    bank_files: dict = {}
    mb_manifest = None
    if memory_bank_shot:
        from aaclip_tpu_torch.eval import memory_bank as mb

        mb_predict = mb.make_mb_predict_fn(
            vit, cfg, acfg, policy=policy, uint8_inputs=True,
            bank_weight=bank_weight, chunk=bank_chunk, device=dev)
        raw_banks = {}
        for ds in datasets:
            support = mb.collect_support_sets(ds, memory_bank_shot, img_size,
                                              uint8=True)
            raw_banks[ds] = {
                cls: mb.collect_bank(mb_predict.features_fn, image_adapter,
                                     imgs)
                for cls, imgs in support.items()}
        all_banks = [b for per in raw_banks.values() for b in per.values()]
        if not all_banks:
            raise ValueError(
                "memory_bank_shot set but no support images found: the "
                "export host needs AACLIP_DATA/AACLIP_METADATA for the "
                "bundled datasets")
        n_max = max(b.shape[1] for b in all_banks)
        banks = {ds: mb.pad_banks_to_common_size(per, n_max)
                 for ds, per in raw_banks.items()}
        bank_shape = (len(acfg.levels), n_max, D)
        for b in batch_sizes:
            # the plain programs' visual tensors: the bank predictor's own
            # prepared tower holds the same values under the same names
            name = f"graph_mb_b{b}.pt2"
            export_s[name] = _export(
                mb_predict.raw, os.path.join(out_dir, name),
                example(b) + (torch.zeros(bank_shape, device=dev),))
            bank_graph_files[str(b)] = name
        for ds in datasets:
            bank_files[ds] = f"banks_{ds}.npz"
            np.savez(os.path.join(out_dir, bank_files[ds]),
                     **{c: v.cpu().numpy() for c, v in banks[ds].items()})
        mb_manifest = {"shot": int(memory_bank_shot),
                       "bank_weight": float(bank_weight),
                       "bank_shape": list(bank_shape),
                       "graphs": bank_graph_files,
                       "bank_files": bank_files}
        del mb_predict, raw_banks, banks

    np.savez(os.path.join(out_dir, "params.npz"),
             **{f"v{i}": _leaf_bytes(t) for i, t in enumerate(visual_leaves)},
             **{f"a{i}": _leaf_bytes(t) for i, t in enumerate(adapter_leaves)})
    for ds in datasets:
        np.savez(os.path.join(out_dir, f"anchors_{ds}.npz"), **anchors[ds])
        np.save(os.path.join(out_dir, f"postproc_{ds}.npy"), postproc[ds])

    # content digests over every payload file: a truncated copy or a
    # flipped bit must fail AT LOAD, not as silently wrong maps
    payload = sorted(graph_files.values()) + ["params.npz"] + \
        sorted(bank_graph_files.values()) + sorted(bank_files.values()) + \
        [f"anchors_{ds}.npz" for ds in datasets] + \
        [f"postproc_{ds}.npy" for ds in datasets]
    digests = {name: sha256_file(os.path.join(out_dir, name))
               for name in payload}
    effective_ckpt = resolve_clip_checkpoint(cfg, clip_checkpoint)
    manifest = {
        "sha256": digests,
        "artifact_version": ARTIFACT_VERSION,
        "torch_version": torch.__version__,
        "model_name": model_name, "img_size": img_size,
        "precision": precision, "adapter_cfg": adapter_cfg or {},
        "embed_dim": int(D), "grid": int(cfg.vision.grid),
        "platforms": [dev.type], "native_kernels": native,
        "batch_sizes": batch_sizes, "datasets": list(datasets),
        "graphs": graph_files, "untrained": untrained,
        # provenance: which weights made this artifact
        "clip_checkpoint": (os.path.abspath(effective_ckpt)
                            if effective_ckpt else f"seed{seed}"),
        "image_adapter_ckpt": os.path.abspath(img_path) if img_path else None,
        "text_adapter_ckpt": (os.path.abspath(text_path)
                              if text_path else None),
        "visual_skeleton": visual_skel, "adapter_skeleton": adapter_skel,
        "memory_bank": mb_manifest,
    }
    # the manifest is the commit marker: written last, atomically
    tmp = os.path.join(out_dir, f".{_MANIFEST}.tmp-{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(out_dir, _MANIFEST))
    manifest["export_s"] = export_s
    if verify:
        b = verify if verify is not True else max(
            [x for x in batch_sizes if x <= 4] or batch_sizes[:1])
        manifest["verify"] = _verify(out_dir, predict, image_adapter,
                                     anchors, postproc, datasets[0], int(b),
                                     img_size, dev)
    return manifest


def _verify(out_dir, predict, image_adapter, anchors, postproc, ds,
            b: int, img_size, dev) -> dict:
    """The reloaded artifact against the live predictor on one batch of
    ``b`` seeded images of the first class: ``bit_equal``, the largest map
    and score differences, the map's span and the load seconds."""
    t0 = time.perf_counter()
    art = load_serving_artifact(out_dir, device=dev)
    load_s = time.perf_counter() - t0
    cls = sorted(anchors[ds])[0]
    imgs = np.random.default_rng(0).integers(
        0, 255, (b, 3, img_size, img_size), dtype=np.uint8)
    maps, scores = art.predict_class(imgs, ds, cls, use_bank=False)
    anc = np.broadcast_to(anchors[ds][cls], (b,) + anchors[ds][cls].shape)
    pix, score = predict(image_adapter, torch.from_numpy(imgs).to(dev),
                         torch.from_numpy(np.array(anc)).to(dev),
                         torch.from_numpy(postproc[ds]).to(dev))
    pix, score = pix.cpu().numpy(), score.cpu().numpy()
    return {"dataset": ds, "class": cls, "batch": b, "load_s": load_s,
            "bit_equal": bool(np.array_equal(maps, pix)
                              and np.array_equal(scores, score)),
            "max_abs_map": float(np.abs(maps - pix).max()),
            "max_abs_score": float(np.abs(scores - score).max()),
            "span": float(pix.max() - pix.min()),
            "maps_shape": list(maps.shape),
            "scores": [float(x) for x in scores]}


# ---------------------------------------------------------------------------
# load + run


class ServingArtifact:
    """A loaded artifact: the exported programs and their constants on
    ``device`` (None: the card).

    ``predict`` pads each chunk to the nearest exported bucket by
    repeating its last sample (edge replication: a zero lane would feed
    the L2 normalisation a zero vector) and trims the outputs;
    ``predict_tensors`` does the same on device tensors and leaves its
    outputs there (the serving engine's path). ``programs`` and
    ``bank_programs`` keep each bucket's loaded ``ExportedProgram``; ``load_s`` the seconds
    of the load's parts (the digests, the tensors, the programs)."""

    def __init__(self, path: str, check_integrity: bool = True,
                 device=None):
        # the programs' attention node needs its operator registered
        import aaclip_tpu_torch.ops.attention  # noqa: F401
        from aaclip_tpu_torch.device import resolve_device

        t0 = time.perf_counter()
        with open(os.path.join(path, _MANIFEST)) as f:
            m = json.load(f)
        if m["artifact_version"] != ARTIFACT_VERSION:
            raise ValueError(
                f"artifact version {m['artifact_version']} at {path!r} not "
                f"supported (this library reads {ARTIFACT_VERSION})")
        if check_integrity:
            for name, want in m.get("sha256", {}).items():
                fpath = os.path.join(path, name)
                if not os.path.exists(fpath):
                    raise ValueError(
                        f"artifact file {name!r} listed in the manifest is "
                        f"missing at {path!r}: truncated copy; re-copy or "
                        "re-export")
                if sha256_file(fpath) != want:
                    raise ValueError(
                        f"artifact file {name!r} at {path!r} fails its "
                        "manifest sha256: corrupted or truncated transfer; "
                        "re-copy or re-export")
        self.load_s = {"digests": time.perf_counter() - t0}
        dev = resolve_device(device)
        if dev.type not in m["platforms"]:
            raise ValueError(
                f"artifact at {path!r} was exported for platforms "
                f"{m['platforms']}, but this process runs on {dev.type!r}: "
                f"re-export on {dev.type!r}")
        self.manifest, self.path, self.device = m, path, dev
        self.img_size = m["img_size"]
        self.embed_dim = m["embed_dim"]
        self.untrained = m["untrained"]
        self.batch_sizes = list(m["batch_sizes"])
        t0 = time.perf_counter()
        with np.load(os.path.join(path, "params.npz")) as z:
            self.visual = _rebuild(m["visual_skeleton"], z, "v", dev)
            self.image_adapter = _rebuild(m["adapter_skeleton"], z, "a", dev)
        self.anchors: Dict[str, Dict[str, np.ndarray]] = {}
        self.postproc: Dict[str, np.ndarray] = {}
        self._postproc_dev: Dict[str, torch.Tensor] = {}
        for ds in m["datasets"]:
            with np.load(os.path.join(path, f"anchors_{ds}.npz")) as z:
                self.anchors[ds] = {k: np.asarray(z[k]) for k in z.files}
            self.postproc[ds] = np.load(os.path.join(path,
                                                     f"postproc_{ds}.npy"))
            self._postproc_dev[ds] = torch.from_numpy(
                self.postproc[ds]).to(dev)
        self.load_s["tensors"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # torch.export's deserializer takes seconds per program at ViT-L
        self.programs = {int(b): torch.export.load(os.path.join(path, name))
                         for b, name in m["graphs"].items()}
        self._fns = {b: ep.module() for b, ep in self.programs.items()}
        mbm = m.get("memory_bank")
        self.banks: Dict[str, Dict[str, np.ndarray]] = {}
        self.bank_programs, self._bank_fns = {}, {}
        self._banks_dev: Dict[Tuple[str, str], torch.Tensor] = {}
        self.shot = self.bank_weight = None
        if mbm:
            self.shot, self.bank_weight = mbm["shot"], mbm["bank_weight"]
            for ds, fname in mbm["bank_files"].items():
                with np.load(os.path.join(path, fname)) as z:
                    self.banks[ds] = {k: np.asarray(z[k]) for k in z.files}
            self.bank_programs = {
                int(b): torch.export.load(os.path.join(path, name))
                for b, name in mbm["graphs"].items()}
            self._bank_fns = {b: ep.module()
                              for b, ep in self.bank_programs.items()}
        self.load_s["programs"] = time.perf_counter() - t0

    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        return self.batch_sizes[-1]

    def predict_tensors(self, images: torch.Tensor, anchors: torch.Tensor,
                        M: torch.Tensor, bank: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``predict`` on device tensors (images [n, 3, S, S] uint8,
        per-sample anchors [n, D, 2], a dataset's ``M``, a bank on the
        device for the bank programs), the outputs left on the device, not
        waited on: chunks of the largest bucket, each padded up to the
        nearest bucket by repeating its last sample and trimmed after."""
        n = int(images.shape[0])
        if n == 0:
            raise ValueError("empty batch")
        maps, scores = [], []
        cap = self.batch_sizes[-1]
        for lo in range(0, n, cap):
            chunk, anc = images[lo:lo + cap], anchors[lo:lo + cap]
            valid = chunk.shape[0]
            pad = self._bucket(valid) - valid
            if pad:  # edge replication: never a zero lane
                chunk = torch.cat([chunk, chunk[-1:].expand(pad, -1, -1,
                                                            -1)])
                anc = torch.cat([anc, anc[-1:].expand(pad, -1, -1)])
            fns = self._fns if bank is None else self._bank_fns
            with torch.inference_mode():
                pix, sc = fns[chunk.shape[0]](
                    self.visual, self.image_adapter, chunk.contiguous(),
                    anc.contiguous(), M, *(() if bank is None else (bank,)))
            maps.append(pix[:valid])
            scores.append(sc[:valid])
        if len(maps) == 1:
            return maps[0], scores[0]
        return torch.cat(maps), torch.cat(scores)

    def predict(self, images_u8: np.ndarray, anchors: np.ndarray,
                dataset: str, *, bank=None) -> Tuple[np.ndarray, np.ndarray]:
        """images [n, 3, S, S] uint8, per-sample anchors [n, D, 2] ->
        (maps [n, S, S], scores [n]) as numpy. ``bank`` (a bundled
        per-class bank [n_levels, N, D]) takes the bank programs."""
        if int(images_u8.shape[0]) == 0:
            raise ValueError("empty batch")
        if dataset not in self.postproc:
            raise KeyError(f"dataset {dataset!r} not in artifact "
                           f"({list(self.postproc)})")
        if bank is not None:
            bank = torch.as_tensor(np.asarray(bank, np.float32)
                                   if not isinstance(bank, torch.Tensor)
                                   else bank).to(self.device)
        pix, sc = self.predict_tensors(
            torch.from_numpy(np.array(images_u8)).to(self.device),
            torch.from_numpy(np.array(anchors, np.float32)).to(self.device),
            self._postproc_dev[dataset], bank)
        return pix.cpu().numpy(), sc.cpu().numpy()

    def class_bank(self, dataset: str, class_name: str
                   ) -> Optional[torch.Tensor]:
        """The bundled bank of a class on the device, or None."""
        if class_name not in self.banks.get(dataset, {}):
            return None
        key = (dataset, class_name)
        if key not in self._banks_dev:
            self._banks_dev[key] = torch.from_numpy(
                self.banks[dataset][class_name]).to(self.device)
        return self._banks_dev[key]

    def predict_class(self, images_u8: np.ndarray, dataset: str,
                      class_name: str, use_bank: Optional[bool] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """One class's prediction. ``use_bank``: None uses the bundled bank
        when the artifact has one for the class; False forces the text
        anchors alone; True demands a bank and raises without one."""
        if dataset not in self.anchors:
            raise KeyError(f"dataset {dataset!r} not in artifact "
                           f"({list(self.anchors)})")
        cls = self.anchors[dataset]
        if class_name not in cls:
            raise KeyError(f"class {class_name!r} not in artifact dataset "
                           f"{dataset!r} ({sorted(cls)})")
        bank = self.class_bank(dataset, class_name)
        if use_bank is True and bank is None:
            raise KeyError(
                f"use_bank=True but the artifact has no bank for "
                f"{dataset!r}/{class_name!r}: re-export with "
                "memory_bank_shot")
        if use_bank is False:
            bank = None
        anc = np.broadcast_to(
            cls[class_name], (images_u8.shape[0],) + cls[class_name].shape)
        return self.predict(images_u8, anc, dataset, bank=bank)


def load_serving_artifact(path: str, check_integrity: bool = True,
                          device=None) -> ServingArtifact:
    return ServingArtifact(path, check_integrity=check_integrity,
                           device=device)


# ---------------------------------------------------------------------------
# CLI


def main(argv=None, *, device=None):
    """``python -m aaclip_tpu_torch.deploy``: the flags of the JAX
    package's ``tools/export_artifact.py``; prints one JSON line last."""
    import argparse
    import sys

    p = argparse.ArgumentParser(
        description="Export a self-contained serving artifact")
    p.add_argument("--out", required=True, help="artifact output directory")
    p.add_argument("--model_name", default="ViT-L-14-336")
    p.add_argument("--img_size", type=int, default=518)
    p.add_argument("--precision", default="bf16",
                   choices=["fp32", "fp32_high", "bf16", "int8"])
    p.add_argument("--datasets", nargs="+", default=["MVTec"])
    p.add_argument("--save_path", default=None,
                   help="adapter checkpoint dir (optional)")
    p.add_argument("--clip_checkpoint", default=None)
    p.add_argument("--seed", type=int, default=111)
    p.add_argument("--batch_sizes", type=int, nargs="+",
                   default=[1, 2, 4, 8, 16, 32])
    p.add_argument("--platforms", nargs="+", default=None,
                   help="the export device's type (cuda or cpu); a program "
                        "runs where it was exported")
    p.add_argument("--native_kernels", action="store_true",
                   help="demand the hand-written attention kernels in the "
                        "programs (the default on the card; raises off it)")
    p.add_argument("--levels", type=int, nargs="+", default=[6, 12, 18, 24])
    p.add_argument("--image_adapt_until", type=int, default=6)
    p.add_argument("--text_adapt_until", type=int, default=3)
    p.add_argument("--relu", action="store_true")
    p.add_argument("--verify", action="store_true",
                   help="reload the artifact and hold one batch bit for bit "
                        "against the live predictor")
    p.add_argument("--memory_bank_shot", type=int, default=0,
                   help="bundle K-shot per-class memory banks and the bank "
                        "programs; needs AACLIP_DATA/METADATA")
    p.add_argument("--bank_weight", type=float, default=0.5)
    p.add_argument("--bank_chunk", type=int, default=1024)
    args = p.parse_args(argv)

    acfg = dict(levels=tuple(args.levels),
                image_adapt_until=args.image_adapt_until,
                text_adapt_until=args.text_adapt_until,
                proj_relu=args.relu)
    t0 = time.perf_counter()
    manifest = export_serving_artifact(
        args.out, model_name=args.model_name, img_size=args.img_size,
        precision=args.precision, adapter_cfg=acfg,
        clip_checkpoint=args.clip_checkpoint, seed=args.seed,
        save_path=args.save_path, datasets=tuple(args.datasets),
        batch_sizes=tuple(args.batch_sizes),
        platforms=tuple(args.platforms) if args.platforms else None,
        native_kernels=True if args.native_kernels else None,
        memory_bank_shot=args.memory_bank_shot,
        bank_weight=args.bank_weight, bank_chunk=args.bank_chunk,
        verify=args.verify, device=device)
    wall = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(args.out, f))
               for f in os.listdir(args.out))
    if manifest["untrained"]:
        print("WARNING: no trained image adapter found; the artifact "
              "serves RANDOM-INIT adapters (manifest.untrained=true)",
              file=sys.stderr)
    if args.verify:
        v = manifest["verify"]
        if not v["bit_equal"]:
            raise SystemExit(
                f"verify FAILED: the artifact's {v['dataset']}/{v['class']} "
                f"batch of {v['batch']} differs from the live predictor "
                f"(max |d map| {v['max_abs_map']:.3e} of span "
                f"{v['span']:.3e}, max |d score| {v['max_abs_score']:.3e})")
        print(f"verify OK: {v['dataset']}/{v['class']} maps "
              f"{tuple(v['maps_shape'])} bit for bit against the live "
              f"predictor, scores {np.round(v['scores'], 4).tolist()}")
    print(json.dumps({"out": args.out, "bytes": size,
                      "wall_s": round(wall, 1),
                      "graphs": len(manifest["graphs"]),
                      "platforms": manifest["platforms"],
                      "native_kernels": manifest["native_kernels"],
                      "untrained": manifest["untrained"]}))


if __name__ == "__main__":
    main()
