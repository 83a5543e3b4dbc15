"""Batched test-time prediction: images -> (pixel anomaly map, image score).

Adapted image forward -> per-level seg tokens -> ``100 * feats @ anchors``
-> level collapse -> ``M q Mᵀ`` (blur and upsample folded into M, see
ops/similarity.py); the image score comes from the det token.
``run_class_predictions`` drives a loader through the predictor for one
class; ``make_anchor_encoder`` is the text side of the evaluation.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace
from typing import Callable, List, Tuple

import numpy as np
import torch
from torch import nn

from aaclip_tpu_torch.core.config import AdapterConfig, CLIPConfig, DtypePolicy
from aaclip_tpu_torch.core.params import cast_matmul_weights
from aaclip_tpu_torch.device import resolve_device
from aaclip_tpu_torch.models.layers import config_act
from aaclip_tpu_torch.models.text_model import (TextAdapter, TextTransformer,
                                                adapted_encode_text,
                                                encode_text)
from aaclip_tpu_torch.models.vit import (ImageAdapter, VisionTransformer,
                                         adapted_forward)
from aaclip_tpu_torch.ops.preprocess import (fold_normalization_into_conv1,
                                             patchify_uint8)
from aaclip_tpu_torch.ops.similarity import (apply_postproc_matrix,
                                             collapse_level_scores,
                                             fused_postproc_matrix,
                                             image_score, level_scores)


class _Graph(nn.Module):
    """The predictor's prepared tower (``visual``), an adapter of the
    predictor's structure (``adapter``, on the meta device) and the folded
    patch embedding (``patch_w``, ``patch_b``) as one module whose forward
    is ``fn(self, *args)``: ``torch.func.functional_call`` swaps every one
    of its tensors for an argument (the raw form that ``deploy.py``
    exports, where the weights are graph inputs)."""

    def __init__(self, visual, adapter, patch, fn):
        super().__init__()
        self.visual, self.adapter = visual, adapter
        if patch is not None:
            self.register_buffer("patch_w", patch[0])
            self.register_buffer("patch_b", patch[1])
        self._fn = fn

    def forward(self, *args):
        return self._fn(self, *args)


def prepare_visual(vit: VisionTransformer, cfg: CLIPConfig,
                   policy: DtypePolicy) -> VisionTransformer:
    """The tower as the predictor runs it: cast as the JAX predictor casts
    it (``cast_matmul_weights``) and, under ``policy.quant_int8``, blocks
    [0, ``int8_until``) (every block when 0) quantized from the ORIGINAL
    fp32 weights (``vit.quantize_prefix``): fitting the int8 grid to the
    bf16 copies would round twice. A quantized block keeps no float copy
    of its four big weights (JAX drops them too). ``int8_until`` outside
    [0, depth] raises."""
    from aaclip_tpu_torch.models.vit import quantize_prefix

    visual = cast_matmul_weights(vit, policy)
    if not policy.quant_int8:
        return visual
    k = policy.int8_until or 0
    layers = cfg.vision.layers
    if k < 0 or k > layers:
        raise ValueError(f"int8_until={k} out of range for the "
                         f"{layers}-layer tower")
    if visual is vit:  # an fp32 compute dtype: never quantize the caller's
        visual = copy.deepcopy(vit)
    return quantize_prefix(visual, vit, k or layers)


def make_features_fn(vit: VisionTransformer, cfg: CLIPConfig,
                     acfg: AdapterConfig, *, img_size: int | None = None,
                     policy: DtypePolicy = DtypePolicy(), attn_fn=None,
                     block_fn=None, uint8_inputs: bool = False, mesh=None,
                     sequence_parallel: bool = False,
                     device=None) -> Callable:
    """``features(image_adapter, images) -> (seg [n_levels, B, L, D],
    det [B, D])``, fp32: the adapted forward that ``make_predict_fn`` scores,
    up to the stacked, L2-normalised seg tokens and the det token (the
    memory bank builds its banks from it). Arguments as
    ``make_predict_fn``'s; ``features.device`` is the device it runs on and
    ``features.pp_precision`` the precision of ``M q Mᵀ`` under ``policy``.

    For the predictors built on it: ``features.forward(g, images)`` is the
    forward on ``g``, which holds ``visual``, ``adapter`` and (with uint8
    inputs) ``patch_w``, ``patch_b``; ``features.bind(image_adapter)``
    gives the live ``g``; ``features.visual`` is every prepared tensor
    but the adapter's by name (sorted); ``features.make_raw(fn)`` gives
    ``raw(visual, adapter, *args) = fn(g, *args)`` with ``g``'s tensors
    taken from the two name -> tensor dicts (``torch.func.functional_call``:
    the weights are arguments, as in JAX's ``predict.raw``).

    ``mesh`` (``parallel/sharding.py``) runs the rank's part of a global
    batch: ``features`` (and the predictors built on it) take the global
    batch, run this rank's rows (``sharding.shard_rows``: rows r, r + dp,
    ...) on ``mesh.device`` and all-gather the outputs over the data axis
    back in global order; ``features`` pads a batch
    the data size does not divide (the last row repeated) and trims the
    result, since the memory bank's support batches are ragged, while the
    predictors refuse one, as JAX's do. ``features.shard`` and
    ``features.gather`` are those two steps. A mesh with a model axis
    (``make_mesh_2d``) also shards the tower's blocks Megatron-style over
    it (``parallel/tensor.py::shard_tower``: ``vit`` may then live on the
    CPU, and the rank keeps only its part on the card); ``attn_fn`` must be
    a ``make_attn_fn`` hook, which reads the shards, and ``block_fn`` and
    the int8 policy raise. ``sequence_parallel`` (a model axis only) also
    shards the residual stream's sequence between the blocks' products.
    ``features.forward`` and ``features.make_raw`` stay per rank.
    """
    from aaclip_tpu_torch.parallel import sharding as sh
    from aaclip_tpu_torch.parallel import tensor as tpar

    tp = sh.is_tp_mesh(mesh)
    if sequence_parallel and not tp:
        raise ValueError("sequence_parallel requires a 2-D mesh with "
                         "model-parallel size > 1 (make_mesh_2d)")
    if tp and block_fn is not None:
        raise ValueError("tensor parallelism and fused block_fn overrides "
                         "are mutually exclusive (the fused block kernels "
                         "read whole blocks)")
    if policy.quant_int8 and (tp or block_fn is not None):
        raise ValueError("int8 quantized inference does not compose with "
                         "tensor parallelism or block_fn overrides (the "
                         "fused kernels read float weights)")
    if mesh is not None and device is not None \
            and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's "
                         f"{mesh.device}")
    dev = mesh.device if mesh is not None else resolve_device(device)
    param_dev = next(vit.parameters()).device
    if param_dev.type != dev.type and not tp:
        raise ValueError(f"vit lives on {param_dev}, predictor built for "
                         f"{dev}")
    if img_size is not None and img_size != cfg.vision.image_size:
        raise ValueError(f"img_size {img_size} does not match the config's "
                         f"{cfg.vision.image_size} (use get_config(name, "
                         f"img_size))")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if tp:
        vit = tpar.shard_tower(vit, cfg.vision.heads, mesh,
                               sequence_parallel)
    visual = prepare_visual(vit, cfg, policy)
    act = config_act(cfg, policy)
    patch = None
    if uint8_inputs:
        w_f, b_f = fold_normalization_into_conv1(vit.conv1.weight.t(),
                                                 cfg.vision.patch_size)
        patch = (w_f.to(policy.compute_dtype), b_f)

    def forward(g, images):
        patch_embed = None
        if uint8_inputs:
            def patch_embed(images_u8):
                return patchify_uint8(images_u8, g.patch_w, g.patch_b,
                                      cfg.vision.patch_size,
                                      compute_dtype=policy.compute_dtype,
                                      precision=policy.precision)
        seg, det = adapted_forward(
            g.visual, g.adapter, cfg, images,
            image_adapt_weight=acfg.image_adapt_weight, levels=acfg.levels,
            proj_relu=acfg.proj_relu, policy=policy, act=act,
            attn_fn=attn_fn, block_fn=block_fn, patch_embed_fn=patch_embed)
        return torch.stack(seg), det

    def bind(image_adapter):
        return SimpleNamespace(
            visual=visual, adapter=image_adapter,
            **(dict(patch_w=patch[0], patch_b=patch[1]) if patch else {}))

    with torch.device("meta"):
        template = ImageAdapter(cfg, acfg)

    def make_raw(fn):
        graph = _Graph(visual, template, patch, fn)

        def raw(visual_tensors: dict, adapter_tensors: dict, *args):
            tensors = dict(visual_tensors)
            tensors.update((f"adapter.{k}", v)
                           for k, v in adapter_tensors.items())
            return torch.func.functional_call(graph, tensors, args)

        return raw

    def shard(x):
        return sh.shard_rows(x, mesh, dev)

    def gather(x, dim=0):
        return sh.gather_rows(x, mesh, dim)

    @torch.inference_mode()
    def features(image_adapter, images):
        images = torch.as_tensor(images)
        n = images.shape[0]
        pad = -n % mesh.dp if mesh is not None else 0
        if pad:
            images = torch.cat([images, images[-1:].expand(
                pad, *images.shape[1:])])
        seg, det = forward(bind(image_adapter), shard(images))
        return gather(seg, 1)[:, :n], gather(det)[:n]

    g0 = _Graph(visual, template, patch, None)
    named = {**dict(g0.named_parameters()), **dict(g0.named_buffers())}
    features.visual = {k: named[k] for k in sorted(named)
                       if not k.startswith("adapter.")}
    features.forward, features.bind, features.make_raw = forward, bind, \
        make_raw
    features.shard, features.gather = shard, gather
    features.device, features.mesh = dev, mesh
    # M q Mᵀ at true fp32 only under precision "highest" (the fp32
    # policy), 3-pass under fp32_high and bf16, as JAX's predictor
    features.pp_precision = "highest" if policy.precision == "highest" \
        else "high"
    return features


def shard_anchors(features, anchors) -> torch.Tensor:
    """The anchors on the features' device: the rank's rows of per-sample
    anchors [B, D, 2] under a mesh, one class's [D, 2] whole."""
    anchors = torch.as_tensor(anchors)
    if anchors.dim() == 3:
        return features.shard(anchors)
    return anchors.to(features.device)


def adapter_tensors(image_adapter: nn.Module) -> dict:
    """An image adapter's tensors by name (sorted), the ``adapter``
    argument of a predictor's raw form."""
    named = dict(image_adapter.named_parameters())
    return {k: named[k] for k in sorted(named)}


def make_predict_fn(vit: VisionTransformer, cfg: CLIPConfig,
                    acfg: AdapterConfig, *, img_size: int | None = None,
                    policy: DtypePolicy = DtypePolicy(), attn_fn=None,
                    block_fn=None, uint8_inputs: bool = False, mesh=None,
                    sequence_parallel: bool = False,
                    device=None) -> Callable:
    """``predict(image_adapter, images, anchors, M) -> (pixel_map [B, img,
    img], image_score [B])``, both fp32.

    ``anchors`` is [D, 2] (one class for the batch) or per-sample
    [B, D, 2]; ``M`` is ``fused_postproc_matrix(grid, img, domain)``.
    ``uint8_inputs=True`` takes raw uint8 pixels, with the CLIP
    normalisation folded into the patch-embedding weights. ``attn_fn``
    defaults to the packed-attention kernel (``ops.attention.make_attn_fn``).
    ``block_fn`` replaces every whole block (``ops.fused_block.
    make_block_fn``, the fused-block kernels; ``maybe_make_block_fn`` gives
    it on the card under bf16, None off it and under fp32 and int8); it
    receives the block's weights as cast for the predictor. A staged policy
    (``policy.bf16_until``, fp32_high) runs its first blocks under
    ``policy.prefix_policy()`` with that policy's attention hook, the bf16
    kernel, as JAX's predictor builds it (``models/vit.py::trunk_taps``);
    ``attn_fn`` serves the later blocks. The int8 policy quantizes blocks
    [0, ``int8_until``) at build time (``prepare_visual``); with
    ``block_fn`` it raises.
    ``img_size`` mirrors the JAX signature: the size comes from ``cfg``
    (``get_config(name, img_size)``) and any other value raises.

    ``device=None`` means the card and raises when there is none; ``vit``
    must already live on that device. On the card TF32 is switched off for
    matmuls and cuDNN, so fp32 products are true fp32. The forward is
    ``make_features_fn``'s. ``predict.raw(visual, adapter, images, anchors,
    M)`` is the same function with the prepared tower (``predict.visual``)
    and the adapter (``adapter_tensors``) as name -> tensor arguments,
    outside inference mode (JAX's ``predict.raw``; ``deploy.py`` exports
    it).

    ``mesh`` and ``sequence_parallel`` as ``make_features_fn``'s: the
    predictor takes the global batch (which the data size must divide) and
    per-sample anchors for all of it, runs the rank's rows and returns the
    global map and scores: ``features.gather`` of ``predict.local`` on
    ``features.shard`` of the batch. ``predict.local`` alone takes the
    rank's rows as the evaluation CLI's loader reads them.
    """
    features = make_features_fn(
        vit, cfg, acfg, img_size=img_size, policy=policy, attn_fn=attn_fn,
        block_fn=block_fn, uint8_inputs=uint8_inputs, mesh=mesh,
        sequence_parallel=sequence_parallel, device=device)
    dev, pp_precision = features.device, features.pp_precision

    def forward(g, images, anchors, M):
        seg, det = features.forward(g, images)
        scores = level_scores(seg, anchors)                  # [n, B, L, 2]
        _, B, L, _ = scores.shape
        grid = int(round(L ** 0.5))
        q = collapse_level_scores(scores).reshape(B, grid, grid)
        return (apply_postproc_matrix(q, M, pp_precision),
                image_score(det, anchors))

    @torch.inference_mode()
    def local(image_adapter, images, anchors, M):
        """The rank's rows (``sharding.shard_rows``'s, as the evaluation
        CLI's loader reads them): their maps and scores, not gathered;
        one class's [D, 2] anchors or the rows' [b, D, 2]."""
        return forward(features.bind(image_adapter),
                       torch.as_tensor(images).to(dev),
                       torch.as_tensor(anchors).to(dev),
                       torch.as_tensor(M, device=dev))

    @torch.inference_mode()
    def predict(image_adapter, images, anchors, M):
        pix, score = local(image_adapter, features.shard(images),
                           shard_anchors(features, anchors), M)
        return features.gather(pix), features.gather(score)

    predict.device, predict.mesh, predict.local = dev, features.mesh, local
    predict.raw = features.make_raw(forward)
    predict.visual = features.visual
    return predict


def run_class_predictions(predict_fn, image_adapter, loader, anchors,
                          domain: str, img_size: int, grid: int
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray, List[str]]:
    """Drive ``loader``'s batches through ``predict_fn`` (a
    ``make_predict_fn`` predictor) for one class; returns (masks, labels,
    pixel_preds, image_preds, file_names) of the valid samples, as numpy.

    ``M`` and the anchors go to the predictor's device once; the
    predictions stay there until the class ends, so copying them back
    does not wait for each batch. On a mesh (``predict_fn.mesh``) the
    loader deals each global batch (``BatchLoader(deal_batches=True)``:
    the rank's rows, padded to as many on every rank), ``predict_fn.local``
    runs them, and the class's maps, masks, labels, scores and file names
    are gathered over the data axis in global order (``sharding.
    gather_rows``) before the padding goes: every rank returns the whole
    class."""
    dev = predict_fn.device
    mesh = getattr(predict_fn, "mesh", None)
    call = predict_fn if mesh is None else predict_fn.local
    M = torch.from_numpy(fused_postproc_matrix(grid, img_size, domain)).to(dev)
    anchors = torch.as_tensor(anchors).to(dev)
    masks, labels, pix_preds, img_preds, files, keep = [], [], [], [], [], []
    for batch in loader:
        pix, score = call(image_adapter,
                          torch.from_numpy(batch["image"]).to(dev), anchors,
                          M)
        # on a mesh every row stays until the gather, which needs as many
        # on each rank; ``keep`` marks the valid ones
        n = len(batch["label"]) if mesh is not None else batch["n_valid"]
        keep.append(np.arange(n) < batch["n_valid"])
        masks.append(batch["mask"][:n])
        labels.append(batch["label"][:n])
        pix_preds.append(pix[:n])
        img_preds.append(score[:n])
        files.extend(batch["file_name"][:n])
    masks, labels, keep = (np.concatenate(a) for a in (masks, labels, keep))
    pix, score = torch.cat(pix_preds), torch.cat(img_preds)
    if mesh is not None and mesh.dp > 1:
        masks, labels, keep, pix, score, files = _gather_class(
            mesh, masks, labels, keep, pix, score, files)
    if not keep.all():
        rows = np.flatnonzero(keep)
        masks, labels, files = masks[rows], labels[rows], \
            [files[i] for i in rows]
        pix, score = (t[torch.from_numpy(rows).to(dev)] for t in (pix, score))
    return masks, labels, pix.cpu().numpy(), score.cpu().numpy(), files


def _gather_class(mesh, masks, labels, keep, pix, score, files):
    """One class's rows of every data rank (each holds as many: its share
    of each padded global batch), in global order."""
    import torch.distributed as dist

    from aaclip_tpu_torch.parallel import sharding as sh

    per_rank = [None] * mesh.dp
    dist.all_gather_object(per_rank, files, group=mesh.data)
    files = [per_rank[i % mesh.dp][i // mesh.dp]
             for i in range(mesh.dp * len(files))]
    dev = pix.device

    def gather(a):
        return sh.gather_rows(torch.as_tensor(a, device=dev), mesh)

    masks, labels, keep = (gather(a).cpu().numpy() for a in
                           (masks, labels, keep.astype(np.uint8)))
    return masks, labels, keep.astype(bool), gather(pix), gather(score), \
        files


def make_anchor_encoder(text: TextTransformer, cfg: CLIPConfig,
                        acfg: AdapterConfig,
                        text_adapter: TextAdapter | None = None, *,
                        policy: DtypePolicy = DtypePolicy()) -> Callable:
    """[N, 77] tokens -> [N, D] embeddings for ``encode_dataset_anchors``:
    the adapted text encoder when a text adapter is given, else the frozen
    one (reference test.py:192-200), on a copy of the tower cast as JAX's
    encoder casts it (``cast_matmul_weights``: every block parameter and
    the >= 2-D weights outside the blocks)."""
    text_c = cast_matmul_weights(text, policy)

    @torch.inference_mode()
    def encode(tokens):
        if text_adapter is None:
            return encode_text(text_c, cfg, tokens, policy=policy)
        return adapted_encode_text(
            text_c, text_adapter, cfg, tokens,
            text_adapt_weight=acfg.text_adapt_weight, policy=policy)

    return encode
