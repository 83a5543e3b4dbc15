"""Anomaly-aware text anchors (the JAX package's
``aaclip_tpu/text/anchors.py``; reference forward_utils.py:131-192).

Per class, the 6 normal and 10 abnormal prompt sentences are encoded, each
sentence embedding is L2-normalised, averaged within its state and
normalised again, and the two means are stacked as the columns of a
[embed_dim, 2] anchor (column 0 normal, column 1 abnormal). All sentences
of all classes of a dataset go through the text tower in one batch,
[n_classes * 16, 77]; the stage-1 step runs the same reduction with
gradients into the text adapters. ``encode_dataset_anchors_cached`` keeps
a dataset's anchors on disk for the serving engine's cold start.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from aaclip_tpu_torch.data.registry import (CLASS_NAMES, build_prompts,
                                            resolve_real_name)
from aaclip_tpu_torch.text.bpe import tokenize

N_NORMAL = 6
N_ABNORMAL = 10
SENTENCES_PER_CLASS = N_NORMAL + N_ABNORMAL


def class_prompt_tokens(dataset_name: str, class_name: str) -> np.ndarray:
    """[16, 77] int32 token ids: 6 normal then 10 abnormal sentences."""
    normal, abnormal = build_prompts(resolve_real_name(dataset_name,
                                                       class_name))
    return tokenize(normal + abnormal)


def dataset_prompt_tokens(dataset_name: str,
                          class_names: Optional[List[str]] = None
                          ) -> np.ndarray:
    """[n_classes, 16, 77] int32 token ids for every class of a dataset."""
    names = class_names if class_names is not None else \
        CLASS_NAMES[dataset_name]
    return np.stack([class_prompt_tokens(dataset_name, c) for c in names])


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True)


def reduce_to_anchors(sentence_embeds: torch.Tensor) -> torch.Tensor:
    """[..., 16, D] sentence embeddings -> [..., D, 2] fp32 anchors."""
    e = _unit(sentence_embeds.float())
    normal = _unit(e[..., :N_NORMAL, :].mean(dim=-2))
    abnormal = _unit(e[..., N_NORMAL:, :].mean(dim=-2))
    return torch.stack([normal, abnormal], dim=-1)


def encode_dataset_anchors(encode_fn: Callable[[torch.Tensor], torch.Tensor],
                           dataset_name: str,
                           class_names: Optional[List[str]] = None
                           ) -> Dict[str, torch.Tensor]:
    """``{class_name: [D, 2] anchor}`` from one batched text forward.

    ``encode_fn`` maps [N, 77] int64 token ids (a CPU tensor; the text
    encoders move them to their weights' device) to [N, D] embeddings."""
    names = class_names if class_names is not None else \
        CLASS_NAMES[dataset_name]
    tokens = dataset_prompt_tokens(dataset_name, names)   # [C, 16, 77]
    C = tokens.shape[0]
    flat = torch.from_numpy(tokens.reshape(C * SENTENCES_PER_CLASS, -1))
    embeds = encode_fn(flat.long())
    anchors = reduce_to_anchors(embeds.reshape(C, SENTENCES_PER_CLASS, -1))
    return {name: anchors[i] for i, name in enumerate(names)}


# bump when the anchor math or the token layout changes in a way the key's
# inputs cannot see
_ANCHOR_CACHE_VERSION = 1


def encode_dataset_anchors_cached(encode_fn, dataset_name: str,
                                  identity: str, cache_dir: str,
                                  class_names: Optional[List[str]] = None
                                  ) -> Dict[str, np.ndarray]:
    """Disk-cached ``encode_dataset_anchors``, as host numpy arrays.

    The anchors are a pure function of the prompts and of what produced
    the text embeddings. The key hashes the token array itself (prompts,
    class list, tokenizer) with ``identity``, which the caller builds from
    everything else: the text weights' provenance (checkpoint identity or
    init seed), the text adapter's digest, the adapter config, the
    precision policy, and the library and device that computed them. A
    wrong-identity hit is silent, so over-key rather than under-key.

    An entry that does not load, or holds another class count, is rebuilt.
    Writes are atomic (a temporary file, then ``os.replace``); engines that
    race write identical bytes."""
    import hashlib
    import os

    names = class_names if class_names is not None else \
        CLASS_NAMES[dataset_name]
    tokens = dataset_prompt_tokens(dataset_name, names)
    h = hashlib.sha256()
    h.update(f"v{_ANCHOR_CACHE_VERSION}|{identity}|{dataset_name}|"
             f"{','.join(names)}|".encode())
    h.update(np.ascontiguousarray(tokens).tobytes())
    path = os.path.join(cache_dir, f"anchors_{h.hexdigest()[:32]}.npz")
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                arr = np.asarray(z["anchors"])
            if arr.shape[0] == len(names):
                return {n: arr[i] for i, n in enumerate(names)}
        except Exception:
            pass  # a corrupt or partial entry: rebuild it below
    out = encode_dataset_anchors(encode_fn, dataset_name, names)
    arr = np.stack([out[n].detach().cpu().numpy() for n in names])
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}.npz"
    try:
        np.savez(tmp, anchors=arr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return {n: arr[i] for i, n in enumerate(names)}
