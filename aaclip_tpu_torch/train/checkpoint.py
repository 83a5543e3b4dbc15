"""Adapter checkpoints: the JAX package's flat npz format and the
reference implementation's ``.pth`` files, both ways.

Both formats hold the adapters as the JAX package's parameter trees
(``[in, out]`` linear weights, the layer adapters stacked on a leading
axis); ``core/params.py::adapter_from_jax`` / ``adapter_to_jax`` (and the
``text_`` pair) convert them to and from the port's modules. The npz file
is the JAX package's byte layout: '/'-joined pytree paths under
``adapter/`` (dict keys sorted, list entries by index), ``__epoch__`` and
``__step__``, written atomically, so a checkpoint written by either
package loads in the other. Reading ignores ``opt_state/*`` and writing
writes none: the port's optimizer state comes with its training CLI.

The reference's state dicts name SimpleAdapter weights ``{i}.fc.0.weight``
and SimpleProj weights ``fc.weight`` or ``fc.0.weight`` (with --relu).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

_ORBAX_SUFFIX = ".orbax"


# ---------------------------------------------------------------------------
# Flat-npz tree io


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{'/'-joined path: leaf} in the order jax.tree_util flattens a tree
    of dicts and lists (dict keys sorted)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _restore(data, root: str, template):
    """``template``'s structure filled from the npz entries under ``root``,
    each of exactly the template leaf's shape, in its dtype."""
    if isinstance(template, dict):
        return {k: _restore(data, f"{root}/{k}", v)
                for k, v in sorted(template.items())}
    if isinstance(template, (list, tuple)):
        return [_restore(data, f"{root}/{i}", v)
                for i, v in enumerate(template)]
    if root not in data:
        raise KeyError(
            f"checkpoint is missing '{root}' — was it saved with "
            f"different adapter flags (levels/adapt_until)?")
    arr = data[root]
    leaf = np.asarray(template)
    # exact-shape check: a size-only check would let e.g. a transposed
    # leaf silently reshape into scrambled weights
    if arr.shape != leaf.shape:
        raise ValueError(
            f"checkpoint entry '{root}' has shape {arr.shape} but the "
            f"current config expects {leaf.shape} — adapter flags "
            f"(levels/adapt_until/model) do not match the checkpoint")
    return np.asarray(arr, dtype=leaf.dtype)


def save_adapter_checkpoint(path: str, epoch: int, adapter: dict,
                            step: int = 0) -> None:
    """Write ``adapter`` (a JAX-layout tree, e.g. ``adapter_to_jax(m)``) as
    the npz checkpoint, atomically and durably: the data is fsync'd
    before the rename and the directory after it."""
    flat = _flatten({"adapter": adapter})
    flat["__epoch__"] = np.asarray(epoch, np.int64)
    flat["__step__"] = np.asarray(step, np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # the tmp name keeps the .npz suffix so numpy does not append one
    tmp = f"{path}.tmp-{os.getpid()}.npz"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dir_fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_adapter_checkpoint(path: str, adapter_template
                            ) -> Tuple[int, dict, int]:
    """(epoch, adapter tree, step) from an npz checkpoint; the tree has
    ``adapter_template``'s structure, shapes and dtypes."""
    with np.load(path, allow_pickle=False) as data:
        epoch = int(data["__epoch__"])
        step = int(data["__step__"]) if "__step__" in data else 0
        adapter = _restore(data, "adapter", adapter_template)
    return epoch, adapter, step


def find_adapter_checkpoint(path: str):
    """The snapshot saved at ``path`` by either of the JAX package's
    backends: the npz file or the ``.orbax`` directory beside it (the newer
    when both exist), or None."""
    base = path[:-4] if path.endswith(".npz") else path
    d = os.path.abspath(base + _ORBAX_SUFFIX)
    has_npz, has_orbax = os.path.isfile(path), os.path.isdir(d)
    if has_npz and has_orbax:
        return path if os.path.getmtime(path) >= os.path.getmtime(d) else d
    if has_npz:
        return path
    if has_orbax:
        return d
    return None


def load_adapter_checkpoint_any(path: str, adapter_template
                                ) -> Tuple[int, dict, int]:
    """``load_adapter_checkpoint``; an ``.orbax`` directory raises."""
    if path.endswith(_ORBAX_SUFFIX):
        raise NotImplementedError(
            f"{path!r} is an orbax checkpoint directory, the JAX package's "
            "own backend, which the port does not read: ROADMAP A6 "
            "(JAX-only backend); save with --ckpt_backend npz")
    return load_adapter_checkpoint(path, adapter_template)


# ---------------------------------------------------------------------------
# Reference .pth interop


def _np(x) -> np.ndarray:
    return np.ascontiguousarray(x.detach().cpu().float().numpy())


def _proj_key(sd: dict, prefix: str) -> str:
    """SimpleProj weight key: 'fc.weight' (relu=False) or 'fc.0.weight'."""
    for suffix in ("fc.weight", "fc.0.weight"):
        if f"{prefix}.{suffix}" in sd:
            return f"{prefix}.{suffix}"
    raise KeyError(f"no projection weight under {prefix}")


def text_adapter_from_torch(sd: dict, n_adapt: int = 3) -> dict:
    """Reference ``text_adapter`` state dict (n SimpleAdapters + the final
    SimpleProj) -> tree."""
    return {
        "layer_adapters": {"w": np.stack([
            _np(sd[f"{i}.fc.0.weight"]).T for i in range(n_adapt)])},
        "proj": {"w": _np(sd[_proj_key(sd, str(n_adapt))]).T},
    }


def image_adapter_from_torch(sd: dict, n_adapt: int = 6,
                             n_levels: int = 4) -> dict:
    """Reference ``image_adapter`` ModuleDict state dict -> tree."""
    return {
        "layer_adapters": {"w": np.stack([
            _np(sd[f"layer_adapters.{i}.fc.0.weight"]).T
            for i in range(n_adapt)])},
        "seg_proj": [
            {"w": _np(sd[_proj_key(sd, f"seg_proj.{i}")]).T}
            for i in range(n_levels)
        ],
        "det_proj": {"w": _np(sd[_proj_key(sd, "det_proj")]).T},
    }


def load_reference_checkpoint(path: str, kind: str, *, n_adapt: int,
                              n_levels: int = 4) -> Tuple[int, dict]:
    """(epoch, adapter tree) from a reference ``.pth`` ({epoch,
    text_adapter | image_adapter, ...})."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    epoch = int(obj.get("epoch", 0))
    if kind == "text":
        return epoch, text_adapter_from_torch(obj["text_adapter"], n_adapt)
    if kind == "image":
        return epoch, image_adapter_from_torch(obj["image_adapter"], n_adapt,
                                               n_levels)
    raise ValueError(f"kind must be 'text' or 'image', got {kind}")


def adapters_to_torch_state_dicts(adapters: dict,
                                  proj_relu: bool) -> Tuple[dict, dict]:
    """(text_sd, image_sd) loadable by the reference implementation from
    ``{"text": tree, "image": tree}``."""
    def t(w):
        return torch.from_numpy(np.asarray(w).T.copy())

    text = adapters["text"]
    tw = np.asarray(text["layer_adapters"]["w"])
    n = tw.shape[0]
    text_sd = {f"{i}.fc.0.weight": t(tw[i]) for i in range(n)}
    # the final text projection always ends in LeakyReLU
    text_sd[f"{n}.fc.0.weight"] = t(text["proj"]["w"])

    image = adapters["image"]
    proj_suffix = "fc.0.weight" if proj_relu else "fc.weight"
    image_sd = {}
    iw = np.asarray(image["layer_adapters"]["w"])
    for i in range(iw.shape[0]):
        image_sd[f"layer_adapters.{i}.fc.0.weight"] = t(iw[i])
    for i, p in enumerate(image["seg_proj"]):
        image_sd[f"seg_proj.{i}.{proj_suffix}"] = t(p["w"])
    image_sd[f"det_proj.{proj_suffix}"] = t(image["det_proj"]["w"])
    return text_sd, image_sd
