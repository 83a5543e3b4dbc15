"""Adapter checkpoints: the JAX package's flat npz format and the
reference implementation's ``.pth`` files, both ways.

Both formats hold the adapters as the JAX package's parameter trees
(``[in, out]`` linear weights, the layer adapters stacked on a leading
axis); ``core/params.py::adapter_from_jax`` / ``adapter_to_jax`` (and the
``text_`` pair) convert them to and from the port's modules. The npz file
is the JAX package's byte layout: '/'-joined pytree paths under
``adapter/`` (dict keys sorted, list entries by index), ``__epoch__`` and
``__step__``, written atomically, so a checkpoint written by either
package loads in the other. The optimizer state sits under
``opt_state/`` in optax's tree layout, as the JAX package's
``_flatten`` names it: ``opt_state/0/.count``, ``opt_state/0/.mu/...`` and
``opt_state/0/.nu/...`` (Adam's count and moments, each moment a tree of
the adapter's layout), and for the image optimizer
``opt_state/1/.count`` (the LR schedule's count). ``adam_state_tree`` and
``load_adam_state`` map torch's Adam (``step``, ``exp_avg``,
``exp_avg_sq``) and MultiStepLR to and from it, so a run saved by either
package resumes in the other.

The reference's state dicts name SimpleAdapter weights ``{i}.fc.0.weight``
and SimpleProj weights ``fc.weight`` or ``fc.0.weight`` (with --relu).
"""

from __future__ import annotations

import bisect
import copy
import os
from typing import Callable, Dict, Tuple

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
                            step: int = 0, opt_state=None) -> None:
    """Write ``adapter`` (a JAX-layout tree, e.g. ``adapter_to_jax(m)``)
    and, when given, ``opt_state`` (``adam_state_tree``) as the npz
    checkpoint, atomically and durably: the data is fsync'd before the
    rename and the directory after it."""
    payload = {"adapter": adapter}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    flat = _flatten(payload)
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


def load_optimizer_state(path: str, opt_state_template):
    """The ``opt_state`` tree of an npz checkpoint, with the template's
    structure, shapes and dtypes; None when the file holds none (an
    adapter exported for evaluation)."""
    with np.load(path, allow_pickle=False) as data:
        if not any(k.startswith("opt_state/") for k in data.files):
            return None
        return _restore(data, "opt_state", opt_state_template)


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
# torch's Adam and MultiStepLR <-> optax's state tree


def _with_values(module: torch.nn.Module, values) -> torch.nn.Module:
    """A copy of ``module`` whose parameters hold ``values`` (in
    ``parameters()`` order), for the JAX-layout converters."""
    out = copy.deepcopy(module)
    with torch.no_grad():
        for p, v in zip(out.parameters(), values):
            p.copy_(v)
    return out


def adam_state_tree(optimizer: torch.optim.Adam, module: torch.nn.Module,
                    to_jax: Callable[[torch.nn.Module], dict],
                    scheduler=None) -> list:
    """optax's ``adam`` state of ``module``'s parameters as the npz
    layout wants it: ``[{".count", ".mu", ".nu"}]`` and, with a
    ``scheduler``, ``{".count"}`` for the schedule. ``to_jax`` is the
    module's tree converter (``core/params.py::adapter_to_jax`` or
    ``text_adapter_to_jax``); each moment leaf is the parameter's, in the
    same layout. Before the first step the moments are zero."""
    params = list(module.parameters())
    state = [optimizer.state.get(p, {}) for p in params]
    count = int(state[0]["step"]) if state[0] else 0

    def moment(key):
        return to_jax(_with_values(module, [
            s[key] if s else torch.zeros_like(p)
            for p, s in zip(params, state)]))

    tree = [{".count": np.asarray(count, np.int32), ".mu": moment("exp_avg"),
             ".nu": moment("exp_avg_sq")}]
    if scheduler is not None:
        tree.append({".count": np.asarray(scheduler.last_epoch, np.int32)})
    return tree


def load_adam_state(optimizer: torch.optim.Adam, module: torch.nn.Module,
                    tree: list, from_jax: Callable[[dict], torch.nn.Module],
                    scheduler=None) -> None:
    """Restore ``adam_state_tree``'s ``tree`` into ``optimizer`` (and the
    scheduler's count and learning rate): the inverse of
    ``adam_state_tree``; ``from_jax`` builds a module of ``module``'s
    structure from a JAX-layout tree on the CPU."""
    adam = tree[0]
    count = int(adam[".count"])
    params = list(module.parameters())
    mu = list(from_jax(adam[".mu"]).parameters())
    nu = list(from_jax(adam[".nu"]).parameters())
    held = [p for g in optimizer.param_groups for p in g["params"]]
    if len(held) != len(params) or len(mu) != len(params) or any(
            a is not b for a, b in zip(held, params)):
        raise ValueError(
            f"the optimizer must hold the module's {len(params)} parameters "
            f"in order (it holds {len(held)}; the checkpoint has "
            f"{len(mu)})")
    sd = optimizer.state_dict()
    ids = [i for g in sd["param_groups"] for i in g["params"]]
    # torch keeps Adam's step as an fp32 scalar tensor; load_state_dict
    # moves the moments to each parameter's device and dtype
    sd["state"] = {} if count == 0 else {
        i: {"step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": m.detach(), "exp_avg_sq": v.detach()}
        for i, m, v in zip(ids, mu, nu)}
    optimizer.load_state_dict(sd)
    if scheduler is not None:
        n = int(tree[1][".count"])
        scheduler.last_epoch = n
        drops = bisect.bisect_right(sorted(scheduler.milestones.elements()),
                                    n)
        for g in optimizer.param_groups:
            g["lr"] = g["initial_lr"] * scheduler.gamma ** drops


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
