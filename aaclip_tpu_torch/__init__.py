"""PyTorch and CUDA port of aaclip_tpu: the adapted ViT-L/14-336 inference
path and the fused anomaly map, both training stages (the text adapters
through the text tower and anchors, the image adapters through the
frozen trunk), with hand-written Hopper kernels.

Imports torch, never jax and nothing of aaclip_tpu. The JAX package's
convenience names resolve lazily (importing the package loads none of
them): ``CLIPModel``, ``AdaptedCLIP``, ``get_config``, ``AdapterConfig``,
``DtypePolicy``, ``create_clip_params``, ``init_adapter_params`` and
``tokenize``.
"""

_EXPORTS = {
    "CLIPModel": "aaclip_tpu_torch.models.clip",
    "AdaptedCLIP": "aaclip_tpu_torch.models.clip",
    "get_config": "aaclip_tpu_torch.core.config",
    "AdapterConfig": "aaclip_tpu_torch.core.config",
    "DtypePolicy": "aaclip_tpu_torch.core.config",
    "create_clip_params": "aaclip_tpu_torch.core.params",
    "init_adapter_params": "aaclip_tpu_torch.core.params",
    "tokenize": "aaclip_tpu_torch.text.bpe",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(
        f"module 'aaclip_tpu_torch' has no attribute {name!r}")
