"""Forward handle on the flagship model with example inputs.

``entry()`` returns ``(predict, (image_adapter, images, anchors, M))`` for
ViT-L-14-336 @ 518 px under the bf16 policy (random weights from fixed
seeds): ``predict(*args)`` gives the pixel map [1, 518, 518] and the image
score [1].
"""

from __future__ import annotations


def entry(device=None):
    """On the card unless ``device`` names another (``None`` raises when
    there is no card)."""
    import torch

    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_vision_params)
    from aaclip_tpu_torch.device import resolve_device
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix

    dev = resolve_device(device)
    cfg = get_config("ViT-L-14-336", img_size=518)
    acfg = AdapterConfig()
    vit = init_vision_params(cfg, seed=0, device=dev)
    adapter = init_image_adapter(cfg, acfg, seed=1, device=dev)
    predict = make_predict_fn(vit, cfg, acfg, policy=DtypePolicy.bf16(),
                              device=dev)
    images = torch.zeros(1, 3, 518, 518, device=dev)
    anchors = torch.full((cfg.embed_dim, 2), cfg.embed_dim ** -0.5,
                         device=dev)
    M = torch.from_numpy(
        fused_postproc_matrix(cfg.vision.grid, 518, "Industrial")).to(dev)
    return predict, (adapter, images, anchors, M)
