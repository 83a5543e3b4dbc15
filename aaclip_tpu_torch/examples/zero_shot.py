"""Minimal zero-shot anomaly detection with aaclip_tpu_torch.

Computes a pixel anomaly map + image score for one image using the raw
(or adapter-trained) CLIP model and the anomaly-aware text anchors — the
library equivalent of one evaluation-CLI iteration, under the bf16
policy, as the JAX package's ``examples/zero_shot.py``. The towers come
from ``AACLIP_CKPT`` when it matches the model, else from seed 0.

Usage:
    python -m aaclip_tpu_torch.examples.zero_shot path/to/image.png \
        --class_name bottle
"""

import argparse


def main(argv=None, *, device=None):
    p = argparse.ArgumentParser()
    p.add_argument("image")
    p.add_argument("--dataset", default="MVTec")
    p.add_argument("--class_name", default="bottle")
    p.add_argument("--model_name", default="ViT-L-14-336")
    p.add_argument("--img_size", type=int, default=518)
    p.add_argument("--save_path", default=None,
                   help="trained adapter dir (optional; zero-shot without)")
    p.add_argument("--levels", type=int, nargs="+", default=None,
                   help="tap depths (default: the ViT-L 6/12/18/24; "
                        "smaller models need shallower taps, e.g. "
                        "--levels 1 2 for tiny-test)")
    args = p.parse_args(argv)

    import glob
    import os

    import numpy as np
    import torch

    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (adapter_from_jax,
                                              adapter_to_jax,
                                              create_clip_towers,
                                              init_adapter_params)
    from aaclip_tpu_torch.data.registry import DOMAINS
    from aaclip_tpu_torch.data.transforms import load_rgb_chw
    from aaclip_tpu_torch.device import resolve_device
    from aaclip_tpu_torch.eval.predict import (make_anchor_encoder,
                                               make_predict_fn)
    from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix
    from aaclip_tpu_torch.text.anchors import encode_dataset_anchors

    dev = resolve_device(device)
    cfg = get_config(args.model_name, args.img_size)
    if args.levels is None:
        acfg = AdapterConfig()
    else:
        until = min(max(args.levels), AdapterConfig().image_adapt_until)
        acfg = AdapterConfig(levels=tuple(args.levels),
                             image_adapt_until=until,
                             text_adapt_until=min(
                                 until, AdapterConfig().text_adapt_until))
    policy = DtypePolicy.bf16()
    vit, text = create_clip_towers(cfg, seed=0, device=dev)
    image_adapter = init_adapter_params(cfg, acfg, seed=0,
                                        device=dev)["image"]
    if args.save_path:
        from aaclip_tpu_torch.train import checkpoint as ckpt

        # the last snapshot in name order, as JAX's example picks it
        snaps = sorted(glob.glob(os.path.join(args.save_path,
                                              "image_adapter_*.npz")))
        if snaps:
            _, tree, _ = ckpt.load_adapter_checkpoint(
                snaps[-1], adapter_to_jax(image_adapter))
            image_adapter = adapter_from_jax(tree, cfg, acfg, device=dev)

    enc = make_anchor_encoder(text, cfg, acfg, policy=policy)
    anchors = encode_dataset_anchors(enc, args.dataset)[args.class_name]
    predict = make_predict_fn(vit, cfg, acfg, policy=policy,
                              uint8_inputs=True, device=dev)
    M = torch.from_numpy(fused_postproc_matrix(
        cfg.vision.grid, args.img_size, DOMAINS[args.dataset]))

    img = load_rgb_chw(args.image, args.img_size, uint8=True)
    amap, score = predict(image_adapter, torch.from_numpy(img[None]),
                          anchors, M)
    amap = amap.cpu().numpy()[0]
    print(f"image score: {float(score[0]):.4f}")
    peak = np.unravel_index(amap.argmax(), amap.shape)
    print(f"anomaly map: shape {amap.shape}, min {amap.min():.3f}, "
          f"max {amap.max():.3f}, argmax {peak}")


if __name__ == "__main__":
    main()
