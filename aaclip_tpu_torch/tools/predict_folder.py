"""Batch anomaly inference over a folder of images — no jsonl metadata.

The reference's test.py requires benchmark metadata; this is the
practitioner path: point at a directory of images, get per-image anomaly
scores (CSV) and optional heatmap PNGs. The JAX package's
``tools/predict_folder.py`` on the port: the towers from
``core/params.py::create_clip_towers`` (``AACLIP_CKPT``, else random from
--seed), the adapters from ``train/checkpoint.py::
discover_serving_adapters``, the anchors and the uint8 predict of
``eval/predict.py`` (its attention is the packed-attention kernel), or an
exported artifact's ``predict_class`` (``deploy.py``). PNG folders need no
PIL.

Usage:
    python -m aaclip_tpu_torch.tools.predict_folder IMAGES_DIR \
        --class_name bottle [--dataset MVTec] [--save_path ckpt/run] \
        [--out out_dir] [--precision bf16] [--batch_size 8] [--heatmaps]

Writes {out}/scores.csv (file, image_score) and, with --heatmaps,
{out}/{name}_heatmap.png JET overlays.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import sys

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp")


def heatmap_panel(path: str, pixel_map, img_size: int):
    """The JET overlay of one image's map: the image bicubic-resized to
    ``img_size`` blended with its map scaled to [0, 255] over the image."""
    import numpy as np

    from aaclip_tpu_torch.data import image
    from aaclip_tpu_torch.eval.visualize import apply_scoremap

    orig = image.resize_bicubic(image.load_rgb(path), img_size)
    m = pixel_map
    span = m.max() - m.min()
    norm = (m - m.min()) / span if span > 0 else m * 0
    return apply_scoremap(orig, (norm * 255).astype(np.uint8))


def main(argv=None, *, device=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("images_dir")
    parser.add_argument("--class_name", required=True)
    parser.add_argument("--dataset", default="MVTec",
                        help="prompt registry to draw the class from")
    parser.add_argument("--model_name", default="ViT-L-14-336")
    parser.add_argument("--img_size", type=int, default=518)
    parser.add_argument("--save_path", default=None,
                        help="trained adapter dir (optional; zero-shot "
                             "with a warning when absent)")
    parser.add_argument("--out", default=None,
                        help="output dir (default: {images_dir}/aaclip_out)")
    parser.add_argument("--precision", default="bf16",
                        choices=["fp32", "fp32_high", "bf16"])
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--heatmaps", action="store_true")
    parser.add_argument("--levels", type=int, nargs="+", default=None)
    parser.add_argument("--seed", type=int, default=111)
    parser.add_argument("--artifact", default=None,
                        help="run an exported artifact dir (python -m "
                             "aaclip_tpu_torch.deploy) — model/adapter/"
                             "precision flags are ignored; --dataset/"
                             "--class_name select among its anchors")
    args = parser.parse_args(argv)

    files = sorted(
        f for f in glob.glob(os.path.join(args.images_dir, "*"))
        if f.lower().endswith(IMG_EXTS))
    if not files:
        parser.error(f"no images under {args.images_dir}")
    out_dir = args.out or os.path.join(args.images_dir, "aaclip_out")
    os.makedirs(out_dir, exist_ok=True)

    import numpy as np
    import torch

    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.data.registry import CLASS_NAMES, DOMAINS
    from aaclip_tpu_torch.data.transforms import load_rgb_chw
    from aaclip_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if args.artifact:
        from aaclip_tpu_torch.deploy import load_serving_artifact

        art = load_serving_artifact(args.artifact, device=dev)
        args.img_size = art.img_size
        if args.dataset not in art.anchors:
            parser.error(f"dataset {args.dataset!r} not in artifact "
                         f"({sorted(art.anchors)})")
        if args.class_name not in art.anchors[args.dataset]:
            parser.error(
                f"class {args.class_name!r} not in artifact dataset "
                f"{args.dataset} ({sorted(art.anchors[args.dataset])})")
        if art.untrained:
            print("WARNING: artifact carries RANDOM-INIT adapters "
                  "(manifest.untrained=true) — scores are not anomaly "
                  "detections", file=sys.stderr)

        def predict_batch(imgs_np):
            return art.predict_class(imgs_np, args.dataset, args.class_name)
    else:
        if args.class_name not in CLASS_NAMES[args.dataset]:
            parser.error(f"class {args.class_name!r} not in {args.dataset} "
                         f"registry; have {CLASS_NAMES[args.dataset]}")

        from aaclip_tpu_torch.core.params import (adapter_from_jax,
                                                  adapter_to_jax,
                                                  create_clip_towers,
                                                  init_adapter_params,
                                                  text_adapter_from_jax,
                                                  text_adapter_to_jax)
        from aaclip_tpu_torch.eval.predict import (make_anchor_encoder,
                                                   make_predict_fn)
        from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix
        from aaclip_tpu_torch.text.anchors import encode_dataset_anchors

        policy = DtypePolicy.from_name(args.precision)
        cfg = get_config(args.model_name, args.img_size)
        kw = {"levels": tuple(args.levels)} if args.levels else {}
        acfg = AdapterConfig(**kw)
        # shallow towers (tiny/test configs): clamp the default adapt
        # depths to the tower — the trunk rejects deeper adapter stacks
        if acfg.image_adapt_until > cfg.vision.layers:
            kw["image_adapt_until"] = cfg.vision.layers
        if acfg.text_adapt_until > cfg.text.layers:
            kw["text_adapt_until"] = cfg.text.layers
        acfg = AdapterConfig(**kw)
        vit, text = create_clip_towers(cfg, seed=args.seed, device=dev)
        adapters = init_adapter_params(cfg, acfg, seed=args.seed,
                                       device=dev)

        image_adapter = adapters["image"]
        text_adapter = None
        if args.save_path:
            from aaclip_tpu_torch.train import checkpoint as ckpt

            image_tree, text_tree, img_path, text_path = \
                ckpt.discover_serving_adapters(
                    args.save_path, adapter_to_jax(adapters["image"]),
                    text_adapter_to_jax(adapters["text"]))
            if text_path:  # else the frozen text encoder, not the
                text_adapter = text_adapter_from_jax(  # random template
                    text_tree, cfg, acfg, device=dev)
            if img_path:
                image_adapter = adapter_from_jax(image_tree, cfg, acfg,
                                                 device=dev)
            else:
                print("WARNING: no image adapter under --save_path; "
                      "running zero-shot with random adapters",
                      file=sys.stderr)
        else:
            print("WARNING: no --save_path; running zero-shot with random "
                  "adapters (scores are not anomaly detections)",
                  file=sys.stderr)

        predict = make_predict_fn(vit, cfg, acfg, img_size=args.img_size,
                                  policy=policy, uint8_inputs=True,
                                  device=dev)
        enc = make_anchor_encoder(text, cfg, acfg, text_adapter,
                                  policy=policy)
        anchors = encode_dataset_anchors(enc, args.dataset)[args.class_name]
        M = torch.from_numpy(fused_postproc_matrix(
            cfg.vision.grid, args.img_size, DOMAINS[args.dataset]))

        def predict_batch(imgs_np):
            n = imgs_np.shape[0]
            if n < args.batch_size:
                # one batch shape for every call, as JAX's compiled
                # predict takes it: a file's score does not depend on how
                # many files share the last batch
                imgs_np = np.concatenate(
                    [imgs_np,
                     np.repeat(imgs_np[-1:], args.batch_size - n, axis=0)])
            pix, score = predict(image_adapter, torch.from_numpy(imgs_np),
                                 anchors, M)
            return pix.cpu().numpy()[:n], score.cpu().numpy()[:n]

    from aaclip_tpu_torch.eval.visualize import write_panel

    rows = []
    B = args.batch_size
    for start in range(0, len(files), B):
        chunk = files[start:start + B]
        imgs = np.stack([
            load_rgb_chw(f, args.img_size, uint8=True) for f in chunk])
        pix, score = predict_batch(imgs)
        for f, s, m in zip(chunk, score, pix):
            rows.append((os.path.basename(f), float(s)))
            if args.heatmaps:
                name = os.path.splitext(os.path.basename(f))[0]
                # JAX's tool saves the panel through PIL as RGB;
                # write_panel writes cv2's channel order, so reverse first
                write_panel(os.path.join(out_dir, f"{name}_heatmap.png"),
                            heatmap_panel(f, m, args.img_size)[..., ::-1])
        print(f"{start + len(chunk)}/{len(files)} images", file=sys.stderr)

    csv_path = os.path.join(out_dir, "scores.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file", "image_score"])
        w.writerows(rows)
    print(f"wrote {csv_path} ({len(rows)} rows)"
          + (f" + heatmaps under {out_dir}" if args.heatmaps else ""))


if __name__ == "__main__":
    main()
