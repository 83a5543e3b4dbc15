"""Full two-stage training + evaluation on generated synthetic data.

The complete AA-CLIP workflow (train, then test) with zero external
assets: generates a tiny synthetic MVTec-style dataset
(``data/synthetic.py``), trains the text-anchor stage and the
image-adapter stage with the port's training CLI, then evaluates every
image-adapter snapshot with its evaluation CLI and prints the per-class
metrics table: the JAX package's ``examples/synthetic_end_to_end.py`` on
``python -m aaclip_tpu_torch.train`` and ``python -m
aaclip_tpu_torch.test``.

    python -m aaclip_tpu_torch.examples.synthetic_end_to_end
    python -m aaclip_tpu_torch.examples.synthetic_end_to_end \
        --workdir /tmp/aaclip_demo --model_name tiny-test --img_size 70

With real datasets + the OpenAI checkpoint, the same flags (minus the
synthetic generation) reproduce the reference's experiments.
"""

import argparse
import os
import tempfile


def main(argv=None, *, device=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=None,
                   help="where data + checkpoints go (default: a temp dir)")
    p.add_argument("--model_name", default="tiny-test",
                   help="tiny-test only: the demo hardcodes shallow-tower "
                        "adapter flags (levels 1 2, adapt_until 1, surgery "
                        "2) that would silently cripple a real backbone")
    p.add_argument("--img_size", type=int, default=70)
    p.add_argument("--epochs", type=int, default=2,
                   help="image-adapter epochs (each snapshot is evaluated)")
    args = p.parse_args(argv)
    if args.model_name != "tiny-test":
        raise SystemExit(
            "this zero-asset demo supports --model_name tiny-test only "
            "(its adapter/surgery flags assume the 2-layer tower); use "
            "python -m aaclip_tpu_torch.train / .test directly for real "
            "backbones")

    from aaclip_tpu_torch import test as test_cli
    from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
    from aaclip_tpu_torch.train import cli as train_cli

    root = args.workdir or tempfile.mkdtemp(prefix="aaclip_demo_")
    data_root, meta_root = make_synthetic_dataset(root, img_px=args.img_size)
    os.environ["AACLIP_DATA"] = data_root
    os.environ["AACLIP_METADATA"] = meta_root
    save = os.path.join(root, "ckpt")
    print(f"synthetic dataset + checkpoints under {root}")

    common = [
        "--model_name", args.model_name, "--img_size", str(args.img_size),
        "--dataset", "MVTec",
        "--text_adapt_until", "1", "--image_adapt_until", "1",
        "--levels", "1", "2",
        "--num_workers", "2",
    ]
    train_cli.main(common + [
        "--save_path", save, "--training_mode", "full_shot",
        "--text_epoch", "1", "--image_epoch", str(args.epochs),
        "--text_batch_size", "4", "--image_batch_size", "4",
        "--surgery_until_layer", "2",
    ], device=device)
    test_cli.main(common + ["--save_path", save, "--batch_size", "4",
                            "--aupro"], device=device)
    print(f"\ndone — metrics table in {save}/test.log")


if __name__ == "__main__":
    main()
