"""Export trained npz adapter checkpoints as reference-loadable .pth files.

Each ``image_adapter_*.npz`` under --save_path becomes an ``.pth`` beside
it holding ``{"epoch", "image_adapter"}``, and ``text_adapter.npz`` one
holding ``{"epoch", "text_adapter", "text_optimizer"}``, the state dicts
of ``train/checkpoint.py::adapters_to_torch_state_dicts``: the JAX
package's ``tools/export_torch_ckpt.py`` on the port's checkpoint code,
the same keys and tensors.

Usage:
    python -m aaclip_tpu_torch.tools.export_torch_ckpt --save_path ckpt/run \
        [--relu] [--text_adapt_until 3] [--image_adapt_until 6] \
        [--levels 6 12 18 24]
"""

import argparse
import glob
import os


def main(argv=None, *, device=None):
    """``device`` is accepted for the tools' common signature; the
    conversion runs on the host."""
    p = argparse.ArgumentParser()
    p.add_argument("--save_path", required=True)
    p.add_argument("--relu", action="store_true")
    p.add_argument("--text_adapt_until", type=int, default=3)
    p.add_argument("--image_adapt_until", type=int, default=6)
    p.add_argument("--levels", type=int, nargs="+", default=[6, 12, 18, 24])
    p.add_argument("--model_name", default="ViT-L-14-336")
    args = p.parse_args(argv)

    import torch

    from aaclip_tpu_torch.core.config import AdapterConfig, get_config
    from aaclip_tpu_torch.core.params import (adapter_to_jax,
                                              init_adapter_params,
                                              text_adapter_to_jax)
    from aaclip_tpu_torch.train import checkpoint as ckpt

    cfg = get_config(args.model_name)
    acfg = AdapterConfig(
        text_adapt_until=args.text_adapt_until,
        image_adapt_until=args.image_adapt_until,
        levels=tuple(args.levels), proj_relu=args.relu)
    # the checkpoint trees' structure and shapes
    template = init_adapter_params(cfg, acfg, seed=0, device="cpu")
    template = {"image": adapter_to_jax(template["image"]),
                "text": text_adapter_to_jax(template["text"])}

    text_npz = os.path.join(args.save_path, "text_adapter.npz")
    adapters = {"text": template["text"], "image": template["image"]}
    text_epoch = 0
    if os.path.isfile(text_npz):
        text_epoch, adapters["text"], _ = ckpt.load_adapter_checkpoint(
            text_npz, template["text"])

    for snap in sorted(glob.glob(
            os.path.join(args.save_path, "image_adapter_*.npz"))):
        epoch, adapters["image"], _ = ckpt.load_adapter_checkpoint(
            snap, template["image"])
        _, image_sd = ckpt.adapters_to_torch_state_dicts(
            adapters, proj_relu=args.relu)
        out = snap.replace(".npz", ".pth")
        torch.save({"epoch": epoch, "image_adapter": image_sd}, out)
        print(f"wrote {out}")
    if os.path.isfile(text_npz):
        text_sd, _ = ckpt.adapters_to_torch_state_dicts(adapters,
                                                        proj_relu=args.relu)
        out = text_npz.replace(".npz", ".pth")
        # the reference's resume loads checkpoint['text_optimizer']
        # unconditionally whenever text_adapter.pth exists: ship a
        # fresh-Adam state (no per-parameter state, one group over all
        # tensors), so a resume re-initializes the optimizer instead of
        # failing on a missing key
        opt_sd = {"state": {}, "param_groups": [{
            # the reference's defaults: load_state_dict overwrites the
            # live optimizer's hyperparameters with these
            "lr": 1e-5, "betas": (0.5, 0.999), "eps": 1e-8,
            "weight_decay": 0, "amsgrad": False, "maximize": False,
            "foreach": None, "capturable": False, "differentiable": False,
            "fused": None, "params": list(range(len(text_sd))),
        }]}
        torch.save({"epoch": text_epoch, "text_adapter": text_sd,
                    "text_optimizer": opt_sd}, out)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
