"""Patch embedding with the CLIP normalisation folded into the weights.

    patchify((x/255 - m)/s) @ W  ==  patchify(x) @ W' + b'
    with  W'[(c,ky,kx), :] = W[(c,ky,kx), :] / (255 * s_c)
    and   b'[:] = - sum_{c,ky,kx} (m_c / s_c) * W[(c,ky,kx), :]

so the card consumes raw uint8 pixels. The embedding is a reshape and one
matmul, not ``nn.Conv2d``: cuDNN runs fp32 convolutions in TF32 by
default, which the fp32 parity policy must not.
"""

from __future__ import annotations

import numpy as np
import torch

from aaclip_tpu_torch.models.layers import matmul

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def fold_normalization_into_conv1(conv_w: torch.Tensor, patch_size: int,
                                  mean=CLIP_MEAN, std=CLIP_STD):
    """(W', b') such that uint8 patches @ W' + b' equals normalized-float
    patches @ W. ``conv_w``: [3*p*p, width] with (c, ky, kx) ordering;
    both results are fp32 on conv_w's device."""
    w = conv_w.detach().float()
    pp = patch_size * patch_size
    w3 = w.reshape(3, pp, w.shape[1])
    mean = torch.as_tensor(mean, dtype=torch.float32, device=w.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=w.device)
    w_folded = (w3 * (1.0 / (255.0 * std))[:, None, None]).reshape(3 * pp, -1)
    b_folded = -(w3 * (mean / std)[:, None, None]).sum(dim=(0, 1))
    return w_folded, b_folded


def extract_patches(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/p)*(W/p), C*p*p] with (c, ky, kx) ordering
    per patch (the conv kernel's flattening)."""
    B, C, H, W = x.shape
    gy, gx = H // patch, W // patch
    x = x.reshape(B, C, gy, patch, gx, patch)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(B, gy * gx, C * patch * patch)


def patchify(x: torch.Tensor, conv_w: torch.Tensor, patch: int,
             compute_dtype=torch.float32,
             precision: str | None = "highest") -> torch.Tensor:
    """[B, 3, H, W] float -> [B, (H/p)*(W/p), width] fp32 patch embeddings
    (the product at ``precision``, ``models/layers.py::matmul``)."""
    return matmul(extract_patches(x, patch).to(compute_dtype),
                  conv_w.to(compute_dtype), precision)


def patchify_uint8(images_u8: torch.Tensor, w_folded: torch.Tensor,
                   b_folded: torch.Tensor, patch: int,
                   compute_dtype=torch.bfloat16,
                   precision: str | None = None) -> torch.Tensor:
    """[B, 3, H, W] uint8 -> [B, (H/p)*(W/p), width] normalized patch
    embeddings (fp32), normalization fused into the matmul."""
    return patchify(images_u8, w_folded, patch, compute_dtype, precision) \
        + b_folded.float()
