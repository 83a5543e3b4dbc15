"""Object facades over the functional towers (the JAX package's
``aaclip_tpu/models/clip.py``), in the shape of the reference's public
classes (model/model.py:149-212 ``CLIP``, model/adapter.py:6-145
``AdaptedCLIP``). Every method delegates to ``models/vit.py`` and
``models/text_model.py`` and runs without gradients: the training steps
(``train/steps.py``) are the differentiable path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from aaclip_tpu_torch.core.config import AdapterConfig, CLIPConfig, DtypePolicy
from aaclip_tpu_torch.models import layers as L
from aaclip_tpu_torch.models import text_model, vit
from aaclip_tpu_torch.models.text_model import TextTransformer
from aaclip_tpu_torch.models.vit import VisionTransformer


class CLIPModel:
    """Frozen two-tower CLIP (reference ``CLIP``): the image tower
    ``visual``, the text tower ``text`` (which holds ``logit_scale``), on
    the device they live on."""

    def __init__(self, visual: VisionTransformer, text: TextTransformer,
                 cfg: CLIPConfig, policy: DtypePolicy = DtypePolicy()):
        self.visual, self.text = visual, text
        self.cfg, self.policy = cfg, policy

    @torch.no_grad()
    def encode_image(self, images: torch.Tensor,
                     out_layers: Sequence[int] = (), normalize: bool = False
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        pooled, taps = vit.encode_image(self.visual, self.cfg, images,
                                        out_layers, policy=self.policy)
        if normalize:
            pooled = L.l2_normalize(pooled)
        return pooled, taps

    @torch.no_grad()
    def encode_text(self, text: torch.Tensor,
                    normalize: bool = False) -> torch.Tensor:
        out = text_model.encode_text(self.text, self.cfg, text,
                                     policy=self.policy)
        return L.l2_normalize(out) if normalize else out

    @property
    def logit_scale(self) -> torch.Tensor:
        return self.text.logit_scale.detach().exp()

    def __call__(self, images: torch.Tensor, text: torch.Tensor):
        """The contrastive forward (reference model/model.py:203-212):
        ``(image_features, text_features, exp(logit_scale))``, both
        features L2-normalised."""
        img, _ = self.encode_image(images, normalize=True)
        return img, self.encode_text(text, normalize=True), self.logit_scale


class AdaptedCLIP:
    """Frozen CLIP and its trainable adapters (reference ``AdaptedCLIP``):
    ``adapters`` is ``{"image": ImageAdapter, "text": TextAdapter}``.
    ``forward(images) -> (seg_tokens, det_token)`` and
    ``encode_text(text, adapt_text=True)`` take the reference's
    arguments."""

    def __init__(self, clip: CLIPModel, adapters: dict,
                 acfg: AdapterConfig = AdapterConfig()):
        self.clip, self.adapters, self.acfg = clip, adapters, acfg

    @classmethod
    def create(cls, cfg: CLIPConfig, acfg: AdapterConfig = AdapterConfig(),
               *, checkpoint: Optional[str] = None, seed: int = 0,
               policy: DtypePolicy = DtypePolicy(),
               device=None) -> "AdaptedCLIP":
        """The towers from ``checkpoint`` (or the seeded init) and seeded
        adapters, on ``device`` (None: the card)."""
        from aaclip_tpu_torch.core.params import (create_clip_towers,
                                                  init_adapter_params)

        visual, text = create_clip_towers(cfg, checkpoint=checkpoint,
                                          seed=seed, device=device)
        adapters = init_adapter_params(cfg, acfg, seed=seed, device=device)
        return cls(CLIPModel(visual, text, cfg, policy), adapters, acfg)

    @torch.no_grad()
    def forward(self, images: torch.Tensor
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        return vit.adapted_forward(
            self.clip.visual, self.adapters["image"], self.clip.cfg, images,
            image_adapt_weight=self.acfg.image_adapt_weight,
            levels=self.acfg.levels, proj_relu=self.acfg.proj_relu,
            policy=self.clip.policy)

    __call__ = forward

    @torch.no_grad()
    def encode_text(self, text: torch.Tensor,
                    adapt_text: bool = True) -> torch.Tensor:
        if not adapt_text:
            return self.clip.encode_text(text)
        return text_model.adapted_encode_text(
            self.clip.text, self.adapters["text"], self.clip.cfg, text,
            text_adapt_weight=self.acfg.text_adapt_weight,
            policy=self.clip.policy)

    @torch.no_grad()
    def surgery_features(self, images: torch.Tensor,
                         out_layers: Sequence[int] = (6, 12, 18, 24),
                         surgery_until_layer: int = 20,
                         vv_mode: str = "batch") -> List[torch.Tensor]:
        return vit.surgery_patch_features(
            self.clip.visual, self.clip.cfg, images, out_layers,
            surgery_until_layer, policy=self.clip.policy, vv_mode=vv_mode)
