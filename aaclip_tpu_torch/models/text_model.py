"""Text transformer tower (the JAX package's
``aaclip_tpu/models/text_model.py``) and the trainable text adapter.

* ``encode_text``: frozen CLIP (reference model/model.py:190-201): token
  and positional embeddings, causal blocks, ln_final, EOT pooling, then
  ``text_projection``.
* ``adapted_encode_text``: AdaptedCLIP (reference model/adapter.py:114-145):
  blocks 0..text_adapt_until-1 are each followed by a norm-matched
  SimpleAdapter blend, and the trainable SimpleProj (width -> width,
  LeakyReLU) replaces ``text_projection``.

EOT pooling takes the argmax over the token ids (the EOT id 49407 is the
largest in any sequence). The attention is the plain masked form
(``layers.masked_attention``) on every device, as in JAX, where no Pallas
kernel serves the text tower.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from aaclip_tpu_torch.core.config import AdapterConfig, CLIPConfig, DtypePolicy
from aaclip_tpu_torch.models import layers as L


class TextTransformer(nn.Module):
    """Frozen CLIP text tower weights (OpenAI's names;
    ``text_projection`` is [width, embed_dim], used as ``x @ proj``). It
    also holds CLIP's ``logit_scale`` (a 0-d log temperature, OpenAI's
    top-level name, which the text tower's checkpoint prefix "" keeps),
    read only by ``models/clip.py::CLIPModel``."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        t = cfg.text
        self.token_embedding = nn.Embedding(t.vocab_size, t.width)
        self.positional_embedding = nn.Parameter(
            torch.empty(t.context_length, t.width))
        self.blocks = nn.ModuleList(
            L.ResidualBlock(t.width, t.mlp_ratio) for _ in range(t.layers))
        self.ln_final = nn.LayerNorm(t.width, eps=L._LN_EPS)
        self.text_projection = nn.Parameter(
            torch.empty(t.width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.empty(()))


class TextAdapter(nn.Module):
    """Trainable text-side adapters (bias-free): one SimpleAdapter per
    adapted block and the final SimpleProj."""

    def __init__(self, cfg: CLIPConfig, acfg: AdapterConfig):
        super().__init__()
        tw = cfg.text.width
        self.layer_adapters = nn.ModuleList(
            nn.Linear(tw, tw, bias=False)
            for _ in range(acfg.text_adapt_until))
        self.proj = nn.Linear(tw, tw, bias=False)


def _trunk(text_w: TextTransformer, cfg: CLIPConfig, text: torch.Tensor, *,
           adapters: TextAdapter | None = None, adapt_weight: float = 0.1,
           policy: DtypePolicy = DtypePolicy(), act=None,
           remat: bool | str = False) -> torch.Tensor:
    """Embeddings, the causal blocks with the adapter blends, ln_final.

    ``text`` [B, Lt] token ids (moved to the weights' device). The token
    embedding is gathered in fp32 and cast to the compute dtype. The mask
    follows the input length Lt, not ``context_length``. ``remat=True``
    runs each block (with its blend) under ``torch.utils.checkpoint``, as
    the JAX package wraps it in ``jax.checkpoint``; ``remat="selective"``
    runs it as ``L.residual_block_selective``, whose backward keeps each
    block's input, ``x + attn_out`` and ``mlp_fc`` (the names JAX's text
    tower carries: it names qkv only on the kernel path) and recomputes the
    masked attention with the LayerNorms, activations and blends. A
    tensor-parallel tower (``parallel/tensor.py::shard_tower``) runs its
    blocks on the rank's heads, the stream split over the model axis under
    sequence parallelism and gathered before ln_final."""
    if remat not in (False, True, "selective"):
        raise ValueError(f"remat must be False, True or 'selective', got "
                         f"{remat!r}")
    if act is None:
        act = L.config_act(cfg, policy)
    t = cfg.text
    n_adapt = len(adapters.layer_adapters) if adapters is not None else 0
    if n_adapt > t.layers:
        raise ValueError(
            f"{n_adapt} text adapters exceed the {t.layers}-layer tower; set "
            f"text_adapt_until to match the model config")
    dev = text_w.positional_embedding.device
    text = torch.as_tensor(text, device=dev).long()
    Lt = text.shape[1]
    x = text_w.token_embedding.weight[text].to(policy.compute_dtype)
    x = x + text_w.positional_embedding[:Lt].to(x.dtype)
    x = L.stream_split(text_w, x)
    mask = L.causal_mask(Lt, device=dev)

    def blend(x, i):
        a = L.simple_adapter(x, adapters.layer_adapters[i].weight, policy)
        return L.norm_matched_blend(x, a, adapt_weight)

    def block(x, i):
        x = L.residual_block(x, text_w.blocks[i], t.heads, mask=mask,
                             act=act, policy=policy)
        return blend(x, i) if i < n_adapt else x

    for i in range(t.layers):
        if remat == "selective" and x.requires_grad:
            x = L.residual_block_selective(
                x, text_w.blocks[i], t.heads, mask=mask, act=act,
                policy=policy,
                tail=functools.partial(blend, i=i) if i < n_adapt else None)
        elif remat and x.requires_grad:
            x = checkpoint(block, x, i, use_reentrant=False)
        else:
            x = block(x, i)
    x = L.stream_gather(text_w, x)
    return L.layer_norm(x, text_w.ln_final.weight, text_w.ln_final.bias)


def _eot_pool(x: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
    """The residual stream at each sequence's EOT token (the largest id)."""
    eot = torch.as_tensor(text, device=x.device).argmax(dim=-1)
    return x[torch.arange(x.shape[0], device=x.device), eot]


def encode_text(text_w: TextTransformer, cfg: CLIPConfig, text: torch.Tensor,
                *, policy: DtypePolicy = DtypePolicy(),
                act=None) -> torch.Tensor:
    """Frozen CLIP text encoding [B, embed_dim], in the compute dtype."""
    x = _trunk(text_w, cfg, text, policy=policy, act=act)
    pooled = _eot_pool(x, text)
    cd = policy.compute_dtype
    return L.matmul(pooled.to(cd), text_w.text_projection.to(cd),
                    policy.precision).to(x.dtype)


def adapted_encode_text(text_w: TextTransformer, adapter: TextAdapter,
                        cfg: CLIPConfig, text: torch.Tensor, *,
                        text_adapt_weight: float = 0.1,
                        policy: DtypePolicy = DtypePolicy(), act=None,
                        remat: bool | str = False) -> torch.Tensor:
    """AdaptedCLIP text encoding [B, width], in the compute dtype: the
    adapter blends, then the SimpleProj, which always ends in LeakyReLU
    (reference model/adapter.py:43)."""
    x = _trunk(text_w, cfg, text, adapters=adapter,
               adapt_weight=text_adapt_weight, policy=policy, act=act,
               remat=remat)
    pooled = _eot_pool(x, text)
    return L.simple_proj(pooled, adapter.proj.weight, relu=True,
                         policy=policy)
