"""Selective remat (``models/layers.py::residual_block_selective``) on the
CPU: what the backward keeps, and that it never reruns the attention.

The JAX package's ``remat="selective"`` saves ``attn_qkv``, ``attn_out``
and ``mlp_fc`` per block (``aaclip_tpu/models/vit.py:92-95``), its custom
VJP's residual is qkv, and the block input is the checkpoint's. A
``saved_tensors_hooks`` pack hook records every tensor autograd keeps
during one block's forward (the frozen weights, parameters, left out):
* a vision block keeps exactly its input x [B, S, D], qkv [B, S, 3D],
  ``x + attn_out`` [B, S, D] and ``mlp_fc`` [B, S, 4D] (fp32), with or
  without the adapter blend after it, and not the attention's output
  before its out-projection;
* a masked text block keeps x, ``x + attn_out`` and ``mlp_fc`` (JAX names
  qkv only on its kernel path);
* outputs and input gradients equal ``residual_block``'s bit for bit;
* in a stage-2 step, the backward calls no attention forward under
  selective remat, one per recomputed block under full remat; the saved
  bytes order full < selective < off.
The numbers of whole steps under selective remat against full, none and
JAX's selective step are in ``test_torch_train.py``,
``test_torch_stage1.py`` and ``test_torch_text.py``.
"""

import functools

import numpy as np
import pytest
import torch

from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                          get_config)
from aaclip_tpu_torch.core.params import (init_image_adapter,
                                          init_text_params,
                                          init_vision_params)
from aaclip_tpu_torch.models import layers as L
from aaclip_tpu_torch.models.vit import adapted_forward, trunk_taps
from aaclip_tpu_torch.ops import attention as A
from aaclip_tpu_torch.ops.attention import make_attn_fn

B, S = 2, 26


class Kept:
    """Every tensor autograd saves inside the ``with``, parameters left
    out, one entry per storage."""

    def __init__(self, params):
        self._params = {p.data_ptr() for p in params}
        self.tensors = {}

    def _pack(self, t):
        if t.data_ptr() not in self._params:
            self.tensors.setdefault(t.data_ptr(), t)
        return t

    def __enter__(self):
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t)
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self._hooks.__exit__(*exc)

    def shapes(self):
        return sorted((tuple(t.shape), t.dtype)
                      for t in self.tensors.values())


def _vision_block():
    cfg = get_config("tiny-test")
    vit = init_vision_params(cfg, seed=0, device="cpu")
    return cfg, vit, vit.blocks[1]


def _adapter_tail(cfg):
    ad = init_image_adapter(cfg, AdapterConfig(levels=(1, 2),
                                               image_adapt_until=1),
                            seed=1, device="cpu")

    def tail(x):
        a = L.simple_adapter(x, ad.layer_adapters[0].weight)
        return L.norm_matched_blend(x, a, 0.1)

    return ad, tail


@pytest.mark.parametrize("with_tail", [False, True])
def test_vision_block_keeps_jax_s_selective_set(with_tail):
    cfg, vit, blk = _vision_block()
    D, heads = cfg.vision.width, cfg.vision.heads
    params = list(vit.parameters())
    tail = None
    if with_tail:
        ad, tail = _adapter_tail(cfg)
        params += list(ad.parameters())
    x0 = torch.randn(B, S, D, generator=torch.Generator().manual_seed(0))
    attn_fn = make_attn_fn(heads, differentiable=True)
    x = x0.clone().requires_grad_()
    with Kept(params) as kept:
        y = L.residual_block_selective(x, blk, heads, attn_fn=attn_fn,
                                       tail=tail)
    assert kept.shapes() == sorted([
        ((B, S, D), torch.float32), ((B, S, 3 * D), torch.float32),
        ((B, S, D), torch.float32), ((B, S, 4 * D), torch.float32)])
    # the block input itself, and no pre-projection attention output
    assert any(t is x or t.data_ptr() == x.data_ptr()
               for t in kept.tensors.values())
    h = L.layer_norm(x0, blk.ln_1.weight, blk.ln_1.bias)
    qkv = L.linear(h, blk.attn.in_proj_weight, blk.attn.in_proj_bias)
    pre = A.attention_packed_plain(qkv, heads, S)
    assert not any(t.shape == pre.shape and torch.equal(t, pre)
                   for t in kept.tensors.values())
    assert any(t.shape == qkv.shape and torch.equal(t, qkv)
               for t in kept.tensors.values())
    # the same function as the plain block
    xr = x0.clone().requires_grad_()
    want = L.residual_block(xr, blk, heads, attn_fn=attn_fn)
    if tail is not None:
        want = tail(want)
    assert torch.equal(y, want)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    y.backward(g)
    want.backward(g)
    assert torch.equal(x.grad, xr.grad)


def test_text_block_keeps_x_attn_out_and_mlp_fc():
    cfg = get_config("tiny-test")
    text = init_text_params(cfg, seed=0, device="cpu")
    blk, heads, D = text.blocks[1], cfg.text.heads, cfg.text.width
    Lt = 12
    mask = L.causal_mask(Lt)
    x0 = torch.randn(B, Lt, D, generator=torch.Generator().manual_seed(2))
    x = x0.clone().requires_grad_()
    with Kept(text.parameters()) as kept:
        y = L.residual_block_selective(x, blk, heads, mask=mask)
    # the mask is a saved input of nothing: only x, x + attn_out, mlp_fc
    assert kept.shapes() == sorted([
        ((B, Lt, D), torch.float32), ((B, Lt, D), torch.float32),
        ((B, Lt, 4 * D), torch.float32)])
    xr = x0.clone().requires_grad_()
    want = L.residual_block(xr, blk, heads, mask=mask)
    assert torch.equal(y, want)
    y.sum().backward()
    want.sum().backward()
    assert torch.equal(x.grad, xr.grad)
    with pytest.raises(ValueError, match="unmasked"):
        L.residual_block_selective(x, blk, heads, mask=mask,
                                   attn_fn=make_attn_fn(heads))


def _count_attention(monkeypatch):
    """Counts the plain forward attention (the CPU route of
    ``_PackedAttention.forward``)."""
    calls = [0]
    plain = A.attention_packed_plain

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(A, "attention_packed_plain", counted)
    return calls


def _step_forward_backward(monkeypatch, remat):
    """(attention forwards in the forward, in the backward, bytes kept)
    of tiny-test's adapted forward and its backward."""
    cfg = get_config("tiny-test")
    acfg = AdapterConfig(levels=(1, 2), image_adapt_until=1)
    vit = init_vision_params(cfg, seed=0, device="cpu")
    ad = init_image_adapter(cfg, acfg, seed=1, device="cpu")
    images = torch.randn(2, 3, 70, 70,
                         generator=torch.Generator().manual_seed(3))
    calls = _count_attention(monkeypatch)
    with Kept(list(vit.parameters()) + list(ad.parameters())) as kept:
        seg, det = adapted_forward(
            vit, ad, cfg, images, levels=acfg.levels, remat=remat,
            attn_fn=make_attn_fn(cfg.vision.heads, differentiable=True))
    forward = calls[0]
    (sum(s.square().sum() for s in seg) + det.sum()).backward()
    nbytes = sum(t.numel() * t.element_size() for t in kept.tensors.values())
    return forward, calls[0] - forward, nbytes


@pytest.mark.parametrize("remat,reruns", [(True, 1), ("selective", 0),
                                          (False, 0)])
def test_backward_reruns_the_attention_only_under_full_remat(
        monkeypatch, remat, reruns):
    """tiny-test's 2 blocks: block 0's input carries no gradient, so only
    block 1 is rematerialised; its backward reruns the attention forward
    under full remat and not under selective."""
    forward, backward, _ = _step_forward_backward(monkeypatch, remat)
    assert forward == get_config("tiny-test").vision.layers
    assert backward == reruns


def test_selective_keeps_more_than_full_and_less_than_none(monkeypatch):
    kept = {remat: _step_forward_backward(monkeypatch, remat)[2]
            for remat in (True, "selective", False)}
    assert kept[True] < kept["selective"] < kept[False], kept


def test_trunk_refuses_other_remat_values_and_block_overrides():
    cfg = get_config("tiny-test")
    vit = init_vision_params(cfg, seed=0, device="cpu")
    images = torch.zeros(1, 3, 70, 70)
    run = functools.partial(trunk_taps, vit, cfg, images, (1,),
                            adapters=None, adapt_weight=0.1, act=L.gelu,
                            policy=DtypePolicy())
    with pytest.raises(ValueError, match="remat must be"):
        run(remat="both")
    with pytest.raises(ValueError, match="inference-only"):
        run(remat="selective", block_fn=lambda x, blk: x)
    np.testing.assert_array_equal(run(remat="selective")[0].numpy(),
                                  run(remat=False)[0].numpy())
