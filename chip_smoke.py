"""On-card smoke test of the PyTorch/CUDA port (``aaclip_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and nvcc. Phases, each of which fails the run:
 1. the card's name and power limit (nvidia-smi);
 2. build every kernel of the inference path from the sources in
    ``aaclip_tpu_torch/kernels/csrc`` and print nvcc's report;
 3. hold each kernel against its plain PyTorch version on the card, at the
    main path's shapes, at ragged sequence lengths and at head dim 16;
 4. run the main path (ViT-L-14-336 @ 518 px, random weights from a seed)
    through ``make_predict_fn``: bf16 with uint8 inputs at batch 8 and fp32
    at batch 2, each against the same predictor with the plain attention,
    counting kernel launches; bf16 against fp32 on the same images (printed,
    the scale of bf16's own rounding); and tiny-test on the card against
    the CPU;
 5. time the kernel, its plain version and torch's SDPA at the main path's
    attention shape, and the whole predict in maps/s with the kernel and
    with the plain attention, with CUDA events.
Then it prints the kernel table as one JSON line, the card line, and the
result line ``{"ok": true, "device": {...}}`` last. Exits non-zero without
a result when there is no card.
"""

from __future__ import annotations

import json
import sys
import time

# bf16 kernel vs plain: P is rounded to bf16 against the running max of
# the online softmax, not the row's final max, and the output is rounded
# to bf16 (2^-8 relative): entries may differ by a few output ulps.
BF16_MAX_ABS, BF16_MEAN_ABS = 2e-2, 2e-3
# fp32 kernel vs plain: both fp32 end to end; only the summation order and
# the online rescaling differ, ~1e-6 relative.
FP32_MAX_ABS = 1e-4
# predict, bf16: the attention rounding above moves each of 24 blocks'
# bf16 residual stream by a few ulps; the map may move by a fraction of a
# percent of its span and the scores by well under 5e-3.
PIX_SPAN_FRAC_BF16, SCORE_ATOL_BF16 = 1e-2, 5e-3
# predict, fp32: the kernel's ~1e-6 relative error carried through 24 fp32
# blocks, the projections and the 100x similarity scale.
PIX_ATOL_FP32, PIX_RTOL_FP32, SCORE_ATOL_FP32 = 1e-3, 1e-4, 1e-4
# tiny-test, card (kernel, cuBLAS fp32) vs CPU (plain), fp32 parity policy.
TINY_ATOL, TINY_RTOL = 1e-4, 1e-5

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, NVIDIA data sheet (SXM)
H100_BYTES_PER_S = 3.35e12  # HBM3


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_qkv(B, S, H, hd, dtype, gen):
    import torch

    x = torch.randn(B, S, 3 * H * hd, generator=gen, device="cuda")
    return x.to(dtype)


def check_kernel(dtype_name: str) -> float:
    """Kernel vs plain on the card; returns the largest max |delta| at the
    main path's shape."""
    import torch

    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_plain)

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype_name]
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # (B, S, heads, head dim, valid_len)
        (2, 1370, 16, 64, 1370),   # ViT-L/518
        (8, 1370, 16, 64, 1370),   # ViT-L/518 at the predict batch
        (2, 77, 16, 64, 77),       # ragged: one partial tile
        (2, 257, 16, 64, 257),     # ragged: 4 full tiles + 1 row
        (2, 257, 16, 64, 200),     # keys past valid_len masked
        (3, 26, 4, 16, 26),        # tiny-test geometry, head dim 16
        (2, 257, 2, 16, 257),      # head dim 16, ragged
    ]
    if dtype_name == "bf16":  # the timed predict's shape (phase 5)
        cases.append((32, 1370, 16, 64, 1370))
    worst_main = 0.0
    for B, S, H, hd, valid in cases:
        qkv = random_qkv(B, S, H, hd, dtype, gen)
        got = attention_packed(qkv, H, valid)
        want = attention_packed_plain(qkv, H, valid)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        mx, mean = d.max().item(), d.mean().item()
        finite = bool(torch.isfinite(got).all())
        del got, want, d, qkv
        print(f"kernel {dtype_name} B={B} S={S} H={H} hd={hd} "
              f"valid={valid}: max|d|={mx:.3e} mean|d|={mean:.3e} "
              f"finite={finite}")
        expect(finite, "kernel output not finite")
        if dtype_name == "bf16":
            expect(mx <= BF16_MAX_ABS and mean <= BF16_MEAN_ABS,
                   f"bf16 kernel off: max {mx}, mean {mean}")
        else:
            expect(mx <= FP32_MAX_ABS, f"fp32 kernel off: max {mx}")
        if S == 1370:
            worst_main = max(worst_main, mx)
    return worst_main


def expect(cond: bool, what: str) -> None:
    """Fail the run (an assert would vanish under python -O)."""
    if not cond:
        raise AssertionError(what)


def run_predict(predict, adapter, images, anchors, M):
    import torch

    from aaclip_tpu_torch.ops.attention import attention_packed

    attention_packed.launches = 0
    pix, score = predict(adapter, images, anchors, M)
    torch.cuda.synchronize()
    return pix, score, attention_packed.launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import numpy as np

    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_vision_params)
    from aaclip_tpu_torch.device import card_line
    from aaclip_tpu_torch.eval.predict import make_predict_fn
    from aaclip_tpu_torch.kernels.build import build
    from aaclip_tpu_torch.ops.attention import (attention_packed,
                                                attention_packed_plain,
                                                make_attn_fn)
    from aaclip_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD
    from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")

    # -- 2. build
    t0 = time.perf_counter()
    path, log = build("attention_packed")
    print(f"built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  nvcc:", line.strip())

    # -- 3. kernel vs plain
    err_bf16 = check_kernel("bf16")
    err_fp32 = check_kernel("fp32")

    # -- 4. main path
    cfg = get_config("ViT-L-14-336", img_size=518)
    acfg = AdapterConfig()
    heads = cfg.vision.heads
    vit = init_vision_params(cfg, seed=0)
    adapter = init_image_adapter(cfg, acfg, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    anchors = torch.randn(cfg.embed_dim, 2, generator=gen, device="cuda")
    anchors = anchors / anchors.norm(dim=0, keepdim=True)
    M = torch.from_numpy(fused_postproc_matrix(cfg.vision.grid, 518,
                                               "Industrial")).cuda()
    img = cfg.vision.image_size
    n_layers = cfg.vision.layers

    bf16 = DtypePolicy.bf16()
    predict_k = make_predict_fn(vit, cfg, acfg, policy=bf16,
                                uint8_inputs=True)
    predict_p = make_predict_fn(
        vit, cfg, acfg, policy=bf16, uint8_inputs=True,
        attn_fn=make_attn_fn(heads, bf16, attention=attention_packed_plain))
    u8 = torch.randint(0, 256, (8, 3, img, img), generator=gen,
                       device="cuda", dtype=torch.uint8)
    pix_k, score_k, main_launches = run_predict(predict_k, adapter, u8,
                                                anchors, M)
    pix_p, score_p, plain_launches = run_predict(predict_p, adapter, u8,
                                                 anchors, M)
    expect(pix_k.shape == (8, img, img) and score_k.shape == (8,),
           f"shapes {pix_k.shape}, {score_k.shape}")
    expect(bool(torch.isfinite(pix_k).all() and torch.isfinite(score_k).all()),
           "bf16 predict output not finite")
    expect(main_launches == n_layers, f"{main_launches} kernel launches")
    expect(plain_launches == 0, f"plain path launched {plain_launches}")
    span = (pix_p.max() - pix_p.min()).item()
    dpix = (pix_k - pix_p).abs().max().item()
    dscore = (score_k - score_p).abs().max().item()
    print(f"predict bf16 B=8: launches={main_launches} per call; map span "
          f"{span:.4f}, max|d map| {dpix:.3e} ({dpix / span:.3e} of span), "
          f"max|d score| {dscore:.3e}")
    expect(dpix <= PIX_SPAN_FRAC_BF16 * span, f"map off: {dpix} of {span}")
    expect(dscore <= SCORE_ATOL_BF16, f"scores off: {dscore}")

    fp32 = DtypePolicy.fp32()
    predict_k32 = make_predict_fn(vit, cfg, acfg, policy=fp32)
    predict_p32 = make_predict_fn(
        vit, cfg, acfg, policy=fp32,
        attn_fn=make_attn_fn(heads, fp32, attention=attention_packed_plain))
    # bf16's own deviation from fp32 on the same weights and images, the
    # scale against which the bf16 kernel-vs-plain bar above is read
    mean = torch.from_numpy(CLIP_MEAN).cuda()[:, None, None]
    std = torch.from_numpy(CLIP_STD).cuda()[:, None, None]
    pix_32, score_32, _ = run_predict(predict_k32, adapter,
                                      (u8.float() / 255.0 - mean) / std,
                                      anchors, M)
    dpix32 = (pix_k - pix_32).abs().max().item()
    span32 = (pix_32.max() - pix_32.min()).item()
    print(f"predict bf16 vs fp32 B=8 (kernel both, same weights and images):"
          f" max|d map| {dpix32:.3e} ({dpix32 / span32:.3e} of the fp32 "
          f"span {span32:.4f}), max|d score| "
          f"{(score_k - score_32).abs().max().item():.3e}")
    del pix_32, score_32

    f32 = torch.randn(2, 3, img, img, generator=gen, device="cuda")
    pix_k, score_k, launches32 = run_predict(predict_k32, adapter, f32,
                                             anchors, M)
    pix_p, score_p, _ = run_predict(predict_p32, adapter, f32, anchors, M)
    expect(launches32 == n_layers, f"{launches32} fp32 kernel launches")
    print(f"predict fp32 B=2: launches={launches32} per call; max|d map| "
          f"{(pix_k - pix_p).abs().max().item():.3e}, max|d score| "
          f"{(score_k - score_p).abs().max().item():.3e}")
    torch.testing.assert_close(pix_k, pix_p, atol=PIX_ATOL_FP32,
                               rtol=PIX_RTOL_FP32)
    torch.testing.assert_close(score_k, score_p, atol=SCORE_ATOL_FP32,
                               rtol=0)
    del predict_k32, predict_p32

    tiny = get_config("tiny-test")
    tacfg = AdapterConfig(levels=(1, 2), image_adapt_until=1)
    outs = []
    for dev in ("cuda", "cpu"):
        tvit = init_vision_params(tiny, seed=0, device="cpu").to(dev)
        tad = init_image_adapter(tiny, tacfg, seed=1, device="cpu").to(dev)
        rng = np.random.default_rng(3)
        x = rng.standard_normal((3, 3, 70, 70)).astype(np.float32)
        a = rng.standard_normal((tiny.embed_dim, 2)).astype(np.float32)
        a /= np.linalg.norm(a, axis=0, keepdims=True)
        tM = fused_postproc_matrix(tiny.vision.grid, 70, "Industrial")
        tp = make_predict_fn(tvit, tiny, tacfg, policy=fp32, device=dev)
        outs.append([t.cpu() for t in tp(tad, torch.from_numpy(x),
                                         torch.from_numpy(a),
                                         torch.from_numpy(tM))])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=TINY_ATOL, rtol=TINY_RTOL)
    print("predict tiny-test fp32: card (kernel, hd 16) matches the CPU")

    # -- 5. timings at the main path's shapes
    B, S, hd = 32, cfg.vision.seq_len, cfg.vision.head_dim
    qkv = random_qkv(B, S, heads, hd, torch.bfloat16, gen)
    ms_kernel = cuda_ms(lambda: attention_packed(qkv, heads, S), 20)
    ms_plain = cuda_ms(lambda: attention_packed_plain(qkv, heads, S), 5)
    q, k, v = qkv.view(B, S, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    ms_sdpa = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 20)
    flops = 4 * B * heads * S * S * hd
    nbytes = B * S * (3 + 1) * heads * hd * qkv.element_size()
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound_ms, bound_by = max((t_ops, "operations"), (t_bytes, "bytes"))
    for name, ms in (("kernel", ms_kernel), ("plain", ms_plain),
                     ("sdpa", ms_sdpa)):
        print(f"time attention {name} [{B},{S},{3 * heads * hd}] bf16: "
              f"{ms:.4f} ms/launch ({flops / ms / 1e9:.1f} TFLOP/s; bound "
              f"{bound_ms:.4f} ms by {bound_by}) on {card}")
    del qkv, q, k, v

    u8 = torch.randint(0, 256, (32, 3, img, img), generator=gen,
                       device="cuda", dtype=torch.uint8)
    ms_pred = cuda_ms(lambda: predict_k(adapter, u8, anchors, M), 5)
    ms_pred_p = cuda_ms(lambda: predict_p(adapter, u8, anchors, M), 3)
    for name, ms in (("kernel", ms_pred), ("plain", ms_pred_p)):
        print(f"time predict bf16 B=32 ViT-L/518 ({name} attention): "
              f"{ms:.2f} ms/call, {32 / ms * 1e3:.2f} maps/s on {card}")

    print(json.dumps({"kernels": [{
        "name": "attention_packed",
        "route": "cuda",
        "source": "aaclip_tpu_torch/kernels/csrc/attention_packed.cu",
        "replaces": "aaclip_tpu/ops/flash_attention.py:190",
        "launches": main_launches,
        "max_abs_err": max(err_bf16, err_fp32),
        "ms": ms_kernel,
        "plain_ms": ms_plain,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": ms_sdpa,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
