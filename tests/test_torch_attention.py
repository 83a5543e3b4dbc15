"""The port's packed attention (aaclip_tpu_torch/ops/attention.py) against
the JAX package's, on the CPU, where the wrapper runs its plain version:

* ``attention_packed_plain`` vs the Pallas ``attention_packed`` in
  interpret mode (hd 64, 80 and 128, 2 heads, S 250, q_blk 64, fp32 and
  bf16);
* ``attention_kernel_plain`` vs the Pallas ``attention_kernel`` (the same
  function on separate [B, H, S, hd] q, k, v) with valid_len < S, at hd
  16, 80 and 128;
* the ``attn_fn`` hook and the plain XLA-path attention vs
  ``layers.attention`` at tiny-test's head dim 16 and at 80, where JAX
  runs XLA's attention (its Pallas gate refuses 2 x 80 columns).

The CUDA kernel itself is checked against the plain version on the card
by chip_smoke.py; here only the wrapper's routing and checks are.

fp32 bar: atol 1e-5, rtol 1e-5 (same arithmetic, another summation
order). bf16 bar: both sides round P and the output to bf16 at the same
points, so they agree to one bf16 ulp of the output (2^-8 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import DtypePolicy as JPolicy
from aaclip_tpu.models import layers as JL
from aaclip_tpu.ops.flash_attention import attention_kernel as \
    j_attention_kernel
from aaclip_tpu.ops.flash_attention import attention_packed as j_attention
from aaclip_tpu_torch.core.config import DtypePolicy
from aaclip_tpu_torch.core.params import params_from_jax
from aaclip_tpu_torch.device import resolve_device
from aaclip_tpu_torch.kernels import build
from aaclip_tpu_torch.models import layers as L
from aaclip_tpu_torch.ops import attention as A
from aaclip_tpu_torch.ops.attention import (KERNEL_HEAD_DIMS, TMA_ALIGN,
                                            TMA_ROUTES, attention_kernel,
                                            attention_kernel_plain,
                                            attention_packed,
                                            attention_packed_plain,
                                            make_attn_fn)
from tests.test_torch_layers import perturbed_clip_tree

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# A narrow user config in open_clip's JSON schema at ViT-H-14's head width
# (80): 2 vision blocks of width 160 in 2 heads, 70 px in patches of 14
# (S 26), a 2-block text tower of width 64.
NARROW_HD80 = {
    "embed_dim": 64,
    "vision_cfg": {"image_size": 70, "layers": 2, "width": 160,
                   "head_width": 80, "patch_size": 14},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 64,
                 "heads": 2, "layers": 2},
}


def packed_qkv(B, S, heads, hd, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, 3 * heads * hd)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("valid_len", [250, 201])
@pytest.mark.parametrize("head_dim", [64, 80, 128])
def test_plain_matches_pallas_interpret(dtype, valid_len, head_dim):
    jd, td = DTYPES[dtype]
    qkv = packed_qkv(2, 250, 2, head_dim)
    want = j_attention(jnp.asarray(qkv, jd), 2, valid_len, q_blk=64,
                       precision="highest" if dtype == "fp32" else None,
                       interpret=True)
    got = attention_packed_plain(torch.from_numpy(qkv).to(td), 2, valid_len)
    assert got.shape == (2, 250, 2 * head_dim) and got.dtype == td
    want = np.asarray(want, np.float32)
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-3,
                                   rtol=2 ** -8)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("head_dim", [16, 80, 128])
def test_attention_kernel_plain_matches_pallas_interpret(dtype, head_dim):
    """B4 on separate [B, H, S, hd] q, k, v with keys past valid_len
    masked; every row, the ones past valid_len too, is a query. Bars as
    the packed attention's above."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 3, 70, head_dim)).astype(np.float32)
               for _ in range(3))
    want = j_attention_kernel(*(jnp.asarray(t, jd) for t in (q, k, v)), 50,
                              q_blk=32, bh_blk=2,
                              precision="highest" if dtype == "fp32"
                              else None, interpret=True)
    got = attention_kernel_plain(*(torch.from_numpy(t).to(td)
                                   for t in (q, k, v)), 50)
    assert got.shape == (2, 3, 70, head_dim) and got.dtype == td
    want = np.asarray(want, np.float32)
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-3,
                                   rtol=2 ** -8)


def test_attention_kernel_is_the_packed_kernel_on_another_layout():
    """On the CPU the wrapper is its plain version, counts no launch, and
    equals the packed attention on the same values packed [B, S, 3D]; it
    refuses a device it has no kernel for."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 4, 33, 16))
                                .astype(np.float32)) for _ in range(3))
    before = attention_kernel.launches
    got = attention_kernel(q, k, v, 20)
    assert attention_kernel.launches == before
    torch.testing.assert_close(got, attention_kernel_plain(q, k, v, 20),
                               atol=0, rtol=0)
    packed = torch.cat([t.transpose(1, 2).reshape(2, 33, 64)
                        for t in (q, k, v)], dim=-1)
    torch.testing.assert_close(got.transpose(1, 2).reshape(2, 33, 64),
                               attention_packed_plain(packed, 4, 20),
                               atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="attention_kernel: unsupported"):
        attention_kernel(*(torch.empty(1, 1, 8, 16, device="meta")
                           for _ in range(3)), 8)


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    qkv = torch.from_numpy(packed_qkv(2, 33, 4, 16, seed=1))
    before = attention_packed.launches
    torch.testing.assert_close(attention_packed(qkv, 4, 33),
                               attention_packed_plain(qkv, 4, 33),
                               atol=0, rtol=0)
    assert attention_packed.launches == before


def test_wrapper_refuses_other_devices_and_bad_shapes():
    with pytest.raises(ValueError, match="unsupported device"):
        attention_packed(torch.empty(1, 8, 48, device="meta"), 1, 8)
    with pytest.raises(ValueError, match="does not split"):
        attention_packed(torch.zeros(1, 8, 50), 2, 8)


def test_residual_block_defaults_to_the_kernel_wrapper():
    """Off the CPU the block's default attention is the kernel wrapper,
    which refuses a device it has no kernel for rather than running the
    plain version; the plain XLA-path attention refuses any non-CPU
    tensor."""
    from aaclip_tpu_torch.core.config import get_config

    cfg = get_config("tiny-test")
    blk = params_from_jax(perturbed_clip_tree("tiny-test"), cfg,
                          device="cpu").blocks[0].to("meta")
    x = torch.empty(2, 26, 64, device="meta")
    with pytest.raises(ValueError, match="attention_packed: unsupported"):
        L.residual_block(x, blk, 4)
    with pytest.raises(ValueError, match="CPU reference"):
        L.attention(x, blk.attn, 4)


def test_no_card_means_raise_not_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(build, "library_path",
                        lambda name: build.BUILD_DIR / "absent.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("attention_packed")


def test_kernel_entry_point_matches_the_c_signature():
    """The ctypes argument list has one entry per parameter of the C
    entry point in attention_packed.cu."""
    import re

    src = (build.CSRC / "attention_packed.cu").read_text()
    sig = re.search(r'extern "C" int aaclip_attention_packed\(([^)]*)\)',
                    src).group(1)
    n_params = len(sig.split(","))
    code = (build.CSRC.parent.parent / "ops" / "attention.py").read_text()
    argtypes = re.search(r"fn\.argtypes = \[([^\]]*)\]", code).group(1)
    assert len(argtypes.split(",")) == n_params == 16
    sig = re.search(r'extern "C" int aaclip_attention_bhsd\(([^)]*)\)',
                    src).group(1)
    argtypes = re.search(r"aaclip_attention_bhsd\n.*?fn\.argtypes = "
                         r"\[([^\]]*)\]", code, re.DOTALL).group(1)
    assert len(argtypes.split(",")) == len(sig.split(",")) == 12


def _const(src: str, name: str) -> int:
    import re

    return int(re.search(rf"\b{name} = (\d+)", src).group(1))


def test_tma_routes_match_the_kernel_sources():
    """The route table is the sources' own: bf16 at the TMA head dims
    (``tma_head_dim``: 64, 80, 88, 104, 128 in the forward and the
    backward alike) takes their TMA + wgmma kernels, each head dim
    instantiated once per route (``by_head_dim``) on the one ``Head<HD>``
    of ``hopper_common.cuh``, whose ``static_assert`` admits the same
    dims; fp32 there their 6-pass and 3-pass entry points (which refuse
    any other head dim), and every other (dtype, head dim) the wrappers
    accept has a retained kernel in each."""
    import re

    fwd = (build.CSRC / "attention_packed.cu").read_text()
    bwd = (build.CSRC / "attention_packed_bwd.cu").read_text()
    common = (build.CSRC / "hopper_common.cuh").read_text()
    want = {fwd: A.TMA_HEAD_DIMS,
            bwd: tuple(d for d in A.BWD_HEAD_DIMS if d != 16)}
    for src, table in want.items():
        body = re.search(r"constexpr bool tma_head_dim\(int hd\) \{([^}]*)\}",
                         src).group(1)
        dims = tuple(int(d) for d in re.findall(r"hd == (\d+)", body))
        assert dims == table == (64, 80, 88, 104, 128)
        for hd in dims:
            assert (f"case {hd}: return fn(std::integral_constant<int, {hd}>"
                    in src)
        assert "struct Head {" not in src
    assert common.count("struct Head {") == 1
    assert ("static_assert(HD == 64 || HD == 80 || HD == 88 || HD == 104 "
            "|| HD == 128," in common)
    assert TMA_ROUTES == {(dtype, hd) for dtype in (torch.bfloat16,
                                                    torch.float32)
                          for hd in A.TMA_HEAD_DIMS}
    assert fwd.count("if (bf16 && tma_head_dim(head_dim))") == 2
    assert bwd.count("if (bf16 && tma_head_dim(head_dim))") == 1
    # the backward's plane entries dispatch on the head dim alone
    assert bwd.count("return launch_planes_at<") == 2
    assert "kTmaHeadDim" not in bwd
    for hd in KERNEL_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            if (dtype, hd) in TMA_ROUTES:
                continue
            bf16 = dtype == torch.bfloat16
            assert f"if ({'' if bf16 else '!'}bf16 && head_dim == {hd})" in fwd
            assert f"if ({'' if bf16 else '!'}bf16 && head_dim == {hd})" in bwd
    for bf16 in ("true", "false"):
        assert f"launch_retained<16, {bf16}>" in bwd


def test_backward_head_dims_match_the_forward():
    """The backward has kernels at every head dim the forward takes
    (``BWD_HEAD_DIMS`` is ``KERNEL_HEAD_DIMS``): the source's head-dim
    dispatch covers the TMA head dims 64, 80, 88, 104, 128 and the
    retained 16, and the wrapper refuses none of them with a
    ``NotImplementedError`` naming a ROADMAP item. The CPU keeps its plain
    version at every head dim."""
    import inspect
    import re

    assert KERNEL_HEAD_DIMS == (16, 64, 80, 88, 104, 128)
    assert A.BWD_HEAD_DIMS == KERNEL_HEAD_DIMS
    bwd = (build.CSRC / "attention_packed_bwd.cu").read_text()
    body = re.search(r"int by_head_dim\(int hd, F&& fn\) \{(.*?)\n\}", bwd,
                     re.S).group(1)
    dispatched = {int(d) for d in re.findall(r"case (\d+):", body)}
    retained = {int(d) for d in re.findall(
        r"if \(!?bf16 && head_dim == (\d+)\)", bwd)}
    assert dispatched == {64, 80, 88, 104, 128} and retained == {16}
    # 88 and 104 read every operand through per-head tensor maps, so the
    # padded last k-step reads zeros, not the next head's columns
    assert "Head<HD>::kHeadMap\n            ? make_head_map(" in bwd
    assert "static constexpr int kKSteps = (HD + 15) / 16;" in (
        build.CSRC / "hopper_common.cuh").read_text()
    assert dispatched | retained == set(A.BWD_HEAD_DIMS)
    src = inspect.getsource(A)
    assert "NotImplementedError" not in src and "B11" not in src
    assert "if hd not in BWD_HEAD_DIMS" not in src
    for hd in (80, 88, 104, 128):
        qkv = torch.from_numpy(packed_qkv(1, 20, 2, hd, seed=4))
        d_out = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (1, 20, 2 * hd)).astype(np.float32))
        got = A.attention_packed_bwd(qkv, d_out, None, 2, 20)
        torch.testing.assert_close(got, A.attention_packed_bwd_plain(
            qkv, d_out, 2, 20), atol=0, rtol=0)


def test_tma_alignment_matches_the_kernel_header():
    """TMA_ALIGN is hopper_common.cuh's kTmaAlign, the bound its tensor
    maps check; every wrapper on the TMA route refuses what a map cannot
    take before the launch."""
    import inspect

    common = (build.CSRC / "hopper_common.cuh").read_text()
    assert TMA_ALIGN == _const(common, "kTmaAlign") == 16
    assert "% kTmaAlign" in common
    assert not A._tma_misaligned(0, 16, 6144, 4096 * 3)
    assert A._tma_misaligned(0, 16, 8) and A._tma_misaligned(2)
    for fn in (A._check_cuda, A.attention_packed_bwd, A.attention_kernel):
        assert "_tma_misaligned(" in inspect.getsource(fn)


def test_bench_profile_classes_name_every_kernel():
    """Every __global__ kernel of the sources falls in one of the bench
    profile's named classes, so its device time is not filed as glue."""
    import re

    from aaclip_tpu_torch.bench import _PROFILE_CLASSES

    kernels = {name for src in build.CSRC.glob("*.cu") for name in re.findall(
        r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(",
        src.read_text())}
    assert {"attn_fwd_wgmma", "attn_bwd_dq_wgmma",
            "attn_bwd_dkdv_wgmma"} <= kernels
    for name in kernels:
        assert any(frag in name for cls, frags in _PROFILE_CLASSES[:3]
                   for frag in frags), name


def test_library_path_is_keyed_by_the_sources():
    p = build.library_path("attention_packed")
    assert p.parent == build.BUILD_DIR and p == build.library_path(
        "attention_packed")
    assert p.name.startswith("libattention_packed-")


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("geometry", ["tiny-test", "head_width_80"])
def test_attn_fn_and_plain_attention_match_jax(policy, geometry):
    """Block 0 of tiny-test (4 heads x 16) and of NARROW_HD80 (2 heads x
    80, where JAX's Pallas gate refuses the geometry and JAX runs XLA's
    attention): the kernel hook (plain version on the CPU) and the
    XLA-path port both against JAX ``layers.attention``."""
    from aaclip_tpu.core.config import config_from_json as j_config
    from aaclip_tpu_torch.core.config import config_from_json, get_config

    if geometry == "tiny-test":
        cfg, jcfg = get_config("tiny-test"), "tiny-test"
    else:
        cfg, jcfg = config_from_json(NARROW_HD80), j_config(NARROW_HD80)
    heads, width = cfg.vision.heads, cfg.vision.width
    jpol, tpol = {"fp32": (JPolicy.fp32(), DtypePolicy.fp32()),
                  "bf16": (JPolicy.bf16(), DtypePolicy.bf16())}[policy]
    visual = perturbed_clip_tree(jcfg, seed=5)
    vit = params_from_jax(visual, cfg, device="cpu")
    jp = {k: np.asarray(v[0]) for k, v in visual["blocks"]["attn"].items()}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 26, width)).astype(np.float32)
    want = np.asarray(JL.attention(jnp.asarray(x), jp, heads, policy=jpol))
    xt = torch.from_numpy(x)
    hooked = make_attn_fn(heads, tpol)(xt, vit.blocks[0].attn)
    plain = L.attention(xt, vit.blocks[0].attn, heads, policy=tpol)
    for got in (hooked, plain):
        if policy == "fp32":
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                       rtol=1e-5)
        else:
            # deferred vs direct softmax division, qkv rounded to bf16 on
            # the hook path: agreement to a few bf16 ulps of the inputs
            np.testing.assert_allclose(got.numpy(), want, atol=2e-2)
