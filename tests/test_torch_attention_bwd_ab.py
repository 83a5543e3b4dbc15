"""The backward A/B tool's host-side pieces (``tools/attention_bwd_ab.py``):
the other build's entry point read from its source, the pairs'
statistics, the ptxas report's lines, and its refusal without a card. Its
builds and launches run only on the card."""

from __future__ import annotations

import ctypes

import pytest
import torch

from aaclip_tpu_torch.kernels import build
from aaclip_tpu_torch.tools import attention_bwd_ab as T

# the entry point before the key-outer kernel took its workspace
PAIR_ONLY_SIGNATURE = '''extern "C" int aaclip_attention_packed_bwd(
    const void* qkv, const void* d_out, const float* lse, float* dsum,
    void* d_qkv, int bf16, int head_dim, int batch, int seq, int valid_len,
    int heads, long long ld, int q_off, int k_off, int v_off, long long do_ld,
    float scale, void* stream) {'''


def test_entry_params_read_the_other_source():
    """The pair's entry point: each parameter's name and ctypes type in
    order; an entry that takes a parameter the tool cannot give (this
    tree's workspace) is refused before anything is built."""
    params = T.entry_params(PAIR_ONLY_SIGNATURE)
    assert [n for n, _ in params] == list(T.PARAMS)
    types = dict(params)
    assert types["qkv"] is types["stream"] is ctypes.c_void_p
    assert types["ld"] is types["do_ld"] is ctypes.c_longlong
    assert types["scale"] is ctypes.c_float and types["seq"] is ctypes.c_int
    src = (build.CSRC / "attention_packed_bwd.cu").read_text()
    with pytest.raises(ValueError, match="dq_acc"):
        T.entry_params(src)


def test_pair_stats_medians_quartiles_and_wins():
    """Each side's (q1, median, q3) over the pairs; a tie wins for
    neither."""
    times = [(1.0, 0.9), (1.1, 1.0), (1.2, 1.3), (1.0, 1.0), (1.3, 1.2)]
    st = T.pair_stats(times)
    assert st["pairs"] == 5 and st["wins"] == 3
    assert st["other"][1] == 1.1 and st["this"][1] == 1.0
    assert st["other"][0] <= st["other"][1] <= st["other"][2]
    assert st["this"][0] <= st["this"][1] <= st["this"][2]


def test_ptxas_lines_keep_the_bf16_kernels_at_the_head_dims():
    """Registers, spills and C75xx notes of ``attn_bwd_*_wgmma<HD>`` at the
    head dims asked for; other kernels and head dims are left out."""
    ns = "_ZN56_GLOBAL__N__5eba468a_23_attention_packed_bwd_cu_f2c57997"
    report = "\n".join([
        f"ptxas info    : (C7517) warpgroup.wait is injected in around line "
        f"9 by compiler to allow use of registers defined by GMMA in "
        f"function '{ns}19attn_bwd_dsum_wgmmaILi104EEEv'",
        f"ptxas info    : Compiling entry function '{ns}17attn_bwd_kv_wgmma"
        f"ILi88EEEv' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    32 bytes stack frame, 28 bytes spill stores, 32 bytes spill "
        "loads",
        "ptxas info    : Used 128 registers, used 2 barriers",
        f"ptxas info    : Compiling entry function '{ns}17attn_bwd_dq_6pass"
        f"ILi88EEEv' for 'sm_90a'",
        "ptxas info    : Used 152 registers",
        f"ptxas info    : Compiling entry function '{ns}17attn_bwd_kv_wgmma"
        f"ILi80EEEv' for 'sm_90a'",
        "ptxas info    : Used 168 registers"])
    assert T.ptxas_lines(report, [88, 104]) == [
        "dsum<104>: C7517 warpgroup.wait is injected in around line 9 by "
        "compiler to allow use of registers defined by GMMA",
        "kv<88>: 32 bytes stack frame, 28 bytes spill stores, 32 bytes "
        "spill loads",
        "kv<88>: ptxas info    : Used 128 registers, used 2 barriers"]


def test_main_refuses_without_a_card(tmp_path, capsys):
    """No CUDA device: exit 1 before anything is built, no result."""
    assert not torch.cuda.is_available()
    assert T.main([str(tmp_path)]) == 1
    captured = capsys.readouterr()
    assert "no CUDA device" in captured.err and not captured.out
