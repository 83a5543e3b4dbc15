"""A/B on the card: the packed-attention backward of this tree against
another build of its source, in one process.

    python -m aaclip_tpu_torch.tools.attention_bwd_ab OTHER_CSRC \
        [--head-dims 88 104] [--models ViT-g-14 ViT-bigG-14] [--pairs 10]

``OTHER_CSRC`` holds another commit's ``kernels/csrc`` (for example
``git archive <commit> aaclip_tpu_torch/kernels/csrc``, unpacked). The
tool builds its ``attention_packed_bwd.cu`` with this package's nvcc flags
beside this tree's library, then prints:

* ptxas's registers, spills and C75xx notes of both builds' bf16 kernels
  at ``--head-dims``;
* which of the other build's functions have the same SASS in this one
  (``cuobjdump -sass``), and which are new;
* ``--pairs`` timed pairs of the two builds' bf16 backward at [8, 1370,
  3D] at each of ``--head-dims``;
* ``--pairs`` timed pairs of the bf16 stage-2 step of each of
  ``--models`` at 518 px, batch 8, remat off (random towers and adapter
  from seeds, random batch), the other build's backward swapped in for
  every B2 call of its side; the calls of both sides are counted. The
  models are ``get_config``'s: open_clip's ViT-g-14 and ViT-bigG-14 are
  JSON configs in a directory named by ``AACLIP_MODEL_CONFIGS``.

Each pair runs both sides back to back, which side first alternating;
each side's median and quartiles and the pairs this build won follow.
The other build's bf16 entry point is called by its parameters' names,
which must be among this tree's pair's (``PARAMS``). The tool measures;
chip_smoke.py (17c, 18c, 18d) checks the outputs. Exit 0 once it has
printed everything, 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import threading
from pathlib import Path

# heads per head dim, as the towers run them
GEOMETRY = {80: 16, 88: 16, 104: 16, 128: 8}
SIG = re.compile(r'extern "C" int aaclip_attention_packed_bwd\(([^)]*)\)')
# the parameters the tool can give the other build's bf16 entry point
PARAMS = ("qkv", "d_out", "lse", "dsum", "d_qkv", "bf16", "head_dim",
          "batch", "seq", "valid_len", "heads", "ld", "q_off", "k_off",
          "v_off", "do_ld", "scale", "stream")


def entry_params(source: str) -> list[tuple[str, type]]:
    """(name, ctypes type) of each parameter of ``source``'s bf16 entry
    point, in order; ValueError for a name outside ``PARAMS``."""
    out = []
    for param in SIG.search(source).group(1).split(","):
        decl, name = param.strip().rsplit(None, 1)
        if name not in PARAMS:
            raise ValueError(f"attention_bwd_ab: the other entry point "
                             f"takes {name!r}, which the tool cannot give")
        out.append((name, ctypes.c_void_p if "*" in decl
                    else ctypes.c_longlong if decl == "long long"
                    else ctypes.c_float if decl == "float" else ctypes.c_int))
    return out


def pair_stats(times: list[tuple[float, float]]) -> dict:
    """Each side's median and quartiles over ``(other, this)`` pairs of
    milliseconds, and the pairs this build won (ties count for neither)."""
    out = {"wins": sum(t < o for o, t in times), "pairs": len(times)}
    for i, side in enumerate(("other", "this")):
        q1, med, q3 = statistics.quantiles([p[i] for p in times], n=4)
        out[side] = (q1, med, q3)
    return out


def build_other(src: Path, out: Path) -> str:
    """``src/attention_packed_bwd.cu`` into the library ``out``; returns
    nvcc's report."""
    from aaclip_tpu_torch.kernels.build import NVCC_FLAGS, find_nvcc

    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(out),
                           str(src / "attention_packed_bwd.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    return proc.stdout + proc.stderr


def ptxas_lines(report: str, head_dims) -> list[str]:
    """ptxas's registers, spills and C75xx notes of the bf16 TMA kernels
    (``attn_bwd_*_wgmma<HD>``) at ``head_dims``."""
    want = re.compile(r"attn_bwd_(dsum|kv|dq|dkdv)_wgmmaILi(%s)E" % "|".join(
        str(d) for d in head_dims))
    out, fn = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = want.search(m.group(1))
            continue
        if fn and any(w in line for w in ("Used", "spill")):
            out.append(f"{fn.group(1)}<{fn.group(2)}>: {line.strip()}")
        elif "(C75" in line and want.search(line):
            m = want.search(line)
            note = re.search(r"\((C75\d\d)\) (.*?) (in|for) (the )?"
                             r"function '", line)
            out.append(f"{m.group(1)}<{m.group(2)}>: "
                       + (f"{note.group(1)} {note.group(2)}" if note
                          else line.strip()))
    return out


def sass_by_function(lib: Path) -> dict[str, str] | None:
    """Each kernel's SASS in ``lib`` without its addresses, keyed by its
    name less the file's anonymous-namespace hash; None without
    cuobjdump."""
    from aaclip_tpu_torch.kernels.build import find_nvcc

    tool = shutil.which("cuobjdump") or str(
        Path(find_nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_attention_packed_bwd"
                          r"_cu_[0-9a-f]{8}", "", m.group(1))
            funcs[name] = []
        elif name is not None:
            funcs[name].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "",
                                      line).strip())
    return {k: "\n".join(v) for k, v in funcs.items()}


def other_bwd(entry, qkv, d_out, lse, heads: int, valid_len: int):
    """The other build's bf16 d(qkv); ``entry`` is (its function, its
    parameters' names)."""
    import torch

    fn, names = entry
    B, S, three_dm = qkv.shape
    dm = three_dm // 3
    out = torch.empty_like(qkv)
    dsum = torch.empty_like(lse)
    values = dict(
        qkv=qkv.data_ptr(), d_out=d_out.data_ptr(), lse=lse.data_ptr(),
        dsum=dsum.data_ptr(), d_qkv=out.data_ptr(), bf16=1,
        head_dim=dm // heads, batch=B, seq=S, valid_len=valid_len,
        heads=heads, ld=three_dm, q_off=0, k_off=dm, v_off=2 * dm, do_ld=dm,
        scale=(dm // heads) ** -0.5,
        stream=torch.cuda.current_stream().cuda_stream)
    rc = fn(*(values[n] for n in names))
    if rc:
        raise RuntimeError(f"the other build's backward failed: CUDA {rc}")
    return out


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


def alternating(sides, pairs: int, iters: int, warmup: int):
    """``pairs`` (other, this) pairs of ``cuda_ms`` of ``sides[0]`` and
    ``sides[1]``, which side first alternating."""
    times = []
    for n in range(pairs):
        got = {i: cuda_ms(sides[i], iters, warmup)
               for i in ((0, 1) if n % 2 == 0 else (1, 0))}
        times.append((got[0], got[1]))
    return times


def report(what: str, times, unit: str = "ms per call", card: str = ""):
    st = pair_stats(times)
    print(f"time {what}, {st['pairs']} pairs ({unit}, median [quartiles]): "
          f"other {st['other'][1]:.4f} [{st['other'][0]:.4f}, "
          f"{st['other'][2]:.4f}], this {st['this'][1]:.4f} "
          f"[{st['this'][0]:.4f}, {st['this'][2]:.4f}]; this won "
          f"{st['wins']} of {st['pairs']}; pairs "
          f"{[(round(o, 4), round(t, 4)) for o, t in times]} on {card}",
          flush=True)
    return st


def call_pairs(entry, hd: int, pairs: int, gen, card: str) -> None:
    """Both builds' bf16 backward at [8, 1370, 3D], ``pairs`` pairs of 20
    calls a side."""
    import torch

    from aaclip_tpu_torch.ops import attention as A

    heads = GEOMETRY[hd]
    qkv = torch.randn(8, 1370, 3 * heads * hd, generator=gen,
                      device="cuda").to(torch.bfloat16)
    d_out = torch.randn(8, 1370, heads * hd, generator=gen,
                        device="cuda").to(torch.bfloat16)
    _, lse = A.attention_packed(qkv, heads, 1370, return_lse=True)
    times = alternating(
        (lambda: other_bwd(entry, qkv, d_out, lse, heads, 1370),
         lambda: A.attention_packed_bwd(qkv, d_out, lse, heads, 1370)),
        pairs, 20, 2)
    report(f"B2 hd {hd} bf16 [8, 1370, {3 * heads * hd}]", times, card=card)


def step_pairs(entry, model: str, pairs: int, gen, card: str) -> None:
    """Both builds' backward in ``model``'s bf16 stage-2 step, batch 8,
    remat off: ``pairs`` pairs of 3 steps a side after one untimed."""
    import torch

    from aaclip_tpu_torch.core.config import (AdapterConfig, DtypePolicy,
                                              get_config)
    from aaclip_tpu_torch.core.params import (init_image_adapter,
                                              init_vision_params)
    from aaclip_tpu_torch.ops import attention as A
    from aaclip_tpu_torch.train.optim import make_image_optimizer
    from aaclip_tpu_torch.train.steps import make_stage2_step

    B, img = 8, 518
    cfg, acfg = get_config(model, img_size=img), AdapterConfig()
    vit = init_vision_params(cfg, seed=0)
    adapter = init_image_adapter(cfg, acfg, seed=1)
    batch = (torch.randn(B, 3, img, img, generator=gen, device="cuda"),
             (torch.rand(B, img, img, generator=gen, device="cuda")
              > 0.9).float(),
             torch.randint(0, 2, (B,), generator=gen, device="cuda"),
             torch.randint(0, 2, (B,), generator=gen, device="cuda"),
             torch.ones(B, device="cuda"))
    table = torch.randn(2, cfg.embed_dim, 2, generator=gen, device="cuda")
    table = table / table.norm(dim=1, keepdim=True)
    step = make_stage2_step(vit, cfg, acfg,
                            make_image_optimizer(adapter.parameters()), table,
                            policy=DtypePolicy.bf16(), remat=False)
    mine, theirs_calls = A.attention_packed_bwd, [0]

    def theirs(qkv, d_out, lse, num_heads, valid_len, *, precision=None):
        if qkv.dtype != torch.bfloat16:
            raise TypeError(f"attention_bwd_ab: a {qkv.dtype} backward")
        theirs_calls[0] += 1
        return other_bwd(entry, qkv, d_out, lse, num_heads, valid_len)

    def side(bwd):
        def run():
            A.attention_packed_bwd = bwd
            try:
                step(adapter, *batch)
            finally:
                A.attention_packed_bwd = mine
        return run

    before = mine.launches
    times = alternating((side(theirs), side(mine)), pairs, 3, 1)
    steps = pairs * 4
    print(f"{model}: B2 calls per step, other {theirs_calls[0] / steps}, "
          f"this {(mine.launches - before) / steps}", flush=True)
    st = report(f"{model} bf16 stage-2 step B={B}", times, "ms per step",
                card)
    print(f"{model}: images/s at the medians, other "
          f"{B / st['other'][1] * 1e3:.2f}, this "
          f"{B / st['this'][1] * 1e3:.2f}", flush=True)
    del vit, adapter, step, batch


def main(argv=None) -> int:
    import gc

    import torch

    from aaclip_tpu_torch.device import card_line
    from aaclip_tpu_torch.kernels import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path,
                    help="a directory holding another attention_packed_bwd"
                         ".cu and the headers it includes")
    ap.add_argument("--head-dims", type=int, nargs="*", default=[88, 104],
                    choices=sorted(GEOMETRY))
    ap.add_argument("--models", nargs="*",
                    default=["ViT-g-14", "ViT-bigG-14"])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    params = entry_params((args.other / "attention_packed_bwd.cu")
                          .read_text())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    other_lib = build.BUILD_DIR / "libattention_packed_bwd-other.so"
    other = {}
    thread = threading.Thread(target=lambda: other.update(
        report=build_other(args.other, other_lib)))
    thread.start()
    # nvcc's report is empty where the library was built before
    built = build.build_all(("attention_packed", "attention_packed_bwd"))
    thread.join()
    if "report" not in other:
        raise RuntimeError("attention_bwd_ab: the other build failed")
    for name, text in (("this", built["attention_packed_bwd"][1]),
                       ("other", other["report"])):
        for line in ptxas_lines(text, args.head_dims):
            print(f"ptxas {name}: {line}")
    this_sass = sass_by_function(build.library_path("attention_packed_bwd"))
    if this_sass is None:
        print("SASS: no cuobjdump")
    else:
        other_sass = sass_by_function(other_lib)
        same = [k for k, v in other_sass.items() if this_sass.get(k) == v]
        print(f"SASS: {len(same)} of the other build's {len(other_sass)} "
              f"functions identical in this one; differing or gone "
              f"{sorted(set(other_sass) - set(same))}; new "
              f"{sorted(set(this_sass) - set(other_sass))}", flush=True)
    fn = ctypes.CDLL(str(other_lib)).aaclip_attention_packed_bwd
    fn.argtypes, fn.restype = [t for _, t in params], ctypes.c_int
    entry = (fn, [n for n, _ in params])
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for hd in args.head_dims:
        call_pairs(entry, hd, args.pairs, gen, card)
    for model in args.models:
        step_pairs(entry, model, args.pairs, gen, card)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
