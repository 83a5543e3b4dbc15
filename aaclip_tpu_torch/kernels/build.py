"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each library is compiled from ``csrc/<name>.cu`` (and the shared
``csrc/*.cuh`` headers) on first use into ``_build/``, keyed by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads at once; a new or edited header rebuilds every library. The sources:
``attention_packed.cu`` (the forward attention in its standard, V-V and
``[B, H, S, hd]`` launches, and the split kernels of the 6-pass and 3-pass
routes),
``attention_packed_bwd.cu`` (its backward) and ``fused_block.cu``
(``ln_linear``, ``linear_residual`` and ``mlp_fused``); the headers
``mma_common.cuh`` (mma.sync helpers and the bf16 splits of the 3-pass
and 6-pass modes), ``hopper_common.cuh`` (mbarriers, TMA, wgmma, the
products over two or three bf16 planes, each kernel's shared-memory
attribute set once per device, and the host-side tensor maps of the TMA
kernels) and ``launch_count.cuh`` (each library's count of its
kernel launches, ``kernels_launched``). Each library links only the CUDA
runtime: the driver-API call that encodes a tensor map,
``cuTensorMapEncodeTiled``, is taken at run time through
``cudaGetDriverEntryPoint(ByVersion)``, so nothing links ``-lcuda``.
``build_all`` starts one nvcc per source, all together (about 25 s on the
card's machine). A missing ``nvcc`` or a failed compile raises: there is
no fallback path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("attention_packed", "attention_packed_bwd",
           "fused_block")  # csrc/<name>.cu
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under the CUDA home torch discovers."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.access(os.path.join(CUDA_HOME, "bin", "nvcc"),
                               os.X_OK):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under the CUDA "
                       "home); the port's kernels cannot be built")


def _sources(name: str) -> list[Path]:
    headers = sorted(CSRC.glob("*.cuh"))
    return [CSRC / f"{name}.cu", *headers]


def library_path(name: str) -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless the hashed library exists.

    Returns the library's path and nvcc's report (ptxas registers, shared
    memory and spills; empty when the library was already built)."""
    out = library_path(name)
    if out.exists():
        return out, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build loads either copy
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def build_all(names=KERNELS) -> dict[str, tuple[Path, str]]:
    """``build`` for every name at once, one nvcc process each; returns
    ``{name: (library path, nvcc report)}`` and raises if any failed."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load; the caller declares its entry points'
    argument types."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))


def kernels_launched(name: str) -> int:
    """How many kernels library ``name`` has launched since it was loaded:
    each launch site in its source counts itself (``launch_count.cuh``)."""
    fn = load(name).aaclip_kernels_launched
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return fn()
