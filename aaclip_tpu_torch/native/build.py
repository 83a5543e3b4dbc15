"""Build and load the host libraries (g++ -> shared library -> ctypes).

``fast_metrics.cc`` (AUROC/AP and connected-component labelling) and
``fast_image.cc`` (PNG/JPEG decode through libpng/libjpeg and Pillow's
resamplers) are compiled on first use into ``native/_build/``. They run
on the host, so they build wherever g++ does, with or without a card
(``kernels/build.py`` builds the card's kernels with nvcc).

* Flags: ``-O3 -std=c++17 -fopenmp -D_GLIBCXX_PARALLEL -march=native``
  (the parallel sort of ``auroc_ap``); when that compile fails, once more
  without OpenMP and ``-march`` (``std::sort``). ``build_info()`` says
  which of the two built, or why neither did.
* Each library's name carries its C ABI version and a hash of its source,
  the flags, the compiler and this machine's CPU flags, so a stale library
  or one built for another CPU is never loaded.
* g++ writes a temporary file that ``os.replace`` moves into place, so
  processes building at once never load a half-written library.
* ``load()`` / ``load_image_lib()`` return None where the library cannot
  be built or loaded (no g++; for the image library, no libjpeg/libpng
  headers) or where ``AACLIP_NO_NATIVE`` is set; the callers then take
  their numpy paths.

``python -m aaclip_tpu_torch.native`` builds both and prints what it
built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
# bump a library's ABI version whenever one of its C signatures changes
# (v2: auroc_ap takes float64 scores, as the JAX package's v2)
LIBS = {"fast_metrics": ("v2", ()), "fast_image": ("v2", ("jpeg", "png"))}
FAST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
              "-D_GLIBCXX_PARALLEL", "-march=native")
PORTABLE_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}   # name -> ctypes.CDLL or None, once tried
_info: dict = {}     # name -> how it built, or why it did not


def _machine_key() -> bytes:
    """The compiler's version and this CPU's flags: ``-march=native``
    code built on one machine may not run on another."""
    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        gxx = b""
    flags = b""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            flags = next((l for l in f if l.startswith(b"flags")), b"")
    except OSError:
        pass
    return gxx + flags


def library_path(name: str) -> str:
    """Where ``name``'s library for this source, machine and ABI lives."""
    version, libs = LIBS[name]
    h = hashlib.sha256()
    with open(os.path.join(_DIR, name + ".cc"), "rb") as f:
        h.update(f.read())
    h.update(repr((FAST_FLAGS, PORTABLE_FLAGS, libs)).encode())
    h.update(_machine_key())
    return os.path.join(BUILD_DIR,
                        f"lib{name}_{version}-{h.hexdigest()[:16]}.so")


def _compile(name: str) -> Optional[str]:
    """Path of ``name``'s library, compiled now if it is not there yet;
    None when neither flag set compiles. Records how in ``_info``."""
    out = library_path(name)
    if os.path.isfile(out):
        try:
            with open(out + ".txt") as f:
                how = f.read().strip()
        except OSError:
            how = "built"
        _info[name] = f"{how}, cached"
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(_DIR, name + ".cc")
    libflags = [f"-l{l}" for l in LIBS[name][1]]
    tmp = f"{out}.tmp-{os.getpid()}-{threading.get_ident()}"
    errors = []
    try:
        for what, flags in (("openmp, -march=native", FAST_FLAGS),
                            ("portable, no OpenMP", PORTABLE_FLAGS)):
            try:
                subprocess.run(["g++", *flags, src, "-o", tmp, *libflags],
                               check=True, capture_output=True, timeout=300)
            except FileNotFoundError:
                _info[name] = "not built: g++ not found"
                return None
            except subprocess.CalledProcessError as e:
                err = e.stderr.decode(errors="replace").splitlines()
                first = next((l for l in err if "error" in l), None)
                errors.append(f"{what}: {first or e}")
                continue
            except subprocess.TimeoutExpired:
                errors.append(f"{what}: g++ timed out")
                continue
            _info[name] = f"built ({what})"
            with open(tmp + ".txt", "w") as f:
                f.write(_info[name])
            os.replace(tmp + ".txt", out + ".txt")
            os.replace(tmp, out)
            return out
        _info[name] = "not built: " + "; ".join(errors)
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(name: str, bind) -> Optional[ctypes.CDLL]:
    with _lock:
        if name in _loaded:
            return _loaded[name]
        lib = None
        if os.environ.get("AACLIP_NO_NATIVE"):
            _info[name] = "off: AACLIP_NO_NATIVE is set"
        else:
            path = _compile(name)
            if path is not None:
                try:
                    lib = ctypes.CDLL(path)
                    bind(lib)
                except OSError as e:
                    _info[name] = f"not loaded: {e}"
                    lib = None
        _loaded[name] = lib
        return lib


def _bind_metrics(lib) -> None:
    lib.auroc_ap.restype = ctypes.c_int
    lib.auroc_ap.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double)]
    lib.label_components.restype = ctypes.c_int32
    lib.label_components.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32)]


def _bind_image(lib) -> None:
    for fn in (lib.load_rgb_resize_chw, lib.load_gray_resize_nearest):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_uint8)]


def load() -> Optional[ctypes.CDLL]:
    """The metrics library, or None (the numpy/scipy path)."""
    return _load("fast_metrics", _bind_metrics)


def load_image_lib() -> Optional[ctypes.CDLL]:
    """The decode + resize library, or None (``data/image.py``)."""
    return _load("fast_image", _bind_image)


def build_info() -> dict:
    """{library: how it was built or loaded, or why not}, for the
    libraries tried so far in this process."""
    return dict(_info)

