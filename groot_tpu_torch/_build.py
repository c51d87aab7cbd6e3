"""Build, load and launch the port's hand-written CUDA kernels.

Every `csrc/*.cu` is compiled by nvcc for sm_90a into ONE shared library
with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/libgroot_kernels-<hash>.so csrc/*.cu

The library is keyed by a hash of the sources and the flags and built at
first use into `_build/` (git-ignored), so a fresh checkout builds it on its
first kernel launch. No `nvcc`, or a failed build, raises: nothing falls back
to the plain PyTorch versions. Each C entry point launches on the stream it
is given and returns `cudaGetLastError()`; `Kernel.launch` raises when that
is not 0 and otherwise adds one to the kernel's `launches` count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

KERNELS: Dict[str, "Kernel"] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be built"
    )


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgroot_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the keyed library unless it already exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(p) for p in _sources() if p.suffix == ".cu"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.groot_cuda_error_string.restype = ctypes.c_char_p
            lib.groot_cuda_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


P = ctypes.c_void_p  # device pointer / stream
I = ctypes.c_int
I64 = ctypes.c_longlong
U32 = ctypes.c_uint32


class Kernel:
    """One C entry point of the library: `launch` calls it on the current
    CUDA stream of `device`, raises on a CUDA error and counts launches."""

    def __init__(self, name: str, symbol: str, argtypes, source: str,
                 replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = tuple(argtypes)
        self.source = source      # path in the repo of the CUDA source
        self.replaces = replaces  # file:line of the TPU/XLA function
        self.launches = 0
        self._fn = None
        self._count_lock = threading.Lock()
        KERNELS[name] = self

    def _entry(self):
        """The C entry point with its ctypes signature declared (without
        it ctypes would pass every pointer as a 32-bit int)."""
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = list(self.argtypes) + [ctypes.c_void_p]
            self._fn = fn
        return self._fn

    def launch(self, device, *args) -> None:
        import torch

        fn = self._entry()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            msg = library().groot_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} launch failed: {msg} ({err})")
        with self._count_lock:
            self.launches += 1


NATIVE_SRC = Path(__file__).resolve().parent.parent / "native" / "grootio.cpp"
# the flags of native/Makefile; -march=native is kept (grootio.cpp has an
# AVX-512 newline scan), and the library's key includes what it resolves to
_CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")


def _loads(path: str) -> bool:
    try:
        ctypes.CDLL(path)
        return True
    except OSError:
        return False


def _native_isa(cxx: str) -> bytes:
    """The target macros -march=native resolves to on this host (e.g.
    __AVX512BW__), so a library built for one CPU is never loaded on
    another that shares the checkout."""
    res = subprocess.run(
        [cxx, "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
        capture_output=True, check=True,
    )
    return b"\n".join(sorted(res.stdout.splitlines()))


def _build_native() -> Path:
    """Compile native/grootio.cpp for this host the way native/Makefile
    does (libdeflate when it links, zlib always) into _build/."""
    cxx = os.environ.get("CXX", "g++")
    probe = subprocess.run(
        [cxx, "-x", "c++", "-", "-l:libdeflate.so.0", "-o", os.devnull],
        input="int main(){return 0;}", capture_output=True, text=True,
    )
    extra = ["-DGIO_HAVE_LIBDEFLATE"] if probe.returncode == 0 else []
    libs = ["-lz"] + (["-l:libdeflate.so.0"] if extra else [])
    h = hashlib.sha256(NATIVE_SRC.read_bytes())
    h.update(" ".join((cxx, *_CXX_FLAGS, *extra)).encode())
    h.update(_native_isa(cxx))
    so = BUILD_DIR / f"libgrootio-march-native-{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *_CXX_FLAGS, *extra, "-o", str(tmp), str(NATIVE_SRC), *libs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"native runtime build failed:\n{res.stderr}")
        os.replace(tmp, so)
    return so


def native_runtime() -> bool:
    """Make the shared host runtime (groot_tpu.io.native) load here, and
    return native.available().

    The port calls the reference's ctypes wrappers of native/grootio.cpp
    (sketch, LSH query, winner reduce, BAM emit) rather than keeping a copy
    of them. The committed native/libgrootio.so links libdeflate; on a host
    without it (the H100 machine), grootio.cpp is compiled for this host
    into _build/ and the module's library path is pointed there before its
    first load. This is the one place the port touches that module's
    private state (`_lib`, `_tried`, `_LIB_PATH`). The module is one per
    process, so JAX code in the same process then uses the same library:
    the same source, built with the same flags."""
    from groot_tpu.io import native

    with _lock:
        if native._lib is None and not native._tried and not _loads(
            native._LIB_PATH
        ):
            native._LIB_PATH = str(_build_native())
    return native.available()


def resolve_device(device):
    """torch.device for `device`; "cuda" without a usable card raises."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def reset_counts() -> None:
    for k in KERNELS.values():
        with k._count_lock:
            k.launches = 0


def ptr(t) -> int:
    """Device pointer of a tensor as a Python int (for ctypes.c_void_p)."""
    return t.data_ptr()
