"""Build, load and launch the port's hand-written CUDA kernels.

Every `csrc/*.cu` is compiled by nvcc for sm_90a into ONE shared library
with a plain C interface, loaded with ctypes: one nvcc per source, all
started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu      (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o _build/libgroot_kernels-<hash>.so *.o

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
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

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


def _sources(csrc: Path = CSRC) -> List[Path]:
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def library_path(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir / f"libgroot_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds: List[List[str]]) -> None:
    """Run the commands at once; raise with the output of any that fails."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for c in cmds
    ]
    errors = []
    for cmd, p in zip(cmds, procs):
        out, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile csrc/*.cu into the keyed library unless it already exists:
    one nvcc per source in parallel, then one link. Another source
    directory (an earlier version of the kernels, for a side-by-side
    timing) builds into its own `build_dir`."""
    so = library_path(csrc, build_dir)
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=build_dir) as objdir:
        srcs = [p for p in _sources(csrc) if p.suffix == ".cu"]
        objs = [os.path.join(objdir, p.stem + ".o") for p in srcs]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                  for p, o in zip(srcs, objs)])
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs]])
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


def _native_isa(cxx: str) -> bytes:
    """The target macros -march=native resolves to on this host (e.g.
    __AVX512BW__), so a library built for one CPU is never loaded on
    another that shares the checkout."""
    res = subprocess.run(
        [cxx, "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
        capture_output=True, check=True,
    )
    return b"\n".join(sorted(res.stdout.splitlines()))


def build_native() -> Path:
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
    """Load the host runtime (io.native: the committed native/libgrootio.so,
    or one compiled for this host by `build_native`) and return
    native.available(). Called on the main thread before the pipelines start
    their worker threads, so a first compile happens once, up front."""
    from .io import native

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


def card_query(device, symbol: str, *args: int) -> int:
    """A size the kernel library works out for the card `device`: its
    `extern "C" long long symbol(long long...)` entry point, which returns
    a CUDA error as a negative number (raised here)."""
    import torch

    fn = getattr(library(), symbol)
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_longlong] * len(args)
    with torch.cuda.device(device):
        v = fn(*args)
    if v < 0:
        raise RuntimeError(f"{symbol} failed: "
                           f"{library().groot_cuda_error_string(int(-v)).decode()}")
    return v


def smem_optin(device) -> int:
    """The shared memory a block of a kernel may opt in to on `device`, in
    bytes (232,448 on an H100)."""
    return card_query(device, "groot_smem_optin")


def reset_counts() -> None:
    for k in KERNELS.values():
        with k._count_lock:
            k.launches = 0


def ptr(t) -> int:
    """Device pointer of a tensor as a Python int (for ctypes.c_void_p)."""
    return t.data_ptr()
