"""Build the port's CUDA sources with nvcc and bind them through ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared
library under ``build/repro_torch/`` at the root of the checkout, with a
plain C interface (no PyTorch headers, so a build takes seconds).  The
library's file name carries a digest of its sources and flags, so an
edited source is rebuilt and a stale library is never loaded.  Nothing
is compiled or loaded when a module is imported: machines without
``nvcc`` (and the CPU tests) import every module of the package.

Every C entry returns ``cudaGetLastError()`` after its launch; a
``Kernel`` raises on a non-zero code and otherwise counts the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
LIBRARIES = ("conv_im2col", "votes_routing", "primary_routing", "conv_bwd",
             "votes_routing_bwd", "caps_votes", "routing", "squash",
             "rmsnorm", "flash_attention")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by a digest of the
    source, the headers it may include, and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: a reader never sees half a file


def build(names=LIBRARIES) -> list[str]:
    """Compile every library of ``names`` that is not built yet, one nvcc
    per source, all started together.  Returns the names it compiled."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [n for n in names if not library_path(n).exists()]
        started = [(n, *_start(n)) for n in todo]
        errors = []
        for n, proc, tmp, out in started:
            try:
                _finish(n, proc, tmp, out)
            except RuntimeError as err:
                errors.append(str(err))
        if errors:
            raise RuntimeError("\n".join(errors))
        return todo


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        with _lock:
            _loaded[name] = lib
    return lib


class Kernel:
    """One C entry of a csrc library and the number of its launches.

    ``launches`` grows by one for each launch that the CUDA runtime
    accepted, and nowhere else.  Arguments are ctypes values: pointers
    and the stream as ``c_void_p``, sizes as ``c_int``.
    """

    def __init__(self, library: str, symbol: str, argtypes: list):
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        REGISTRY[symbol] = self

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_library(self.library), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = _library(self.library).repro_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


REGISTRY: dict[str, Kernel] = {}


def cluster_query(library: str, symbol: str, *sizes: int) -> dict[str, int]:
    """What the card says of a cluster kernel at these sizes, through the
    library's ``*_occupancy`` entry: the clusters it can run at once
    (``cudaOccupancyMaxActiveClusters``) and ``cudaFuncGetAttributes``'s
    static and maximum dynamic shared memory and registers a thread."""
    fn = getattr(_library(library), symbol)
    fn.argtypes = [ctypes.c_int] * len(sizes) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(*sizes, out)
    if err != 0:
        msg = _library(library).repro_error_string(err).decode()
        raise RuntimeError(f"{symbol}: CUDA error {err} ({msg})")
    return dict(zip(("max_active_clusters", "static_smem",
                     "max_dynamic_smem", "registers"), out))


def call(library: str, symbol: str, argtypes: list, *args) -> None:
    """Call a C entry of a library that launches no kernel of a model path
    (a measurement aid, such as an empty launch): counted nowhere; raises
    on a non-zero CUDA error code."""
    fn = getattr(_library(library), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        msg = _library(library).repro_error_string(err).decode()
        raise RuntimeError(f"{symbol}: CUDA error {err} ({msg})")


def launch_counts() -> dict[str, int]:
    """Launches of every kernel so far, by C entry name."""
    return {name: k.launches for name, k in REGISTRY.items()}


def reset_launch_counts() -> None:
    for k in REGISTRY.values():
        k.launches = 0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def on_cpu(name: str, *tensors: torch.Tensor,
           dtypes: tuple = (torch.float32,), contiguous: bool = True) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs its
    plain twin); False when all lie on one CUDA device, each of a type in
    ``dtypes`` and (unless ``contiguous=False``) contiguous: the wrapper
    then launches its kernel.  Anything else raises."""
    dev = tensors[0].device
    if all(t.device.type == "cpu" for t in tensors):
        return True
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device "
                             f"(or all lie on the CPU), got {t.device} and "
                             f"{dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: expects {' or '.join(map(str, dtypes))}"
                            f", got {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
    return False


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record through a forward-only kernel: a
    launch would cut the graph without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward yet; "
                           f"call it under torch.no_grad() or on tensors "
                           f"that do not require grad")
