"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Every ``flo_torch/csrc/*.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, under ``build/flo_torch/`` beside the
package, named by a hash of the source and flags: a changed source builds a
new library, an unchanged one is reused. Nothing but the package's own
sources goes in, and no PyTorch header is included, which keeps a build short.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "flo_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    from torch.utils import cpp_extension

    homes.append(cpp_extension.CUDA_HOME)
    for home in filter(None, homes):
        cand = pathlib.Path(home) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels of flo_torch are "
        "built from source at first use and need the CUDA toolkit"
    )


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by its bytes and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, str(CSRC / f"{name}.cu"), "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent builder never loads half a file
    return out


def build_all() -> list[pathlib.Path]:
    """Build every kernel source of the package, one ``nvcc`` per source, all
    started together."""
    names = [p.stem for p in sources()]
    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib


def check_tensor(name: str, t, dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape`` on
    ``device``: what a kernel's C entry point takes on trust."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
