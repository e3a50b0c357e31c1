"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface and is compiled
by ``nvcc`` for ``sm_90a`` into a shared library, loaded with ``ctypes``.
The build happens at first use, from the sources in the checkout, into
``build/torch_kernels/<name>-<hash>/`` at the repository root; the hash
covers the source and the flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME)")


def build(name: str) -> pathlib.Path:
    """Compile csrc/<name>.cu (if its hashed output is missing) and return
    the shared library's path.  Raises KernelBuildError with the compiler's
    output on failure."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"{name}-{digest}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib{name}.{os.getpid()}.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    (out_dir / "build.log").write_text(log + f"\nseconds: {time.perf_counter() - t0:.2f}\n")
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {src.name}:\n{log}")
    os.replace(tmp, lib)          # atomic: concurrent builders never see half a file
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load csrc/<name>.cu's library."""
    return ctypes.CDLL(str(build(name)))


def build_log(name: str) -> str:
    """The compiler output (incl. ``-Xptxas -v`` register/smem lines) of the
    current build of ``name``."""
    return (build(name).parent / "build.log").read_text()
