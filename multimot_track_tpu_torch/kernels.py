"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface and is compiled
by ``nvcc`` for ``sm_90a`` into a shared library, loaded with ``ctypes``.
The build happens at first use, from the sources in the checkout, into
``build/torch_kernels/<name>-<hash>/`` at the repository root; the hash
covers the source, the headers it includes with quotes, and the flags, so
an edited source or header rebuilds and an unchanged one loads at once.
Nothing here runs at import time.

The host C++ sources under ``native/`` (the exact graph-cut labeler, the
PNG unfilter, the threaded KITTI loader) build the same way with the host
compiler (``$CXX``, then ``g++``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / "csrc"
NATIVE = PACKAGE_DIR / "native"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the JAX package's Makefile (its -lpthread as -pthread), and no fused
# multiply-adds: the loader rounds each float32 product of its gray conversion
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread", "-ffp-contract=off")
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


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


def _source_bytes(src: pathlib.Path, seen=None) -> bytes:
    """The bytes of ``src`` and of every header it includes with quotes,
    recursively (each once), relative to the including file."""
    seen = set() if seen is None else seen
    seen.add(src)
    data = src.read_bytes()
    out = [data]
    for inc in _LOCAL_INCLUDE.findall(data):
        path = (src.parent / inc.decode()).resolve()
        if path not in seen:
            out.append(_source_bytes(path, seen))
    return b"".join(out)


def _build_lib(name: str, src: pathlib.Path, compiler: str, flags) -> pathlib.Path:
    """Compile ``src`` into build/torch_kernels/<name>-<hash>/lib<name>.so
    unless that file exists; the hash covers the source, the headers it
    includes with quotes, and the flags.  Raises KernelBuildError with the
    compiler's output on failure."""
    digest = hashlib.sha256(_source_bytes(src) + " ".join(flags).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"{name}-{digest}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib{name}.{os.getpid()}.so"
    cmd = [compiler, *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise KernelBuildError(f"cannot run {compiler} for {src.name}: {e}") from e
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    (out_dir / "build.log").write_text(log + f"\nseconds: {time.perf_counter() - t0:.2f}\n")
    if proc.returncode != 0:
        raise KernelBuildError(f"{compiler} failed for {src.name}:\n{log}")
    os.replace(tmp, lib)          # atomic: concurrent builders never see half a file
    return lib


def build(name: str) -> pathlib.Path:
    """Compile csrc/<name>.cu with nvcc (if its hashed output is missing)
    and return the shared library's path."""
    return _build_lib(name, CSRC / f"{name}.cu", nvcc_path(), NVCC_FLAGS)


def build_native(name: str) -> pathlib.Path:
    """Compile native/<name>.cc with the host C++ compiler and return the
    shared library's path."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    return _build_lib(name, NATIVE / f"{name}.cc", cxx, CXX_FLAGS)


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load csrc/<name>.cu's library."""
    return ctypes.CDLL(str(build(name)))


def build_log(name: str) -> str:
    """The compiler output (incl. ``-Xptxas -v`` register/smem lines) of the
    current build of ``name``."""
    return (build(name).parent / "build.log").read_text()
