"""Builds the package's CUDA sources into shared libraries and loads them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``wire_tpu_torch/_build/<name>-<hash>.so`` and bound with ``ctypes`` through
its plain C interface; no source includes PyTorch's headers, so a build
takes seconds.  The file name carries a hash of the source, of every
shared header ``csrc/*.cuh`` and of the flags, so a stale library is never
loaded, and the library is written to a temporary name and renamed into
place, so no lock file is needed and a build cut off half-way leaves
nothing that a later build would trust.

Nothing here runs at import time: a kernel is built at its first launch.
A build is a ``build.compile`` span (nvcc's time, the library's name) and
advances the counter ``build.compiled.<name>``; a load is a ``build.load``
span (``wire_tpu_torch.train.profiling``).
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

from wire_tpu_torch.train import profiling

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then torch's CUDA_HOME, then PATH, then
    /usr/local/cuda; raises with every place tried."""
    from torch.utils import cpp_extension
    homes = [os.environ.get("CUDA_HOME"), cpp_extension.CUDA_HOME]
    candidates = [os.path.join(home, "bin", "nvcc") for home in homes if home]
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    tried = [p for p in candidates if p] + ["nvcc on PATH"]
    raise FileNotFoundError("nvcc not found; tried: " + ", ".join(tried))


def library_path(name: str) -> str:
    """The hashed library path of ``csrc/<name>.cu``: the hash covers the
    source, every ``csrc/*.cuh`` (so an edited shared header rebuilds every
    library) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> tuple[str, str]:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists.
    Returns (library path, nvcc's diagnostic output; empty when cached)."""
    out = library_path(name)
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        with profiling.span("build.compile", library=name):
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC_DIR, f"{name}.cu")],
                capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    profiling.count(f"build.compiled.{name}")
    return out, proc.stdout + proc.stderr


def build_all(names) -> dict:
    """Build several sources at once, one nvcc process each, all started
    together.  Returns {name: (library path, nvcc's output)}; raises the
    first failure after every build has ended."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(len(names) or 1) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per
    process."""
    with profiling.span("build.load", library=name):
        path, _ = build(name)
        return ctypes.CDLL(path)
