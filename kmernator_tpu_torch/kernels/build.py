"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source under `kmernator_tpu_torch/csrc/` is compiled at first use into
`build/` at the root of the checkout, as a shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, so an edited source is
rebuilt and a stale library is never loaded. Nothing here runs at import
time, and a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_libs = {}
build_seconds = {}   # source name -> seconds spent in nvcc (0.0 if cached)


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    cands = ["/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the CUDA kernels of "
                       "kmernator_tpu_torch are built from csrc/ at first use")


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(ARCH_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name,
                                                   digest.hexdigest()[:12]))


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its hashed library exists; returns the
    library path. Writes to a temporary file and renames, so concurrent
    builds never load a half-written library."""
    out = library_path(name)
    if os.path.exists(out):
        build_seconds.setdefault(name, 0.0)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc()] + ARCH_FLAGS + [
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed building %s.cu (rc %d):\n%s\n%s"
                               % (name, proc.returncode, " ".join(cmd),
                                  proc.stderr))
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds[name] = time.perf_counter() - t0
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(build(name))
    return _libs[name]
