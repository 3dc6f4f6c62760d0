"""Build and load the E-step's CUDA kernels (``csrc/estep.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, under ``svae_tpu_torch/_build/`` and named by the
source's content hash, at the first CUDA use; it is then loaded with
``ctypes``. A failed build or load raises: there is no fallback. ``nvcc`` is
``$CUDA_HOME/bin/nvcc`` when ``CUDA_HOME`` is set, else the one on ``PATH``,
else ``/usr/local/cuda/bin/nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "estep.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def nvcc_path():
    home = os.environ.get("CUDA_HOME")
    if home:
        path = os.path.join(home, "bin", "nvcc")
    else:
        path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError(
            f"cannot build the E-step kernels: nvcc not found at {path} "
            "(set CUDA_HOME to the CUDA toolkit)")
    return path


def library_path():
    with open(SOURCE, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libsvae_estep_{sha}.so")


def build():
    """Compile the kernels unless a library of this source exists; returns
    its path. ``nvcc``'s report (registers, spills) is kept beside it in
    ``<library>.log``."""
    so = library_path()
    if os.path.exists(so):
        return so
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}")
    with open(so + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def load_library():
    """The loaded kernel library, built first if needed (cached)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.svae_filter_fwd_f32.argtypes = [i, i, i] + [p] * 11
        lib.svae_filter_fwd_f32.restype = i
        lib.svae_sampler_fwd_f32.argtypes = [i, i, i, i] + [p] * 8
        lib.svae_sampler_fwd_f32.restype = i
        _lib = lib
    return _lib
