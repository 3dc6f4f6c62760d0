"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into an
object, all in parallel processes, and the objects are linked into one
shared library with a plain C interface, under ``svae_tpu_torch/_build/``
and named by the hash of every file in ``csrc/``, at the first CUDA use; it
is then loaded with ``ctypes``. A failed build or load raises: there is no
fallback. ``nvcc`` is ``$CUDA_HOME/bin/nvcc`` when ``CUDA_HOME`` is set, else
the one on ``PATH``, else ``/usr/local/cuda/bin/nvcc``.
"""

import concurrent.futures
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
COMPILE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    sha = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        sha.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            sha.update(f.read())
    return os.path.join(BUILD_DIR, f"libsvae_estep_{sha.hexdigest()[:16]}.so")


def build():
    """Compile the kernels unless a library of these sources exists;
    returns its path. ``nvcc``'s report (registers, spills) and each
    source's compile seconds are kept beside it in ``<library>.log``."""
    so = library_path()
    if os.path.exists(so):
        return so
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}"

    def compile_one(src):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *COMPILE_FLAGS, "-c", "-o", obj, src],
                              capture_output=True, text=True)
        return src, obj, proc, time.perf_counter() - t0

    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        jobs = list(pool.map(compile_one, srcs))
    failed = [f"nvcc failed ({proc.returncode}) on {src}:\n{proc.stderr}"
              for src, _, proc, _ in jobs if proc.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    log = [f"== {os.path.basename(src)}: {secs:.1f} s\n"
           f"{proc.stdout}{proc.stderr}" for src, _, proc, secs in jobs]
    objs = [obj for _, obj, _, _ in jobs]
    proc = subprocess.run([nvcc, "-shared", "-o", f"{tmp}.so", *objs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) linking {so}:\n"
                           f"{proc.stderr}")
    for obj in objs:
        os.remove(obj)
    with open(so + ".log", "w") as f:
        f.writelines(log)
    os.replace(f"{tmp}.so", so)
    return so


# The C entries of the library: (name, leading int arguments, pointers
# including the stream).
ENTRIES = (("svae_filter_fwd_f32", 3, 11),
           ("svae_sampler_fwd_f32", 4, 10),
           ("svae_sampler_fwd_factor_f32", 4, 7),
           ("svae_sampler_fwd_chain_f32", 4, 6),
           ("svae_filter_adj_f32", 3, 17),
           ("svae_filter_adj_factor_f32", 3, 10),
           ("svae_filter_adj_chain_f32", 3, 9),
           ("svae_sampler_adj_f32", 4, 14),
           ("svae_sampler_adj_factor_f32", 3, 4),
           ("svae_sampler_adj_chain_f32", 4, 9),
           ("svae_sampler_adj_dJc_f32", 4, 10),
           ("svae_bidir_fwd_f32", 3, 12),
           ("svae_sampler_bp_fwd_f32", 4, 10),
           ("svae_sampler_bp_fwd_factor_f32", 4, 8),
           ("svae_sampler_bp_fwd_chain_f32", 4, 5),
           ("svae_bidir_adj_f32", 3, 19),
           ("svae_bidir_adj_factor_f32", 3, 9),
           ("svae_bidir_adj_chain_f32", 3, 12),
           ("svae_sampler_bp_adj_f32", 4, 16),
           ("svae_sampler_bp_adj_factor_f32", 3, 4),
           ("svae_sampler_bp_adj_chain_f32", 4, 6),
           ("svae_sampler_bp_adj_dJc_f32", 4, 13),
           ("svae_hmm_fb_fwd_f32", 3, 5),
           ("svae_hmm_fb_stat_fwd_f32", 3, 6),
           ("svae_hmm_fb_adj_f32", 3, 13),
           ("svae_hmm_fb_adj_weights_f32", 3, 7),
           ("svae_hmm_fb_adj_chain_f32", 3, 8),
           ("svae_hmm_fb_adj_dM_f32", 3, 6),
           ("svae_hmm_fb_stat_adj_f32", 3, 15),
           ("svae_hmm_fb_stat_adj_weights_f32", 3, 8),
           ("svae_hmm_fb_stat_adj_sums_f32", 3, 7),
           ("svae_elem_scan_f32", 3, 3),
           ("svae_elem_scan_adj_f32", 3, 6),
           ("svae_elem_scan_adj_factor_f32", 3, 4),
           ("svae_elem_scan_adj_chain_f32", 3, 4),
           ("svae_filter_shared_f32", 3, 12),
           ("svae_backward_shared_f32", 3, 8),
           ("svae_sampler_shared_f32", 4, 10),
           ("svae_sampler_shared_factor_f32", 4, 8))


# The latent sizes compiled from csrc/*_wide.cu: each of those sources
# includes its namesake's template bodies and defines that source's C
# entries for them under the suffix WIDE_SUFFIX.
WIDE_DIMS = (24, 32)
WIDE_SUFFIX = "_wide"


def bind(lib, names=None):
    """Set the argument and result types of ``lib``'s C entries (those in
    ``names``, else all of ENTRIES, each with its ``_wide`` twin where the
    library has one); returns ``lib``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, ints, ptrs in ENTRIES:
        if names is None or name in names:
            for entry in (name, name + WIDE_SUFFIX):
                fn = getattr(lib, entry, None)
                if fn is None and entry != name:
                    continue
                if fn is None:
                    raise AttributeError(f"{entry}: not in the library")
                fn.argtypes = [i] * ints + [p] * ptrs
                fn.restype = i
    return lib


class Library:
    """A bound library's C entries by name. An entry whose first argument
    is the latent size and which has a ``_wide`` twin calls the twin for d
    in WIDE_DIMS, so callers name one entry for every built d."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        wide = getattr(self.lib, name + WIDE_SUFFIX, None)
        if wide is not None:
            narrow = fn

            def fn(d, *args):
                return (wide if d in WIDE_DIMS else narrow)(d, *args)

            fn.argtypes, fn.restype = narrow.argtypes, narrow.restype
        setattr(self, name, fn)
        return fn


def load_library():
    """The loaded kernel library, built first if needed (cached), as a
    :class:`Library`."""
    global _lib
    if _lib is None:
        _lib = Library(bind(ctypes.CDLL(build())))
    return _lib
