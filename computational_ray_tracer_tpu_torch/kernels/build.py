"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` of the package, one
process per source, all started together, and links the objects into one
shared library with a plain C interface,
``computational_ray_tracer_tpu_torch/build/libcrt_kernels.so``, which is
loaded with ctypes. The library is rebuilt whenever the hash of the sources
and flags changes (recorded in ``build/libcrt_kernels.sha256``). Only the
sources in the checkout are used; nothing is downloaded.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3 -std=c++17`` plus
``-fmad=false`` (the kernels also spell out their rounding with
``__fmul_rn``/``__fadd_rn``); no ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libcrt_kernels.so")
HASH_PATH = os.path.join(BUILD_DIR, "libcrt_kernels.sha256")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIB = None
# Set by the call that compiled the library: seconds and nvcc's output.
build_seconds = 0.0
build_log = ""


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def build():
    """Compile the library if it is missing or stale; returns its path."""
    global build_seconds, build_log
    digest = source_hash()
    if os.path.exists(LIB_PATH) and os.path.exists(HASH_PATH):
        with open(HASH_PATH) as fh:
            if fh.read().strip() == digest:
                return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = LIB_PATH + f".tmp{os.getpid()}"
    nvcc = _nvcc()
    srcs = [s for s in _sources() if s.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, os.path.basename(s) + f".{os.getpid()}.o")
            for s in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for src, obj in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    failed = [src for src, p in zip(srcs, procs) if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        failed = ["link"] if link.returncode != 0 else []
    build_seconds = time.perf_counter() - t0
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    os.replace(tmp, LIB_PATH)
    with open(HASH_PATH, "w") as fh:
        fh.write(digest + "\n")
    return LIB_PATH


def load_library():
    """The loaded kernel library (built first if needed), with argtypes."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.crt_mesh_intersect.argtypes = [p, p, p, p, p, i, i, p, p, p, p, p]
        lib.crt_mesh_intersect.restype = i
        lib.crt_octree_traverse.argtypes = [p, p, p, i, p, p, p, i, i, p, p, p,
                                            p, p, p, p]
        lib.crt_octree_traverse.restype = i
        lib.crt_error_string.argtypes = [i]
        lib.crt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def error_string(err):
    return load_library().crt_error_string(int(err)).decode()
