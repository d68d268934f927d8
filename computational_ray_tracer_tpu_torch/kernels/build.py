"""Build and load the port's CUDA kernels and its host library.

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

The host code in ``csrc/host/*.cpp`` (the native octree builder and the
OBJ and PLY loaders) is built the same way by ``g++`` into
``build/libcrt_host.so`` at first use (:func:`load_host_library`); it needs
no card. A failed compile of either library raises.
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
HOST_LIB_PATH = os.path.join(BUILD_DIR, "libcrt_host.so")
HOST_HASH_PATH = os.path.join(BUILD_DIR, "libcrt_host.sha256")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_LIB = None
_HOST_LIB = None
# Set by the call that compiled the library: seconds and nvcc's output.
build_seconds = 0.0
build_log = ""


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def _host_sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "host", "*.cpp")))


def source_hash(paths=None, flags=NVCC_FLAGS):
    h = hashlib.sha256(" ".join(flags).encode())
    for path in _sources() if paths is None else paths:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def _is_current(lib_path, hash_path, digest):
    if os.path.exists(lib_path) and os.path.exists(hash_path):
        with open(hash_path) as fh:
            return fh.read().strip() == digest
    return False


def _install(tmp, lib_path, hash_path, digest):
    os.replace(tmp, lib_path)
    with open(hash_path, "w") as fh:
        fh.write(digest + "\n")


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
    if _is_current(LIB_PATH, HASH_PATH, digest):
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
    _install(tmp, LIB_PATH, HASH_PATH, digest)
    return LIB_PATH


def build_host():
    """Compile the host library with g++ if it is missing or stale;
    returns its path. Raises if g++ is missing or fails."""
    srcs = _host_sources()
    digest = source_hash(srcs, GXX_FLAGS)
    if _is_current(HOST_LIB_PATH, HOST_HASH_PATH, digest):
        return HOST_LIB_PATH
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native octree builder and "
                           "mesh loaders need a C++ compiler")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = HOST_LIB_PATH + f".tmp{os.getpid()}"
    out = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, *srcs],
                         capture_output=True, text=True)
    if out.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed:\n{out.stdout}{out.stderr}")
    _install(tmp, HOST_LIB_PATH, HOST_HASH_PATH, digest)
    return HOST_LIB_PATH


def load_library():
    """The loaded kernel library (built first if needed), with argtypes."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.crt_mesh_intersect.argtypes = [p, p, p, p, p, i, i, p, p, p, p, p,
                                           p, p, p]
        lib.crt_mesh_intersect.restype = i
        lib.crt_mesh_anyhit.argtypes = [p, p, p, p, p, i, i, p, p, p, p, p]
        lib.crt_mesh_anyhit.restype = i
        lib.crt_octree_traverse.argtypes = [p, p, p, i, p, p, p, i, i, p, p, p,
                                            p, p, p, p, p]
        lib.crt_octree_traverse.restype = i
        lib.crt_dense_interp.argtypes = [p, i, i, p, p, i, p, p]
        lib.crt_dense_interp.restype = i
        lib.crt_dense_interp_backward_scratch.argtypes = [i, i, i]
        lib.crt_dense_interp_backward_scratch.restype = ctypes.c_longlong
        lib.crt_dense_interp_backward.argtypes = [p, i, i, p, p, i, p, p, p]
        lib.crt_dense_interp_backward.restype = i
        lib.crt_sampler_draw.argtypes = [i, i, p, i, p, ctypes.c_longlong, p,
                                         p, p, p]
        lib.crt_sampler_draw.restype = i
        lib.crt_shade_bounce.argtypes = [p, p]
        lib.crt_shade_bounce.restype = i
        lib.crt_shade_resolve.argtypes = [p, p, p, i, p]
        lib.crt_shade_resolve.restype = i
        lib.crt_error_string.argtypes = [i]
        lib.crt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


class CrtOctree(ctypes.Structure):
    """The output of ``crt_build_octree`` (``csrc/host/octree_builder.cpp``);
    its buffers are freed by ``crt_free_octree``."""
    _fields_ = [
        ("n_nodes", ctypes.c_int64),
        ("n_leaves", ctypes.c_int64),
        ("leaf_cap", ctypes.c_int64),
        ("node_lo", ctypes.POINTER(ctypes.c_float)),
        ("node_hi", ctypes.POINTER(ctypes.c_float)),
        ("node_child0", ctypes.POINTER(ctypes.c_int32)),
        ("node_leaf_id", ctypes.POINTER(ctypes.c_int32)),
        ("leaf_tris", ctypes.POINTER(ctypes.c_int32)),
        ("leaf_counts", ctypes.POINTER(ctypes.c_int32)),
    ]


class CrtMesh(ctypes.Structure):
    """The output of ``crt_load_obj`` / ``crt_load_ply``
    (``csrc/host/mesh_loader.cpp``, ``ply_loader.cpp``); its buffers are
    freed by ``crt_free_mesh``."""
    _fields_ = [
        ("n_verts", ctypes.c_int64),
        ("n_tris", ctypes.c_int64),
        ("has_normals", ctypes.c_int32),
        ("has_uvs", ctypes.c_int32),
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("indices", ctypes.POINTER(ctypes.c_int32)),
        ("uvs", ctypes.POINTER(ctypes.c_float)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
    ]


def load_host_library():
    """The loaded host library (built first if needed), with argtypes."""
    global _HOST_LIB
    if _HOST_LIB is None:
        lib = ctypes.CDLL(build_host())
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.crt_build_octree.argtypes = [
            fp, ctypes.c_int64, ip, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_double, ctypes.POINTER(CrtOctree)]
        lib.crt_build_octree.restype = ctypes.c_int
        lib.crt_free_octree.argtypes = [ctypes.POINTER(CrtOctree)]
        lib.crt_free_octree.restype = None
        for name in ("crt_load_obj", "crt_load_ply"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(CrtMesh)]
            fn.restype = ctypes.c_int
        lib.crt_free_mesh.argtypes = [ctypes.POINTER(CrtMesh)]
        lib.crt_free_mesh.restype = None
        _HOST_LIB = lib
    return _HOST_LIB


def error_string(err):
    return load_library().crt_error_string(int(err)).decode()
