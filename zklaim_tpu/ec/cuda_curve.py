"""Fused complete point add/double for BN254 G1 and G2: CUDA kernels
called through XLA's foreign function interface.

The MSM inner loop is a chain of complete projective adds over wide
batches (msm/pippenger.py, msm/fixedbase.py).  Through XLA every one of
the ~14 field multiplies inside an add writes its (n, 16, 16) partial
products to device memory.  Here one thread holds one point in registers
(8 x 32-bit words per Fq value, Montgomery CIOS on 64-bit products): an
add reads 6 and writes 3 coordinates per point and moves nothing else
(reference hot loop: libsnark multi_exp; SURVEY.md §2.6 row 3).  The
source is ec/cuda/curve.cuh; results are bit-identical to ec/jaxcurve.py.

Points are "planes": a batch of width n is one (48 * deg, n) uint32 array
of 16-bit limbs (msm/pippenger.py keeps every level in this layout).  The
width is a run-time argument of the kernels, so one compiled library
serves every width, and no padding is needed.

`impl` (zklaim_tpu/kernels.py):
  "kernel"  the CUDA kernels.  The library is built with nvcc for sm_90a
            at first use into build/ (utils/build.py) and registered as
            FFI targets;
  "host"    the same curve.cuh compiled for the CPU with g++ and called
            back from XLA, so the CPU tests check the kernels' own
            arithmetic.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np

import jax
import jax.numpy as jnp

from ..utils.build import BUILD_DIR, build_if_stale

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda")
_HEADER = os.path.join(_SRC, "curve.cuh")
_GPU_LIB = os.path.join(BUILD_DIR, "libzk_curve_cuda.so")
_HOST_LIB = os.path.join(BUILD_DIR, "libzk_curve_host.so")

_TARGETS = (("zk_curve_add", "ZkCurveAdd"), ("zk_curve_halves", "ZkCurveHalves"),
            ("zk_curve_double", "ZkCurveDouble"))
_LIBS: dict = {}


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build_gpu_library() -> str:
    """nvcc build of the FFI kernels (sm_90a), if missing or stale."""
    src = os.path.join(_SRC, "curve_ffi.cu")
    build_if_stale(_GPU_LIB, [src, _HEADER], [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
        "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-I", _SRC, "-o", _GPU_LIB, src,
    ])
    return _GPU_LIB


def _gpu_targets() -> None:
    """Build, load and register the FFI targets once per process."""
    if "gpu" in _LIBS:
        return
    lib = ctypes.cdll.LoadLibrary(build_gpu_library())
    for name, symbol in _TARGETS:
        jax.ffi.register_ffi_target(
            name, jax.ffi.pycapsule(getattr(lib, symbol)), platform="CUDA"
        )
    _LIBS["gpu"] = lib


def _host_library():
    lib = _LIBS.get("host")
    if lib is None:
        src = os.path.join(_SRC, "curve_host.cc")
        build_if_stale(_HOST_LIB, [src, _HEADER], [
            "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
            "-Wno-unknown-pragmas", "-I", _SRC, "-o", _HOST_LIB, src,
        ])
        lib = ctypes.cdll.LoadLibrary(_HOST_LIB)
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.zk_host_add.argtypes = [ctypes.c_int32, u32p, i64, u32p, i64,
                                    u32p, i64, i64]
        lib.zk_host_add.restype = None
        lib.zk_host_double.argtypes = [ctypes.c_int32, u32p, i64, u32p, i64, i64]
        lib.zk_host_double.restype = None
        _LIBS["host"] = lib
    return lib


def _check(deg: int, p) -> None:
    if p.ndim != 2 or p.shape[0] != 48 * deg or p.dtype != jnp.uint32:
        raise ValueError(f"expected uint32 planes ({48 * deg}, n), got "
                         f"{p.dtype} {p.shape}")


def _host_add(deg, p, q):
    p = np.ascontiguousarray(p, np.uint32)
    q = np.ascontiguousarray(q, np.uint32)
    n = p.shape[1]
    out = np.empty_like(p)
    _host_library().zk_host_add(deg, p, n, q, n, out, n, n)
    return out


def _host_double(deg, p):
    p = np.ascontiguousarray(p, np.uint32)
    n = p.shape[1]
    out = np.empty_like(p)
    _host_library().zk_host_double(deg, p, n, out, n, n)
    return out


def point_add(deg: int, p, q, impl: str = "kernel"):
    """Complete add of two plane batches (48*deg, n) -> (48*deg, n)."""
    _check(deg, p)
    _check(deg, q)
    out = jax.ShapeDtypeStruct(p.shape, jnp.uint32)
    if impl == "host":
        return jax.pure_callback(lambda a, b: _host_add(deg, a, b), out, p, q,
                                 vmap_method="sequential")
    _gpu_targets()
    return jax.ffi.ffi_call("zk_curve_add", out, vmap_method="sequential")(
        p, q, deg=np.int32(deg))


def point_double(deg: int, p, impl: str = "kernel"):
    """Complete doubling of a plane batch (48*deg, n) -> (48*deg, n)."""
    _check(deg, p)
    out = jax.ShapeDtypeStruct(p.shape, jnp.uint32)
    if impl == "host":
        return jax.pure_callback(lambda a: _host_double(deg, a), out, p,
                                 vmap_method="sequential")
    _gpu_targets()
    return jax.ffi.ffi_call("zk_curve_double", out, vmap_method="sequential")(
        p, deg=np.int32(deg))


def point_add_halves(deg: int, p, impl: str = "kernel"):
    """p[:, :n/2] + p[:, n/2:] -> (48*deg, n/2), n even.  The kernel reads
    both halves in place (second operand at column offset n/2), so the
    MSM upsweep tree materializes no slices."""
    _check(deg, p)
    n = p.shape[1]
    if n % 2:
        raise ValueError(f"halves-add needs an even width, got {n}")
    if impl == "host":
        return point_add(deg, p[:, : n // 2], p[:, n // 2 :], impl)
    _gpu_targets()
    out = jax.ShapeDtypeStruct((p.shape[0], n // 2), jnp.uint32)
    return jax.ffi.ffi_call("zk_curve_halves", out, vmap_method="sequential")(
        p, deg=np.int32(deg))
