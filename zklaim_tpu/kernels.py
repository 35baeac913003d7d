"""The one place that decides which implementation runs the point ops.

The MSM and fixed-base code take an `impl` argument:

  "kernel"  the fused CUDA point kernels (ec/cuda_curve.py), on the GPU;
  "xla"     XLA's lowering of the plain jaxcurve code, the reference;
  "host"    the kernels' source compiled for the CPU and called back from
            XLA.  Only tests ask for it, to check the kernels' arithmetic
            on a machine with no GPU.

`impl=None` means "choose": the kernels on a GPU, XLA elsewhere.  There
is no environment switch; on a GPU the kernels compile or the run fails.
"""

from __future__ import annotations

import jax

IMPLS = ("kernel", "xla", "host")


def curve_impl(impl: str | None = None) -> str:
    if impl is None:
        return "kernel" if jax.default_backend() == "gpu" else "xla"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl
