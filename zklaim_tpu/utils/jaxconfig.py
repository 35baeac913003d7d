"""Shared JAX runtime configuration.

Call setup_cache() early in any entry point (CLI, bench, smoke test):
the wide-limb field programs are compile-time heavy, so compiled
executables persist across processes.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives at one fixed path inside
the checkout, `<repo>/.jax_cache` (listed in .gitignore): the path is
part of the cache key, so it must not move between runs.

On the CPU backend the persistent cache is DISABLED: XLA:CPU's
LoadedExecutable.serialize segfaults the process on some of the large
MSM/prove executables (observed on single-device programs as well as
the multi-device batched-prove program), taking the whole test run with
it.  CPU runs are test runs; correctness matters there, not cold-start
latency.
"""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def setup_cache(cache_dir: str = CACHE_DIR) -> None:
    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_compilation_cache", False)
        return
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
