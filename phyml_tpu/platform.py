"""Where the program runs, in what precision, and where it caches
compiled programs.  The CLI, the XML front end and chip_smoke.py all
go through these two functions.

Rule:
  * a GPU runs the engine in float32;
  * the CPU runs it in float64;
  * --float32 asks for float32 anywhere;
  * x64 is on in every case, so the per-site sums, the optimizers'
    scalars and the Bayesian chains are real float64.
"""

from __future__ import annotations

import os

_CHOICES = ("cpu", "gpu")


def select_platform(platform: str | None = None,
                    float32: bool = False):
    """Pin the JAX backend (when `platform` is given) and return the
    engine dtype.  `platform` is "cpu" or "gpu"; asking for a GPU
    where JAX finds none is an error, not a fall-back to the CPU."""
    import jax
    import jax.numpy as jnp

    if platform is not None:
        if platform not in _CHOICES:
            raise ValueError(f"platform must be one of {_CHOICES}, "
                             f"got {platform!r}")
        # takes effect only before the first device use; the check
        # below catches a process already bound to another backend.
        # "gpu" would also demand a ROCm plugin, so name CUDA.
        jax.config.update("jax_platforms",
                          "cuda" if platform == "gpu" else platform)
    jax.config.update("jax_enable_x64", True)
    try:
        backend = jax.default_backend()
    except (RuntimeError, AssertionError) as exc:
        raise RuntimeError(
            f"--platform {platform}: JAX found no such device") from exc
    if platform is not None and backend != platform:
        raise RuntimeError(
            f"--platform {platform} was asked for, but JAX runs on "
            f"{backend!r}")
    if float32 or backend != "cpu":
        return jnp.float32
    return jnp.float64


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else `.jax_cache/` at the
    root of this checkout (git-ignored).  The path is part of the
    cache key, so it is fixed rather than per-user or per-run."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def enable_compile_cache() -> str:
    """Persistent XLA compile cache at compile_cache_dir().  The
    default thresholds skip small or quickly compiled programs; this
    program compiles many of both per analysis, so every executable
    is cached.  Returns the directory."""
    import jax

    cache_dir = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir
