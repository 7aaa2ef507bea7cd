"""Where the program runs: the one place that asks JAX which backend it
has, which routes auto prefers there, how much device memory it may
plan for, and where compiled programs are cached.

Every question is answered at call time, never while a module is
imported, so a process can still choose its platform after importing
the package.
"""

import os

import jax

# Default share of the device's memory limit that chunked and streamed
# runs plan for: the per-voxel footprint estimates (inference/vb.py
# _chunk_size) are within about 2x, so half the limit leaves room for
# the temporaries they miss.
PLAN_FRACTION = 0.5
# Planning budget where the backend reports no memory limit (the CPU).
DEFAULT_BUDGET_BYTES = 8e9


def backend():
    """The default JAX backend: "gpu" or "cpu"."""
    return jax.default_backend()


def spectral_by_default():
    """Whether auto takes the spectral eigenbasis routes (ops/spectral.py)
    for single-group white-noise fixed designs. They are plain XLA and
    run anywhere; auto takes them on a GPU, where their program measured
    faster than the sufficient-statistics route (PERF.md), and keeps the
    statistics route elsewhere."""
    return backend() == "gpu"


def device_memory_limit(device=None):
    """Bytes this process's first device (or `device`) may allocate, as
    its memory_stats report them; None where the backend reports no
    limit. FABBER_TPU_MEM_GB, when set, overrides it (in GB)."""
    env = os.environ.get("FABBER_TPU_MEM_GB")
    if env:
        return float(env) * 1e9
    # local: under jax.distributed, jax.devices()[0] may belong to
    # another process
    device = device if device is not None else jax.local_devices()[0]
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    return float(limit) if limit else None


def planning_budget(device=None):
    """Bytes a chunked or streamed run plans its windows for: the
    explicit FABBER_TPU_MEM_GB override as given, else PLAN_FRACTION of
    the device's limit, else DEFAULT_BUDGET_BYTES."""
    if os.environ.get("FABBER_TPU_MEM_GB"):
        return device_memory_limit(device)
    limit = device_memory_limit(device)
    return PLAN_FRACTION * limit if limit else DEFAULT_BUDGET_BYTES


def compile_cache_dir(environ=None):
    """The persistent compilation cache directory: JAX_COMPILATION_CACHE_DIR
    when set (JAX reads it itself), else a fixed directory inside the
    checkout, so that the path, which is part of the cache key, never
    moves between runs."""
    environ = os.environ if environ is None else environ
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return environ["JAX_COMPILATION_CACHE_DIR"]
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")
