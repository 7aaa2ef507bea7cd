"""fabber_core_tpu — a JAX Bayesian model-fitting framework.

A from-scratch JAX/XLA re-design of the capabilities of
physimals/fabber_core: analytic Variational Bayes over nonlinear forward
models for 4-D timeseries volumes, batched over all voxels at once and
sharded over device meshes, instead of the reference's serial per-voxel
C++ loop (reference: inference_vb.cc:423).

Key entry points:
  - fabber_core_tpu.api.FabberTpu().run_with_data(options, data)
  - fabber_core_tpu.cli.main()  (the `fabber` CLI equivalent)
"""

# Double precision must be enabled before any JAX computation is traced.
# The reference pipeline is entirely double-precision (NEWMAT); we keep
# float64 as the parity default and use explicit float32/bfloat16 dtypes
# where a run asks for speed.
import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# On a GPU, JAX's DEFAULT matmul precision runs float32 products in TF32,
# which keeps about three decimal digits: enough to move the sufficient
# statistics' posterior means by a visible fraction of a posterior sd.
# This is a scientific-computing package, so every matmul/einsum is
# true float32. The routes are memory-bound, so the cost is invisible
# end to end.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when set (JAX
# reads it itself), else a fixed directory inside the checkout.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    from .devices import compile_cache_dir as _cache_dir

    _jax.config.update("jax_compilation_cache_dir", _cache_dir())

from .version import __version__  # noqa: E402,F401
