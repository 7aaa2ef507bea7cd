"""Device-mesh sharding for multi-chip runs.

The reference has no distributed backend (SURVEY.md section 2.8); this
is the green-field device-mesh equivalent. The engine's SoA layout puts
voxels on the last axis of every plane, so a 1-D mesh over the voxel
axis is the framework's data-parallel (and, for spatial VB,
halo-coupled) sharding: GSPMD turns neighbour gathers into halo
exchanges and the aK reduction into a psum automatically, and results
are bit-identical to single-device execution (tests/test_spatial.py).

Use:
    eng = VBInference(...)
    shard_engine(eng)          # all local devices
    res = eng.run()
or pass --shard-voxels to the CLI.
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def voxel_mesh(devices=None):
    """1-D mesh over the voxel axis."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), ("vox",))


def _vox_sharding(mesh, ndim):
    return NamedSharding(mesh, P(*([None] * (ndim - 1) + ["vox"])))


def shard_engine(engine, devices=None, log=None):
    """Shard an inference engine's per-run arrays over a voxel mesh.

    The voxel count must divide the device count; chunked execution is
    disabled (each device already holds only its shard). Returns the
    mesh.

    Non-divisible voxel counts fall back to the largest dividing device
    subset (pad-free policy) — with a loud warning, since that can mean
    running on 1 device. For full utilisation at any voxel count use
    the padded path (parallel.distributed.build_engine_sharded), which
    the CLI --shard-voxels route takes automatically.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if engine.nvoxels % n != 0:
        # pad-free policy: shard only when it divides evenly; GSPMD
        # handles uneven shards too but keeps layouts simpler this way
        usable = max(d for d in range(1, n + 1) if engine.nvoxels % d == 0)
        devices = devices[:usable]
        msg = (f"shard_engine: {engine.nvoxels} voxels do not divide "
               f"{n} devices; using {usable} device(s). Pad the voxel "
               "count or use parallel.distributed.build_engine_sharded "
               "for full utilisation.")
        if log is not None:
            log.warn(msg)
        else:
            import warnings
            warnings.warn(msg, stacklevel=2)
    mesh = voxel_mesh(devices)

    def put(x):
        if hasattr(x, "ndim") and x.ndim >= 1 \
                and x.shape[-1] == engine.nvoxels:
            return jax.device_put(x, _vox_sharding(mesh, x.ndim))
        return x

    engine.data = put(engine.data)
    engine.coords = put(engine.coords)
    if engine.suppdata is not None:
        engine.suppdata = put(engine.suppdata)
    if getattr(engine, "neigh", None) is not None \
            and hasattr(engine, "neigh"):
        # neighbour tables are [V, K] (voxel axis FIRST)
        vox_first = NamedSharding(mesh, P("vox", None))
        engine.neigh = jax.device_put(engine.neigh, vox_first)
        engine.neigh2 = jax.device_put(engine.neigh2, vox_first)
    # chunking would fight the sharding; a sharded run is one pass
    engine.options.set("voxel-chunk-size", str(engine.nvoxels))
    # the spectral routes dispatch per shard via shard_map
    # (inference/vb.py _shard_kernel); the device subset above always
    # divides the voxel count
    engine.mesh = mesh
    return mesh
