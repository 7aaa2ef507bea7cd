"""Multi-host execution: jax.distributed + process-local sharded data.

The reference is a single process with no distributed backend
(SURVEY.md section 2.8); this is the green-field layer for running one
analysis across several processes: on GPUs one process per card, on
one host or several.

Design:
  * One global 1-D device mesh over the voxel axis (the workload's
    data-parallel axis). Plain VB has no cross-shard traffic at all;
    spatial VB's neighbour gathers become halo exchanges and the
    aK/Fglobal reductions become psums — all inserted by GSPMD
    from the sharding annotations, exactly as on a single host.
  * Each process feeds ONLY its shard of the voxel axis
    (`jax.make_array_from_process_local_data`): device memory is the
    scarce resource, so a host never materializes another host's
    voxels on its devices. (NIFTI stores the time axis slowest, so a
    voxel subset is strided across the whole file; hosts on a shared
    filesystem read the file once and keep only their slice in host
    RAM, which is cheap next to device memory.)
  * Deterministic reductions: the Jacobi sweep formulation makes
    results independent of shard topology (docs/PARITY.md section 2.8).

Single-process use is a no-op passthrough, so the same driver script
runs unchanged on a laptop CPU, one GPU host, or several.
"""

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address=None, num_processes=None,
               process_id=None):
    """Initialize jax.distributed from args or the standard env vars
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID). No-op for
    single-process runs."""
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        return False  # single process
    # GPU backends carry cross-process collectives over NCCL; the CPU
    # backend needs an explicit collectives implementation or every
    # process sees only its own devices (the multi-process CPU tests)
    if "cpu" in str(jax.config.jax_platforms or ""):
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)
    return True


def global_voxel_mesh():
    """1-D mesh over ALL devices of ALL processes, voxel axis."""
    return Mesh(np.array(jax.devices()), ("vox",))


def process_voxel_range(nvoxels, mesh=None):
    """The [lo, hi) slice of the global voxel axis this process feeds.

    The voxel axis is padded (by the caller, see pad_voxels) to a
    multiple of the device count, so every device holds an equal
    shard and every process an equal contiguous range.
    """
    nproc = jax.process_count()
    pid = jax.process_index()
    if nvoxels % nproc != 0:
        raise ValueError(
            f"padded voxel count {nvoxels} must divide process count "
            f"{nproc} (use pad_voxels)")
    per = nvoxels // nproc
    return pid * per, (pid + 1) * per


def pad_voxels(nvoxels, mesh=None):
    """Global voxel count padded up to a multiple of the device count."""
    n = len(jax.devices()) if mesh is None else mesh.devices.size
    return ((nvoxels + n - 1) // n) * n


def make_sharded_plane(local, mesh, global_vox, axis=-1):
    """Assemble a global [..., V] device array from this process's
    local [..., V/nproc] slice (zero cross-host transfers: each shard
    lands on the devices of the process that produced it)."""
    axis = axis % (local.ndim if hasattr(local, "ndim") else 1)
    spec = [None] * local.ndim
    spec[axis] = "vox"
    sharding = NamedSharding(mesh, P(*spec))
    global_shape = list(local.shape)
    global_shape[axis] = global_vox
    if jax.process_count() == 1:
        # single host: device_put with the sharding splits locally
        return jax.device_put(local, sharding)
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(local), tuple(global_shape))


def load_voxel_data_sharded(geometry, volume, mesh=None, dtype=None,
                            pad_mode="edge"):
    """4-D volume (host RAM, e.g. from io.nifti.load) -> global
    sharded [T, V_pad] SoA device plane (the engines' internal
    layout); this process transfers only its voxel range to its own
    devices.

    Returns (array [T, V_pad], v_pad) — callers slice results back to
    geometry.nvoxels.
    """
    mesh = mesh if mesh is not None else global_voxel_mesh()
    vox = geometry.to_voxels(np.asarray(volume))  # [V, T] host
    v_pad = pad_voxels(geometry.nvoxels, mesh)
    if v_pad != geometry.nvoxels:
        reps = np.repeat(vox[-1:], v_pad - geometry.nvoxels, axis=0) \
            if pad_mode == "edge" else np.zeros(
                (v_pad - geometry.nvoxels, vox.shape[1]), vox.dtype)
        vox = np.concatenate([vox, reps], axis=0)
    lo, hi = process_voxel_range(v_pad)
    local = np.ascontiguousarray(vox[lo:hi].T)  # [T, Vlocal]
    if dtype is not None:
        local = local.astype(dtype)
    return make_sharded_plane(local, mesh, v_pad, axis=-1), v_pad


def gather_result_local(arr, lo, hi):
    """Fetch this process's [lo, hi) slice of a sharded [..., V] result
    to host RAM (only locally-resident shards move; cross-host results
    stay remote)."""
    sliced = arr[..., lo:hi]
    return np.asarray(jax.device_get(sliced))


def fetch_global(x):
    """Device array -> full numpy array on EVERY host. Single process:
    plain np.asarray; multi-process: allgather over DCN (results are
    small next to the input volumes).

    Host arrays and fully-addressable device arrays (values every
    process already holds whole, e.g. a model re-evaluation at the
    gathered posterior means) are fetched directly — allgathering
    those would concatenate identical per-process copies."""
    if jax.process_count() == 1:
        return np.asarray(x)
    if not isinstance(x, jax.Array) or x.is_fully_addressable:
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


# -- production run path (wired from runner._dispatch) -------------------

def _pad_voxel_major(arr, v_pad):
    """Pad a voxel-major [V, ...] host array to v_pad rows by repeating
    the last voxel (padding lanes run real arithmetic; results are
    sliced off)."""
    v = arr.shape[0]
    if v_pad == v:
        return np.asarray(arr)
    reps = np.repeat(np.asarray(arr)[-1:], v_pad - v, axis=0)
    return np.concatenate([np.asarray(arr), reps], axis=0)


def pad_coords_isolated(coords, v_pad):
    """Pad [V,3] coords with voxels guaranteed OUT of every neighbour
    graph: placed past the volume along x with stride 2, so padding
    voxels have no first/second neighbours among real voxels or each
    other."""
    coords = np.asarray(coords, float)
    v = coords.shape[0]
    if v_pad == v:
        return coords
    n = v_pad - v
    xmax = coords[:, 0].max() if v else 0.0
    pad = np.zeros((n, 3))
    pad[:, 0] = xmax + 3 + 3 * np.arange(n)
    pad[:, 1] = coords[:, 1].max() if v else 0.0
    pad[:, 2] = coords[:, 2].max() if v else 0.0
    return np.concatenate([coords, pad], axis=0)


def padded_getter(getter, v_real, v_pad):
    """Wrap a voxel-data getter so image-prior planes etc. come back
    padded to the sharded voxel count."""
    def get(key):
        arr = np.asarray(getter(key))
        if arr.ndim >= 1 and arr.shape[0] == v_real:
            return _pad_voxel_major(arr, v_pad)
        return arr
    return get


def build_engine_sharded(engine_cls, model, options, data, coords,
                         suppdata=None, voxel_data_getter=None,
                         mesh=None, log=None):
    """Construct an inference engine whose voxel planes are sharded
    over the global device mesh, with process-local feeding.

    data [V,T] / coords [V,3] / suppdata [V,S] are THIS PROCESS's view
    of the full volume (on a shared filesystem every process loads the
    whole file; only its shard reaches its devices). Returns
    (engine, v_real): engine.run() output must be sliced back to
    v_real voxels (slice_result)."""
    mesh = mesh if mesh is not None else global_voxel_mesh()
    v_real = data.shape[0]
    v_pad = pad_voxels(v_real, mesh)
    lo, hi = process_voxel_range(v_pad)

    dtype = np.float64 if options.get_string(
        "dtype", "double") == "double" else np.float32
    data_pad = _pad_voxel_major(data, v_pad).astype(dtype)
    coords_pad = pad_coords_isolated(coords, v_pad)

    data_plane = make_sharded_plane(
        np.ascontiguousarray(data_pad[lo:hi].T), mesh, v_pad, axis=-1)
    supp_plane = None
    if suppdata is not None and suppdata.shape[1] > 0:
        supp_pad = _pad_voxel_major(suppdata, v_pad).astype(dtype)
        supp_plane = make_sharded_plane(
            np.ascontiguousarray(supp_pad[lo:hi].T), mesh, v_pad, axis=-1)

    getter = voxel_data_getter
    if getter is not None and v_pad != v_real:
        getter = padded_getter(getter, v_real, v_pad)

    engine = engine_cls(model, options, None, coords_pad,
                        voxel_data_getter=getter,
                        data_plane=data_plane, supp_plane=supp_plane)
    shard_engine_arrays(engine, mesh)
    if v_pad != v_real:
        # padding lanes: excised from the MRF graph + aK reduction so
        # sharded spatial results equal the unsharded run exactly
        engine._pre_excised = np.arange(v_pad) >= v_real
        if hasattr(engine, "ak_nvoxels"):
            engine.ak_nvoxels = v_real
    engine._fetch = fetch_global
    if log is not None:
        log.log(f"Distributed run: {v_real} voxels (padded to {v_pad}) "
                f"over {mesh.devices.size} devices / "
                f"{jax.process_count()} processes")
    return engine, v_real


def shard_engine_arrays(engine, mesh):
    """Re-place an engine's per-run device arrays with voxel-axis
    shardings on the given (global) mesh; disable chunking. The
    engine's data plane is expected to be sharded already
    (build_engine_sharded) or locally shardable (single process)."""
    vox_last = lambda nd: NamedSharding(
        mesh, P(*([None] * (nd - 1) + ["vox"])))
    engine.coords = jax.device_put(engine.coords,
                                   vox_last(engine.coords.ndim))
    if getattr(engine, "neigh", None) is not None \
            and hasattr(engine, "neigh"):
        vox_first = NamedSharding(mesh, P("vox", None))
        engine.neigh = jax.device_put(engine.neigh, vox_first)
        engine.neigh2 = jax.device_put(engine.neigh2, vox_first)
    engine.options.set("voxel-chunk-size", str(engine.nvoxels))
    # the spectral routes dispatch per shard via shard_map
    # (inference/vb.py _shard_kernel); the padded voxel count always
    # divides the mesh here, so eligibility is unchanged.
    engine.mesh = mesh
    return mesh


def slice_result(result, v_real):
    """Drop padding voxels from a VBResult (all fields are voxel-major
    [V,...] except fhistory [iters,V])."""
    def cut(x):
        if x is None or not hasattr(x, "ndim") or x.ndim == 0:
            return x
        return x[:v_real]

    out = {f: cut(getattr(result, f)) for f in result._fields
           if f != "fhistory"}
    out["fhistory"] = None if result.fhistory is None \
        else result.fhistory[:, :v_real]
    return type(result)(**out)
