"""Multi-host layer (parallel/distributed.py) exercised on the
8-device virtual CPU mesh (single process; the process-local code path
is shared with real multi-host runs via
jax.make_array_from_process_local_data)."""

import jax
import numpy as np
import pytest

from fabber_core_tpu.core.volume import VolumeGeometry
from fabber_core_tpu.parallel import distributed as dist


def test_initialize_noop_single_process(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("NUM_PROCESSES", raising=False)
    assert dist.initialize() is False


def test_pad_and_range():
    mesh = dist.global_voxel_mesh()
    n = mesh.devices.size
    assert dist.pad_voxels(n * 3, mesh) == n * 3
    assert dist.pad_voxels(n * 3 + 1, mesh) == n * 4
    lo, hi = dist.process_voxel_range(n * 4)
    assert (lo, hi) == (0, n * 4)  # single process feeds everything


def test_load_voxel_data_sharded_roundtrip():
    rng = np.random.default_rng(0)
    nx, ny, nz, nt = 5, 4, 2, 7
    mask = rng.random((nx, ny, nz)) > 0.3
    vol = rng.normal(size=(nx, ny, nz, nt))
    geom = VolumeGeometry((nx, ny, nz), mask)

    mesh = dist.global_voxel_mesh()
    arr, v_pad = dist.load_voxel_data_sharded(geom, vol, mesh)
    assert arr.shape == (nt, v_pad)
    assert v_pad % mesh.devices.size == 0
    # sharded over the voxel axis
    assert arr.sharding.spec == jax.sharding.PartitionSpec(None, "vox")
    # values identical to the host packing; padding repeats last voxel
    expect = geom.to_voxels(vol).T
    np.testing.assert_allclose(np.asarray(arr)[:, :geom.nvoxels], expect)
    np.testing.assert_allclose(
        np.asarray(arr)[:, geom.nvoxels:],
        np.repeat(expect[:, -1:], v_pad - geom.nvoxels, axis=1))


def test_sharded_vb_run_matches_unsharded():
    """A VB run whose data plane is globally sharded produces the same
    numbers as the plain single-device run."""
    from fabber_core_tpu.options import RunOptions
    from fabber_core_tpu.models import get_model_class
    from fabber_core_tpu.inference.vb import VBInference
    from fabber_core_tpu.parallel.mesh import shard_engine

    rng = np.random.default_rng(3)
    mesh = dist.global_voxel_mesh()
    nv = mesh.devices.size * 8
    nt = 12
    t = np.arange(1, nt + 1, dtype=float)
    data = 1.5 + 0.2 * t[None, :] + rng.normal(0, 0.1, (nv, nt))
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    mk = lambda: RunOptions({"model": "poly", "degree": "1",
                             "noise": "white", "max-iterations": "8"})
    o1 = mk()
    e1 = VBInference(get_model_class("poly")(o1), o1, data, coords)
    r1 = e1.run()

    o2 = mk()
    e2 = VBInference(get_model_class("poly")(o2), o2, data, coords)
    shard_engine(e2)
    r2 = e2.run()
    np.testing.assert_allclose(r1.means, r2.means, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(r1.noise_means, r2.noise_means, rtol=1e-12)


def _phantom_vols(rng, shape, nt):
    nv = int(np.prod(shape))
    t = np.arange(1, nt + 1, dtype=float)
    c0 = rng.uniform(0.5, 1.5, nv)
    data = (c0[:, None] + 0.05 * t[None, :]
            + rng.normal(0, 0.1, (nv, nt)))
    return data.reshape(shape + (nt,), order="F").astype(np.float32)


@pytest.mark.parametrize("method,extra", [
    ("vb", {}),
    ("spatialvb", {"param-spatial-priors": "M+", "spatial-dims": "3"}),
    ("nlls", {}),
], ids=["vb", "spatialvb", "nlls"])
def test_distributed_runner_matches_plain(method, extra):
    """The production --distributed path (runner._dispatch_distributed:
    padded voxel planes, process-local feeding, pre-excised padding
    lanes) returns the same outputs as a plain run."""
    from fabber_core_tpu.api import FabberTpu

    rng = np.random.default_rng(11)
    shape, nt = (3, 5, 3), 10   # 45 voxels: not divisible by 8 devices
    vol = _phantom_vols(rng, shape, nt)
    base = {"model": "poly", "degree": "1", "noise": "white",
            "method": method, "max-iterations": "5",
            "save-mean": True, "save-std": True, "save-model-fit": True}
    base.update(extra)
    fab = FabberTpu()
    r_plain = fab.run_with_data(dict(base), {"data": vol})
    r_dist = fab.run_with_data(dict(base, distributed=True), {"data": vol})
    assert sorted(r_plain.data) == sorted(r_dist.data)
    for key in r_plain.data:
        np.testing.assert_allclose(
            r_dist.data[key], r_plain.data[key], rtol=1e-9, atol=1e-11,
            err_msg=key)


def test_distributed_spatial_ar_composition():
    """spatialvb + AR(1) noise, sharded over the global mesh via the
    production helpers == unsharded (VERDICT r1 next-round item 8)."""
    from fabber_core_tpu.options import RunOptions
    from fabber_core_tpu.models import get_model_class
    from fabber_core_tpu.inference.spatial import SpatialVBInference

    rng = np.random.default_rng(5)
    nx, ny = 5, 9
    nv, nt = nx * ny, 14
    t = np.arange(1, nt + 1, dtype=float)
    data = 1.0 + 0.05 * t[None, :] + rng.normal(0, 0.1, (nv, nt))
    coords = np.array([[x, y, 0] for y in range(ny) for x in range(nx)],
                      float)

    def mk():
        return RunOptions({"model": "poly", "degree": "1", "noise": "ar",
                           "num-echoes": "1", "method": "spatialvb",
                           "param-spatial-priors": "M+",
                           "spatial-dims": "2", "max-iterations": "4",
                           "print-free-energy": True})

    o1 = mk()
    e1 = SpatialVBInference(get_model_class("poly")(o1), o1, data, coords)
    r1 = e1.run()

    o2 = mk()
    e2, v_real = dist.build_engine_sharded(
        SpatialVBInference, get_model_class("poly")(o2), o2, data, coords)
    assert e2.nvoxels % dist.global_voxel_mesh().devices.size == 0
    r2 = dist.slice_result(e2.run(), v_real)

    np.testing.assert_allclose(r1.means, r2.means, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(r1.noise_means, r2.noise_means, rtol=1e-9)
    np.testing.assert_allclose(r1.free_energy, r2.free_energy,
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(e1.final_ak, e2.final_ak, rtol=1e-9)


def test_distributed_cli(tmp_path):
    """--distributed reaches the distributed layer from the CLI."""
    from fabber_core_tpu import cli
    from fabber_core_tpu.io import nifti

    rng = np.random.default_rng(2)
    shape, nt = (3, 3, 5), 8
    vol = _phantom_vols(rng, shape, nt)
    data_f = str(tmp_path / "data.nii.gz")
    nifti.save(nifti.NiftiImage(vol), data_f)
    out1 = str(tmp_path / "out_plain")
    out2 = str(tmp_path / "out_dist")
    args = [f"--data={data_f}", "--model=poly", "--degree=1",
            "--method=vb", "--noise=white", "--max-iterations=5"]
    assert cli.execute(args + [f"--output={out1}"]) == 0
    assert cli.execute(args + [f"--output={out2}", "--distributed"]) == 0
    m1 = nifti.load(out1 + "/mean_c0.nii.gz").data
    m2 = nifti.load(out2 + "/mean_c0.nii.gz").data
    np.testing.assert_allclose(m1, m2, rtol=1e-6, atol=1e-8)


def test_shard_voxels_nondivisible_pads(tmp_path):
    """--shard-voxels with a voxel count that does not divide the
    device count takes the padded path (full device utilisation)
    instead of silently dropping devices, and results match the
    unsharded run (review finding)."""
    from fabber_core_tpu.options import RunOptions
    from fabber_core_tpu.runner import run as run_full
    from fabber_core_tpu.core.volume import VoxelDataStore

    rng = np.random.default_rng(5)
    n = dist.global_voxel_mesh().devices.size
    nv, nt = n * 3 + 1, 10   # prime-ish: does not divide n
    t = np.arange(1, nt + 1)
    c0, c1 = rng.uniform(-1, 1, nv), rng.uniform(-0.5, 0.5, nv)
    data = c0[:, None] + c1[:, None] * t[None] + rng.normal(0, .05, (nv, nt))
    geom = VolumeGeometry((nv, 1, 1))
    vol = data.reshape(nv, 1, 1, nt)

    def one(shard):
        o = {"model": "poly", "degree": "1", "method": "vb",
             "noise": "white", "max-iterations": "5", "save-mean": ""}
        if shard:
            o["shard-voxels"] = ""
        opts = RunOptions(o)
        store = VoxelDataStore(geom)
        store.set("data", vol)
        return run_full(opts, store)

    plain = one(False)
    sharded = one(True)
    assert sharded.outputs["mean_c0"].shape[0] == nv
    np.testing.assert_allclose(sharded.outputs["mean_c0"],
                               plain.outputs["mean_c0"], rtol=1e-6)
    np.testing.assert_allclose(sharded.outputs["mean_c1"],
                               plain.outputs["mean_c1"], rtol=1e-6)


def test_shard_engine_warns_on_device_drop():
    from fabber_core_tpu.options import RunOptions
    from fabber_core_tpu.models import get_model_class
    from fabber_core_tpu.inference.vb import VBInference
    from fabber_core_tpu.parallel.mesh import shard_engine
    import warnings

    nv = dist.global_voxel_mesh().devices.size * 2 + 1  # odd
    data = np.ones((nv, 6)) + 0.01 * np.random.default_rng(
        0).standard_normal((nv, 6))
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    opts = RunOptions({"model": "poly", "degree": "0", "noise": "white"})
    eng = VBInference(get_model_class("poly")(opts), opts, data, coords)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        mesh = shard_engine(eng)
    assert any("do not divide" in str(w.message) for w in rec)
    assert mesh.devices.size == 1  # documented pad-free fallback
