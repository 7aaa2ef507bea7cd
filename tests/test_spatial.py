"""Spatial VB tests: neighbour graphs, oracle parity of the Jacobi
sweep, smoothing behavior, and sharded-mesh equivalence."""

import numpy as np
import pytest

from fabber_core_tpu.core.neighbours import calc_neighbours, check_coords_ordered
from fabber_core_tpu.exceptions import FabberError
from fabber_core_tpu.inference.spatial import SpatialVBInference
from fabber_core_tpu.inference.vb import VBInference
from fabber_core_tpu.models import get_model_class
from fabber_core_tpu.options import RunOptions

from oracle_spatial import spatial_oracle_sweeps


def grid_coords(nx, ny, nz):
    """x-fastest (z-major) coordinate list, like VolumeGeometry."""
    coords = []
    for z in range(nz):
        for y in range(ny):
            for x in range(nx):
                coords.append([x, y, z])
    return np.array(coords, float)


def neigh_set(neigh, v):
    return {int(i) for i in neigh[v] if i >= 0}


class TestNeighbourGraph:
    """Semantics documented by the reference's (stale) spatialvb tests
    (test_spatialvb.cc:81-585)."""

    def test_line_1d(self):
        coords = grid_coords(5, 1, 1)
        neigh, neigh2 = calc_neighbours(coords, spatial_dims=1)
        assert neigh_set(neigh, 0) == {1}
        assert neigh_set(neigh, 2) == {1, 3}
        assert neigh_set(neigh, 4) == {3}
        # second neighbours: neighbours-of-neighbours excluding self
        assert sorted(i for i in neigh2[2] if i >= 0) == [0, 4]

    def test_cube_3d(self):
        coords = grid_coords(3, 3, 3)
        neigh, neigh2 = calc_neighbours(coords, spatial_dims=3)
        centre = 13  # (1,1,1)
        assert neigh_set(neigh, centre) == {12, 14, 10, 16, 4, 22}
        corner = 0
        assert neigh_set(neigh, corner) == {1, 3, 9}
        # diagonally-connected second neighbours appear twice
        n2 = [int(i) for i in neigh2[corner] if i >= 0]
        assert n2.count(4) == 2   # reachable via 1 and 3
        assert n2.count(10) == 2  # reachable via 1 and 9

    def test_irregular_mask(self):
        # L-shaped 2D region: (0,0),(1,0),(0,1)
        coords = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], float)
        neigh, _ = calc_neighbours(coords, spatial_dims=2)
        assert neigh_set(neigh, 0) == {1, 2}
        assert neigh_set(neigh, 1) == {0}
        assert neigh_set(neigh, 2) == {0}

    def test_no_wraparound(self):
        # two rows: (2,0) and (0,1) are adjacent in flat index but not
        # spatially
        coords = grid_coords(3, 2, 1)
        neigh, _ = calc_neighbours(coords, spatial_dims=2)
        assert 3 not in neigh_set(neigh, 2)
        assert neigh_set(neigh, 2) == {1, 5}

    def test_misordered_coords_rejected(self):
        coords = np.array([[1, 0, 0], [0, 0, 0]], float)
        with pytest.raises(FabberError):
            check_coords_ordered(coords)


def run_spatial(data, coords, opts_dict):
    options = RunOptions(opts_dict)
    model = get_model_class(options.get_string("model"))(options)
    eng = SpatialVBInference(model, options, data, coords)
    return eng, eng.run()


class TestSpatialOracle:
    @pytest.mark.parametrize("tcode", ["M", "m", "P", "p"])
    def test_matches_oracle_all_types(self, tcode):
        rng = np.random.default_rng(0)
        nx, ny, nz, nt = 4, 3, 2, 12
        coords = grid_coords(nx, ny, nz)
        nv = len(coords)
        t = np.arange(1, nt + 1, dtype=float)
        design = t[:, None] ** np.arange(2)[None, :]
        truth = 1.0 + 0.1 * coords[:, 0]
        data = (truth[:, None] + 0.05 * truth[:, None] * t[None, :]
                + rng.normal(0, 0.1, (nv, nt)))

        eng, res = run_spatial(data, coords, {
            "model": "poly", "degree": "1", "noise": "white",
            "method": "spatialvb", "param-spatial-priors": tcode * 2,
            "max-iterations": "5"})

        omeans, ocov, oak = spatial_oracle_sweeps(
            data, coords, design, niter=5, tcode=tcode)
        np.testing.assert_allclose(res.means, omeans, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(res.cov, ocov, rtol=1e-7, atol=1e-12)
        np.testing.assert_allclose(eng.final_ak, oak, rtol=1e-8)


class TestSpatialBehavior:
    def test_spatial_smooths_estimates(self):
        rng = np.random.default_rng(1)
        nx, ny, nz, nt = 6, 6, 1, 10
        coords = grid_coords(nx, ny, nz)
        nv = len(coords)
        # constant true signal + heavy noise
        data = 5.0 + rng.normal(0, 2.0, (nv, nt))

        opts = {"model": "poly", "degree": "0", "noise": "white",
                "max-iterations": "10"}
        options = RunOptions(dict(opts))
        model = get_model_class("poly")(options)
        vox = VBInference(model, options, data, coords).run()

        _, sp = run_spatial(data, coords, dict(
            opts, **{"method": "spatialvb", "param-spatial-priors": "M",
                     "spatial-dims": "2"}))

        # spatial smoothing should reduce across-voxel scatter
        assert sp.means[:, 0].std() < 0.7 * vox.means[:, 0].std()
        # and stay centred on the truth
        assert abs(sp.means[:, 0].mean() - 5.0) < 0.5

    def test_runner_dispatches_spatial_by_prior_type(self):
        """method=vb with spatial prior chars must route to spatial VB
        (inference_vb.cc:334-358)."""
        from fabber_core_tpu.api import FabberTpu
        rng = np.random.default_rng(2)
        shape, nt = (4, 4, 1), 8
        data = 3.0 + rng.normal(0, 1.0, shape + (nt,))
        run = FabberTpu().run_with_data({
            "model": "poly", "degree": "0", "method": "vb", "noise": "white",
            "param-spatial-priors": "M", "spatial-dims": "2",
            "save-mean": True, "max-iterations": "5"}, {"data": data})
        assert "mean_c0" in run.data


class TestSpatialSharded:
    def test_sharded_matches_single_device(self):
        """The same jitted sweep under an 8-device voxel sharding must
        produce identical results (GSPMD inserts the halo gathers +
        psum)."""
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        rng = np.random.default_rng(3)
        nx, ny, nz, nt = 8, 4, 2, 10  # 64 voxels = 8 per device
        coords = grid_coords(nx, ny, nz)
        nv = len(coords)
        data = 2.0 + rng.normal(0, 0.5, (nv, nt))
        opts = {"model": "poly", "degree": "0", "noise": "white",
                "method": "spatialvb", "param-spatial-priors": "M",
                "max-iterations": "4"}

        _, res_single = run_spatial(data, coords, dict(opts))

        devices = jax.devices()
        assert len(devices) == 8
        mesh = Mesh(np.array(devices), ("v",))
        # SoA layout: voxel axis is last ([T,V])
        sharding = NamedSharding(mesh, P(None, "v"))

        options = RunOptions(dict(opts))
        model = get_model_class("poly")(options)
        eng = SpatialVBInference(model, options, data, coords)
        # shard the data along the voxel axis and rerun
        eng.data = jax.device_put(eng.data, sharding)
        res_sharded = eng.run()

        np.testing.assert_allclose(res_sharded.means, res_single.means,
                                   rtol=1e-12, atol=1e-12)


class TestSpatialAllNonspatial:
    """method=spatialvb with all-N priors is legal in the reference —
    the golden outdata_linear_spatialvb run uses exactly that — and
    must match voxelwise VB (no cross-voxel coupling, same updates,
    same fixed iteration budget)."""

    def test_all_n_matches_voxelwise(self):
        import numpy as np
        from fabber_core_tpu.options import RunOptions
        from fabber_core_tpu.models import get_model_class
        from fabber_core_tpu.inference.vb import VBInference
        from fabber_core_tpu.inference.spatial import SpatialVBInference

        rng = np.random.default_rng(4)
        nx, ny = 6, 5
        nv, nt = nx * ny, 20
        t = np.arange(1, nt + 1, dtype=float)
        data = 2.0 + 0.1 * t[None, :] + rng.normal(0, 0.3, (nv, nt))
        coords = np.array([[x, y, 0] for y in range(ny) for x in range(nx)],
                          float)
        base = {"model": "poly", "degree": "1", "noise": "white",
                "max-iterations": "10"}

        so = RunOptions({**base, "method": "spatialvb",
                         "param-spatial-priors": "N+", "spatial-dims": "2"})
        se = SpatialVBInference(get_model_class("poly")(so), so, data, coords)
        assert se.spatial_params == []
        rs = se.run()

        vo = RunOptions({**base, "convergence": "maxits"})
        ve = VBInference(get_model_class("poly")(vo), vo, data, coords)
        rv = ve.run()

        np.testing.assert_allclose(rs.means, rv.means, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(rs.noise_means, rv.noise_means, rtol=1e-8)


class TestDenseStencil:
    """The dense-grid stencil neighbour sums must equal the gather
    formulation exactly, on irregular masks and for P-type second
    neighbours (with duplicates, self excluded)."""

    @pytest.mark.parametrize("tcode", ["M", "P", "p", "m"])
    def test_dense_matches_gather(self, tcode):
        import numpy as np
        from fabber_core_tpu.options import RunOptions
        from fabber_core_tpu.models import get_model_class
        from fabber_core_tpu.inference.spatial import SpatialVBInference

        rng = np.random.default_rng(23)
        nx, ny = 7, 6
        keep = rng.random(nx * ny) > 0.25  # irregular mask
        coords = np.array([[x, y, 0] for y in range(ny) for x in range(nx)],
                          float)[keep]
        nv = len(coords)
        nt = 8
        data = 3.0 + rng.normal(0, 0.4, (nv, nt))

        def run(stencil):
            opts = RunOptions({
                "model": "poly", "degree": "0", "noise": "white",
                "method": "spatialvb", "param-spatial-priors": tcode,
                "spatial-dims": "2", "max-iterations": "5",
                "spatial-stencil": stencil})
            eng = SpatialVBInference(get_model_class("poly")(opts), opts,
                                     data, coords)
            if stencil == "dense":
                assert eng._dense is not None
            else:
                assert True
            return eng.run()

        rd = run("dense")
        rg = run("gather")
        np.testing.assert_allclose(rd.means, rg.means, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(rd.noise_means, rg.noise_means, rtol=1e-7)


def test_spatial_rejects_non_maxits_detector():
    """Unsupported detectors raise instead of being silently ignored
    (the reference hardcodes a counting detector for the spatial loop,
    inference_vb.cc:599-602)."""
    from fabber_core_tpu.exceptions import InvalidOptionValue
    nv, nt = 8, 6
    data = np.ones((nv, nt))
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    opts = RunOptions({"model": "poly", "degree": "0", "noise": "white",
                       "method": "spatialvb", "param-spatial-priors": "M",
                       "convergence": "trialmode"})
    with pytest.raises(InvalidOptionValue):
        SpatialVBInference(get_model_class("poly")(opts), opts, data,
                           coords)


def test_coefficient_resels_diagnostic():
    """After a spatial run the engine exposes the Penny-2005
    coefficient-resels diagnostic (inference_vb.cc:727-756) and the
    runner logs it; values are 1 - sigma_post/sigma_prior averaged over
    voxels, so in (0, 1) for an informative fit."""
    rng = np.random.default_rng(0)
    nx, ny, nt = 4, 8, 12
    nv = nx * ny
    t = np.arange(1, nt + 1, dtype=float)
    data = 1.0 + 0.1 * t[None, :] + rng.normal(0, 0.1, (nv, nt))
    coords = np.array([[x, y, 0] for y in range(ny) for x in range(nx)],
                      float)
    opts = RunOptions({"model": "poly", "degree": "1", "noise": "white",
                       "method": "spatialvb", "param-spatial-priors": "M+",
                       "spatial-dims": "2", "max-iterations": "4"})
    eng = SpatialVBInference(get_model_class("poly")(opts), opts, data,
                             coords)
    res = eng.run()
    gamma = eng.coefficient_resels
    assert gamma.shape == (2,)
    assert np.all(gamma > 0) and np.all(gamma <= 1.0)
    # posterior variances must be below the prior variances by exactly
    # the margin gamma reports (res.cov already checked finite by run)
    assert res.cov is not None

    # runner surface: the log line appears
    from fabber_core_tpu.api import FabberTpu
    vol = data.reshape(4, 4, 2, nt, order="F").astype(np.float32)
    run = FabberTpu().run_with_data(
        {"model": "poly", "degree": "1", "noise": "white",
         "method": "spatialvb", "param-spatial-priors": "M+",
         "max-iterations": "4", "save-mean": True}, {"data": vol})
    assert "Coefficient resels per voxel for param 1" in run.log


def test_mixed_spatial_nonspatial_priors_p4(tmp_path):
    """BASELINE config 5 shape: 4-parameter linear model with combined
    spatial (M) and non-spatial (N) priors — the bench's spatial-p4
    config. The spatial parameters are smoothed toward their neighbours
    while the N parameters keep per-voxel estimates; everything must
    stay finite and recover the simulated coefficients."""
    rng = np.random.default_rng(8)
    nx, ny, nt = 8, 8, 40
    nv = nx * ny
    t = np.arange(nt, dtype=float)
    design = np.stack([np.ones(nt), t / nt, np.sin(t / 3.0),
                       np.cos(t / 3.0)], axis=1)
    dfile = str(tmp_path / "design_p4.txt")
    np.savetxt(dfile, design)
    coords = np.array([[x, y, 0] for y in range(ny) for x in range(nx)],
                      float)
    # spatial (M) parameters get smooth truth fields — the MRF shrinks
    # toward neighbours, so a white random field would be biased by
    # design; the non-spatial (N) parameters stay white
    xs, ys = coords[:, 0] / nx, coords[:, 1] / ny
    truth = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * xs),
                      0.5 * np.cos(2 * np.pi * ys),
                      rng.uniform(-1, 1, nv),
                      rng.uniform(-1, 1, nv)], axis=1)
    data = truth @ design.T + rng.normal(0, 0.05, (nv, nt))
    opts = RunOptions({"model": "linear", "basis": dfile,
                       "noise": "white", "method": "spatialvb",
                       "param-spatial-priors": "MMNN",
                       "spatial-dims": "2", "max-iterations": "6"})
    eng = SpatialVBInference(get_model_class("linear")(opts), opts, data,
                             coords)
    assert [p.prior_type for p in eng.params] == ["M", "M", "N", "N"]
    res = eng.run()
    assert not res.bad_voxels.any()
    assert np.isfinite(res.means).all()
    # both prior families recover the coefficients on clean-ish data
    err = np.abs(res.means - truth).mean(axis=0)
    assert np.all(err < 0.05), err
