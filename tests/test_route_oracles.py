"""Configurations whose removed whole-loop kernels used to serve them,
run through the XLA routes that serve them now, and pinned against the NumPy oracles
(tests/oracle.py, tests/oracle_ar.py): multi-group noise patterns,
masked timepoints, locked and prior-set noise, the F-based detectors
(the detector replayed on the oracle's own free-energy history), the
save/revert detectors, AR(1) noise with one and two echoes, and
streamed voxel windows."""

import numpy as np
import pytest

import oracle
import oracle_ar
from fabber_core_tpu.inference.vb import VBInference
from fabber_core_tpu.models import get_model_class
from fabber_core_tpu.noise.white import parse_noise_pattern
from fabber_core_tpu.options import RunOptions

def poly_data(nv, nt, seed, degree=1):
    rng = np.random.default_rng(seed)
    t = np.arange(1, nt + 1)
    c = rng.uniform(-1, 1, (nv, degree + 1)) * 0.1 ** np.arange(degree + 1)
    sd = rng.uniform(0.02, 0.5, (nv, 1))   # lanes converge at their pace
    return c @ (t[None, :] ** np.arange(degree + 1)[:, None]) \
        + sd * rng.standard_normal((nv, nt))


def exp_data(nv, nt, seed, dt=0.05):
    rng = np.random.default_rng(seed)
    t = np.arange(nt) * dt
    amp = rng.uniform(0.5, 2.0, (nv, 1))
    return amp * np.exp(-t)[None, :] + rng.normal(0, 0.05, (nv, nt))


def run(model, data, extra):
    nv = data.shape[0]
    opts = {"model": model, "noise": "white", "max-iterations": "6",
            "save-free-energy": True, **extra}
    if model == "poly":
        opts.setdefault("degree", "1")
    if model == "exp":
        opts["dt"] = "0.05"
    o = RunOptions(opts)
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    eng = VBInference(get_model_class(model)(o), o, data, coords)
    return eng, eng.run()


def forward(eng, model):
    """Oracle model functions in latent space."""
    nt = eng.nt
    if model == "poly":
        d = np.asarray(eng.model.fixed_design(nt), np.float64)
        return lambda p: d @ p, lambda p: d
    t = np.arange(nt) * 0.05

    def jac(p):
        s = np.exp(p[0]) * np.exp(-np.exp(p[1]) * t)
        return np.stack([s, -np.exp(p[1]) * t * s], 1)
    return lambda p: jac(p)[:, 0], jac


def qmasks_of(pattern, nt, masked=()):
    ids, nq = parse_noise_pattern(pattern, nt)
    q = np.zeros((nq, nt))
    q[ids, np.arange(nt)] = 1.0
    q[:, [m - 1 for m in masked]] = 0.0
    return q


def oracle_for(eng, model, data, v, niter, qmasks=None, **kw):
    sig, jac = forward(eng, model)
    pm = np.array([s.prior.mean for s in eng.params])
    pp = np.array([1.0 / s.prior.var for s in eng.params])
    m0 = np.asarray(eng.initial_state().post.means, np.float64).T[v]
    return oracle.vb_voxel(sig, jac, np.asarray(data[v], np.float64), pm,
                           pp, m0, np.ones(len(pm)), niter, qmasks=qmasks,
                           **kw)


def assert_close(res, ref, v, dtype):
    """float64: the oracle's own precision; float32: in posterior sd."""
    if dtype == "double":
        np.testing.assert_allclose(res.means[v], ref["means"], rtol=1e-8,
                                   atol=1e-9)
        np.testing.assert_allclose(res.noise_means[v],
                                   ref["phi_b"] * ref["phi_c"], rtol=1e-8)
        np.testing.assert_allclose(res.free_energy[v], ref["F"],
                                   rtol=1e-8)
    else:
        sd = np.sqrt(np.diag(ref["cov"]))
        assert np.max(np.abs(res.means[v] - ref["means"]) / sd) < 1e-3
        np.testing.assert_allclose(res.noise_means[v],
                                   ref["phi_b"] * ref["phi_c"], rtol=1e-3)


NOISE_CASES = {
    "pattern-12": ({"noise-pattern": "12"}, {"pattern": "12"}),
    "pattern-123": ({"noise-pattern": "123"}, {"pattern": "123"}),
    "pattern-1122": ({"noise-pattern": "1122"}, {"pattern": "1122"}),
    "masked": ({"mt1": "3", "mt2": "7"}, {"masked": (3, 7)}),
    "locked-sd": ({"locked-noise-stdev": "0.2"}, {"locked_sd": 0.2}),
    "phiprior": ({"prior-noise-stddev": "0.3"}, {"phiprior": 0.3}),
    "one-iteration": ({"max-iterations": "1"}, {"niter": 1}),
}


def noise_oracle_args(case, nt):
    spec = NOISE_CASES[case][1]
    kw = {"qmasks": qmasks_of(spec.get("pattern", "1"), nt,
                              spec.get("masked", ()))}
    if "locked_sd" in spec:
        kw["locked_sd"] = spec["locked_sd"]
    if "phiprior" in spec:
        b = 1.0 / (spec["phiprior"] ** 2 * 0.5)
        kw.update(prior_b=b, prior_c=0.5, post_b0=b, post_c0=0.5)
    return kw, spec.get("niter", 6)


@pytest.mark.parametrize("dtype", ["double", "single"])
@pytest.mark.parametrize("route", ["stats", "direct"])
@pytest.mark.parametrize("case", sorted(NOISE_CASES))
def test_fixed_design_noise_configs_match_oracle(case, route, dtype):
    nt = 24
    data = poly_data(6, nt, seed=len(case))
    eng, res = run("poly", data, {**NOISE_CASES[case][0], "dtype": dtype,
                                  "fixed-design-route": route})
    assert (route == "stats") == eng.use_stats
    kw, niter = noise_oracle_args(case, nt)
    for v in range(data.shape[0]):
        assert_close(res, oracle_for(eng, "poly", data, v, niter, **kw),
                     v, dtype)


@pytest.mark.parametrize("case", ["pattern-12", "masked", "locked-sd",
                                  "phiprior"])
def test_generic_route_noise_configs_match_oracle(case):
    nt = 24
    data = exp_data(5, nt, seed=3)
    eng, res = run("exp", data, {**NOISE_CASES[case][0], "dtype": "double"})
    assert "generic-Jacobian" in eng.route_description()
    kw, niter = noise_oracle_args(case, nt)
    for v in range(data.shape[0]):
        assert_close(res, oracle_for(eng, "exp", data, v, niter, **kw), v,
                     "double")


@pytest.mark.parametrize("det", ["pointzeroone", "freduce"])
@pytest.mark.parametrize("route", ["stats", "spectral", "generic"])
def test_f_detectors_match_oracle(route, det):
    max_its = 12
    model = "exp" if route == "generic" else "poly"
    data = (exp_data(24, 30, seed=4) if model == "exp"
            else poly_data(24, 30, seed=4))
    dtype = "single" if route == "spectral" else "double"
    extra = {"convergence": det, "max-iterations": str(max_its),
             "dtype": dtype}
    if route == "spectral":
        extra["engine-kernel"] = "spectral"
    eng, res = run(model, data, extra)
    assert (route == "spectral") == eng.use_spectral_fdet
    m0 = np.asarray(eng.initial_state().post.means, np.float64).T
    flips = 0
    for v in range(data.shape[0]):
        full = oracle_for(eng, model, data, v, max_its + 2)
        n, its, reverted = oracle.replay_detector(full["F_history"], max_its,
                                           0.01, det == "freduce")
        if its != res.iterations[v]:
            flips += 1   # |dF| within float32 roundoff of the threshold
            continue
        if reverted:
            np.testing.assert_allclose(res.means[v], m0[v], rtol=1e-6)
            continue
        assert_close(res, oracle_for(eng, model, data, v, n), v, dtype)
    assert flips <= (1 if dtype == "single" else 0)
    assert len(np.unique(res.iterations)) > 1


@pytest.mark.parametrize("det", ["trialmode", "lm"])
def test_save_revert_detectors_stats_equals_direct(det):
    """trialmode / lm run on the XLA routes only: the sufficient-
    statistics and direct fixed-design arithmetic agree lane for lane."""
    data = poly_data(32, 30, seed=6)
    extra = {"convergence": det, "max-iterations": "15", "dtype": "double"}
    _, rs = run("poly", data, extra)
    _, rd = run("poly", data, {**extra, "fixed-design-route": "direct"})
    np.testing.assert_array_equal(rs.iterations, rd.iterations)
    np.testing.assert_allclose(rs.means, rd.means, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(rs.free_energy, rd.free_energy, rtol=1e-8)


def test_trialmode_spectral_equals_stats():
    data = poly_data(32, 30, seed=8).astype(np.float32)
    extra = {"convergence": "trialmode", "max-iterations": "15",
             "dtype": "single"}
    _, rs = run("poly", data, extra)
    eng, rp = run("poly", data, {**extra, "engine-kernel": "spectral"})
    assert eng.use_spectral_fdet
    flip = rs.iterations != rp.iterations
    assert flip.sum() <= 1
    sd = np.sqrt(np.diagonal(rs.cov[~flip], axis1=1, axis2=2))
    assert np.max(np.abs(rs.means[~flip] - rp.means[~flip]) / sd) < 1e-3


def ar_series(nv, nt, nphis, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(1, nt + 1)
    clean = rng.uniform(0.5, 1.5, (nv, 1)) + 0.02 * t[None, :]
    e = np.zeros((nv, nt))
    per = nt // nphis
    for q in range(nphis):
        w = rng.normal(0, 0.3, (nv, per))
        for i in range(1, per):
            w[:, i] += 0.4 * w[:, i - 1]
        e[:, q::nphis] = w
    return clean + e


@pytest.mark.parametrize("det", ["pointzeroone", "freduce"])
@pytest.mark.parametrize("nphis", [1, 2])
def test_ar_detectors_match_oracle(nphis, det):
    nt, max_its = 20 * nphis, 10
    data = ar_series(10, nt, nphis, seed=nphis)
    o = RunOptions({"model": "poly", "degree": "1", "noise": "ar",
                    "num-echoes": str(nphis), "convergence": det,
                    "max-iterations": str(max_its), "save-free-energy": True})
    coords = np.stack([np.arange(10), np.zeros(10), np.zeros(10)], 1)
    eng = VBInference(get_model_class("poly")(o), o, data, coords)
    res = eng.run()
    design = np.asarray(eng.model.fixed_design(nt), np.float64)
    for v in range(10):
        def orc(n):
            return oracle_ar.ar_vb_voxel(
                data[v], design, np.zeros(2), np.full(2, 1e-12), n,
                nphis=nphis, compute_f=True)
        n, its, reverted = oracle.replay_detector(orc(max_its + 2)["F_history"],
                                           max_its, 0.01, det == "freduce")
        assert its == res.iterations[v]
        if reverted:
            np.testing.assert_allclose(res.means[v], 0.0, atol=1e-12)
            continue
        ref = orc(n)
        np.testing.assert_allclose(res.means[v], ref["means"], rtol=1e-7,
                                   atol=1e-10)
        np.testing.assert_allclose(res.free_energy[v], ref["F"], rtol=1e-7)


@pytest.mark.parametrize("route", ["stats", "spectral", "generic",
                                   "generic-single"])
def test_streamed_windows_match_oracle(route):
    """Volumes larger than one voxel window stream the windows inside
    one compiled program (inference/vb.py compiled_streamed); every
    window, the slid last one included, matches the oracle."""
    model = "poly" if route in ("stats", "spectral") else "exp"
    nv, nt = 45, 20
    data = (poly_data(nv, nt, seed=2) if model == "poly"
            else exp_data(nv, nt, seed=2))
    dtype = "double" if route in ("stats", "generic") else "single"
    extra = {"voxel-chunk-size": "16", "dtype": dtype,
             "engine-kernel": "spectral" if route == "spectral" else "xla"}
    eng, res = run(model, data, extra)
    assert eng._chunk_size() < nv
    assert eng.use_spectral == (route == "spectral")
    for v in (0, 15, 16, 31, 32, nv - 1):
        assert_close(res, oracle_for(eng, model, data, v, 6), v, dtype)


@pytest.mark.parametrize("det", ["maxits", "pointzeroone", "freduce",
                                 "trialmode"])
def test_spectral_routes_sharded_equal_one_device(det):
    """The spectral routes run per shard under shard_map on the 8-device
    CPU mesh, padded to the mesh, and match the one-device run lane for
    lane."""
    from fabber_core_tpu.parallel import distributed as dist
    nv, nt = 203, 30
    data = poly_data(nv, nt, seed=12).astype(np.float32)
    o = RunOptions({"model": "poly", "degree": "1", "noise": "white",
                    "dtype": "single", "engine-kernel": "spectral",
                    "convergence": det, "max-iterations": "8",
                    "save-free-energy": True})
    model = get_model_class("poly")(o)
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    eng, v_real = dist.build_engine_sharded(
        VBInference, model, o, data, coords, mesh=dist.global_voxel_mesh())
    assert eng.mesh.devices.size == 8
    assert eng.use_spectral or eng.use_spectral_fdet
    r8 = dist.slice_result(eng.run(), v_real)
    r1 = VBInference(model, o, data, coords).run()
    np.testing.assert_array_equal(r8.iterations, r1.iterations)
    np.testing.assert_allclose(r8.means, r1.means, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(r8.noise_means, r1.noise_means, rtol=1e-6)
    np.testing.assert_allclose(r8.free_energy, r1.free_energy, rtol=1e-6)
