"""The generic-Jacobian XLA route, which serves every model without a
fixed design (exp, biexp, plugins) on every backend, against the
float64 NumPy oracle (tests/oracle.py): models with P of 2-4, T that is
not a power of two, float32 and float64, with and without the free
energy, voxelwise image priors, and the F-based detectors replayed on
the oracle's own free-energy history.

float32 comparisons run 3 iterations: biexp from its default start is
ill-conditioned and float32 rounding grows ~30x per iteration, so
deeper float32 runs measure the conditioning, not the route."""

import numpy as np
import pytest

import oracle
from fabber_core_tpu.inference.vb import VBInference
from fabber_core_tpu.models import get_model_class
from fabber_core_tpu.models.base import DistParams, Model, ParamSpec
from fabber_core_tpu.options import RunOptions

DT = 0.05


class SineModel(Model):
    """Identity-transformed parameters on a sinusoidal basis: P=3
    (sine3) or P=4 with no exchange symmetry (asym4), so every route
    has one fixed point. No fixed_design: the generic route serves it."""

    def __init__(self, nparams):
        self.name = f"sine{nparams}test"
        self.nparams = nparams

    def param_defaults(self):
        return [ParamSpec(i, f"c{i}", DistParams(0, 100), DistParams(0, 10))
                for i in range(self.nparams)]

    @staticmethod
    def basis(nt, nparams, xp=np, dtype=float):
        t = xp.arange(nt, dtype=dtype) * DT
        cols = [xp.ones_like(t), xp.sin(np.pi * t), xp.cos(2 * np.pi * t),
                xp.sin(3 * np.pi * t)]
        return xp.stack(cols[:nparams], 1)

    def evaluate(self, params, ctx, key=""):
        import jax.numpy as jnp
        return self.basis(ctx.nt, self.nparams, jnp, params.dtype) @ params


MODELS = {"exp": 2, "biexp": 4, "sine3": 3, "asym4": 4}


def latent_signal(model, nt):
    """Oracle forward model in latent space: (p -> signal, p -> [T,P])."""
    if model in ("sine3", "asym4"):
        d = SineModel.basis(nt, MODELS[model])
        return (lambda p: d @ p), (lambda p: d)
    t = np.arange(nt) * DT

    def jac(p):
        cols = []
        for a, r in zip(np.exp(p[0::2]), np.exp(p[1::2])):
            e = a * np.exp(-r * t)
            cols += [e, -r * t * e]
        return np.stack(cols, 1)
    return (lambda p: jac(p)[:, 0::2].sum(1)), jac


def make_data(model, nv, nt, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(nt) * DT
    if model in ("sine3", "asym4"):
        c = rng.uniform(0.5, 1.5, (nv, MODELS[model]))
        clean = c @ SineModel.basis(nt, MODELS[model]).T
    else:
        amp = rng.uniform(0.5, 2.0, (nv, 1))
        clean = amp * np.exp(-t)[None, :]
        if model == "biexp":
            clean = clean + 0.5 * amp * np.exp(-5 * t)[None, :]
    return clean + rng.normal(0, 0.05, (nv, nt))


def engine(model, data, extra=None, getter=None):
    nv = data.shape[0]
    o = RunOptions({"model": model, "dt": str(DT), "noise": "white",
                    "max-iterations": "3", **(extra or {})})
    m = SineModel(MODELS[model]) if model in ("sine3", "asym4") \
        else get_model_class(model)(o)
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    eng = VBInference(m, o, data, coords, voxel_data_getter=getter)
    assert eng.route_description() == "generic-Jacobian XLA route"
    return eng


def oracle_at(eng, model, data, v, niter, prior_mean=None, **kw):
    sig, jac = latent_signal(model, eng.nt)
    pm = np.array([s.prior.mean for s in eng.params]) \
        if prior_mean is None else prior_mean
    pp = np.array([1.0 / s.prior.var for s in eng.params])
    m0 = np.asarray(eng.initial_state().post.means, np.float64).T[v]
    return oracle.vb_voxel(sig, jac, np.asarray(data[v], np.float64), pm,
                           pp, m0, np.ones(len(pp)), niter, **kw)


def assert_voxel(res, ref, v, dtype, need_f=True):
    sd = np.sqrt(np.diag(ref["cov"]))
    phi = ref["phi_b"][0] * ref["phi_c"][0]
    if dtype == "double":
        np.testing.assert_allclose(res.means[v], ref["means"], rtol=1e-7,
                                   atol=1e-9 * np.max(sd))
        np.testing.assert_allclose(res.cov[v], ref["cov"], rtol=1e-7,
                                   atol=1e-9 * np.max(sd) ** 2)
        np.testing.assert_allclose(res.noise_means[v, 0], phi, rtol=1e-7)
        if need_f:
            np.testing.assert_allclose(res.free_energy[v], ref["F"],
                                       rtol=1e-7)
    else:
        assert np.max(np.abs(res.means[v] - ref["means"]) / sd) < 2e-3
        np.testing.assert_allclose(res.cov[v], ref["cov"], rtol=2e-3,
                                   atol=1e-3 * np.max(sd) ** 2)
        np.testing.assert_allclose(res.noise_means[v, 0], phi, rtol=2e-3)
        if need_f:
            np.testing.assert_allclose(res.free_energy[v], ref["F"],
                                       rtol=1e-4, atol=2e-2)


@pytest.mark.parametrize("need_f", [False, True], ids=["noF", "F"])
@pytest.mark.parametrize("dtype", ["single", "double"])
@pytest.mark.parametrize("nt", [23, 40])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_generic_route_matches_oracle(model, nt, dtype, need_f):
    nv = 37
    data = make_data(model, nv, nt, seed=nt + MODELS[model])
    niter = 3 if dtype == "single" else 6
    eng = engine(model, data, {"dtype": dtype, "max-iterations": str(niter),
                               "save-free-energy": need_f})
    res = eng.run()
    assert np.isfinite(res.means).all() and not res.bad_voxels.any()
    assert (res.free_energy is not None) == need_f
    np.testing.assert_array_equal(res.iterations, niter)
    for v in (0, nv // 2, nv - 1):
        assert_voxel(res, oracle_at(eng, model, data, v, niter), v, dtype,
                     need_f)


@pytest.mark.parametrize("det", ["maxits", "pointzeroone", "freduce"])
@pytest.mark.parametrize("model", ["exp", "sine3", "asym4"])
def test_generic_detectors_match_oracle(model, det):
    """Each lane stops where the detector, replayed on the oracle's F
    history, stops it, and holds the oracle's posterior there."""
    max_its, nv = 12, 24
    data = make_data(model, nv, 30, seed=4)
    eng = engine(model, data, {"convergence": det, "dtype": "double",
                               "max-iterations": str(max_its),
                               "save-free-energy": True})
    res = eng.run()
    m0 = np.asarray(eng.initial_state().post.means, np.float64).T
    for v in range(nv):
        if det == "maxits":
            n, its, reverted = max_its, max_its, False
        else:
            full = oracle_at(eng, model, data, v, max_its + 2)
            n, its, reverted = oracle.replay_detector(full["F_history"], max_its,
                                               0.01, det == "freduce")
        assert its == res.iterations[v], v
        if reverted:
            np.testing.assert_allclose(res.means[v], m0[v], rtol=1e-12)
        else:
            assert_voxel(res, oracle_at(eng, model, data, v, n), v,
                         "double")


@pytest.mark.parametrize("dtype", ["single", "double"])
@pytest.mark.parametrize("model", ["exp", "sine3"])
def test_generic_image_prior_matches_oracle(model, dtype):
    """A voxelwise image prior on the first parameter: each voxel's
    prior mean is its image value (in latent space, as every prior mean
    the engine holds)."""
    nv, nt = 16, 24
    data = make_data(model, nv, nt, seed=11)
    img = np.linspace(0.5, 1.5, nv)
    extra = {"dtype": dtype, "save-free-energy": True,
             "PSP_byname1": "c0" if model == "sine3" else "amp1",
             "PSP_byname1_type": "I", "PSP_byname1_image": "prior_img"}
    eng = engine(model, data, extra, getter=lambda key: img[:, None])
    res = eng.run()
    for v in range(0, nv, 5):
        pm = np.array([s.prior.mean for s in eng.params])
        pm[0] = img[v]
        assert_voxel(res, oracle_at(eng, model, data, v, 3, prior_mean=pm),
                     v, dtype)


@pytest.mark.parametrize("det", ["maxits", "pointzeroone", "freduce",
                                 "trialmode"])
@pytest.mark.parametrize("model", ["exp", "biexp"])
def test_generic_route_sharded_equals_one_device(model, det):
    """--shard-voxels on the 8-device CPU mesh, with a voxel count the
    mesh does not divide (padded): every lane equals the one-device
    run. The route is lane-local, so the shards run the same
    arithmetic."""
    from fabber_core_tpu.parallel import distributed as dist
    nv = 203
    data = make_data(model, nv, 24, seed=9)
    extra = {"convergence": det, "max-iterations": "8", "dtype": "double",
             "save-free-energy": True, "allow-bad-voxels": True}
    plain = engine(model, data, extra)
    r1 = plain.run()
    eng, v_real = dist.build_engine_sharded(
        VBInference, plain.model, plain.options, data,
        np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1),
        mesh=dist.global_voxel_mesh())
    assert eng.mesh.devices.size == 8 and v_real == nv
    r8 = dist.slice_result(eng.run(), v_real)
    np.testing.assert_array_equal(r8.iterations, r1.iterations)
    np.testing.assert_array_equal(r8.bad_voxels, r1.bad_voxels)
    np.testing.assert_allclose(r8.means, r1.means, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(r8.noise_means, r1.noise_means, rtol=1e-10)
    np.testing.assert_allclose(r8.free_energy, r1.free_energy, rtol=1e-10)
