"""NLLS fixed-design sufficient-statistics route (inference/nlls.py
fast tier): must agree with the generic per-iteration-Jacobian route,
and windowed execution must not change results."""

import numpy as np

from fabber_core_tpu.inference.nlls import NLLSInference
from fabber_core_tpu.models import get_model_class
from fabber_core_tpu.options import RunOptions


def _mkdata(rng, nv, nt):
    t = np.arange(1, nt + 1, dtype=float)
    c0 = rng.uniform(-1, 1, nv)
    c1 = rng.uniform(-0.05, 0.05, nv)
    data = (c0[:, None] + c1[:, None] * t[None, :]
            + rng.normal(0, 0.1, (nv, nt)))
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    return data, coords


def _engine(data, coords, extra=None):
    opts = {"model": "poly", "degree": "1", "method": "nlls"}
    opts.update(extra or {})
    options = RunOptions(opts)
    return NLLSInference(get_model_class("poly")(options), options,
                         data, coords)


def test_stats_route_selected_and_matches_generic():
    rng = np.random.default_rng(11)
    data, coords = _mkdata(rng, 64, 40)

    fast = _engine(data, coords)
    assert fast.use_stats, "poly should land on the fixed-design tier"
    res_fast = fast.run()

    slow = _engine(data, coords)
    slow.design = None
    slow.use_stats = False  # force the generic route on the same fit
    res_slow = slow.run()

    np.testing.assert_allclose(res_fast.means, res_slow.means,
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(res_fast.cov, res_slow.cov,
                               rtol=1e-6, atol=1e-12)
    assert not res_fast.bad_voxels.any()

    # both routes recover the simulated coefficients
    lsq = np.array([np.polyfit(np.arange(1, 41, dtype=float), d, 1)[::-1]
                    for d in data])
    np.testing.assert_allclose(res_fast.means, lsq, rtol=1e-5, atol=1e-6)


def test_nlls_windowed_equals_single_pass():
    rng = np.random.default_rng(4)
    data, coords = _mkdata(rng, 103, 30)  # odd count: slid final window

    full = _engine(data, coords).run()
    win = _engine(data, coords, {"voxel-chunk-size": "40"}).run()
    np.testing.assert_array_equal(full.means, win.means)
    np.testing.assert_array_equal(full.cov, win.cov)
    np.testing.assert_array_equal(full.iterations, win.iterations)


def test_nlls_windowed_generic_route():
    """Windowing on the generic (nonlinear-model) route too."""
    rng = np.random.default_rng(9)
    nv, nt, dt = 53, 24, 0.05
    t = np.arange(nt) * dt
    amp = rng.uniform(0.6, 1.4, nv)
    data = amp[:, None] * np.exp(-t)[None, :] \
        + rng.normal(0, 0.05, (nv, nt))
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    opts = {"model": "exp", "dt": str(dt), "method": "nlls"}

    def run(extra):
        options = RunOptions({**opts, **extra})
        eng = NLLSInference(get_model_class("exp")(options), options,
                            data, coords)
        assert not eng.use_stats
        return eng.run()

    full = run({})
    win = run({"voxel-chunk-size": "20"})
    np.testing.assert_array_equal(full.means, win.means)
    np.testing.assert_array_equal(full.iterations, win.iterations)


def test_masked_timepoints_on_stats_route():
    rng = np.random.default_rng(2)
    data, coords = _mkdata(rng, 32, 40)
    data[:, 4] = 1e6  # corrupted timepoint, masked out below
    data[:, 17] = -1e6

    fast = _engine(data, coords, {"mt1": "5", "mt2": "18"})
    assert fast.use_stats
    res = fast.run()

    clean = np.delete(np.arange(40), [4, 17])
    t = np.arange(1, 41, dtype=float)
    lsq = np.array([np.polyfit(t[clean], d[clean], 1)[::-1]
                    for d in data])
    np.testing.assert_allclose(res.means, lsq, rtol=1e-5, atol=1e-6)
