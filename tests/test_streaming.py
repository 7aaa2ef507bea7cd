"""In-program chunk streaming (vb.py compiled_streamed) must be
bit-identical to host-side per-window dispatches on every route.

The streamed path exists to break the single-dispatch volume ceiling
(one compiled program scans over fixed-size voxel windows, so a
whole-brain volume costs ONE dispatch instead of one serialized
round trip per window); these tests pin that it is a pure execution-
strategy change with no numerical surface.
"""

import numpy as np
import pytest

from fabber_core_tpu.inference.vb import VBInference
from fabber_core_tpu.models import get_model_class
from fabber_core_tpu.options import RunOptions


def _run(data, coords, extra):
    opts = {"noise": "white", "max-iterations": "6",
            "save-free-energy": True, "voxel-chunk-size": "40"}
    opts.update(extra)
    options = RunOptions(opts)
    model = get_model_class(options.get_string("model"))(options)
    eng = VBInference(model, options, data, coords)
    res = eng.run()
    return res, eng


def _mkdata(rng, nv, nt, kind):
    t = np.arange(nt) * 0.05
    if kind == "exp":
        amp = rng.uniform(0.5, 2.0, nv)
        clean = amp[:, None] * np.exp(-t)[None, :]
    else:
        c0 = rng.uniform(-1, 1, nv)
        clean = c0[:, None] + 0.05 * t[None, :]
    data = clean + rng.normal(0, 0.05, (nv, nt))
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    return data, coords


def _assert_same(a, b):
    np.testing.assert_array_equal(a.means, b.means)
    np.testing.assert_array_equal(a.cov, b.cov)
    np.testing.assert_array_equal(a.noise_means, b.noise_means)
    np.testing.assert_array_equal(a.noise_cov, b.noise_cov)
    np.testing.assert_array_equal(a.free_energy, b.free_energy)
    np.testing.assert_array_equal(a.iterations, b.iterations)


@pytest.mark.parametrize("extra,kind,route_attr", [
    # generic-Jacobian XLA route, F-detector with save/revert lanes
    ({"model": "exp", "dt": "0.05", "convergence": "trialmode"},
     "exp", None),
    # fixed-design stats route (double)
    ({"model": "poly", "degree": "1"}, "poly", "use_stats"),
    # spectral eigenbasis route (f32, forced on the CPU)
    ({"model": "poly", "degree": "1", "dtype": "single",
      "engine-kernel": "spectral"}, "poly", "use_spectral"),
    # spectral route with its in-loop F-based detector
    ({"model": "poly", "degree": "1", "dtype": "single",
      "engine-kernel": "spectral", "convergence": "pointzeroone"},
     "poly", "use_spectral_fdet"),
    # generic-Jacobian route in float32 with an F-based detector
    ({"model": "exp", "dt": "0.05", "dtype": "single",
      "convergence": "pointzeroone"}, "exp", None),
])
def test_streamed_equals_host_chunked(extra, kind, route_attr):
    rng = np.random.default_rng(7)
    nv, nt = 103, 24  # odd count exercises the slid final window
    data, coords = _mkdata(rng, nv, nt, kind)

    streamed, eng_s = _run(data, coords, extra)
    hosted, eng_h = _run(data, coords,
                         {**extra, "chunk-streaming": "off"})
    if route_attr is not None:
        assert getattr(eng_s, route_attr), \
            f"config did not land on the intended route ({route_attr})"
    _assert_same(streamed, hosted)


def test_streamed_fhistory_matches():
    rng = np.random.default_rng(3)
    nv, nt = 90, 24
    data, coords = _mkdata(rng, nv, nt, "exp")
    extra = {"model": "exp", "dt": "0.05", "convergence": "pointzeroone",
             "save-free-energy-history": True}
    streamed, _ = _run(data, coords, extra)
    hosted, _ = _run(data, coords, {**extra, "chunk-streaming": "off"})
    rows = min(streamed.fhistory.shape[0], hosted.fhistory.shape[0])
    # shared rows identical; both end with the final (reverted) F row
    np.testing.assert_array_equal(streamed.fhistory[:rows - 1],
                                  hosted.fhistory[:rows - 1])
    np.testing.assert_array_equal(streamed.fhistory[-1],
                                  hosted.fhistory[-1])


def test_stream_chunk_gates_on_residents():
    """_stream_chunk returns None when the volume-scale residents
    (data plane + result planes) don't fit the device budget."""
    import os
    rng = np.random.default_rng(0)
    nv, nt = 256, 16
    data, coords = _mkdata(rng, nv, nt, "poly")
    options = RunOptions({"model": "poly", "degree": "1",
                          "noise": "white", "max-iterations": "2"})
    eng = VBInference(get_model_class("poly")(options), options,
                      data, coords)
    old = os.environ.get("FABBER_TPU_MEM_GB")
    try:
        os.environ["FABBER_TPU_MEM_GB"] = "1e-7"  # ~100 bytes
        assert eng._stream_chunk() is None
    finally:
        if old is None:
            os.environ.pop("FABBER_TPU_MEM_GB")
        else:
            os.environ["FABBER_TPU_MEM_GB"] = old


def test_streamed_map_path_equals_host():
    """Equal-window volumes take the carry-free lax.map path
    (nv % nwin == 0 -> compiled_streamed_map); results identical to
    host-side windows."""
    rng = np.random.default_rng(12)
    nv, nt = 120, 24  # chunk 40 -> nwin 3 -> 120 % 3 == 0: map path
    data, coords = _mkdata(rng, nv, nt, "poly")
    extra = {"model": "poly", "degree": "1"}
    streamed, eng = _run(data, coords, extra)
    # confirm the division actually selects the map path
    assert nv % (-(-nv // 40)) == 0
    hosted, _ = _run(data, coords, {**extra, "chunk-streaming": "off"})
    _assert_same(streamed, hosted)
