"""Route selection and the platform decisions (fabber_core_tpu/devices.py):
which route auto takes on each backend, removed engine-kernel values,
the device-memory budget, and the compile-cache directory rule."""

import os
import subprocess
import sys

import numpy as np
import pytest

from fabber_core_tpu import devices
from fabber_core_tpu.exceptions import InvalidOptionValue
from fabber_core_tpu.inference.vb import ENGINE_KERNELS, VBInference
from fabber_core_tpu.models import get_model_class
from fabber_core_tpu.options import RunOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(extra, model="exp", nv=64, nt=20):
    rng = np.random.default_rng(0)
    data = (1.0 + 0.1 * rng.standard_normal((nv, nt))).astype(np.float32)
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    opts = {"model": model, "noise": "white", "dtype": "single",
            "max-iterations": "5", **extra}
    if model in ("exp", "biexp"):
        opts["dt"] = "0.05"
    if model == "poly":
        opts["degree"] = "1"
    o = RunOptions(opts)
    return VBInference(get_model_class(model)(o), o, data, coords)


@pytest.mark.parametrize("value", ["pallas", "pallas-loop",
                                   "pallas-whole", "spectral-whole",
                                   "fused"])
def test_removed_engine_kernel_values_rejected(value):
    with pytest.raises(InvalidOptionValue) as e:
        build({"engine-kernel": value})
    for kept in ENGINE_KERNELS:
        assert kept in str(e.value)
    assert ENGINE_KERNELS == ("auto", "spectral", "xla")


STATS, SPECTRAL = "sufficient-statistics route", "spectral eigenbasis"
GENERIC = "generic-Jacobian XLA route"
# configuration -> (model, extra options, route where no spectral
# route is taken, whether a spectral route can serve it)
CONFIGS = {
    "poly": ("poly", {}, STATS, True),
    "poly-p001": ("poly", {"convergence": "pointzeroone"}, STATS, True),
    "poly-pattern": ("poly", {"noise-pattern": "12"}, STATS, False),
    "exp": ("exp", {}, GENERIC, False),
}


def expected_route(backend, request_, config):
    _, _, plain, spectral_ok = CONFIGS[config]
    wants = request_ == "spectral" or (request_ == "auto"
                                       and backend == "gpu")
    return SPECTRAL if spectral_ok and wants else plain


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("request_", ENGINE_KERNELS)
@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_route_table(monkeypatch, backend, request_, config):
    """The route each engine-kernel request takes on each backend:
    auto takes the spectral routes on a GPU only, spectral takes them
    wherever the configuration allows, xla never; every route is XLA
    and runs on any backend (the engine is only built, not run)."""
    monkeypatch.setattr(devices, "backend", lambda: backend)
    model, extra, _, _ = CONFIGS[config]
    eng = build({**extra, "engine-kernel": request_}, model=model)
    route = eng.route_description()
    assert expected_route(backend, request_, config) in route
    assert "XLA" in route


@pytest.mark.parametrize("backend,expected", [("cpu", False),
                                              ("gpu", True)])
def test_spectral_by_default(monkeypatch, backend, expected):
    monkeypatch.setattr(devices, "backend", lambda: backend)
    assert devices.spectral_by_default() is expected


@pytest.mark.parametrize("model,extra,route", [
    ("exp", {}, "generic-Jacobian XLA route"),
    ("biexp", {"convergence": "pointzeroone"}, "generic-Jacobian XLA"),
    ("poly", {}, "sufficient-statistics route"),
    ("poly", {"convergence": "pointzeroone"}, "sufficient-statistics"),
], ids=["exp", "biexp-p001", "poly", "poly-p001"])
def test_auto_routes_on_cpu(model, extra, route):
    eng = build(extra, model=model)
    assert route in eng.route_description()
    assert not (eng.use_spectral or eng.use_spectral_fdet)


@pytest.mark.parametrize("model,extra,route", [
    ("exp", {}, "generic-Jacobian XLA route"),
    ("biexp", {"convergence": "freduce"}, "generic-Jacobian XLA route"),
    ("exp", {"convergence": "trialmode"}, "generic-Jacobian XLA route"),
    ("poly", {}, "spectral eigenbasis fixed point (XLA)"),
    ("poly", {"convergence": "trialmode"}, "in-loop F-based"),
    ("poly", {"convergence": "lm"}, "sufficient-statistics route"),
    ("poly", {"noise-pattern": "12"}, "sufficient-statistics route"),
], ids=["exp", "biexp-freduce", "exp-trialmode", "poly", "poly-trialmode",
        "poly-lm", "poly-pattern"])
def test_auto_routes_on_gpu(monkeypatch, model, extra, route):
    """Route choice on a GPU, decided without one (the engine is only
    built, not run)."""
    monkeypatch.setattr(devices, "backend", lambda: "gpu")
    assert route in build(extra, model=model).route_description()


def test_xla_request_takes_no_fast_route(monkeypatch):
    monkeypatch.setattr(devices, "backend", lambda: "gpu")
    for model in ("exp", "poly"):
        eng = build({"engine-kernel": "xla"}, model=model)
        assert "XLA" in eng.route_description()
        assert not (eng.use_spectral or eng.use_spectral_fdet)


class FakeDevice:
    def __init__(self, stats):
        self.stats = stats

    def memory_stats(self):
        return self.stats


@pytest.mark.parametrize("stats,env,limit", [
    ({"bytes_limit": 60e9, "bytes_in_use": 1}, None, 60e9),
    ({}, None, None),
    (None, None, None),
    ({"bytes_limit": 60e9}, "2", 2e9),
], ids=["limit", "no-limit", "no-stats", "env-override"])
def test_device_memory_limit(monkeypatch, stats, env, limit):
    if env is None:
        monkeypatch.delenv("FABBER_TPU_MEM_GB", raising=False)
    else:
        monkeypatch.setenv("FABBER_TPU_MEM_GB", env)
    assert devices.device_memory_limit(FakeDevice(stats)) == limit


@pytest.mark.parametrize("stats,env,budget", [
    ({"bytes_limit": 60e9}, None, 30e9),
    (None, None, devices.DEFAULT_BUDGET_BYTES),
    ({"bytes_limit": 60e9}, "3", 3e9),
], ids=["half-limit", "cpu-default", "env-override"])
def test_planning_budget(monkeypatch, stats, env, budget):
    if env is None:
        monkeypatch.delenv("FABBER_TPU_MEM_GB", raising=False)
    else:
        monkeypatch.setenv("FABBER_TPU_MEM_GB", env)
    assert devices.planning_budget(FakeDevice(stats)) == budget


def test_chunk_size_follows_device_limit(monkeypatch):
    """The voxel window scales with the device's memory limit."""
    import jax
    monkeypatch.delenv("FABBER_TPU_MEM_GB", raising=False)
    eng = build({}, model="exp")
    sizes = []
    for limit in (4e9, 40e9):
        monkeypatch.setattr(jax, "local_devices", lambda *a, limit=limit: [
            FakeDevice({"bytes_limit": limit})])
        sizes.append(eng._chunk_size())
    assert sizes[1] == pytest.approx(10 * sizes[0], rel=1e-3)


def test_spatial_capacity_reads_device_limit(monkeypatch):
    from fabber_core_tpu.inference import spatial
    from fabber_core_tpu.inference.spatial import SpatialVBInference
    nv, nt = 16, 12
    coords = np.stack([np.arange(nv) % 4, np.arange(nv) // 4,
                       np.zeros(nv)], 1)
    data = np.ones((nv, nt))

    def make(extra):
        o = RunOptions({"model": "poly", "degree": "1", "noise": "white",
                        "method": "spatialvb", "param-spatial-priors": "M",
                        "spatial-dims": "2", **extra})
        return SpatialVBInference(get_model_class("poly")(o), o, data,
                                  coords)
    monkeypatch.setattr(spatial, "device_memory_limit", lambda: 7e9)
    assert make({})._device_mem_budget() == 7e9
    assert make({"spatial-mem-gb": "2"})._device_mem_budget() == 2e9


@pytest.mark.parametrize("env,expected", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, "/elsewhere/cache"),
    ({}, os.path.join(REPO, ".jax_cache")),
], ids=["variable-set", "variable-unset"])
def test_compile_cache_dir_rule(env, expected):
    assert devices.compile_cache_dir(env) == expected


def test_compile_cache_dir_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("set_var", [True, False], ids=["set", "unset"])
def test_package_import_places_cache(tmp_path, set_var):
    """Importing the package leaves JAX_COMPILATION_CACHE_DIR in force
    when it is set, and otherwise points JAX at the in-checkout cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if set_var:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    code = ("import jax, fabber_core_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip().splitlines()[-1]
    assert out == (str(tmp_path) if set_var
                   else os.path.join(REPO, ".jax_cache"))


@pytest.mark.gpu
def test_gpu_auto_route_is_true_float32(gpu):
    """On a card, auto takes the spectral route for a float32 poly fit,
    and its statistics carry float32 roundoff, not TF32's ~1e-3
    (chip_smoke.py's api-poly phase checks the same at full width)."""
    import oracle
    nv, nt = 4096, 106
    rng = np.random.default_rng(0)
    t = np.arange(1, nt + 1, dtype=np.float64)
    design = t[:, None] ** np.arange(3)[None, :]
    c = np.stack([rng.uniform(-1, 1, nv), rng.uniform(-0.1, 0.1, nv),
                  rng.uniform(-1e-3, 1e-3, nv)], 1)
    data = c @ design.T + 0.1 * rng.standard_normal((nv, nt))
    o = RunOptions({"model": "poly", "degree": "2", "noise": "white",
                    "dtype": "single", "max-iterations": "10"})
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    eng = VBInference(get_model_class("poly")(o), o,
                      data.astype(np.float32), coords)
    assert eng.use_spectral
    res = eng.run()
    for v in range(0, nv, 512):
        ref = oracle.vb_voxel(
            lambda p: design @ p, lambda p: design,
            data[v].astype(np.float32).astype(np.float64), np.zeros(3),
            np.full(3, 1e-12), np.zeros(3), np.full(3, 1e12), 10,
            compute_f=False)
        sd = np.sqrt(np.diag(ref["cov"]))
        assert np.max(np.abs(res.means[v] - ref["means"]) / sd) < 1e-2
