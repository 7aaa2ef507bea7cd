#!/usr/bin/env python3
"""GPU smoke test: drive the engine's main path once on one card.

    python3 chip_smoke.py            # one GPU, every phase below
    python3 chip_smoke.py --multi    # four GPUs: the sharded paths only

Phases, in one process, in order; the first failure exits non-zero:

  device      the card (JAX platform must be "gpu"), nvidia-smi name and
              power limit, JAX version, compile-cache directory
  cli-default the CLI at its defaults (dtype=double): poly deg 2, T=106,
              on a masked 64x64x42 NIFTI volume made from --seed,
              outputs read back and compared with tests/oracle.py
  api-poly    FabberTpu.run_with_data, poly deg 2, T=106, single, 4M
              voxels; the spectral and sufficient-statistics routes
              timed in turn, each sample compared with the oracle
  biexp       nonlinear VB, biexp T=100 P=4, single, 1M voxels, maxits
              and pointzeroone, through the generic-Jacobian XLA route
              (what auto takes): warm wall times, compared with the
              oracle at 3 iterations, the 10-iteration configuration
              in float64 on a sub-volume
  ar1         poly + AR(1) noise, 1M voxels, against tests/oracle_ar.py
  spatial     spatialvb, M priors, spatial-dims=3, on the masked volume;
              a masked sub-volume against tests/oracle_spatial.py
  nlls        fixed-design NLLS (poly) and the biexp NLLS -> VB
              pipeline, against tests/oracle_nlls.py and tests/oracle.py
  memory      compiled memory analysis of the api-poly step, the peak
              device bytes in use, and the budget the engine plans for

--multi runs voxelwise VB (spectral route), nonlinear VB (generic
route), NLLS and spatial VB sharded over four cards through
--shard-voxels, each compared with the same run on one card, in float32
and in float64, and checks that each card held its share of the data.

Each phase prints its engine route and its compile time. The last line
of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Nothing is printed there unless every phase passed. Without a GPU the
script exits non-zero at the first phase.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

VOL_SHAPE = (64, 64, 42)   # the reference test volume's grid
POLY_T = 106               # the reference test data's timepoints
BIEXP_T, BIEXP_DT = 100, 0.02

_compile_s = [0.0]


def log(msg):
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def _on_event(event, duration, **_):
    if event.startswith("/jax/core/compile/"):
        _compile_s[0] += duration


class Phase:
    """Prints a phase's name, its compile time (JAX's own compile
    events) and its wall time."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"== phase {self.name}")
        self.c0, self.t0 = _compile_s[0], time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"[{self.name}] compile time {_compile_s[0] - self.c0:.2f} s")
            log(f"[{self.name}] phase wall {time.perf_counter() - self.t0:.2f}"
                " s: ok")


def route_of(run_log):
    m = re.findall(r"(?:Vb|NLLS)::Engine route: (.*)", run_log)
    check(m, "run log has no engine route line")
    return m[-1]


# -- data ------------------------------------------------------------------

def brain_mask(shape):
    """An ellipsoid mask over the grid (a head-shaped masked volume)."""
    axes = [(np.arange(n) - (n - 1) / 2) / (n / 2) for n in shape]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    return (x ** 2 + y ** 2 + (z / 0.9) ** 2) < 0.85


def poly_design(nt, degree=2):
    t = np.arange(1, nt + 1, dtype=np.float64)
    return t[:, None] ** np.arange(degree + 1)[None, :]


def poly_data(rng, nv, nt=POLY_T, noise=0.1):
    """[T,V] float32 poly deg-2 signals (bench.py's coefficient ranges)."""
    c = np.stack([rng.uniform(-1, 1, nv), rng.uniform(-0.1, 0.1, nv),
                  rng.uniform(-1e-3, 1e-3, nv)]).astype(np.float32)
    d = poly_design(nt).astype(np.float32) @ c
    d += noise * rng.standard_normal(d.shape, dtype=np.float32)
    return d


def biexp_data(rng, nv, nt=BIEXP_T, dt=BIEXP_DT):
    """[T,V] float32 biexponential decays (bench.py's biexp cell)."""
    t = (np.arange(nt) * dt).astype(np.float32)[:, None]
    amp = rng.uniform(0.5, 1.5, nv).astype(np.float32)[None, :]
    d = amp * np.exp(-t) + 0.5 * amp * np.exp(-5 * t)
    d += 0.05 * rng.standard_normal(d.shape, dtype=np.float32)
    return d


def as_volume(data_tv):
    """[T,V] -> [nx,ny,nz,T], V = nx*ny*nz a power of two (x fastest),
    without a copy."""
    nt, nv = data_tv.shape
    k = nv.bit_length() - 1
    check(nv == 1 << k, f"{nv} voxels is not a power of two")
    nz, rest = 1 << (k // 3), k - k // 3
    nx, ny = 1 << (rest - rest // 2), 1 << (rest // 2)
    return data_tv.T.reshape((nx, ny, nz, nt), order="F")


def from_vox(rows, mask):
    """Voxel-major rows of the masked voxels (x fastest) -> a volume."""
    flat = np.zeros((mask.size,) + rows.shape[1:], rows.dtype)
    flat[mask.reshape(-1, order="F")] = rows
    return flat.reshape(mask.shape + rows.shape[1:], order="F")


def to_vox(vol, shape_mask=None):
    """[nx,ny,nz(,k)] output volume -> voxel-major rows (masked)."""
    flat = vol.reshape((-1,) + vol.shape[3:], order="F")
    return flat if shape_mask is None else flat[shape_mask.reshape(-1,
                                                                  order="F")]


# -- oracle comparisons ----------------------------------------------------

def oracle_poly(y, niter, nt=POLY_T):
    import oracle
    design = poly_design(nt)
    return oracle.vb_voxel(
        eval_fn=lambda p: design @ p, jac_fn=lambda p: design, y=y,
        prior_mean=np.zeros(3), prior_prec=np.full(3, 1e-12),
        post_mean0=np.zeros(3), post_var0=np.full(3, 1e12), niter=niter)


def biexp_latent_fns(nt=BIEXP_T, dt=BIEXP_DT):
    t = np.arange(nt) * dt

    def sig_jac(lat, _t=None):
        a1, r1, a2, r2 = np.exp(lat)
        e1, e2 = np.exp(-r1 * t), np.exp(-r2 * t)
        s = a1 * e1 + a2 * e2
        return s, np.stack([a1 * e1, -r1 * t * a1 * e1,
                            a2 * e2, -r2 * t * a2 * e2])
    return t, sig_jac


def _engine(opts, data_tv):
    from fabber_core_tpu.inference.vb import VBInference
    from fabber_core_tpu.models import get_model_class
    from fabber_core_tpu.options import RunOptions
    o = RunOptions({k: v for k, v in opts.items()
                    if not k.startswith("save")})
    return VBInference(get_model_class(o.get_string("model"))(o), o,
                       data_tv.T, np.zeros((data_tv.shape[1], 3)))


def engine_start(opts, data_vt):
    """Latent prior means and precisions, and the initial posterior
    means [V,P], that a VB engine starts these voxels from."""
    eng = _engine(opts, data_vt)
    pm = np.array([p.prior.mean for p in eng.params])
    pp = np.array([1.0 / p.prior.var for p in eng.params])
    return pm, pp, np.asarray(eng.initial_state().post.means, float).T


# -- phases ----------------------------------------------------------------

def phase_device(multi):
    import jax
    import fabber_core_tpu  # noqa: F401  (x64, precision, compile cache)
    jax.monitoring.register_event_duration_secs_listener(_on_event)
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX platform is {devs[0].platform!r}, not a GPU")
    if multi:
        check(len(devs) >= 4, f"--multi needs 4 GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    log(f"device_kind {devs[0].device_kind}, {len(devs)} device(s), "
        f"jax {jax.__version__}")
    log(f"compile cache {jax.config.jax_compilation_cache_dir}")
    for line in smi:
        log(line)
    return smi[0]


def phase_cli_default(workdir, seed, shape=VOL_SHAPE, nsample=256,
                      niter=10):
    from fabber_core_tpu import cli
    from fabber_core_tpu.io import nifti

    rng = np.random.default_rng(seed)
    mask = brain_mask(shape)
    nv = int(mask.sum())
    vox = poly_data(rng, nv).T                       # [V,T]
    vol = from_vox(vox, mask)
    data_f = os.path.join(workdir, "data.nii")
    mask_f = os.path.join(workdir, "mask.nii")
    nifti.save(nifti.NiftiImage(vol), data_f)
    nifti.save(nifti.NiftiImage(mask.astype(np.float32)), mask_f)
    log(f"[cli-default] {shape} grid, {nv} masked voxels, T={POLY_T}")

    out = os.path.join(workdir, "cli_out")
    argv = [f"--data={data_f}", f"--mask={mask_f}", f"--output={out}",
            "--model=poly", "--degree=2", "--method=vb", "--noise=white",
            f"--max-iterations={niter}", "--save-mean",
            "--save-noise-mean", "--overwrite"]
    t0 = time.perf_counter()
    rc = cli.execute(argv)
    log(f"[cli-default] CLI wall {time.perf_counter() - t0:.3f} s")
    check(rc == 0, f"CLI exit code {rc}")
    with open(os.path.join(out, "logfile")) as f:
        log(f"[cli-default] route: {route_of(f.read())}")

    means = np.stack([to_vox(nifti.load(os.path.join(
        out, f"mean_c{i}.nii.gz")).data, mask) for i in range(3)], 1)
    noise = to_vox(nifti.load(os.path.join(out, "noise_means.nii.gz")).data,
                   mask)
    check(np.isfinite(means).all() and means.shape == (nv, 3),
          "CLI means not finite / wrong shape")
    idx = rng.choice(nv, min(nsample, nv), replace=False)
    err_m = err_n = 0.0
    for v in idx:
        ref = oracle_poly(vox[v].astype(np.float64), niter)
        # outputs are written as float32 images: compare at f32 storage
        # roundoff of the f64 result
        err_m = max(err_m, float(np.max(np.abs(means[v] - ref["means"])
                                        / (np.abs(ref["means"]) + 1e-6))))
        phi = ref["phi_b"][0] * ref["phi_c"][0]
        err_n = max(err_n, abs(float(noise[v]) - phi) / phi)
    log(f"[cli-default] {len(idx)}-voxel sample vs f64 oracle: max rel "
        f"err means {err_m:.2e}, noise {err_n:.2e} (limit 1e-6: float32 "
        "image storage of float64 results)")
    check(err_m < 1e-6 and err_n < 1e-6, "CLI result != oracle")
    return data_f, mask_f, mask, vol


def _api_run(opts, data, mask=None):
    from fabber_core_tpu.api import FabberTpu
    t0 = time.perf_counter()
    run = FabberTpu().run_with_data(opts, {"data": data}, mask=mask)
    return run, time.perf_counter() - t0


def program_time(opts, data_tv, reps=3):
    """Best wall time of the engine's compiled program on data already
    on the card, warm, synchronized with block_until_ready."""
    import jax
    eng = _engine(opts, data_tv)
    full, bind = eng.compiled_full(), eng._bind()
    jax.block_until_ready(full(bind))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(full(bind))
        best = min(best, time.perf_counter() - t0)
    return best


def phase_api_poly(seed, nv=4 << 20, nsample=64, niter=10):
    rng = np.random.default_rng(seed + 1)
    d = poly_data(rng, nv)
    vol = as_volume(d)
    opts = {"model": "poly", "degree": "2", "noise": "white",
            "method": "vb", "max-iterations": str(niter),
            "dtype": "single", "save-mean": True, "save-std": True}
    idx = rng.choice(nv, nsample, replace=False)
    refs = [oracle_poly(d[:, v].astype(np.float64), niter) for v in idx]
    times = {}
    for kernel in ("auto", "xla", "auto", "xla"):
        run, wall = _api_run({**opts, "engine-kernel": kernel}, vol)
        times.setdefault(kernel, []).append(wall)
        route = route_of(run.log)
        log(f"[api-poly] engine-kernel={kernel}: {route}, "
            f"end-to-end wall {wall:.3f} s")
        means = np.stack([to_vox(run.data[f"mean_c{i}"])[idx]
                          for i in range(3)], 1).astype(np.float64)
        sds = np.stack([to_vox(run.data[f"std_c{i}"])[idx]
                        for i in range(3)], 1).astype(np.float64)
        err = float(np.max(np.abs(means - np.stack([r["means"]
                                                    for r in refs])) / sds))
        log(f"[api-poly] {kernel}: max |mean - f64 oracle| = {err:.3e} "
            "posterior sd (limit 1e-2: float32 statistics, TF32 would "
            "show ~1)")
        check(err < 1e-2, f"api-poly {kernel}: oracle mismatch")
    log(f"[api-poly] run_with_data, second call: auto {times['auto'][1]:.3f}"
        f" s, xla {times['xla'][1]:.3f} s ({nv} voxels)")
    steps = {k: program_time({**opts, "engine-kernel": k}, d)
             for k in ("auto", "xla")}
    log(f"[api-poly] engine program, warm, block_until_ready: spectral "
        f"{steps['auto'] * 1e3:.2f} ms vs sufficient statistics "
        f"{steps['xla'] * 1e3:.2f} ms")
    return vol, opts


def biexp_oracle(d, opts, idx, niters):
    """The f64 oracle on voxels idx of d [T,V], from the start the
    engine gives them, niters[j] iterations for voxel idx[j]."""
    import oracle
    _, sig_jac = biexp_latent_fns()
    pm, pp, lat0 = engine_start({**opts, "max-iterations": "1"}, d[:, idx])
    return [oracle.vb_voxel(
        eval_fn=lambda p: sig_jac(p)[0], jac_fn=lambda p: sig_jac(p)[1].T,
        y=d[:, v].astype(np.float64), prior_mean=pm, prior_prec=pp,
        post_mean0=lat0[j], post_var0=np.ones(4), niter=n)
        for j, (v, n) in enumerate(zip(idx, niters))]


def sd_err(means, ref):
    return float(np.max(np.abs(means - ref["means"])
                        / np.sqrt(np.diag(ref["cov"]))))


def phase_biexp(seed, card, nv=1 << 20, nsample=32, depth=3, nsub=4096):
    """Nonlinear VB through the generic-Jacobian XLA route, which auto
    takes for every model without a fixed design.

    biexp from its default start is ill-conditioned: rounding
    differences grow ~30x per iteration. float32 lanes are therefore
    compared with the oracle at `depth` iterations; the timed
    10-iteration configuration is compared in float64 on `nsub` voxels,
    where most lanes still agree with the oracle lane by lane (the rest
    diverge even in float64), and its float32 run is checked for a
    bounded share of failed voxels."""
    import oracle

    rng = np.random.default_rng(seed + 2)
    d = biexp_data(rng, nv)
    vol = as_volume(d)
    idx = rng.choice(nv, nsample, replace=False)
    base = {"model": "biexp", "dt": str(BIEXP_DT), "noise": "white",
            "method": "vb", "dtype": "single",
            # biexp loses a few voxels to numerical failure, as the
            # reference documents for its biexp example
            "allow-bad-voxels": True, "save-mean": True}
    for det in ("maxits", "pointzeroone"):
        opts = {**base, "convergence": det, "max-iterations": str(depth)}
        eng = _engine(opts, d)
        route = eng.route_description()
        log(f"[biexp] {det}: {route}")
        check(route == "generic-Jacobian XLA route",
              f"biexp {det}: unexpected route {route}")
        r = eng.run()
        # where the detector, replayed on the oracle's F, stops each lane
        stops = [(depth, depth)] * nsample
        if det != "maxits":
            stops = [oracle.replay_detector(ref["F_history"], depth, 0.01,
                                            False)[:2] for ref in
                     biexp_oracle(d, opts, idx, [depth + 2] * nsample)]
        # |dF| within float32 roundoff of 0.01 may stop a lane elsewhere
        same = [its == r.iterations[v] for v, (_, its) in zip(idx, stops)]
        flips = nsample - sum(same)
        refs = biexp_oracle(d, opts, idx[same],
                            [n for (n, _), ok in zip(stops, same) if ok])
        err = max(sd_err(r.means[v], ref)
                  for v, ref in zip(idx[same], refs))
        log(f"[biexp] {det}, {depth} iterations, float32 vs f64 oracle on "
            f"{nsample} voxels: max {err:.2e} posterior sd (limit 1e-2); "
            f"{flips} lanes stopped at another iteration (limit 2)")
        check(err < 1e-2 and flips <= 2, f"biexp {det}: oracle mismatch")

        # the timed configuration: 10 iterations, end to end and the
        # engine program alone
        opts = {**base, "convergence": det, "max-iterations": "10"}
        walls = [_api_run(opts, vol)[1] for _ in range(2)]
        r = _engine(opts, d).run()
        step = program_time(opts, d)
        nbad = int(r.bad_voxels.sum())
        log(f"[biexp] {det}, 10 iterations, {nv} voxels: engine program "
            f"(warm, block_until_ready) {step * 1e3:.2f} ms; run_with_data "
            f"{walls[1]:.3f} s (first call {walls[0]:.3f} s); {nbad} "
            f"failed voxels (limit {nv // 10}) -- {card}")
        check(np.isfinite(r.means[~r.bad_voxels]).all(),
              f"biexp {det}: non-finite means")
        check(nbad <= nv // 10, f"biexp {det}: {nbad} failed voxels")

    # the 10-iteration configuration in float64, lane by lane
    sub = d[:, :nsub]
    opts = {**base, "dtype": "double", "max-iterations": "10"}
    r = _engine(opts, sub).run()
    pick = rng.choice(nsub, 2 * nsample, replace=False)
    errs = [sd_err(r.means[v], ref) for v, ref in
            zip(pick, biexp_oracle(sub, opts, pick, [10] * len(pick)))]
    share = float(np.mean(np.asarray(errs) < 1e-6))
    log(f"[biexp] maxits, 10 iterations, float64, {nsub} voxels: "
        f"{share:.0%} of {len(pick)} sampled lanes within 1e-6 posterior sd"
        f" of the f64 oracle (median {np.median(errs):.2e}; limit 75%: "
        "the rest diverge from the oracle's own rounding)")
    check(share >= 0.75, "biexp float64: oracle mismatch")


def phase_ar1(seed, nv=1 << 20, nsample=32, niter=10):
    import oracle_ar
    rng = np.random.default_rng(seed + 3)
    nt = POLY_T
    d = poly_data(rng, nv, noise=0.0)
    e = np.zeros((nt, nv), np.float32)
    eps = 0.1 * rng.standard_normal((nt, nv), dtype=np.float32)
    e[0] = eps[0]
    for i in range(1, nt):
        e[i] = 0.4 * e[i - 1] + eps[i]
    d += e
    opts = {"model": "poly", "degree": "2", "noise": "ar", "method": "vb",
            "max-iterations": str(niter), "dtype": "single",
            "save-mean": True, "save-std": True, "save-noise-mean": True}
    run, wall = _api_run(opts, as_volume(d))
    log(f"[ar1] route: {route_of(run.log)}; end-to-end wall {wall:.3f} s")
    idx = rng.choice(nv, nsample, replace=False)
    means = np.stack([to_vox(run.data[f"mean_c{i}"])[idx]
                      for i in range(3)], 1).astype(np.float64)
    sds = np.stack([to_vox(run.data[f"std_c{i}"])[idx]
                    for i in range(3)], 1).astype(np.float64)
    refs = [oracle_ar.ar_vb_voxel(
        d[:, v].astype(np.float64), poly_design(nt), np.zeros(3),
        np.full(3, 1e-12), niter) for v in idx]
    err = float(np.max(np.abs(means - np.stack([r["means"] for r in refs]))
                       / sds))
    log(f"[ar1] max |mean - f64 oracle| = {err:.3e} posterior sd "
        "(limit 1e-2)")
    check(err < 1e-2, "ar1: oracle mismatch")


def phase_spatial(seed, vol, mask, niter=10, sub=(10, 10, 6)):
    from oracle_spatial import spatial_oracle_sweeps
    opts = {"model": "poly", "degree": "2", "noise": "white",
            "method": "spatialvb", "param-spatial-priors": "MMM",
            "spatial-dims": "3", "max-iterations": str(niter),
            "save-mean": True}
    run, wall = _api_run(opts, vol, mask=mask)
    log(f"[spatial] route: {route_of(run.log)}; {int(mask.sum())} masked "
        f"voxels, end-to-end wall {wall:.3f} s")
    means = np.stack([to_vox(run.data[f"mean_c{i}"], mask)
                      for i in range(3)], 1)
    check(np.isfinite(means).all(), "spatial means not finite")

    # a masked sub-volume through the same path, against the oracle
    c = [n // 2 for n in mask.shape]
    sl = tuple(slice(ci - s // 2, ci - s // 2 + s) for ci, s in zip(c, sub))
    smask = mask[sl].copy()
    smask[0, 0, :] = False   # an irregular mask edge
    svol = np.ascontiguousarray(vol[sl])
    run, _ = _api_run(opts, svol, mask=smask)
    got = np.stack([to_vox(run.data[f"mean_c{i}"], smask)
                    for i in range(3)], 1).astype(np.float64)
    coords = np.argwhere(smask.transpose(2, 1, 0))[:, ::-1].astype(float)
    data = to_vox(svol, smask).astype(np.float64)
    omeans, _, _ = spatial_oracle_sweeps(data, coords,
                                            poly_design(POLY_T), niter)
    err = float(np.max(np.abs(got - omeans) / (np.abs(omeans) + 1e-6)))
    log(f"[spatial] {len(got)}-voxel masked sub-volume vs f64 oracle: "
        f"max rel err {err:.2e} (limit 1e-6: float32 image storage of "
        "float64 results)")
    check(err < 1e-6, "spatial: oracle mismatch")


def phase_nlls(seed, nv=1 << 20, nsample=32, depth=3):
    from oracle_nlls import nlls_voxel
    import oracle
    from fabber_core_tpu.io import mvn as mvn_io

    rng = np.random.default_rng(seed + 4)
    # fixed-design (poly) NLLS: the eigen tier
    d = poly_data(rng, nv)
    run, wall = _api_run({"model": "poly", "degree": "2", "method": "nlls",
                          "dtype": "single", "save-mean": True,
                          "save-std": True}, as_volume(d))
    log(f"[nlls] poly route: {route_of(run.log)}; end-to-end wall "
        f"{wall:.3f} s")
    idx = rng.choice(nv, nsample, replace=False)
    design = poly_design(POLY_T)
    got = np.stack([to_vox(run.data[f"mean_c{i}"])[idx]
                    for i in range(3)], 1).astype(np.float64)
    sds = np.stack([to_vox(run.data[f"std_c{i}"])[idx]
                    for i in range(3)], 1).astype(np.float64)
    t = np.arange(POLY_T, dtype=np.float64)
    refs = np.stack([nlls_voxel(
        d[:, v].astype(np.float64), t, np.zeros(3),
        signal_and_jac=lambda p, _t: (design @ p, design.T))["params"]
        for v in idx])
    err = float(np.max(np.abs(got - refs) / sds))
    log(f"[nlls] poly: max |param - f64 oracle| = {err:.3e} posterior sd "
        "(limit 1e-2)")
    check(err < 1e-2, "nlls poly: oracle mismatch")

    # biexp NLLS -> VB continuation (the reference's documented
    # workflow: nlls + save-mvn, then vb --continue-from-mvn). The VB
    # half runs `depth` iterations: from the default initial noise its
    # first update jumps towards the prior, and from there biexp
    # float32 rounding grows ~30x per iteration (see phase_biexp)
    nvb = nv // 4
    d = biexp_data(rng, nvb)
    vol = as_volume(d)
    base = {"model": "biexp", "dt": str(BIEXP_DT), "dtype": "single"}
    run, wall = _api_run({**base, "method": "nlls", "vb-init": True,
                          "save-mvn": True}, vol)
    log(f"[nlls] biexp NLLS route: {route_of(run.log)}; wall {wall:.3f} s")
    mvn = run.data["finalMVN"]
    from fabber_core_tpu.api import FabberTpu
    t0 = time.perf_counter()
    run = FabberTpu().run_with_data(
        {**base, "method": "vb", "noise": "white",
         "max-iterations": str(depth), "continue-from-mvn": "mvn",
         "allow-bad-voxels": True, "save-mvn": True},
        {"data": vol, "continue-from-mvn": mvn})
    log(f"[nlls] biexp VB continuation route: {route_of(run.log)}; wall "
        f"{time.perf_counter() - t0:.3f} s")
    nmeans, _ = mvn_io.unpack(to_vox(mvn).T)
    tb, sig_jac = biexp_latent_fns()
    idx = rng.choice(nvb, nsample, replace=False)
    vmeans = mvn_io.unpack(to_vox(run.data["finalMVN"]).T)[0][idx, :4]
    pm, pp, _ = engine_start({**base, "noise": "white"}, d[:, idx])
    n_ok = n_vb = 0
    for j, v in enumerate(idx):
        y = d[:, v].astype(np.float64)
        o = nlls_voxel(y, tb, np.log(np.asarray(
            [y.max() / 2, 1.0, y.max() / 3, 1.0])), signal_and_jac=sig_jac)
        if np.max(np.abs(nmeans[v, :4] - o["params"])) < 1e-2:
            n_ok += 1
        ref = oracle.vb_voxel(
            eval_fn=lambda p: sig_jac(p)[0], jac_fn=lambda p: sig_jac(p)[1].T,
            y=y, prior_mean=pm, prior_prec=pp,
            post_mean0=nmeans[v, :4].astype(np.float64),
            post_var0=np.ones(4), niter=depth, compute_f=False)
        if np.max(np.abs(vmeans[j] - ref["means"])
                  / np.sqrt(np.diag(ref["cov"]))) < 1e-2:
            n_vb += 1
    log(f"[nlls] biexp: NLLS lanes matching the f64 oracle {n_ok}/"
        f"{nsample} (within 1e-2 in latent space), VB continuation "
        f"lanes {n_vb}/{nsample} (within 1e-2 posterior sd); limit 90%: "
        "a float32 NLLS lane may settle in the other biexp basin")
    check(n_ok >= 0.9 * nsample and n_vb >= 0.9 * nsample,
          "nlls biexp pipeline != oracle")


def phase_memory(vol, opts):
    import jax
    from fabber_core_tpu import devices

    eng = _engine(opts, vol.reshape(-1, vol.shape[-1], order="F").T)
    log(f"[memory] route: {eng.route_description()}")
    compiled = eng.compiled_full().lower(eng._bind()).compile()
    log(f"[memory] api-poly step memory_analysis: "
        f"{compiled.memory_analysis()}")
    stats = jax.devices()[0].memory_stats()
    log(f"[memory] peak_bytes_in_use {stats['peak_bytes_in_use']} of "
        f"bytes_limit {stats['bytes_limit']}")
    log(f"[memory] engine budget: device limit "
        f"{devices.device_memory_limit():.4g} B, planning budget "
        f"{devices.planning_budget():.4g} B, voxel window "
        f"{eng._chunk_size()} voxels")


class BytesWatch:
    """Each card's highest bytes_in_use while the block runs, above what
    it held when the block began; a thread polls memory_stats."""

    def __init__(self, devs, period=0.002):
        self.devs, self.period = devs, period

    def _used(self):
        return [d.memory_stats()["bytes_in_use"] for d in self.devs]

    def _poll(self):
        while not self._stop.wait(self.period):
            self.high = [max(h, u) for h, u in zip(self.high, self._used())]

    def __enter__(self):
        self.base = self._used()
        self.high = list(self.base)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.delta = [h - b for h, b in zip(self.high, self.base)]


# float32 limits per job, sharded against one card: means in posterior
# sd, other outputs relative to max(|x|, 1). About 3x the readings of
# the last passing run on 4 x H100; the shards' float32 reductions
# (matmul blocking included) run in another order than one card's.
MULTI_LIMITS = {"voxelwise": (3e-3, 1e-4), "nonlinear": (3e-3, 1e-4),
                "nlls": (6e-4, 1e-6), "spatial": (1.2e-2, 1e-5)}
# the same comparison in float64: if the float32 gaps are rounding
# order, they shrink by the ratio of the two precisions' epsilons
F64_LIMIT = 1e-8


def sharded_gap(one, four, name):
    """Worst difference of the sharded run's outputs from one card's:
    {"mean": (err, key), "other": (err, key)}."""
    worst = {"mean": (0.0, None), "other": (0.0, None)}
    for key in one.data:
        a = np.asarray(one.data[key], np.float64)
        b = np.asarray(four.data[key], np.float64)
        check(a.shape == b.shape and np.array_equal(
            np.isfinite(a), np.isfinite(b)), f"{name} {key}: shape")
        fin = np.isfinite(a)
        if key.startswith("mean_"):
            scale = np.maximum(np.asarray(
                one.data["std_" + key[5:]], np.float64)[fin], 1e-30)
            kind = "mean"
        else:
            # F can sit near 0, where a relative gap says nothing
            scale = np.maximum(np.abs(a[fin]), 1.0)
            kind = "other"
        err = float(np.max(np.abs(a[fin] - b[fin]) / scale, initial=0.0))
        if err >= worst[kind][0]:
            worst[kind] = (err, key)
    return worst


def phase_multi(seed, nv=(1 << 20) + 3, shape=VOL_SHAPE):
    """The sharded paths on four cards against one card."""
    import jax
    rng = np.random.default_rng(seed + 5)
    devs = jax.devices()[:4]
    jobs = {
        "voxelwise": ({"model": "poly", "degree": "2", "noise": "white",
                       "method": "vb", "max-iterations": "10"},
                      poly_data(rng, nv), None),
        # exp, not biexp: near-degenerate biexp lanes can tip into
        # overflow on either side of a rounding difference; maxits, as
        # a lane near an F threshold may stop an iteration apart
        "nonlinear": ({"model": "exp", "dt": str(BIEXP_DT),
                       "noise": "white", "method": "vb",
                       "max-iterations": "10"}, biexp_data(rng, nv), None),
        "nlls": ({"model": "exp", "dt": str(BIEXP_DT), "method": "nlls"},
                 biexp_data(rng, nv // 4), None),
    }
    mask = brain_mask(shape)
    svol = from_vox(poly_data(rng, int(mask.sum())).T, mask)
    jobs["spatial"] = ({"model": "poly", "degree": "2", "noise": "white",
                        "method": "spatialvb", "param-spatial-priors": "MMM",
                        "spatial-dims": "3", "max-iterations": "10"},
                       svol, mask)
    for name, (opts, data, m) in jobs.items():
        vol = data if data.ndim == 4 else data.T.reshape(
            (data.shape[1], 1, 1, data.shape[0]))
        nvox = int(m.sum()) if m is not None else int(np.prod(vol.shape[:3]))
        for dtype, item in (("single", 4), ("double", 8)):
            run_opts = {**opts, "dtype": dtype, "allow-bad-voxels": True,
                        "save-mean": True, "save-std": True,
                        "save-free-energy": opts["method"] != "nlls"}
            one, w1 = _api_run(run_opts, vol, mask=m)
            with BytesWatch(devs) as watch:
                four, w4 = _api_run({**run_opts, "shard-voxels": True}, vol,
                                    mask=m)
            tag = f"{name} {dtype}"
            log(f"[multi] {tag}: route {route_of(four.log)}")
            share = nvox * vol.shape[-1] * item / len(devs)
            log(f"[multi] {tag}: one card {w1:.3f} s, four cards {w4:.3f} s"
                f" (cold, compile included); bytes each card added during "
                f"the sharded run {watch.delta} (its share of the data "
                f"plane {share:.0f})")
            check(min(watch.delta) >= share / 2,
                  f"{tag}: a card held less than half its share")
            check(any(w in four.log for w in ("Sharding", "padding",
                                              "mesh")),
                  f"{tag}: run was not sharded")
            gap = sharded_gap(one, four, tag)
            lim_m, lim_o = MULTI_LIMITS[name] if dtype == "single" \
                else (F64_LIMIT, F64_LIMIT)
            log(f"[multi] {tag}: sharded vs one card over "
                f"{sorted(one.data)}: means differ by at most "
                f"{gap['mean'][0]:.2e} posterior sd ({gap['mean'][1]}; "
                f"limit {lim_m:.0e}), other outputs by "
                f"{gap['other'][0]:.2e} relative ({gap['other'][1]}; "
                f"limit {lim_o:.0e})")
            check(gap["mean"][0] < lim_m and gap["other"][0] < lim_o,
                  f"{tag}: sharded != single card")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the sharded paths on four GPUs instead")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    with Phase("device"):
        card = phase_device(args.multi)
    import jax
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_") as work:
        if args.multi:
            with Phase("multi"):
                phase_multi(args.seed)
        else:
            with Phase("cli-default"):
                _, _, mask, vol = phase_cli_default(work, args.seed)
            with Phase("api-poly"):
                pvol, popts = phase_api_poly(args.seed)
            with Phase("biexp"):
                phase_biexp(args.seed, card)
            with Phase("ar1"):
                phase_ar1(args.seed)
            with Phase("spatial"):
                phase_spatial(args.seed, vol, mask)
            with Phase("nlls"):
                phase_nlls(args.seed)
            with Phase("memory"):
                phase_memory(pvol, popts)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)


if __name__ == "__main__":
    main()
