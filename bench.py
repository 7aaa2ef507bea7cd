"""Benchmark: voxels/sec of full VB convergence on the GPU.

Mirrors the reference's headline workload (BASELINE.md): white-noise VB
on a poly/linear-sized problem with the shipped test data's dimensions
(T=106 timepoints), run over a large batch of voxels. The reference's
serial C++ loop manages order 1e5 voxels/s; the target is >=1e6.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device"}, the device as JAX reports it. A device without an entry in
PEAKS is an error: the benchmark never falls back to another device.

Env knobs:
  FABBER_BENCH_VOXELS  batch size (default 4_000_000)
  FABBER_BENCH_CONFIG  all (default) | one config name below
  FABBER_BENCH_DTYPE   single (default) | double
  FABBER_BENCH_KERNEL  the engine-kernel option (default auto)
  FABBER_BENCH_REPS    timed repetitions, best kept (default 3)
"""

import json
import os
import sys
import time

import numpy as np

REFERENCE_VOXELS_PER_SEC = 1e5  # implied C++ throughput (BASELINE.md)


def _gen_plane(key, nv, nt, slab_fn):
    """Assemble a [nt,nv] f32 device plane slab-by-slab.

    Bounded temps: a single full-plane normal draw materializes erf_inv
    temporaries (and, under the package's x64 default, f64 intermediates)
    that are several times the plane; and host-side concatenation of
    slabs briefly doubles the plane. One jitted scan writes each slab
    into a preallocated plane (XLA aliases the carry in place), so peak
    memory is plane + one slab. The final slab is slid back to end at
    nv (overlap rewritten, same distribution). slab_fn(key, m) ->
    [nt,m] f32 generates one voxel slab including its per-voxel random
    parameters."""
    import jax
    import jax.numpy as jnp
    slab = min(1 << 19, nv)
    nslab = (nv + slab - 1) // slab
    keys = jax.random.split(key, nslab)
    starts = np.arange(nslab, dtype=np.int32) * slab
    starts[-1] = nv - slab

    @jax.jit
    def gen(keys, starts):
        def body(plane, ks):
            k, lo = ks
            return jax.lax.dynamic_update_slice(
                plane, slab_fn(k, slab), (jnp.int32(0), lo)), None
        plane, _ = jax.lax.scan(
            body, jnp.zeros((nt, nv), jnp.float32), (keys, starts))
        return plane

    return gen(keys, jnp.asarray(starts))


def build_engine(config, nv):
    import jax
    import jax.numpy as jnp
    from fabber_core_tpu.options import RunOptions
    from fabber_core_tpu.models import get_model_class
    from fabber_core_tpu.inference.vb import VBInference

    key = jax.random.PRNGKey(0)
    iters = 10

    f32 = jnp.float32

    if config in ("poly", "poly-24m", "poly-lm", "poly-p001",
                  "poly-pattern"):
        nt, opts = 106, {"model": "poly", "degree": "2", "noise": "white"}
        if config == "poly-lm":
            # the LM robustness detector (XLA stats route). Opt-in
            # config (not in "all").
            opts["convergence"] = "lm"
        elif config == "poly-p001":
            opts["convergence"] = "pointzeroone"
        elif config == "poly-pattern":
            # 2-group noise pattern (the spectral collapse is
            # single-group only — docs/PARITY.md). Opt-in config.
            opts["noise-pattern"] = "12"
        t = jnp.arange(1, nt + 1, dtype=f32)[:, None]

        def slab_fn(k, m):
            k1, k2, k3 = jax.random.split(k, 3)
            c0 = jax.random.uniform(k1, (1, m), f32, -1, 1)
            c1 = jax.random.uniform(k2, (1, m), f32, -0.1, 0.1)
            return c0 + c1 * t + 0.1 * jax.random.normal(k3, (nt, m), f32)
    elif config in ("biexp", "biexp-fdet"):
        nt, opts = 100, {"model": "biexp", "dt": "0.02", "noise": "white"}
        if config == "biexp-fdet":
            # pointzeroone: per-lane F + freezing on the generic route
            opts["convergence"] = "pointzeroone"
        t = jnp.arange(nt, dtype=f32)[:, None] * 0.02
        e1, e5 = jnp.exp(-t), jnp.exp(-5 * t)

        def slab_fn(k, m):
            k1, k2 = jax.random.split(k)
            amp = jax.random.uniform(k1, (1, m), f32, 0.5, 1.5)
            return (amp * e1 + 0.5 * amp * e5
                    + 0.05 * jax.random.normal(k2, (nt, m), f32))
    elif config in ("ar1", "ar2"):
        nt, opts = 106, {"model": "poly", "degree": "2", "noise": "ar",
                         "num-echoes": "1"}
        if config == "ar2":
            # 2-echo interleaved AR(1) (noisemodel_ar.cc:83-224): the
            # XLA stats route
            opts["num-echoes"] = "2"
        t = jnp.arange(1, nt + 1, dtype=f32)[:, None]

        def slab_fn(k, m):
            k1, k2 = jax.random.split(k)
            c0 = jax.random.uniform(k1, (1, m), f32, -1, 1)
            return c0 + 0.01 * t + 0.1 * jax.random.normal(k2, (nt, m), f32)
    elif config in ("linear", "nlls", "nlls-lm", "spatial-p4"):
        # the reference's shipped VEST design (T=106, P=4): the
        # outdata_linear_vb / _nlls / _spatialvb workload shape
        # (BASELINE.md configs 2 and 5)
        from fabber_core_tpu.io import matfile
        dref = "/root/reference/test/test_linear_design.mat"
        dh = np.asarray(matfile.read_matrix_file(dref), np.float32)
        nt = dh.shape[0]
        opts = {"model": "linear", "basis": dref, "noise": "white"}
        if config in ("nlls", "nlls-lm"):
            opts["method"] = "nlls"
            if config == "nlls-lm":
                opts["lm"] = ""
        elif config == "spatial-p4":
            # combined spatial (M) + non-spatial (N) priors on the
            # 4-parameter linear model — BASELINE config 5 as written
            nv = max(1024, (nv // 1024) * 1024)
            opts.update({"method": "spatialvb",
                         "param-spatial-priors": "MMNN",
                         "spatial-dims": "2"})
        dd = jnp.asarray(dh)

        def slab_fn(k, m):
            k1, k2 = jax.random.split(k)
            p = jax.random.uniform(k1, (dh.shape[1], m), f32, -1, 1)
            return dd @ p + 0.1 * jax.random.normal(k2, (nt, m), f32)
    elif config == "biexp-nllsinit":
        # BASELINE config 3 as written: NLLS fit seeds a VB continuation
        # (the reference's documented biexp workflow: nlls + save-mvn,
        # then vb --continue-from-mvn). Run as one fused device program
        # in _run_config.
        nt, opts = 100, {"model": "biexp", "dt": "0.02", "noise": "white"}
        t = jnp.arange(nt, dtype=f32)[:, None] * 0.02
        e1, e5 = jnp.exp(-t), jnp.exp(-5 * t)

        def slab_fn(k, m):
            k1, k2 = jax.random.split(k)
            amp = jax.random.uniform(k1, (1, m), f32, 0.5, 1.5)
            return (amp * e1 + 0.5 * amp * e5
                    + 0.05 * jax.random.normal(k2, (nt, m), f32))
    elif config == "spatial":
        nt = 50
        nv = max(1024, (nv // 1024) * 1024)  # full rows of the 2-D grid
        opts = {"model": "poly", "degree": "0", "noise": "white",
                "method": "spatialvb", "param-spatial-priors": "M",
                "spatial-dims": "2"}

        def slab_fn(k, m):
            k1, k2 = jax.random.split(k)
            base = jax.random.uniform(k1, (1, m), f32, 3.0, 5.0)
            return base + 0.5 * jax.random.normal(k2, (nt, m), f32)
    else:
        raise ValueError(f"Unknown config {config}")

    data_plane = jax.block_until_ready(_gen_plane(key, nv, nt, slab_fn))
    if config in ("spatial", "spatial-p4"):
        # full 2-D grid so the neighbour graph is dense
        nx = 1024
        assert nv % nx == 0
        ny = nv // nx
        coords = np.stack([np.arange(nv) % nx, (np.arange(nv) // nx) % ny,
                           np.zeros(nv)], 1).astype(np.float32)
    else:
        coords = np.stack([np.arange(nv) % 256, (np.arange(nv) // 256) % 256,
                           np.arange(nv) // 65536], 1).astype(np.float32)
    options = RunOptions({**opts, "max-iterations": str(iters),
                          "dtype": os.environ.get("FABBER_BENCH_DTYPE",
                                                  "single"),
                          "engine-kernel": os.environ.get(
                              "FABBER_BENCH_KERNEL", "auto")})
    model_cls = get_model_class(options.get_string("model"))
    model = model_cls(options)
    if config in ("spatial", "spatial-p4"):
        from fabber_core_tpu.inference.spatial import SpatialVBInference
        eng = SpatialVBInference(model, options, None, coords,
                                 data_plane=data_plane)
    elif config in ("nlls", "nlls-lm"):
        from fabber_core_tpu.inference.nlls import NLLSInference
        eng = NLLSInference(model, options, None, coords,
                            data_plane=data_plane)
    elif config == "biexp-nllsinit":
        from fabber_core_tpu.inference.nlls import NLLSInference
        nlls_opts = RunOptions({**opts, "method": "nlls",
                                "vb-init": "", "dtype": "single"})
        nlls_eng = NLLSInference(model_cls(nlls_opts), nlls_opts, None,
                                 coords, data_plane=data_plane)
        vb_eng = VBInference(model, options, None, coords,
                             data_plane=data_plane)
        # programmatic continuation takes the per-iteration routes
        # (the spectral routes start from the model-default initial
        # posterior; mirror the engine's own _run_vb continuation guard)
        vb_eng.use_spectral = False
        vb_eng.use_spectral_fdet = False
        return (nlls_eng, vb_eng), iters
    else:
        eng = VBInference(model, options, None, coords,
                          data_plane=data_plane)
    return eng, iters


NT_LABELS = {"poly": "T=106, P=3",
             "poly-24m": "T=106, P=3, 24M voxels (streaming scale)",
             "ar2": "T=106, P=3 + 2-echo AR(1)",
             "poly-lm": "T=106, P=3, lm detector",
             "poly-pattern": "T=106, P=3, noise-pattern=12",
             "poly-p001": "T=106, P=3, pointzeroone", "biexp": "T=100, P=4",
             "biexp-fdet": "T=100, P=4, pointzeroone",
             "biexp-nllsinit": "T=100, P=4, NLLS init -> VB",
             "ar1": "T=106, P=3 + AR(1)", "spatial": "T=50, P=1 + MRF",
             "linear": "T=106, P=4 design-matrix",
             "nlls": "T=106, P=4, damped GN to convergence",
             "nlls-lm": "T=106, P=4, LM-damped GN to convergence",
             "spatial-p4": "T=106, P=4, mixed MMNN priors"}
# Per-config voxel budget as a multiple of FABBER_BENCH_VOXELS.
CONFIG_SCALE = {"poly": 4.0, "poly-24m": 6.0, "poly-lm": 1.0,
                "poly-p001": 1.0, "poly-pattern": 1.0, "biexp": 1.0,
                "biexp-fdet": 1.0, "ar1": 1.0, "ar2": 1.0, "spatial": 2.0,
                "linear": 2.0, "nlls": 1.0, "nlls-lm": 1.0,
                "spatial-p4": 1.0, "biexp-nllsinit": 0.25}

# Published peaks, keyed by jax.devices()[0].device_kind. Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates: HBM3
# at 3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores (at the
# 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flops_per_s": 67e12},
}


def device_info():
    """(platform, device_kind, count) of the first device, and its
    published peaks; a device not in PEAKS is an error."""
    import jax
    devs = jax.devices()
    kind = devs[0].device_kind
    if kind not in PEAKS:
        raise SystemExit(f"bench.py: no published peaks for device "
                         f"{kind!r} ({devs[0].platform}); add it to PEAKS")
    return ({"platform": devs[0].platform, "kind": kind,
             "count": len(devs)}, PEAKS[kind])


def _work_model(eng, config, nv, nt, iters):
    """Analytic per-voxel work estimate for the route the engine
    actually selected: (flops, bytes) for the whole run. These are
    operation counts of the update equations (exp/log/div counted as
    one flop — a lower bound on the arithmetic), and the bytes each route
    moves to and from device memory by construction (data plane reads,
    posterior state writes, per-iteration state traffic where the
    route round-trips it)."""
    p = eng.nparams
    item = 4  # all bench routes store/compute f32
    state_planes = (p * p * 2 + 2 * p + 2)  # prec+cov, means+prior, noise
    out_bytes = state_planes * item
    cholesky = 2 * p ** 3 // 3 + 4 * p * p  # unrolled chol+inverse
    theta = cholesky + 4 * p * p            # + rhs assembly / solve
    if config in ("nlls", "nlls-lm"):
        # stats tier: one [T,V] pass, then ~4 P-dim LM steps per lane
        # (linear fits land in 1 accepted step; the rejected-plateau
        # exit ends the lane ~3 trials later — inference/nlls.py CFTOL
        # block)
        its = 4
        flops = 4 * nt * p + its * (theta + 4 * p * p + 8 * p)
        bytes_ = nt * item + (p + p * p + 2) * item
        return flops, bytes_
    if config == "biexp-nllsinit":
        # generic-Jacobian NLLS (~24 accepted+rejected steps per lane
        # mean, each a model+Jacobian evaluation over T) + 10 fused VB
        # iterations
        nlls_its = 24
        flops = (nlls_its * ((6 * p + 6) * nt + theta)
                 + iters * ((3 * p + 6) * nt + theta + 6 * p))
        bytes_ = (nlls_its + iters) * nt * item + out_bytes * 2
        return flops, bytes_
    if getattr(eng, "use_spectral", False) \
            or getattr(eng, "use_spectral_fdet", False):
        # one [T,V] stats pass, then a scalar rational fixed point in
        # the eigenbasis + one P-dim reconstruction (ops/spectral.py)
        flops = 2 * nt * p + 4 * p * p + 20 * iters
        bytes_ = nt * item + out_bytes
    elif config == "spatial":
        # stats pass + per-sweep P-dim update + MRF stencil (~30 flops)
        flops = 2 * nt * p + iters * (theta + 30)
        # Jacobi sweeps round-trip the posterior state each iteration
        bytes_ = nt * item + out_bytes * (2 * iters)
    elif getattr(eng, "use_stats", False):
        # XLA stats route: per-iteration state round-trips device memory
        flops = 2 * nt * p + iters * (theta + 8 * p)
        bytes_ = nt * item + out_bytes * (2 * iters)
    else:
        # XLA generic-Jacobian route: per-iteration model+Jacobian
        # evaluation materializes [T,V] and [P,T,V] planes in memory
        flops = iters * ((6 * p + 6) * nt + theta)
        bytes_ = iters * nt * (p + 3) * item + out_bytes * (2 * iters)
    return flops, bytes_


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    device, _ = device_info()
    nv = int(os.environ.get("FABBER_BENCH_VOXELS", 4_000_000))
    config = os.environ.get("FABBER_BENCH_CONFIG", "all")

    if config == "all":
        # one JSON line: the headline poly number, plus every
        # BASELINE.json config family as extra fields so regressions in
        # biexp/ar1/spatial are visible per round
        per = {}
        for cfg in ("poly", "poly-24m", "linear", "biexp", "biexp-fdet",
                    "biexp-nllsinit", "ar1", "ar2", "nlls", "nlls-lm",
                    "spatial", "spatial-p4", "poly-lm", "poly-pattern"):
            try:
                per[cfg] = _run_config(cfg, max(1024, int(
                    nv * CONFIG_SCALE[cfg])), quiet=True)
            except Exception as e:  # a broken config must not hide others
                print(f"# config={cfg} FAILED: {e}", file=sys.stderr)
                per[cfg] = None
        head = per["poly"] or {"voxels_per_sec": 0.0}
        result = {
            "metric": "vb_convergence_voxels_per_sec",
            "value": round(head["voxels_per_sec"], 1),
            "unit": "voxels/s",
            "vs_baseline": round(
                head["voxels_per_sec"] / REFERENCE_VOXELS_PER_SEC, 2),
            "configs": {k: (round(v["voxels_per_sec"], 1) if v else None)
                        for k, v in per.items()},
            "utilization": {k: (v["utilization"] if v else None)
                            for k, v in per.items()},
            "device": device,
        }
        print(json.dumps(result))
        return

    _run_config(config, nv)


def _run_config(config, nv, quiet=False):
    import jax

    eng, iters = build_engine(config, nv)

    if config in ("nlls", "nlls-lm"):
        # NLLS: per-lane damped-GN loops run to their own convergence
        # (lam > 1e10); the fixed-design stats tier keeps every
        # iteration on P-dim planes. One compiled dispatch.
        bind = eng._bind()
        solve = jax.jit(lambda b: eng._solve_body(
            eng._initial_means_traced(b.data), b)[0].params)

        def run_once():
            jax.block_until_ready(solve(bind))

        return _measure(run_once, nv, eng.max_its, config,
                        NT_LABELS[config], quiet, eng=eng)

    if config == "biexp-nllsinit":
        # two-stage pipeline in ONE device program: generic-Jacobian
        # NLLS fit -> posterior (J'J/mse) -> VB continuation from it
        import jax.numpy as jnp
        nlls_eng, vb_eng = eng
        bind_n = nlls_eng._bind()
        bind_v = vb_eng._bind()
        vb_eng._ensure_noise_prior()
        vb_loop = vb_eng.compiled_loop()

        @jax.jit
        def pipeline(bn, bv):
            s, prec, cov = nlls_eng._solve_body(
                nlls_eng._initial_means_traced(bn.data), bn)
            means_vm = s.params.T               # [V,P] voxel-major
            cov_vm = jnp.moveaxis(cov, -1, 0)   # [V,P,P]
            s0 = vb_eng.initial_state(continue_means=means_vm,
                                      continue_cov=cov_vm)
            out, _ = vb_loop(s0, bv)
            return out.post.means

        def run_once():
            jax.block_until_ready(pipeline(bind_n, bind_v))

        return _measure(run_once, nv, iters, config, NT_LABELS[config],
                        quiet, eng=vb_eng)

    if config in ("spatial", "spatial-p4"):
        import jax.numpy as jnp
        from fabber_core_tpu.inference.spatial import SpatialState, AK_INIT
        base_state = eng.initial_state()
        s0 = SpatialState(
            post=base_state.post, centre=base_state.centre, f=base_state.f,
            ak=jnp.full(len(eng.spatial_params), AK_INIT, eng.dtype),
            bad=jnp.zeros(eng.nvoxels, bool))
        bind = eng._bind()
        sp_loop = eng.compiled_sweeps()

        def run_once():
            jax.block_until_ready(sp_loop(s0, bind).post.means)

        return _measure(run_once, eng.nvoxels, iters, config,
                        NT_LABELS[config], quiet, eng=eng)

    import jax.numpy as jnp
    chunk = min(eng._chunk_size(), nv)
    can_stream = (eng._can_trace_init(None)
                  and getattr(eng, "mesh", None) is None)

    if chunk < nv and can_stream:
        schunk = eng._stream_chunk()
        if schunk is not None:
            # in-program chunk streaming: the whole volume is ONE
            # dispatch, the window loop runs on device. Equal windows
            # take the carry-free map path (vb.py compiled_streamed_map)
            schunk = min(schunk, nv)
            nwin = -(-nv // schunk)
            sbind = eng._bind()
            if nv % nwin == 0:
                mchunk = nv // nwin
                streamed = eng.compiled_streamed_map(mchunk)
                starts = np.arange(nwin, dtype=np.int64) * mchunk
                label = f"map {nwin} x {mchunk}"
            else:
                streamed = eng.compiled_streamed(schunk)
                starts = np.arange(nwin, dtype=np.int64) * schunk
                starts[-1] = nv - schunk
                label = f"scan {nwin} x {schunk}"
            starts = jnp.asarray(starts, jnp.int32)
            print(f"# streamed: {label}-voxel windows in one dispatch",
                  file=sys.stderr)

            def run_once():
                jax.block_until_ready(streamed(sbind, starts)[0])

            return _measure(run_once, nv, iters, config,
                            NT_LABELS[config], quiet, eng=eng)

    # single-dispatch path: initial state + VB loop in one compiled
    # program per window
    full = eng.compiled_full()
    windows = [(lo, min(lo + chunk, nv)) for lo in range(0, nv, chunk)]
    # fixed-size windows (the engine's chunked-run convention)
    windows = [(hi - chunk, hi) if hi - lo < chunk else (lo, hi)
               for lo, hi in windows]
    if len(windows) > 1:
        print(f"# chunked into {len(windows)} x {chunk} voxels",
              file=sys.stderr)

    # with one window its bindings are built once, outside the timed
    # path; with several, hoisted copies would hold every window's
    # data slice at once, so they are built per dispatch
    if len(windows) == 1:
        binds = [eng._bind(lo, hi) for lo, hi in windows]

        def run_once():
            final, _ = full(binds[0])
            jax.block_until_ready(final.post.means)
    else:
        def run_once():
            final = None
            for lo, hi in windows:
                final, _ = full(eng._bind(lo, hi))
            jax.block_until_ready(final.post.means)

    return _measure(run_once, nv, iters, config, NT_LABELS[config], quiet,
                    eng=eng)


def _measure(run_once, nv, iters, config, nt_label, quiet=False,
             eng=None):
    device, peaks = device_info()
    t0 = time.perf_counter()
    run_once()  # warmup (compile)
    compile_time = time.perf_counter() - t0

    reps = int(os.environ.get("FABBER_BENCH_REPS", 3))
    elapsed = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run_once()
        elapsed = min(elapsed, time.perf_counter() - t0)

    voxels_per_sec = nv / elapsed
    result = {
        "metric": "vb_convergence_voxels_per_sec",
        "value": round(voxels_per_sec, 1),
        "unit": "voxels/s",
        "vs_baseline": round(voxels_per_sec / REFERENCE_VOXELS_PER_SEC, 2),
        "device": device,
    }
    util = None
    if eng is not None:
        nt = eng.nt
        flops_v, bytes_v = _work_model(eng, config, nv, nt, iters)
        # wall time includes dispatch and the host, so these are lower
        # bounds on the device's own utilization
        util = {
            "flops_per_voxel": flops_v,
            "bytes_per_voxel": bytes_v,
            "achieved_gflops": round(flops_v * nv / elapsed / 1e9, 1),
            "achieved_gbps": round(bytes_v * nv / elapsed / 1e9, 1),
            "vs_f32_peak": round(flops_v * nv / elapsed
                                 / peaks["f32_flops_per_s"], 4),
            "vs_hbm_peak": round(bytes_v * nv / elapsed
                                 / peaks["hbm_bytes_per_s"], 4),
        }
    if not quiet:
        print(json.dumps(result))
    print(f"# config={config}: {nv} voxels x {iters} VB iterations "
          f"({nt_label}) in {elapsed:.3f}s wall (compile {compile_time:.1f}s) "
          f"on {device['kind']} ({device['platform']}, {device['count']} "
          "device(s))"
          + (f"; util {util['vs_hbm_peak']:.1%} of HBM peak / "
             f"{util['vs_f32_peak']:.1%} of f32 peak (lower bounds: wall "
             "time)" if util else ""),
          file=sys.stderr)
    return {"voxels_per_sec": voxels_per_sec, "elapsed": elapsed,
            "compile_s": compile_time, "utilization": util}


if __name__ == "__main__":
    main()
