"""Batched nonlinear least squares (Levenberg / Levenberg-Marquardt).

Capability parity with the reference NLLS method
(inference_nlls.cc:90-293), which drives the MISCMATHS ``nonlin``
optimizer per voxel. Here all voxels run a damped Gauss-Newton loop
simultaneously in SoA layout (voxels on lanes) with per-lane damping
factors and accept/reject masks:

    cost     = ||y - f(p)||^2 (masked timepoints excluded)
    step     solve (J'J + lambda * D) delta = J'r
    L mode   D = I        (reference default, LM_L)
    LM mode  D = diag(J'J) (--lm flag)

Posterior: precision = J'J / mse with a 1e-6 diagonal floor
(inference_nlls.cc:175-192); failed lanes get precision 1e-12*I.

Fast tier — fixed-design sufficient statistics: for models linear in
their (untransformed) parameters (poly / linear design matrices,
model.fixed_design) the Jacobian is the constant design D, so the
whole optimizer loop runs on P-dim planes:

    cost(m)  = r0'r0 - 2 d'(D'r0) + d'(D'D)d,   d = m - m0
    J'r(m)   = D'r0 - (D'D) d
    J'J      = D'D                               (voxel-invariant)

with m0 the per-voxel OLS reference point (cost assembles from
residual-scale terms, same cancellation-safe construction as the VB
DesignStats, noise/white.py). One [T,V] pass builds the stats; the
iteration loop never touches the data plane again — the exact
pathology fix the VB stats route applies to Eq 19-22
(inference_nlls.cc:230-293 recompute J and the T-length residual
every callback).

Further, the damped solve collapses to SCALARS in an eigenbasis (the
same trick as the VB spectral route, ops/spectral.py): the damping
matrix is voxel-INVARIANT up to the per-lane scalar lambda —
Levenberg damp = I, Marquardt damp = diag(D'D) — so with the
(damp-whitened) Gram W (D'D) W = E diag(Lam) E' (host f64, W =
damp^-1/2), the per-lane solve (D'D + lam damp)^-1 g becomes P
independent rationals 1/(Lam_i + lam) in z = E'W^-1 d coordinates,
and the cost quadratic is sum_i Lam_i z_i^2. The whole LM loop runs
as ~8 fused elementwise [V]-row ops per iteration: no [P,P,V] plane
is ever materialized inside the loop.

Execution is windowed like the VB engine: one compiled program per
fixed-size voxel window (initial estimates built on device when
traceable), so device memory is bounded at any volume size.
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import resolve_parameters, PRIOR_IMAGE
from ..ops import smallmat as sm
from ..options import OptionSpec, OPT_BOOL, OPT_INT, OPT_STR
from ..devices import planning_budget
from .linearize import Linearizer
from .vb import VBResult, _concat_results

LAMBDA_INIT = 1e-3
LAMBDA_GROW = 10.0
LAMBDA_SHRINK = 0.1
LAMBDA_MAX = 1e10
PREC_DIAG_FLOOR = 1e-6
FAIL_PRECISION = 1e-12
# relative cost-gain convergence (the MISCMATHS nonlin driver's
# cost-tolerance family, inference_nlls.cc:135-153): an accepted step
# that improves the cost by <= CFTOL * |cost| converges the lane.
# Without it a lane near the optimum keeps accepting roundoff-level
# improvements (lambda shrinking each time), so it never reaches the
# lambda ceiling and runs every one of the max iterations — measured
# ~10x the useful work on the linear benchmark.
# The value is scaled to the f32 cost arithmetic this engine runs: a
# double-precision-era 1e-8 sits BELOW f32 eps (1.2e-7), so near the
# optimum no accepted step can ever clear it — lanes then "converge"
# by climbing the whole lambda ladder to the 1e10 ceiling (~13
# rejected trials each; measured 43 -> 26 mean iterations on the
# biexp benchmark with identical final cost to 6 digits). The floor
# for a MEANINGFUL tolerance is the f32 cost-sum noise, ~sqrt(T) * eps
# * cost ~ 1e-6 * cost at T~100: a threshold at that level makes
# accept/convergence decisions flip on summation order (routes then
# disagree on iteration counts by whole lambda ladders). 1e-5 is one
# decade above the noise floor — reproducible across routes, final
# cost identical to ~5 digits.
CFTOL = 1e-5
# plateau convergence: a REJECTED trial whose cost sits within
# CFTOL * |cost| of the current cost, attempted at lambda >=
# PLATEAU_LAMBDA, converges the lane at its current params. Without
# it every lane's terminal phase is a full lambda-ladder climb to the
# 1e10 ceiling (~13 rejected trials each — for the linear fast tier
# that ladder IS most of the iteration count, since step 1 lands on
# the optimum). The lambda guard keeps an early small-overshoot
# rejection (lambda still < 1) from stopping a lane at its initial
# estimates; reaching lambda >= 1 from 1e-3 takes >= 3 consecutive
# rejections, i.e. the step direction is already pinned down.
PLATEAU_LAMBDA = 1.0


class NLLSState(NamedTuple):
    params: jnp.ndarray  # [P,V]
    cost: jnp.ndarray    # [V]
    lam: jnp.ndarray     # [V]
    done: jnp.ndarray    # [V] bool
    it: jnp.ndarray      # scalar
    its: jnp.ndarray     # [V] per-voxel optimizer iterations
                         # (inference_nlls.cc:110-153 runs the optimizer
                         # per voxel; lanes stop counting once done)


class NLLSStats(NamedTuple):
    """Fixed-design sufficient statistics (see module docstring)."""
    m0: Any    # [P,V] OLS reference point
    rtr: Any   # [V]   r0'r0, r0 = y - D m0 (masked rows zeroed)
    dtr: Any   # [P,V] D'r0
    dtd: Any   # [P,P] D'D (voxel-invariant)


class NLLSInference:
    """method=nlls. Shares the model/linearization stack with VB."""

    @classmethod
    def get_options(cls):
        return [
            OptionSpec("vb-init", OPT_BOOL,
                       "Whether NLLS is being run as a pre-step for VB"),
            OptionSpec("lm", OPT_BOOL,
                       "Use Levenberg-Marquardt damping (default Levenberg)"),
            OptionSpec("nlls-max-iterations", OPT_INT,
                       "Maximum optimizer iterations", default="100"),
            OptionSpec("fwd-initial-posterior", OPT_STR,
                       "MVN matrix file with initial parameter estimates"),
        ]

    def __init__(self, model, options, data, coords, suppdata=None,
                 voxel_data_getter=None, dtype=None, data_plane=None,
                 supp_plane=None):
        self.model = model
        self.options = options
        self.dtype = dtype or (jnp.float64 if options.get_string(
            "dtype", "double") == "double" else jnp.float32)
        self.data = data_plane if data_plane is not None \
            else jnp.asarray(data, self.dtype).T         # [T,V]
        self.coords = jnp.asarray(coords, self.dtype).T  # [3,V]
        if supp_plane is not None:
            self.suppdata = supp_plane
        else:
            self.suppdata = None if suppdata is None \
                or suppdata.shape[1] == 0 \
                else jnp.asarray(suppdata, self.dtype).T
        self.nt, self.nvoxels = self.data.shape
        self._fetch = np.asarray
        self._pre_excised = None

        self.masked_tpoints = options.get_int_list("mt", 1)
        tmask = np.ones((self.nt, 1))
        for t in self.masked_tpoints:
            tmask[t - 1, 0] = 0.0
        self.tmask = jnp.asarray(tmask, self.dtype)  # [T,1]
        self.n_unmasked = int(tmask.sum())

        self.params = resolve_parameters(model, options)
        self.nparams = len(self.params)
        self._voxel_data = voxel_data_getter or (lambda key: (_ for _ in ()).throw(
            KeyError(key)))

        self.marquardt = options.get_bool("lm")
        self.vb_init = options.get_bool("vb-init")
        self.max_its = options.get_int("nlls-max-iterations", 100, minval=1)

        lin_mode = options.get_string("linearization", "auto")
        self.linearizer = Linearizer(model, self.params, self.nt,
                                     mode=lin_mode)

        # Constant-Jacobian fast tier (same gate as the VB engine,
        # vb.py): linear-in-parameters model, identity transforms,
        # autodiff linearization
        self.design = None
        if (lin_mode == "auto"
                and all(pm.transform.is_identity for pm in self.params)):
            d = model.fixed_design(self.nt)
            if d is not None:
                self.design = jnp.asarray(d, self.dtype)
        self.use_stats = self.design is not None

        if self.use_stats:
            # host-f64 eigenbasis of the damp-whitened Gram (module
            # docstring): z = Bz d, grad coords Bg jtr, d = Bback z
            dw = (np.asarray(self.design, np.float64)
                  * np.asarray(tmask, np.float64))
            dtd = dw.T @ dw
            damp = np.diag(dtd).copy() if self.marquardt \
                else np.ones(self.nparams)
            damp = np.maximum(damp, 1e-300)
            w = 1.0 / np.sqrt(damp)
            lam_h, e_h = np.linalg.eigh(w[:, None] * dtd * w[None, :])
            self._eig = (
                [float(x) for x in np.maximum(lam_h, 0.0)],  # Lam
                e_h.T * (1.0 / w)[None, :],                  # Bz
                e_h.T * w[None, :],                          # Bg
                w[:, None] * e_h,                            # Bback
            )

    def route_description(self):
        """Which optimizer arithmetic this configuration landed on
        (logged by the runner, mirroring the VB route line)."""
        if self.use_stats:
            return ("fixed-design sufficient-statistics NLLS "
                    "(P-dim LM loop in the damp-whitened eigenbasis)")
        return "generic-Jacobian NLLS (per-iteration linearization)"

    def initial_means(self):
        """Initial estimate from the model's posterior defaults;
        returns [P,V] planes (host path; used when not traceable)."""
        v, p = self.nvoxels, self.nparams
        means = np.zeros((v, p))
        for i, spec in enumerate(self.params):
            if spec.prior_type == PRIOR_IMAGE:
                img = np.asarray(self._voxel_data(spec.options["image"]))
                means[:, i] = img.reshape(v, -1)[:, 0]
            else:
                means[:, i] = spec.post.mean
        means = np.array(self.model.init_posterior(
            self.data.T, jnp.asarray(means)))

        # Optional file-based initial estimates (inference_nlls.cc:75-81)
        init_file = self.options.get_string("fwd-initial-posterior",
                                            "modeldefault")
        if init_file != "modeldefault":
            from ..io import mvn as mvn_io
            fmeans, _ = mvn_io.load_matrix(init_file)
            means = np.broadcast_to(fmeans[None, :], means.shape).copy()

        for i, spec in enumerate(self.params):
            means[:, i] = np.asarray(spec.transform.to_latent(
                jnp.asarray(means[:, i])))
        return jnp.asarray(means.T, self.dtype)

    def _can_trace_init(self):
        return (all(spec.prior_type != PRIOR_IMAGE for spec in self.params)
                and self.options.get_string(
                    "fwd-initial-posterior",
                    "modeldefault") == "modeldefault")

    def _initial_means_traced(self, data):
        """Device-built initial estimates (pure function of the data
        window; no volume-sized host constants in the program)."""
        v = data.shape[1]
        cols = [jnp.full((v,), spec.post.mean, self.dtype)
                for spec in self.params]
        means = jnp.stack(cols, axis=1)  # [V,P] model space
        means = self.model.init_posterior(data.T, means)
        lat = [self.params[i].transform.to_latent(means[:, i])
               for i in range(self.nparams)]
        return jnp.stack(lat).astype(self.dtype)

    def _bind(self, lo=0, hi=None):
        from .vb import RunBindings
        hi = self.nvoxels if hi is None else hi
        sl = slice(None) if (lo == 0 and hi == self.nvoxels) \
            else slice(lo, hi)
        supp = self.suppdata[:, sl] if self.suppdata is not None \
            else jnp.zeros((0, hi - lo), self.dtype)
        return RunBindings(data=self.data[:, sl], coords=self.coords[:, sl],
                           supp=supp, prior_base_means=())

    def evaluate_model(self, means_planes, key=""):
        """Model prediction [T,V] at latent means [P,V] (for outputs)."""
        v = np.shape(means_planes)[-1]
        if v != self.nvoxels:  # padded sharded engine (see vb.py)
            means_planes = np.concatenate(
                [np.asarray(means_planes)] +
                [np.asarray(means_planes)[..., -1:]] * (self.nvoxels - v),
                axis=-1)
            return self._fetch(self.evaluate_model(means_planes,
                                                   key))[..., :v]
        bind = self._bind()
        lin = self.linearizer if not key else Linearizer(
            self.model, self.params, self.nt, key=key)
        return lin.evaluate(jnp.asarray(means_planes, self.dtype),
                            bind.data, bind.coords, bind.supp)

    # -- fixed-design sufficient statistics -------------------------------
    def _make_stats(self, bind):
        """One [T,V] pass -> NLLSStats (runs inside the jitted solve)."""
        dw = self.design * self.tmask          # [T,P] masked design
        yw = bind.data * self.tmask            # [T,V]
        dtd = dw.T @ dw                        # [P,P]
        dty = dw.T @ yw                        # [P,V]
        chol, ok = sm.cholesky_jittered(dtd[:, :, None])
        m0 = sm.solve_chol_vec(chol, dty)
        m0 = jnp.where(ok & jnp.all(jnp.isfinite(m0), axis=0), m0, 0.0)
        r0 = yw - dw @ m0
        rtr = jnp.sum(r0 * r0, axis=0)
        dtr = dw.T @ r0
        return NLLSStats(m0=m0, rtr=rtr, dtr=dtr, dtd=dtd)

    def _cost(self, params, bind, stats=None):
        if stats is not None:
            d = params - stats.m0
            quad = jnp.einsum("pv,pq,qv->v", d, stats.dtd, d)
            return stats.rtr - 2.0 * jnp.sum(d * stats.dtr, axis=0) + quad
        pred = self.linearizer.evaluate(params, bind.data, bind.coords,
                                        bind.supp)
        r = (bind.data - pred) * self.tmask
        return jnp.sum(r * r, axis=0)

    def _jtj_jtr(self, params, bind, stats=None):
        if stats is not None:
            d = params - stats.m0
            jtr = stats.dtr - jnp.einsum("pq,qv->pv", stats.dtd, d)
            jtj = jnp.broadcast_to(
                stats.dtd[:, :, None],
                stats.dtd.shape + (params.shape[-1],))
            return jtj, jtr
        offset, jac = self.linearizer(params, bind.data, bind.coords,
                                      bind.supp)
        jac = jac * self.tmask[None]
        r = (bind.data - offset) * self.tmask
        p = self.nparams
        jtj = jnp.stack([
            jnp.stack([jnp.sum(jac[i] * jac[j], axis=0) for j in range(p)])
            for i in range(p)])
        jtr = jnp.stack([jnp.sum(jac[i] * r, axis=0) for i in range(p)])
        return jtj, jtr

    def _step(self, s, bind, stats=None):
        jtj, jtr = self._jtj_jtr(s.params, bind, stats)
        if self.marquardt:
            damp = sm.diag_of(jtj)
        else:
            damp = jnp.ones_like(s.params)
        damped = sm.add_diag(jtj, s.lam[None] * damp)
        chol, _ok = sm.cholesky_jittered(damped)
        delta = sm.solve_chol_vec(chol, jtr)

        trial = s.params + delta
        trial_cost = self._cost(trial, bind, stats)
        better = (trial_cost < s.cost) & jnp.isfinite(trial_cost)

        params = jnp.where(better[None], trial, s.params)
        cost = jnp.where(better, trial_cost, s.cost)
        lam = jnp.where(better, s.lam * LAMBDA_SHRINK, s.lam * LAMBDA_GROW)
        converged = better & (
            s.cost - trial_cost
            <= CFTOL * jnp.maximum(jnp.abs(trial_cost), 1e-30))
        plateau = (~better) & jnp.isfinite(trial_cost) \
            & (s.lam >= PLATEAU_LAMBDA) \
            & (trial_cost - s.cost
               <= CFTOL * jnp.maximum(jnp.abs(s.cost), 1e-30))
        done = s.done | (lam > LAMBDA_MAX) | converged | plateau

        keep = s.done
        return NLLSState(
            jnp.where(keep[None], s.params, params),
            jnp.where(keep, s.cost, cost),
            jnp.where(keep, s.lam, lam),
            done, s.it + 1,
            s.its + (~keep).astype(s.its.dtype))

    def _solve_body(self, p0, bind):
        if self.use_stats:
            return self._solve_body_eigen(p0, bind)
        stats = None
        nv = bind.data.shape[1]
        s0 = NLLSState(
            params=p0, cost=self._cost(p0, bind, stats),
            lam=jnp.full(nv, LAMBDA_INIT, self.dtype),
            done=jnp.zeros(nv, bool),
            it=jnp.array(0, jnp.int32),
            its=jnp.zeros(nv, jnp.int32))
        s = jax.lax.while_loop(
            lambda s: (~jnp.all(s.done)) & (s.it < self.max_its),
            lambda st: self._step(st, bind, stats), s0)
        # posterior precision = J'J/mse, diagonal floor 1e-6
        jtj, _ = self._jtj_jtr(s.params, bind, stats)
        mse = s.cost / (self.n_unmasked - self.nparams)
        prec = jtj / mse[None, None]
        d = sm.diag_of(prec)
        prec = sm.add_diag(jnp.where(jnp.eye(self.nparams, dtype=bool)
                                     [:, :, None], 0.0, prec),
                           jnp.maximum(d, PREC_DIAG_FLOOR))
        chol, _ = sm.cholesky_jittered(prec)
        cov = sm.inverse_from_chol(chol)
        return s, prec, cov

    def _solve_body_eigen(self, p0, bind):
        """Fixed-design LM loop in the damp-whitened eigenbasis: P
        independent scalar rationals per lane per iteration (module
        docstring). Same accept/reject/convergence semantics as
        _step, so iteration counts match the generic route."""
        dt = self.dtype
        stats = self._make_stats(bind)
        nv = bind.data.shape[1]
        p = self.nparams
        lam_h, bz_h, bg_h, bback_h = self._eig
        lam_c = [jnp.asarray(x, dt) for x in lam_h]
        bz = jnp.asarray(bz_h, dt)
        bg = jnp.asarray(bg_h, dt)
        bback = jnp.asarray(bback_h, dt)

        # loop-invariant eigen-coordinate rows ([V] each)
        u = [r[0] for r in jnp.split(bg @ stats.dtr, p)]
        z0m = bz @ (p0 - stats.m0)
        z0 = [r[0] for r in jnp.split(z0m, p)]
        rtr = stats.rtr

        def cost_of(z):
            c = rtr
            for i in range(p):
                c = c + lam_c[i] * z[i] * z[i] - 2.0 * z[i] * u[i]
            return c

        def step(carry):
            z, cost, lam, done, it, its = carry
            trial = []
            for i in range(p):
                g = u[i] - lam_c[i] * z[i]
                trial.append(z[i] + g / (lam_c[i] + lam))
            tcost = cost_of(trial)
            better = (tcost < cost) & jnp.isfinite(tcost)
            znew = tuple(jnp.where(better, trial[i], z[i])
                         for i in range(p))
            cnew = jnp.where(better, tcost, cost)
            lnew = jnp.where(better, lam * LAMBDA_SHRINK,
                             lam * LAMBDA_GROW)
            converged = better & (
                cost - tcost <= CFTOL * jnp.maximum(jnp.abs(tcost),
                                                    1e-30))
            plateau = (~better) & jnp.isfinite(tcost) \
                & (lam >= PLATEAU_LAMBDA) \
                & (tcost - cost
                   <= CFTOL * jnp.maximum(jnp.abs(cost), 1e-30))
            dnew = done | (lnew > LAMBDA_MAX) | converged | plateau
            keep = done
            z = tuple(jnp.where(keep, z[i], znew[i]) for i in range(p))
            return (z, jnp.where(keep, cost, cnew),
                    jnp.where(keep, lam, lnew), dnew, it + 1,
                    its + (~keep).astype(its.dtype))

        carry0 = (tuple(z0), cost_of(z0),
                  jnp.full(nv, LAMBDA_INIT, dt),
                  jnp.zeros(nv, bool), jnp.array(0, jnp.int32),
                  jnp.zeros(nv, jnp.int32))
        z, cost, lam, done, it, its = jax.lax.while_loop(
            lambda c: (~jnp.all(c[3])) & (c[4] < self.max_its),
            step, carry0)

        params = stats.m0 + bback @ jnp.stack(z)
        s = NLLSState(params=params, cost=cost, lam=lam, done=done,
                      it=it, its=its)
        # posterior precision = J'J/mse with the diagonal floor — the
        # only [P,P,V] planes of the whole solve, built once
        jtj = jnp.broadcast_to(stats.dtd[:, :, None],
                               stats.dtd.shape + (nv,))
        mse = cost / (self.n_unmasked - p)
        prec = jtj / mse[None, None]
        d = sm.diag_of(prec)
        prec = sm.add_diag(jnp.where(jnp.eye(p, dtype=bool)[:, :, None],
                                     0.0, prec),
                           jnp.maximum(d, PREC_DIAG_FLOOR))
        chol, _ = sm.cholesky_jittered(prec)
        cov = sm.inverse_from_chol(chol)
        return s, prec, cov

    def _chunk_size(self):
        """Voxels per device pass (memory-bounded execution at any
        volume size, mirroring the VB engine's convention)."""
        explicit = self.options.get_int("voxel-chunk-size", 0)
        if explicit > 0:
            return explicit
        item = jnp.dtype(self.dtype).itemsize
        p, t = self.nparams, self.nt
        if self.use_stats:
            # one [T,V] stats pass; loop temps are P-dim planes
            per_vox = (3 * t + 8 * p * p + 10 * p + 24) * item
        else:
            # per-iteration [P,T,V] Jacobian + autodiff intermediates
            per_vox = (t * (3 * p + 8) + 6 * p * p + 10 * p + 24) * item
        return max(16384, int(planning_budget() / per_vox))

    def run(self):
        traced = self._can_trace_init()
        if traced:
            @jax.jit
            def solve_full(bind):
                return self._solve_body(
                    self._initial_means_traced(bind.data), bind)
        else:
            solve_win = jax.jit(self._solve_body)
            p0_full = self.initial_means()

        chunk = min(self._chunk_size(), self.nvoxels)

        def run_window(lo, hi):
            bind = self._bind(lo, hi)
            if traced:
                return solve_full(bind)
            return solve_win(p0_full[:, lo:hi], bind)

        windows = [(lo, min(lo + chunk, self.nvoxels))
                   for lo in range(0, self.nvoxels, chunk)]
        # fixed-size windows, final window slid back (one trace)
        windows = [(hi - chunk, hi) if hi - lo < chunk else (lo, hi)
                   for lo, hi in windows]
        results = []
        prev_hi = 0
        for lo, hi in windows:
            take_from = prev_hi - lo  # overlap of the slid last window
            s, prec, cov = run_window(lo, hi)
            res = self._to_result(s, cov, hi - lo)
            if take_from:
                res = jax.tree_util.tree_map(
                    lambda x: x[take_from:]
                    if hasattr(x, "ndim") and x.ndim >= 1
                    and x.shape[0] == chunk else x, res)
            results.append(res)
            prev_hi = hi
            cb = getattr(self, "progress_cb", None)
            if cb is not None:
                cb(hi, self.nvoxels)
        return results[0] if len(results) == 1 \
            else _concat_results(results)

    def _to_result(self, s, cov, nv):
        means = self._fetch(s.params).T.copy()              # [V,P]
        cov = np.moveaxis(self._fetch(cov), -1, 0).copy()   # [V,P,P]
        bad = ~(np.isfinite(means).all(axis=1)
                & np.isfinite(cov).reshape(cov.shape[0], -1).all(axis=1))
        if bad.any():
            # failed lanes: keep params, set precision 1e-12*I
            # (inference_nlls.cc:195-214)
            cov[bad] = np.eye(self.nparams) / FAIL_PRECISION
            means[bad] = np.nan_to_num(means[bad])

        return VBResult(
            means=means, cov=cov,
            noise_means=np.zeros((nv, 0)),
            noise_cov=np.zeros((nv, 0, 0)),
            free_energy=None, fhistory=None,
            iterations=np.asarray(self._fetch(s.its)).copy(),
            bad_voxels=bad)
