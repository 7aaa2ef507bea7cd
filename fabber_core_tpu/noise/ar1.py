"""AR(1) autoregressive noise model with optional cross-terms.

Capability parity with the reference Ar1cNoiseModel
(noisemodel_ar.cc): AR(1) noise for 1-2 interleaved echoes, AR
coefficients alpha inferred as a small MVN per voxel, Gamma-distributed
precisions phi per echo, and the banded "alpha matrix" algebra of the
MATLAB NPINTS derivation.

Batched formulation: the reference materializes T x T banded
matrices per voxel (noisemodel_ar.cc:83-224). Every such matrix is a
*global* pattern — a single (symmetrized) shifted diagonal with entries
at (a + i*s, b + i*s), i = 0..nTimes-2, s = n_echoes — so every
quadratic form it enters reduces to strided-slice correlations over
[T,V] planes:

    k' M k             = w * (2 - [a==b]) * sum_i k[a+is] k[b+is]
    (J' M J)[p,q]      = w * (sum_i Jp[a+is] Jq[b+is] (+ mirrored))
    tr(C J' M J)       = sum_pq C[pq] (J' M J)[q,p]

and the per-voxel alpha marginals Q_n = sum_j coeff_nj(alpha) M_j are
never formed — their coefficients multiply the per-matrix scalar
reductions instead. Everything is elementwise vector work in the SoA
layout; no T x T objects exist anywhere.

State: alpha means [A,V] + covariance [A,A,V] (A = 2/3/4 for
cross-terms none/same/dual), phi_b/phi_c [Q,V].
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
from jax.scipy.special import digamma, gammaln

from ..core.dists import gamma_mean, gamma_var, gamma_from_mean_var
from ..exceptions import InvalidOptionValue
from ..ops import smallmat as sm
from ..options import OptionSpec, OPT_STR, OPT_INT
from .base import NoiseModel, register_noise


class Ar1NoiseState(NamedTuple):
    alpha_means: jnp.ndarray  # [A,V]
    alpha_cov: jnp.ndarray    # [A,A,V]
    alpha_prec: jnp.ndarray   # [A,A,V]
    b: jnp.ndarray            # [Q,V]
    c: jnp.ndarray            # [Q,V]


class Ar1DesignStats(NamedTuple):
    """Fixed-design sufficient statistics, one entry per basis matrix
    M_s (the flattened (echo, alpha-power) spec list): with a constant
    Jacobian D the offset cancels exactly, so every banded quadratic
    form reduces to r0' M_s r0 / D' M_s r0 / D' M_s D about the OLS
    reference point m0 (k = r0 - D (means - m0)). The VB loop then
    never touches [T,V] data (same construction as the white-noise
    DesignStats)."""
    m0: jnp.ndarray   # [P,V]
    rmr: jnp.ndarray  # [S,V]
    dmr: jnp.ndarray  # [S,P,V]
    dmd: jnp.ndarray  # [S,P,P]


class BandSpec(NamedTuple):
    """One global alpha matrix: entries w at (a+i*s, b+i*s), 0-based,
    symmetrized when a != b (noisemodel_ar.cc:104-180)."""
    a: int
    b: int
    w: float


def _band_spec(n, a12pow, a34pow, nphis):
    """Start positions for matrix (n, a12pow, a34pow); interleaved
    echo layout (noisemodel_ar.cc:126-171). 1-based rows from the
    reference, converted to 0-based."""
    table = {
        (0, 0): (1 + nphis, 1 + nphis),
        (1, 0): (1, 1 + nphis),
        (2, 0): (1, 1),
        (0, 1): (4, 3),
        (1, 1): (4, 1),
        (0, 2): (4, 4),
    }
    row, col = table[(a12pow, a34pow)]
    if n == 2:
        # swap odd/even rows: 2m -> 2m-1, 2m-1 -> 2m
        row = row - 1 + 2 * (row % 2)
        col = col - 1 + 2 * (col % 2)
    value = -1.0 if (a12pow + a34pow) == 1 else 1.0
    return BandSpec(row - 1, col - 1, value)


@register_noise
class Ar1NoiseModel(NoiseModel):
    name = "ar"
    # fixed-design support is stats-only: the direct design route has
    # no AR implementation (update_theta reads the Jacobian planes)
    supports_fixed_design = True
    fixed_design_direct = False

    def __init__(self, options, nt, masked_tpoints=()):
        super().__init__(options, nt, masked_tpoints)
        if masked_tpoints:
            raise InvalidOptionValue(
                "mt1", "", "Masked time points are not supported for the "
                "AR noise model")
        self.nphis = options.get_int("num-echoes", 1)
        self.ar1_type = options.get_string("ar1-cross-terms", "none")
        if self.ar1_type == "same":
            self.nalphas = 3
        elif self.ar1_type == "dual":
            self.nalphas = 4
        elif self.ar1_type == "none":
            self.nalphas = 2
        else:
            raise InvalidOptionValue("ar1-cross-terms", self.ar1_type,
                                     "Must be dual, same or none")
        if self.nphis == 1:
            if self.ar1_type != "none":
                raise InvalidOptionValue(
                    "ar1-cross-terms", self.ar1_type,
                    "You must use ar1-cross-terms=none with num-echoes=1")
        elif self.nphis != 2:
            raise InvalidOptionValue("num-echoes", self.nphis, "Must be 1 or 2")
        if nt % self.nphis != 0:
            raise InvalidOptionValue(
                "num-echoes", self.nphis,
                f"Data length {nt} not divisible by number of echoes")
        self.ntimes = nt // self.nphis  # samples per echo
        # AR model uses only 2 alphas per echo group; with nalphas==2
        # only the first-echo group exists in the cross-term basis
        self._basis = {}
        for n in range(1, self.nphis + 1):
            specs = [(0, 0), (1, 0), (2, 0)]
            if self.nalphas >= 3:
                specs += [(0, 1), (1, 1), (0, 2)]
            self._basis[n] = {(a12, a34): _band_spec(n, a12, a34, self.nphis)
                              for a12, a34 in specs}
        # flat spec ordering for the sufficient-statistics route
        self._spec_list = [(n, key) for n in range(1, self.nphis + 1)
                           for key in self._basis[n]]

    @classmethod
    def get_options(cls):
        return [
            OptionSpec("num-echoes", OPT_INT,
                       "Number of interleaved echoes", default="1"),
            OptionSpec("ar1-cross-terms", OPT_STR,
                       "Type of cross-linking between echoes "
                       "(dual, same or none)", default="none"),
        ]

    @property
    def num_params(self):
        """Noise parameters serialized into result MVNs: the alpha MVN
        concatenated with the phis (Ar1cParams::OutputAsMVN).

        NB the reference's NumParams() reports only nPhis, which makes
        its noise_means output read alpha values; here the count is
        consistent with what is actually serialized.
        """
        return self.nalphas + self.nphis

    # -- state ------------------------------------------------------------
    def initial_state(self, nvoxels, dtype):
        """Hardcoded dists (noisemodel_ar.cc:379-403) + the
        Precalculate phi_c adjustment (noisemodel_ar.cc:749-768)."""
        a, q, v = self.nalphas, self.nphis, nvoxels
        eye = np.zeros((a, a, 1))
        eye[np.arange(a), np.arange(a), 0] = 1.0

        def tile(x, like):
            return jnp.asarray(np.broadcast_to(x, like).copy(), dtype)

        # voxel-uniform prior: singleton voxel axis (broadcasts)
        prior = Ar1NoiseState(
            alpha_means=jnp.zeros((a, 1), dtype),
            alpha_prec=tile(eye * 1e-4, (a, a, 1)),
            alpha_cov=tile(eye * 1e4, (a, a, 1)),
            b=jnp.full((q, 1), 1e6, dtype),
            c=jnp.full((q, 1), 1e-6, dtype))
        alpha_means = jnp.zeros((a, v), dtype)
        # posterior phi_c starts at prior_c + (nTimes-1)/2 so the first
        # phi update doesn't cause an artificial F drop
        post = Ar1NoiseState(
            alpha_means=alpha_means,
            alpha_prec=tile(eye * 1e-4, (a, a, v)),
            alpha_cov=tile(eye * 1e4, (a, a, v)),
            b=jnp.full((q, v), 1e-8, dtype),
            c=jnp.full((q, v), 1e-6 + (self.ntimes - 1) * 0.5, dtype))
        return prior, post

    def state_to_mvn(self, state):
        am = np.asarray(state.alpha_means).T          # [V,A]
        ac = np.moveaxis(np.asarray(state.alpha_cov), -1, 0)
        pm = np.asarray(gamma_mean(state.b, state.c)).T
        pv = np.asarray(gamma_var(state.b, state.c)).T
        v = am.shape[0]
        a, q = self.nalphas, self.nphis
        means = np.concatenate([am, pm], axis=1)
        cov = np.zeros((v, a + q, a + q))
        cov[:, :a, :a] = ac
        cov[:, a + np.arange(q), a + np.arange(q)] = pv
        return means, cov

    def state_from_mvn(self, means, cov):
        means = np.asarray(means)
        cov = np.asarray(cov)
        a = self.nalphas
        am = jnp.asarray(means[:, :a].T)
        ac = jnp.asarray(np.moveaxis(cov[:, :a, :a], 0, -1))
        chol, _ = sm.cholesky_jittered(ac)
        ap = sm.inverse_from_chol(chol)
        pvar = np.diagonal(cov[:, a:, a:], axis1=-2, axis2=-1)
        b, c = gamma_from_mean_var(means[:, a:].T, pvar.T)
        return Ar1NoiseState(am, ac, ap, jnp.asarray(b), jnp.asarray(c))

    # -- banded quadratic forms -------------------------------------------
    def _corr(self, u, w, a, b):
        """sum_i u[a+i*s] * w[b+i*s] over [T,V] planes -> [V]."""
        s = self.nphis
        n = self.ntimes - 1
        return jnp.sum(u[a:a + n * s:s] * w[b:b + n * s:s], axis=0)

    def _kmk(self, k, spec):
        mult = 1.0 if spec.a == spec.b else 2.0
        return spec.w * mult * self._corr(k, k, spec.a, spec.b)

    def _jmj(self, jac, spec):
        """(J' M J)[p,q] planes: [P,P,V]."""
        p = jac.shape[0]
        rows = []
        for i in range(p):
            row = []
            for j in range(p):
                v = self._corr(jac[i], jac[j], spec.a, spec.b)
                if spec.a != spec.b:
                    v = v + self._corr(jac[i], jac[j], spec.b, spec.a)
                row.append(spec.w * v)
            rows.append(jnp.stack(row))
        return jnp.stack(rows)

    def _jmr(self, jac, r, spec):
        """(J' M r)[p] planes: [P,V]."""
        p = jac.shape[0]
        out = []
        for i in range(p):
            v = self._corr(jac[i], r, spec.a, spec.b)
            if spec.a != spec.b:
                v = v + self._corr(jac[i], r, spec.b, spec.a)
            out.append(spec.w * v)
        return jnp.stack(out)

    def _trace_form(self, cpl, jmj_planes):
        """tr(C J'MJ) from covariance planes [P,P,V]."""
        p = cpl.shape[0]
        s = 0.0
        for i in range(p):
            for j in range(p):
                s = s + cpl[i, j] * jmj_planes[j, i]
        return s

    def _marginal_coeffs(self, state):
        """Per-voxel coefficients of Q_n = sum_j coeff_j * M_j
        (noisemodel_ar.cc:197-222). Returns {n: {(a12,a34): [V]}}."""
        mu = state.alpha_means
        cov_plus = state.alpha_cov + mu[:, None, :] * mu[None, :, :]
        coeffs = {}
        for n in range(1, self.nphis + 1):
            one = jnp.ones_like(mu[0])
            cn = {(0, 0): one,
                  (1, 0): mu[n - 1],
                  (2, 0): cov_plus[n - 1, n - 1]}
            if self.nalphas >= 3:
                t = (2 + n if self.nalphas == 4 else 3) - 1  # 0-based
                cn[(0, 1)] = mu[t]
                cn[(1, 1)] = cov_plus[n - 1, t]
                cn[(0, 2)] = cov_plus[t, t]
            coeffs[n] = cn
        return coeffs

    # -- sufficient-statistics route (fixed design) -------------------------
    def make_design_stats(self, design, data):
        """One-time banded reductions for the fixed-design fast path.
        design [T,P], data [T,V] -> Ar1DesignStats."""
        from ..ops import smallmat as sm2
        p = design.shape[1]

        # OLS reference point (unweighted; cancellation control only)
        dtd = (design.T @ design)[:, :, None]
        dty = design.T @ data
        chol, ok = sm2.cholesky_jittered(dtd)
        m0 = sm2.solve_chol_vec(chol, dty)
        m0 = jnp.where(ok & jnp.all(jnp.isfinite(m0), axis=0), m0, 0.0)
        r0 = data - design @ m0  # [T,V]

        rmr, dmr, dmd = [], [], []
        for n, key in self._spec_list:
            spec = self._basis[n][key]
            rmr.append(self._kmk(r0, spec))
            # D' M r0 (symmetrized like _jmr), D columns as [T,1] planes
            cols_r, rows_d = [], []
            for i in range(p):
                di = design[:, i:i + 1]
                v = self._corr(di, r0, spec.a, spec.b)
                row = []
                for j in range(p):
                    dj = design[:, j:j + 1]
                    e = self._corr(di, dj, spec.a, spec.b)[0]
                    if spec.a != spec.b:
                        e = e + self._corr(di, dj, spec.b, spec.a)[0]
                    row.append(spec.w * e)
                if spec.a != spec.b:
                    v = v + self._corr(di, r0, spec.b, spec.a)
                cols_r.append(spec.w * v)
                rows_d.append(jnp.stack(row))
            dmr.append(jnp.stack(cols_r))
            dmd.append(jnp.stack(rows_d))
        return Ar1DesignStats(m0=m0, rmr=jnp.stack(rmr),
                              dmr=jnp.stack(dmr), dmd=jnp.stack(dmd))

    @staticmethod
    def design_stats_voxel(stats, v):
        """Single-voxel slice (Gauss-Seidel parity sweeps)."""
        import jax as _jax
        sl = lambda x: _jax.lax.dynamic_slice_in_dim(x, v, 1, axis=-1)
        return Ar1DesignStats(m0=sl(stats.m0), rmr=sl(stats.rmr),
                              dmr=sl(stats.dmr), dmd=stats.dmd)

    def _stats_quadratics(self, means, cov, stats):
        """Per spec s: (k'M_s k, tr(cov J'M_s J)) from the statistics,
        k = r0 - D (means - m0)."""
        delta = means - stats.m0  # [P,V]
        p = means.shape[0]
        kmk, tr = {}, {}
        for s, (n, key) in enumerate(self._spec_list):
            cross = sum(delta[a] * stats.dmr[s, a] for a in range(p))
            quad = 0.0
            t = 0.0
            for a in range(p):
                for b in range(p):
                    quad = quad + stats.dmd[s, a, b] * delta[a] * delta[b]
                    t = t + stats.dmd[s, a, b] * cov[a, b]
            kmk[(n, key)] = stats.rmr[s] - 2.0 * cross + quad
            tr[(n, key)] = t
        return kmk, tr

    def update_theta_stats(self, noise_post, prior_means, prior_prec,
                           stats, lm_alpha=None, centre=None):
        """Eq 19/20 from sufficient statistics (same arithmetic as
        update_theta up to the exact offset cancellation)."""
        si_ci = gamma_mean(noise_post.b, noise_post.c)
        coeffs = self._marginal_coeffs(noise_post)
        p = prior_means.shape[0]
        nv = prior_means.shape[1]

        ltmp = jnp.zeros((p, p, nv), prior_means.dtype)
        m_tmp = jnp.zeros_like(prior_means)
        for s, (n, key) in enumerate(self._spec_list):
            w = si_ci[n - 1] * coeffs[n][key]  # [V]
            ltmp = ltmp + w[None, None] * stats.dmd[s][:, :, None]
            # D'M y = D'M r0 + (D'M D) m0
            dmy = stats.dmr[s] + jnp.einsum("ab,bv->av", stats.dmd[s],
                                            stats.m0)
            m_tmp = m_tmp + w[None] * dmy

        prec = sm.add_diag(ltmp, prior_prec)
        chol, ok = sm.cholesky_jittered(prec)
        cov = sm.inverse_from_chol(chol)
        rhs = m_tmp + prior_prec * prior_means
        new_means = sm.matvec_planes(cov, rhs)
        return new_means, prec, cov, ok

    def update_noise_stats(self, noise_post, noise_prior, means, cov,
                           stats):
        """UpdateAlpha + UpdatePhi from the statistics."""
        kmk, tr = self._stats_quadratics(means, cov, stats)
        op = {sk: kmk[sk] + tr[sk] for sk in kmk}
        return self._alpha_phi_update(noise_post, noise_prior, means, op)

    def free_energy_stats(self, noise_post, noise_prior, means, prec, cov,
                          prior_means, prior_prec, stats):
        kmk, tr = self._stats_quadratics(means, cov, stats)
        si_ci = gamma_mean(noise_post.b, noise_post.c)
        coeffs = self._marginal_coeffs(noise_post)
        nv = means.shape[1]
        kqk = jnp.zeros(nv, means.dtype)
        trq = jnp.zeros(nv, means.dtype)
        for n, key in self._spec_list:
            w = si_ci[n - 1] * coeffs[n][key]
            kqk = kqk + w * kmk[(n, key)]
            trq = trq + w * tr[(n, key)]
        return self._free_energy_tail(noise_post, noise_prior, means, prec,
                                      cov, prior_means, prior_prec,
                                      kqk, trq)

    # -- VB updates --------------------------------------------------------
    def update_theta(self, noise_post, means, prior_means, prior_prec,
                     centre, offset, jac, data, lm_alpha=None, design=None):
        """Eq 19/20 with X = sum_n E[phi_n] Q_n (noisemodel_ar.cc:558-634).
        The LM variant is not defined for AR noise (the reference
        ignores LMalpha here too)."""
        si_ci = gamma_mean(noise_post.b, noise_post.c)  # [Q,V]
        coeffs = self._marginal_coeffs(noise_post)

        p = jac.shape[0]
        ltmp = jnp.zeros((p, p, means.shape[1]), means.dtype)
        resid = data - offset + jnp.einsum("ptv,pv->tv", jac, centre)
        m_tmp = jnp.zeros_like(means)
        for n in range(1, self.nphis + 1):
            for key, spec in self._basis[n].items():
                w = si_ci[n - 1] * coeffs[n][key]  # [V]
                ltmp = ltmp + w[None, None] * self._jmj(jac, spec)
                m_tmp = m_tmp + w[None] * self._jmr(jac, resid, spec)

        prec = sm.add_diag(ltmp, prior_prec)
        chol, ok = sm.cholesky_jittered(prec)
        cov = sm.inverse_from_chol(chol)
        rhs = m_tmp + prior_prec * prior_means
        new_means = sm.matvec_planes(cov, rhs)
        return new_means, prec, cov, ok

    def update_noise(self, noise_post, noise_prior, means, cov,
                     centre, offset, jac, data, design=None):
        """UpdateAlpha then UpdatePhi (noisemodel_ar.cc:405-556)."""
        k = data - offset + jnp.einsum("ptv,pv->tv", jac, centre - means)

        # OpKLJ(M) = k'Mk + tr(cov J'MJ) for each basis matrix, where
        # cov is the inverse of the theta precisions
        op = {}
        for n in range(1, self.nphis + 1):
            for key, spec in self._basis[n].items():
                op[(n, key)] = (self._kmk(k, spec)
                                + self._trace_form(cov, self._jmj(jac, spec)))
        return self._alpha_phi_update(noise_post, noise_prior, means, op)

    def _alpha_phi_update(self, noise_post, noise_prior, means, op):
        si_ci = gamma_mean(noise_post.b, noise_post.c)
        a = self.nalphas

        # -- alpha precision update (noisemodel_ar.cc:466-500)
        nv = means.shape[1]
        aprec = jnp.broadcast_to(
            noise_prior.alpha_prec,
            noise_prior.alpha_prec.shape[:2] + (nv,))
        for n in range(1, self.nphis + 1):
            aprec = aprec.at[n - 1, n - 1].add(
                si_ci[n - 1] * op[(n, (2, 0))])
        if a > 2:
            t = a - 1  # 0-based index of the last alpha
            aprec = aprec.at[2, 0].add(0.5 * si_ci[0] * op[(1, (1, 1))])
            aprec = aprec.at[0, 2].add(0.5 * si_ci[0] * op[(1, (1, 1))])
            aprec = aprec.at[t, 1].add(0.5 * si_ci[1] * op[(2, (1, 1))])
            aprec = aprec.at[1, t].add(0.5 * si_ci[1] * op[(2, (1, 1))])
            aprec = aprec.at[2, 2].add(si_ci[0] * op[(1, (0, 2))])
            aprec = aprec.at[t, t].add(si_ci[1] * op[(2, (0, 2))])

        achol, _ = sm.cholesky_jittered(aprec)
        acov = sm.inverse_from_chol(achol)

        # -- alpha means update (noisemodel_ar.cc:501-513)
        tmp = jnp.broadcast_to(
            sm.matvec_planes(noise_prior.alpha_prec,
                             noise_prior.alpha_means), (a, nv))
        for n in range(1, self.nphis + 1):
            tmp = tmp.at[n - 1].add(-0.5 * si_ci[n - 1] * op[(n, (1, 0))])
        if a > 2:
            t = a - 1
            tmp = tmp.at[2].add(-0.5 * si_ci[0] * op[(1, (0, 1))])
            tmp = tmp.at[t].add(-0.5 * si_ci[1] * op[(2, (0, 1))])
        ameans = sm.matvec_planes(acov, tmp)

        new_alpha = noise_post._replace(
            alpha_means=ameans, alpha_cov=acov, alpha_prec=aprec)

        # -- phi update with the *new* alpha marginals
        # (noisemodel_ar.cc:530-556)
        coeffs = self._marginal_coeffs(new_alpha)
        new_b, new_c = [], []
        for n in range(1, self.nphis + 1):
            tmp_n = 0.0
            for key in self._basis[n]:
                tmp_n = tmp_n + coeffs[n][key] * op[(n, key)]
            b = 1.0 / (tmp_n * 0.5 + 1.0 / noise_prior.b[n - 1])
            c = jnp.full_like(b, (self.ntimes - 1) * 0.5) \
                + noise_prior.c[n - 1]
            new_b.append(b)
            new_c.append(c)
        return new_alpha._replace(b=jnp.stack(new_b), c=jnp.stack(new_c))

    def free_energy(self, noise_post, noise_prior, means, prec, cov,
                    prior_means, prior_prec, centre, offset, jac, data,
                    design=None):
        """Full ELBO, translated from the reference's NPINTS port
        (noisemodel_ar.cc:643-747)."""
        dtype = means.dtype
        nv = means.shape[1]
        k = data - offset + jnp.einsum("ptv,pv->tv", jac, centre - means)
        si_ci = gamma_mean(noise_post.b, noise_post.c)
        coeffs = self._marginal_coeffs(noise_post)

        # k' Qsum k and tr(J' Qsum J Linv) via the basis decomposition
        kqk = jnp.zeros(nv, dtype)
        trq = jnp.zeros(nv, dtype)
        for n in range(1, self.nphis + 1):
            for key, spec in self._basis[n].items():
                w = si_ci[n - 1] * coeffs[n][key]
                kqk = kqk + w * self._kmk(k, spec)
                trq = trq + w * self._trace_form(cov, self._jmj(jac, spec))
        return self._free_energy_tail(noise_post, noise_prior, means, prec,
                                      cov, prior_means, prior_prec,
                                      kqk, trq)

    def _free_energy_tail(self, noise_post, noise_prior, means, prec, cov,
                          prior_means, prior_prec, kqk, trq):
        dtype = means.dtype
        nv = means.shape[1]
        n_theta = means.shape[0]
        a = self.nalphas
        log2pi = jnp.log(2 * jnp.pi).astype(dtype)

        achol, _ = sm.cholesky_jittered(noise_post.alpha_prec)
        exp_alpha = (0.5 * sm.logdet_from_chol(achol)
                     - 0.5 * a * (log2pi + 1.0))
        tchol, _ = sm.cholesky_jittered(prec)
        exp_theta = (0.5 * sm.logdet_from_chol(tchol)
                     - 0.5 * n_theta * (log2pi + 1.0))

        exp_phi = jnp.zeros(nv, dtype)
        part0 = jnp.zeros(nv, dtype)
        part9 = jnp.zeros(nv, dtype)
        for i in range(self.nphis):
            si, ci = noise_post.b[i], noise_post.c[i]
            si0, ci0 = noise_prior.b[i], noise_prior.c[i]
            dg_ls = digamma(ci) + jnp.log(si)
            exp_phi += (-gammaln(ci) - ci * jnp.log(si) - ci
                        + (ci - 1.0) * dg_ls)
            part0 += dg_ls * ((self.ntimes - 1) * 0.5 + ci0 - 1.0)
            part9 += (-2.0 * gammaln(ci0) - 2.0 * ci0 * jnp.log(si0)
                      - si * ci / si0)

        part1 = -log2pi * ((self.ntimes - 1) + 0.5 * a + 0.5 * n_theta)
        part2 = -0.5 * kqk - 0.5 * trq
        part3 = 0.5 * jnp.sum(jnp.log(prior_prec), axis=0)
        dm = means - prior_means
        part4 = -0.5 * jnp.sum(dm * prior_prec * dm, axis=0)
        part5 = -0.5 * jnp.sum(sm.diag_of(cov) * prior_prec, axis=0)
        pchol, _ = sm.cholesky_jittered(noise_prior.alpha_prec)
        part6 = 0.5 * sm.logdet_from_chol(pchol)
        da = noise_post.alpha_means - noise_prior.alpha_means
        part7 = -0.5 * jnp.einsum(
            "av,av->v", da, sm.matvec_planes(noise_prior.alpha_prec, da))
        part8 = -0.5 * self._trace_form(noise_post.alpha_cov,
                                        noise_prior.alpha_prec)

        return (-exp_alpha - exp_theta - exp_phi
                + part0 + part1 + part2 + part3 + part4 + part5
                + part6 + part7 + part8 + part9)
