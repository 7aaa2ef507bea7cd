"""White-noise VB update equations in SoA (voxels-on-lanes) layout.

Implements the analytic VB fixed-point updates of Chappell et al. 2009
(Eqs 19-22) with the same numerical conventions as the reference
(noisemodel_white.cc:228-454), re-expressed as whole-volume plane arithmetic:
every per-voxel quantity is a [..., V] plane (voxels on the fastest,
vectorized axis) and the tiny P x P algebra is unrolled elementwise
(ops/smallmat.py) instead of batched LAPACK calls — the layout a SIMD
machine wants when P << 128.

Array shapes:  means/prior [P,V], precision/covariance [P,P,V],
data/offset [T,V], Jacobian [P,T,V], noise state phi_b/phi_c [Q,V].

Update equations:
  * theta:  Lambda = Lambda0 + J^T X J,
            m = Lambda^-1 (J^T X (y - g(m) + J m_c) + Lambda0 m0)
    with X = diag of E[phi] per timepoint (masked timepoints excluded);
  * phi:    1/b = (k^T Q k + tr(Sigma J^T Q J))/2 + 1/b0,
            c = (n-1)/2 + c0;
  * free energy: full ELBO with digamma/gammaln terms.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
from jax.scipy.special import digamma, gammaln

from ..core.dists import gamma_mean, gamma_var, gamma_from_mean_var
from ..exceptions import FabberError, InvalidOptionValue
from ..ops import smallmat as sm
from ..options import OptionSpec, OPT_STR, OPT_FLOAT
from .base import NoiseModel, register_noise


class WhiteNoiseState(NamedTuple):
    b: jnp.ndarray  # [Q, V]
    c: jnp.ndarray  # [Q, V]


class DesignStats(NamedTuple):
    """Sufficient statistics for fixed-design VB (no [T,V] traffic in
    the iteration loop).

    With a constant Jacobian J = D the linearization offset D@centre
    cancels exactly in every update equation (k = y - D@means,
    residual-in-theta-update = y), so the whole fixed point is a
    function of the data only through these per-voxel reductions,
    computed once per run. They are taken about a per-voxel ordinary-
    least-squares reference point m0 so the quadratic k'Qk assembles
    from residual-scale terms (raw y'Qy expansion would lose ~all
    significant bits in float32 when fits are tight).
    """
    m0: jnp.ndarray    # [P,V]   OLS reference point
    rtqr: jnp.ndarray  # [Q,V]   r0' Q_i r0,  r0 = y - D m0
    dtqr: jnp.ndarray  # [Q,P,V] D' Q_i r0
    dtqd: jnp.ndarray  # [Q,P,P] D' Q_i D


def parse_noise_pattern(pattern, nt):
    """Expand a pattern string to a group index per timepoint.

    Characters 1-9 then A-Z/a-z index phi groups from 1
    (noisemodel_white.cc:166-201). Returns int array [nt] of 0-based
    group ids and the number of groups.
    """
    if len(pattern) == 0:
        raise InvalidOptionValue("noise-pattern", pattern, "Empty pattern")
    if len(pattern) > nt:
        raise InvalidOptionValue("noise-pattern", pattern,
                                 "Pattern length exceeds data length")
    ids = []
    for ch in pattern:
        if "1" <= ch <= "9":
            n = ord(ch) - ord("0")
        elif "A" <= ch <= "Z":
            n = ord(ch) - ord("A") + 10
        elif "a" <= ch <= "z":
            n = ord(ch) - ord("a") + 10
        else:
            raise InvalidOptionValue("noise-pattern", ch, "Invalid character")
        ids.append(n - 1)
    nq = max(ids) + 1
    full = [ids[i % len(ids)] for i in range(nt)]
    return np.array(full, dtype=np.int32), nq


@register_noise
class WhiteNoiseModel(NoiseModel):
    name = "white"
    supports_fixed_design = True

    def __init__(self, options, nt, masked_tpoints=()):
        super().__init__(options, nt, masked_tpoints)
        pattern = options.get_string("noise-pattern", "1")
        group_ids, self.nphis = parse_noise_pattern(pattern, nt)

        # Indicator masks Q_i [Q, T]; masked timepoints belong to no group
        unmasked = np.ones(nt, dtype=bool)
        for t in self.masked_tpoints:  # 1-indexed
            unmasked[t - 1] = False
        self.qmasks = np.zeros((self.nphis, nt))
        for t in range(nt):
            if unmasked[t]:
                self.qmasks[group_ids[t], t] = 1.0
        self.ntimes_per_group = self.qmasks.sum(axis=1)  # Qi.Trace()
        self.n_unmasked = int(unmasked.sum())
        # single-group fast path: X = phi * unmasked, so J^T Q J can be
        # recovered from J^T X J without extra reductions
        self.single_group = (self.nphis == 1)

        self.locked_noise_stdev = options.get_float("locked-noise-stdev", -1.0)
        self.phiprior = options.get_float("prior-noise-stddev", -1.0)
        if self.phiprior < 0 and self.phiprior != -1:
            raise InvalidOptionValue("prior-noise-stddev", self.phiprior, "Must be > 0")

    @classmethod
    def get_options(cls):
        return [
            OptionSpec("noise-pattern", OPT_STR,
                       "Repeating pattern of noise variances for each point "
                       "(e.g. 12 gives odd/even different variances)", default="1"),
            OptionSpec("locked-noise-stdev", OPT_FLOAT,
                       "Fix noise std dev to this value", default="-1"),
            OptionSpec("prior-noise-stddev", OPT_FLOAT,
                       "Prior noise std dev", default="-1"),
        ]

    @property
    def num_params(self):
        return self.nphis

    # -- state ------------------------------------------------------------
    def initial_state(self, nvoxels, dtype):
        """Hardcoded initial dists (noisemodel_white.cc:127-164)."""
        if self.phiprior == -1:
            prior_b, prior_c = 1e6, 1e-6
            # tiny initial noise precision helps (reference's observation)
            post_b, post_c = 1e-8, 50.0
        else:
            prior_c = post_c = 0.5
            prior_b = post_b = 1.0 / (self.phiprior ** 2 * prior_c)
        # The prior is voxel-uniform: a singleton voxel axis broadcasts
        # against [Q,V] posterior planes and keeps it out of compiled
        # constants regardless of volume size.
        prior = WhiteNoiseState(jnp.full((self.nphis, 1), prior_b, dtype),
                                jnp.full((self.nphis, 1), prior_c, dtype))
        shape = (self.nphis, nvoxels)
        post = WhiteNoiseState(jnp.full(shape, post_b, dtype),
                               jnp.full(shape, post_c, dtype))
        return prior, post

    def state_to_mvn(self, state):
        """-> (means [V,Q], cov [V,Q,Q]) for serialization."""
        means = np.asarray(gamma_mean(state.b, state.c)).T
        var = np.asarray(gamma_var(state.b, state.c)).T
        v, q = means.shape
        cov = np.zeros((v, q, q), means.dtype)
        cov[:, np.arange(q), np.arange(q)] = var
        return means, cov

    def state_from_mvn(self, means, cov):
        cov = np.asarray(cov)
        offdiag = cov - np.einsum("vij,ij->vij", cov,
                                  np.eye(cov.shape[-1]))
        if cov.shape[-1] > 1 and np.any(offdiag != 0.0):
            raise FabberError("Phis should have zero covariance!")
        var = np.diagonal(cov, axis1=-2, axis2=-1)
        b, c = gamma_from_mean_var(np.asarray(means).T, var.T)
        return WhiteNoiseState(jnp.asarray(b), jnp.asarray(c))

    # -- VB updates (pure, SoA) -------------------------------------------
    def phi_timepoint_weights(self, state):
        """X diagonal [T,V]: E[phi] at each unmasked timepoint."""
        phimeans = gamma_mean(state.b, state.c)  # [Q,V]
        q = jnp.asarray(self.qmasks, state.b.dtype)  # [Q,T]
        return jnp.einsum("qt,qv->tv", q, phimeans)

    def update_theta(self, noise_post, means, prior_means, prior_prec,
                     centre, offset, jac, data, lm_alpha=None, design=None):
        """Eq 19/20: returns (new_means [P,V], prec, cov [P,P,V], ok [V]).

        Two routes to the same arithmetic:
          * generic: per-voxel Jacobian planes jac [P,T,V];
          * fixed-design (design [T,P], jac unused): the T-contractions
            become single [P^2,T] @ [T,V] matmuls and the
            Jacobian never materializes per voxel.
        """
        x = self.phi_timepoint_weights(noise_post)  # [T,V]
        if design is not None:
            p = design.shape[1]
            ltmp_flat = jnp.einsum("tp,tq,tv->pqv", design, design, x,
                                   optimize=True)
            ltmp = ltmp_flat
            resid = data - offset + design @ centre
            m_tmp = design.T @ (x * resid)
        else:
            p = jac.shape[0]
            jx = jac * x[None]                          # [P,T,V]
            ltmp = jnp.stack([
                jnp.stack([jnp.sum(jx[i] * jac[j], axis=0) for j in range(p)])
                for i in range(p)])                     # [P,P,V]
            resid = data - offset + jnp.einsum("ptv,pv->tv", jac, centre)
            m_tmp = jnp.einsum("ptv,tv->pv", jx, resid)

        prec = sm.add_diag(ltmp, prior_prec)
        chol, ok = sm.cholesky_jittered(prec)
        cov = sm.inverse_from_chol(chol)
        rhs = m_tmp + prior_prec * prior_means
        # mirror the reference's op order: covariance then multiply
        new_means = sm.matvec_planes(cov, rhs)

        if lm_alpha is not None:
            # Levenberg-Marquardt damped update (Appendix C form)
            if design is not None:
                jxr = design.T @ (x * (data - offset))
            else:
                jxr = jnp.einsum("ptv,tv->pv", jx, data - offset)
            delta = jxr + prior_prec * prior_means - prior_prec * centre
            damped = sm.add_diag(prec, lm_alpha[None] * sm.diag_of(prec))
            dchol, dok = sm.cholesky_jittered(damped)
            lm_means = centre + sm.solve_chol_vec(dchol, delta)
            use_lm = lm_alpha > 0.0
            new_means = jnp.where(use_lm[None], lm_means, new_means)
            ok = jnp.where(use_lm, dok, ok)

        return new_means, prec, cov, ok

    def _group_quadratics(self, k, cov, jac, design=None):
        """Per phi group: (k^T Q k [V], tr(Sigma J^T Q J) [V]) lists."""
        dtype = k.dtype
        kqk, trace = [], []
        for i in range(self.nphis):
            qi = jnp.asarray(self.qmasks[i], dtype)[:, None]  # [T,1]
            kqk.append(jnp.sum(k * k * qi, axis=0))
            tr = 0.0
            if design is not None:
                # G_i = J' Q_i J is a constant [P,P]; the trace needs no
                # T reduction at all
                g = jnp.einsum("tp,tq->pq", design * qi, design)
                p = design.shape[1]
                for a in range(p):
                    for b in range(p):
                        tr = tr + g[a, b] * cov[a, b]
            else:
                p = jac.shape[0]
                for a in range(p):
                    for b in range(p):
                        g_ab = jnp.sum(jac[a] * jac[b] * qi, axis=0)
                        tr = tr + cov[a, b] * g_ab
            trace.append(tr)
        return kqk, trace

    def update_noise(self, noise_post, noise_prior, means, cov,
                     centre, offset, jac, data, design=None):
        """Eq 21/22 per phi group; returns new WhiteNoiseState."""
        if design is not None:
            k = data - offset + design @ (centre - means)
        else:
            k = data - offset + jnp.einsum("ptv,pv->tv", jac, centre - means)
        kqk, trace = self._group_quadratics(k, cov, jac, design)
        return self._noise_from_quadratics(kqk, trace, noise_prior)

    def _noise_from_quadratics(self, kqk, trace, noise_prior):
        new_b, new_c = [], []
        for i in range(self.nphis):
            tmp = kqk[i] + trace[i]
            b = 1.0 / (tmp * 0.5 + 1.0 / noise_prior.b[i])
            c = jnp.full_like(b, (float(self.ntimes_per_group[i]) - 1) * 0.5) \
                + noise_prior.c[i]
            if self.locked_noise_stdev > 0:
                b = 1.0 / c / self.locked_noise_stdev ** 2
            new_b.append(b)
            new_c.append(c)
        return WhiteNoiseState(jnp.stack(new_b), jnp.stack(new_c))

    # -- sufficient-statistics route (fixed design) -------------------------
    def make_design_stats(self, design, data):
        """One-time reductions for the fixed-design fast path.

        design [T,P], data [T,V] -> DesignStats. Runs inside the jitted
        loop (traced once, executed once per chunk); everything after it
        is [P,V]-plane arithmetic.
        """
        from ..ops import smallmat as sm
        # bf16-stored data computes in f32 (storage tier only: the HBM
        # read is half-width, every reduction accumulates in f32)
        dtype = jnp.promote_types(data.dtype, jnp.float32)
        q = jnp.asarray(self.qmasks, dtype)  # [Q,T]
        dtqd = jnp.einsum("it,tp,tq->ipq", q, design, design)

        # OLS reference point over unmasked timepoints; lanes where the
        # normal matrix fails to factor fall back to m0 = 0 (raw
        # expansion — still correct, just less cancellation headroom)
        w = jnp.sum(q, axis=0)  # [T] 0/1
        dty = (design * w[:, None]).T @ data  # [P,V]
        chol, ok = sm.cholesky_jittered(jnp.sum(dtqd, axis=0)[:, :, None])
        m0 = sm.solve_chol_vec(chol, dty)
        m0 = jnp.where(ok & jnp.all(jnp.isfinite(m0), axis=0), m0, 0.0)

        r0 = data - design @ m0  # [T,V]
        # all-ones group indicators (the common single-group unmasked
        # case) skip their multiply: q_i * r0 ahead of a matmul
        # materializes another [T,V] plane in HBM — one write + one
        # read of pure identity work (rtqr's multiply fuses into its
        # reduction, so only the matmul operand matters)
        ones_mask = [bool(np.all(np.asarray(self.qmasks[i]) == 1.0))
                     for i in range(self.nphis)]
        rtqr = jnp.stack([
            jnp.sum((r0 * r0 if ones_mask[i]
                     else q[i][:, None] * r0 * r0), axis=0)
            for i in range(self.nphis)])
        dtqr = jnp.stack([
            design.T @ (r0 if ones_mask[i] else q[i][:, None] * r0)
            for i in range(self.nphis)])
        return DesignStats(m0=m0, rtqr=rtqr, dtqr=dtqr, dtqd=dtqd)

    @staticmethod
    def design_stats_voxel(stats, v):
        """Single-voxel slice (Gauss-Seidel parity sweeps)."""
        import jax as _jax
        sl = lambda x: _jax.lax.dynamic_slice_in_dim(x, v, 1, axis=-1)
        return DesignStats(m0=sl(stats.m0), rtqr=sl(stats.rtqr),
                           dtqr=sl(stats.dtqr), dtqd=stats.dtqd)

    def update_theta_stats(self, noise_post, prior_means, prior_prec,
                           stats, lm_alpha=None, centre=None):
        """Eq 19/20 from sufficient statistics: identical arithmetic to
        update_theta(design=...) up to the exact cancellation of the
        linearization offset (noisemodel_white.cc:275-363)."""
        from ..ops import smallmat as sm
        phim = gamma_mean(noise_post.b, noise_post.c)  # [Q,V]
        ltmp = jnp.einsum("iab,iv->abv", stats.dtqd, phim)
        # D'Q_i y = D'Q_i r0 + (D'Q_i D) m0
        dtqy = stats.dtqr + jnp.einsum("iab,bv->iav", stats.dtqd, stats.m0)
        m_tmp = jnp.einsum("iv,ipv->pv", phim, dtqy)

        prec = sm.add_diag(ltmp, prior_prec)
        chol, ok = sm.cholesky_jittered(prec)
        cov = sm.inverse_from_chol(chol)
        rhs = m_tmp + prior_prec * prior_means
        new_means = sm.matvec_planes(cov, rhs)

        if lm_alpha is not None:
            # J'X(y - D centre) = sum_i phi_i (D'Q_i r0 - D'Q_i D (c-m0))
            dc = centre - stats.m0
            jxr = jnp.einsum(
                "iv,ipv->pv", phim,
                stats.dtqr - jnp.einsum("iab,bv->iav", stats.dtqd, dc))
            delta = jxr + prior_prec * prior_means - prior_prec * centre
            damped = sm.add_diag(prec, lm_alpha[None] * sm.diag_of(prec))
            dchol, dok = sm.cholesky_jittered(damped)
            lm_means = centre + sm.solve_chol_vec(dchol, delta)
            use_lm = lm_alpha > 0.0
            new_means = jnp.where(use_lm[None], lm_means, new_means)
            ok = jnp.where(use_lm, dok, ok)
        return new_means, prec, cov, ok

    def _group_quadratics_stats(self, means, cov, stats):
        """(k'Q_i k, tr(Sigma J'Q_i J)) from sufficient statistics:
        k = y - D means = r0 - D (means - m0)."""
        delta = means - stats.m0  # [P,V]
        p = means.shape[0]
        kqk, trace = [], []
        for i in range(self.nphis):
            cross = sum(delta[a] * stats.dtqr[i, a] for a in range(p))
            quad = 0.0
            tr = 0.0
            for a in range(p):
                for b in range(p):
                    quad = quad + stats.dtqd[i, a, b] * delta[a] * delta[b]
                    tr = tr + stats.dtqd[i, a, b] * cov[a, b]
            # true k'Qk >= 0; clamp away the tiny negative rounding tail
            kqk.append(jnp.maximum(stats.rtqr[i] - 2.0 * cross + quad, 0.0))
            trace.append(tr)
        return kqk, trace

    def update_noise_stats(self, noise_post, noise_prior, means, cov, stats):
        kqk, trace = self._group_quadratics_stats(means, cov, stats)
        return self._noise_from_quadratics(kqk, trace, noise_prior)

    def free_energy_stats(self, noise_post, noise_prior, means, prec, cov,
                          prior_means, prior_prec, stats):
        kqk, trace = self._group_quadratics_stats(means, cov, stats)
        return self.free_energy_from_parts(
            noise_post, noise_prior, means, prec, cov,
            prior_means, prior_prec, kqk, trace)

    def free_energy(self, noise_post, noise_prior, means, prec, cov,
                    prior_means, prior_prec, centre, offset, jac, data,
                    design=None):
        """Full ELBO (noisemodel_white.cc:365-454). Returns F [V]."""
        if design is not None:
            k = data - offset + design @ (centre - means)
        else:
            k = data - offset + jnp.einsum("ptv,pv->tv", jac, centre - means)
        kqk, trace = self._group_quadratics(k, cov, jac, design)
        return self.free_energy_from_parts(
            noise_post, noise_prior, means, prec, cov,
            prior_means, prior_prec, kqk, trace)

    def free_energy_from_parts(self, noise_post, noise_prior, means, prec,
                               cov, prior_means, prior_prec, kqk, trace):
        """ELBO assembly given the per-group quadratics k'Q_ik and
        tr(J'Q_iJ Sigma) (noisemodel_white.cc:365-454)."""
        dtype = means.dtype
        nv = means.shape[1]
        p = means.shape[0]
        n_times = self.n_unmasked
        log2pi = jnp.log(2 * jnp.pi).astype(dtype)

        chol, _ = sm.cholesky_jittered(prec)
        logdet_prec = sm.logdet_from_chol(chol)
        exp_log_theta_dist = 0.5 * logdet_prec - 0.5 * p * (log2pi + 1.0)

        exp_log_phi_dist = jnp.zeros(nv, dtype)
        part0 = jnp.zeros_like(exp_log_phi_dist)
        part2 = jnp.zeros_like(exp_log_phi_dist)
        part9 = jnp.zeros_like(exp_log_phi_dist)
        for i in range(self.nphis):
            si, ci = noise_post.b[i], noise_post.c[i]
            si0, ci0 = noise_prior.b[i], noise_prior.c[i]
            dg_ls = digamma(ci) + jnp.log(si)
            exp_log_phi_dist += (-gammaln(ci) - ci * jnp.log(si) - ci
                                 + (ci - 1.0) * dg_ls)
            part0 += dg_ls * (float(self.ntimes_per_group[i]) * 0.5 + ci0 - 1.0)
            part9 += -gammaln(ci0) - ci0 * jnp.log(si0) - si * ci / si0
            # NB: the trace term carries no phi weighting, mirroring the
            # reference expression exactly (noisemodel_white.cc:413-417)
            part2 += -0.5 * si * ci * kqk[i] - 0.5 * trace[i]

        part3 = (0.5 * jnp.sum(jnp.log(prior_prec), axis=0)
                 - 0.5 * n_times * log2pi - 0.5 * p * log2pi)
        dm = means - prior_means
        part4 = -0.5 * jnp.sum(dm * prior_prec * dm, axis=0)
        part5 = -0.5 * jnp.sum(sm.diag_of(cov) * prior_prec, axis=0)

        return (-exp_log_theta_dist - exp_log_phi_dist
                + part0 + part2 + part3 + part4 + part5 + part9)
