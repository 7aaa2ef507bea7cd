"""Independent NumPy oracle for the AR(1) noise model.

Direct dense-matrix transcription of noisemodel_ar.cc: builds the
actual T x T banded alpha matrices and marginals per voxel, sharing no
structure with the engine's strided-correlation reformulation.
"""

import numpy as np

AR1_BANDWIDTH = 3


def make_band(mat):
    n = mat.shape[0]
    for r in range(n):
        for c in range(n):
            if abs(r - c) > AR1_BANDWIDTH:
                mat[r, c] = 0.0
    return mat


def build_alpha_matrices(ntimes, nphis, nalphas):
    """{(n, a12, a34): dense [T,T]} with T = ntimes*nphis."""
    mats = {}
    total = ntimes * nphis
    for n in range(1, nphis + 1):
        for a12 in range(3):
            for a34 in range(3 - a12):
                if nalphas < 3 and a34 > 0:
                    break
                table = {
                    (0, 0): (1 + nphis, 1 + nphis),
                    (1, 0): (1, 1 + nphis),
                    (2, 0): (1, 1),
                    (0, 1): (4, 3),
                    (1, 1): (4, 1),
                    (0, 2): (4, 4),
                }
                row, col = table[(a12, a34)]
                if n == 2:
                    row = row - 1 + 2 * (row % 2)
                    col = col - 1 + 2 * (col % 2)
                value = -1.0 if (a12 + a34) == 1 else 1.0
                mat = np.zeros((total, total))
                r, c = row - 1, col - 1
                for _ in range(ntimes - 1):
                    mat[r, c] = value
                    mat[c, r] = value
                    r += nphis
                    c += nphis
                mats[(n, a12, a34)] = make_band(mat)
    return mats


def marginals(mats, alpha_means, alpha_cov, nphis, nalphas):
    """Q_n per the cache update (noisemodel_ar.cc:197-222)."""
    cp = alpha_cov + np.outer(alpha_means, alpha_means)
    out = {}
    for n in range(1, nphis + 1):
        q = (mats[(n, 0, 0)] + mats[(n, 1, 0)] * alpha_means[n - 1]
             + mats[(n, 2, 0)] * cp[n - 1, n - 1])
        if nalphas >= 3:
            t = (2 + n if nalphas == 4 else 3) - 1
            q = (q + mats[(n, 0, 1)] * alpha_means[t]
                 + mats[(n, 1, 1)] * cp[n - 1, t]
                 + mats[(n, 0, 2)] * cp[t, t])
        out[n] = q
    return out


def ar_vb_voxel(y, design, prior_mean, prior_prec, niter, nphis=1,
                nalphas=2, compute_f=False):
    """Full per-voxel AR(1) VB loop for a linear model (constant J)."""
    from scipy.special import digamma, gammaln

    tq = len(y)
    ntimes = tq // nphis
    p = design.shape[1]
    mats = build_alpha_matrices(ntimes, nphis, nalphas)

    m = np.array(prior_mean, float) * 0  # posterior starts at 0 (N(0,1e12))
    cov = np.eye(p) * 1e12
    alpha_m = np.zeros(nalphas)
    alpha_prec = np.eye(nalphas) * 1e-4
    alpha_cov = np.eye(nalphas) * 1e4
    phi_b = np.full(nphis, 1e-8)
    phi_c = np.full(nphis, 1e-6 + (ntimes - 1) * 0.5)
    pb = np.full(nphis, 1e6)
    pc = np.full(nphis, 1e-6)
    prior_alpha_prec = np.eye(nalphas) * 1e-4

    centre = m.copy()
    offset = design @ centre
    jac = design
    fs = []

    for _ in range(niter):
        qs = marginals(mats, alpha_m, alpha_cov, nphis, nalphas)
        si_ci = phi_b * phi_c

        # theta update
        x = sum(si_ci[n - 1] * qs[n] for n in range(1, nphis + 1))
        x = make_band(x)
        prec = np.diag(prior_prec) + jac.T @ x @ jac
        cov = np.linalg.inv(prec)
        m_tmp = jac.T @ x @ (y - offset + jac @ centre)
        m = cov @ (m_tmp + prior_prec * prior_mean)

        # alpha update
        k = y - offset + jac @ (centre - m)

        def opklj(mat):
            return k @ mat @ k + np.trace(cov @ jac.T @ mat @ jac)

        aprec = prior_alpha_prec.copy()
        for n in range(1, nphis + 1):
            aprec[n - 1, n - 1] += si_ci[n - 1] * opklj(mats[(n, 2, 0)])
        if nalphas > 2:
            t = nalphas - 1
            v = 0.5 * si_ci[0] * opklj(mats[(1, 1, 1)])
            aprec[2, 0] += v
            aprec[0, 2] += v
            v = 0.5 * si_ci[1] * opklj(mats[(2, 1, 1)])
            aprec[t, 1] += v
            aprec[1, t] += v
            aprec[2, 2] += si_ci[0] * opklj(mats[(1, 0, 2)])
            aprec[t, t] += si_ci[1] * opklj(mats[(2, 0, 2)])
        alpha_cov = np.linalg.inv(aprec)
        tmp = prior_alpha_prec @ np.zeros(nalphas)
        for n in range(1, nphis + 1):
            tmp[n - 1] += -0.5 * si_ci[n - 1] * opklj(mats[(n, 1, 0)])
        if nalphas > 2:
            t = nalphas - 1
            tmp[2] += -0.5 * si_ci[0] * opklj(mats[(1, 0, 1)])
            tmp[t] += -0.5 * si_ci[1] * opklj(mats[(2, 0, 1)])
        alpha_m = alpha_cov @ tmp
        alpha_prec = aprec

        # phi update with new marginals
        qs = marginals(mats, alpha_m, alpha_cov, nphis, nalphas)
        for n in range(1, nphis + 1):
            qi = qs[n]
            tmp_n = k @ qi @ k + np.trace(cov @ jac.T @ qi @ jac)
            phi_b[n - 1] = 1.0 / (tmp_n * 0.5 + 1.0 / pb[n - 1])
            phi_c[n - 1] = (ntimes - 1) * 0.5 + pc[n - 1]

        # relinearize (linear model: offset follows means)
        centre = m.copy()
        offset = design @ centre

        if compute_f:
            si_ci = phi_b * phi_c
            qsum = sum(si_ci[n - 1] * qs[n] for n in range(1, nphis + 1))
            k = y - offset + jac @ (centre - m)
            sign, logdet_ap = np.linalg.slogdet(alpha_prec)
            sign, logdet_tp = np.linalg.slogdet(prec)
            ea = 0.5 * logdet_ap - 0.5 * nalphas * (np.log(2 * np.pi) + 1)
            et = 0.5 * logdet_tp - 0.5 * p * (np.log(2 * np.pi) + 1)
            ep = 0.0
            p0 = p9 = 0.0
            for i in range(nphis):
                si, ci = phi_b[i], phi_c[i]
                si0, ci0 = pb[i], pc[i]
                ep += -gammaln(ci) - ci * np.log(si) - ci \
                    + (ci - 1) * (digamma(ci) + np.log(si))
                p0 += (digamma(ci) + np.log(si)) * ((ntimes - 1) * 0.5 + ci0 - 1)
                p9 += -2 * gammaln(ci0) - 2 * ci0 * np.log(si0) - si * ci / si0
            p1 = -np.log(2 * np.pi) * (ntimes - 1 + 0.5 * nalphas + 0.5 * p)
            p2 = -0.5 * (k @ qsum @ k) - 0.5 * np.trace(jac.T @ qsum @ jac @ cov)
            p3 = 0.5 * np.sum(np.log(prior_prec))
            dm = m - prior_mean
            p4 = -0.5 * dm @ (prior_prec * dm)
            p5 = -0.5 * np.sum(np.diag(cov) * prior_prec)
            sign, logdet_pap = np.linalg.slogdet(prior_alpha_prec)
            p6 = 0.5 * logdet_pap
            p7 = -0.5 * alpha_m @ prior_alpha_prec @ alpha_m
            p8 = -0.5 * np.trace(alpha_cov @ prior_alpha_prec)
            fs.append(-ea - et - ep + p0 + p1 + p2 + p3 + p4 + p5
                      + p6 + p7 + p8 + p9)

    return {"means": m, "cov": cov, "alpha_means": alpha_m,
            "alpha_cov": alpha_cov, "phi_b": phi_b, "phi_c": phi_c,
            "F": fs[-1] if fs else None, "F_history": fs}
