"""Independent NumPy oracle for spatial VB (inference/spatial.py): the
Jacobi sweep of a linear model under one spatial prior type on every
parameter, one voxel at a time in plain float64 NumPy."""

import numpy as np

from fabber_core_tpu.core.neighbours import calc_neighbours


def spatial_oracle_sweeps(data, coords, design, niter, sd=3, q1=10.0,
                          q2=1.0, tcode="M"):
    """NumPy Jacobi spatial-VB oracle for a linear model + type-M/m/P/p
    prior on every parameter, mirroring priors.cc:221-488 +
    noisemodel_white.cc updates."""
    nv, nt = data.shape
    p = design.shape[1]
    neigh, neigh2 = calc_neighbours(coords, sd)

    means = np.zeros((nv, p))
    cov = np.stack([np.eye(p) * 1e12] * nv)
    phi_b = np.full(nv, 1e-8)
    phi_c = np.full(nv, 50.0)
    ak = np.full(p, 1e-8)
    base_prec = 1e-12
    base_mean = 0.0

    centre = means.copy()
    offset = np.zeros((nv, nt))
    jac = np.tile(design, (nv, 1, 1))

    for it in range(niter):
        # aK from pre-sweep posteriors
        if it > 0:
            for k in range(p):
                trace_term = term2 = 0.0
                for v in range(nv):
                    nbrs = [i for i in neigh[v] if i >= 0]
                    nn = len(nbrs)
                    sigma = cov[v, k, k]
                    w = means[v, k]
                    swk = sum(w - means[j, k] for j in nbrs)
                    if tcode == "M":
                        trace_term += sigma * (nn + 1e-8)
                        term2 += swk * w
                    elif tcode == "m":
                        trace_term += sigma * sd * 2
                        swk += w * (sd * 2 - nn)
                        term2 += swk * w
                    elif tcode == "P":
                        trace_term += sigma * (nn * nn + nn)
                        term2 += swk * swk
                    else:  # p
                        trace_term += sigma * (4 * sd * sd + 2 * sd)
                        swk += w * (sd * 2 - nn)
                        term2 += swk * swk
                gk = 1.0 / (0.5 * trace_term + 0.5 * term2 + 1.0 / q1)
                ak[k] = max(gk * (nv * 0.5 + q2), 1e-50)

        # per-voxel priors from pre-sweep means
        prior_means = np.zeros((nv, p))
        prior_prec = np.zeros((nv, p))
        for v in range(nv):
            nbrs = [i for i in neigh[v] if i >= 0]
            nbrs2 = [i for i in neigh2[v] if i >= 0]
            nn, nn2 = len(nbrs), len(nbrs2)
            for k in range(p):
                contrib = sum(means[j, k] for j in nbrs)
                contrib2 = -sum(means[j, k] for j in nbrs2)
                nnk, nn2k = nn, nn2
                if tcode in "pm":
                    nnk, nn2k = 2 * sd, 4 * sd * sd - 2 * sd
                if tcode == "M":
                    sprec = ak[k] * (nnk + 1e-8)
                elif tcode == "m":
                    sprec = ak[k] * nnk
                else:
                    sprec = ak[k] * (nnk * nnk + nnk)
                if tcode in "pm":
                    newprec = sprec
                else:
                    newprec = base_prec + sprec
                if tcode in "mM":
                    smean = contrib / nnk if nnk else 0.0
                    newmean = (1.0 / newprec) * sprec * smean
                else:
                    smean = ((8 * contrib + contrib2) / (8 * nnk - nn2k)
                             if nnk else 0.0)
                    newmean = (1.0 / newprec) * (sprec * smean
                                                 + base_prec * base_mean)
                prior_means[v, k] = newmean
                prior_prec[v, k] = newprec

        # theta update (old linearization, old phi)
        new_means = np.zeros_like(means)
        new_cov = np.zeros_like(cov)
        for v in range(nv):
            x = phi_b[v] * phi_c[v]
            prec_v = np.diag(prior_prec[v]) + x * design.T @ design
            cov_v = np.linalg.inv(prec_v)
            mtmp = x * design.T @ (data[v] - offset[v] + design @ centre[v])
            new_means[v] = cov_v @ (mtmp + prior_prec[v] * prior_means[v])
            new_cov[v] = cov_v
        means, cov = new_means, new_cov

        # noise update + relinearize
        for v in range(nv):
            k_v = data[v] - offset[v] + design @ (centre[v] - means[v])
            tmp = k_v @ k_v + np.trace(cov[v] @ design.T @ design)
            phi_b[v] = 1.0 / (tmp * 0.5 + 1.0 / 1e6)
            phi_c[v] = (nt - 1) * 0.5 + 1e-6
        centre = means.copy()
        offset = np.einsum("tp,vp->vt", design, means)

    return means, cov, ak
