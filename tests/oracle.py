"""Independent per-voxel NumPy oracle for the white-noise VB updates.

This is a direct, slow transcription of the Chappell 2009 fixed-point
equations in the same operation order as the reference C++
(noisemodel_white.cc:228-454, inference_vb.cc:448-500), used to verify
the batched JAX engine lane-for-lane. Deliberately written per voxel
with plain numpy so it shares no code with the engine.
"""

import numpy as np
from scipy.special import digamma, gammaln


def vb_voxel(eval_fn, jac_fn, y, prior_mean, prior_prec, post_mean0,
             post_var0, niter, qmasks=None, prior_b=1e6, prior_c=1e-6,
             post_b0=1e-8, post_c0=50.0, compute_f=True, locked_sd=None):
    """Run `niter` VB iterations for one voxel; returns history dict.

    eval_fn(params) -> signal [T]; jac_fn(params) -> [T, P].
    qmasks: [Q,T] 0/1 indicator per phi group (default: single group).
    locked_sd: fix the noise std dev (b = 1 / (c sd^2) after each
    update, noisemodel_white.cc locked-noise-stdev).
    """
    t_len = len(y)
    p = len(post_mean0)
    if qmasks is None:
        qmasks = np.ones((1, t_len))
    q = qmasks.shape[0]

    m = np.array(post_mean0, float)
    phi_b = np.full(q, post_b0)
    phi_c = np.full(q, post_c0)
    pb = np.full(q, prior_b)
    pc = np.full(q, prior_c)

    centre = m.copy()
    offset = eval_fn(centre)
    jac = jac_fn(centre)

    fs = []
    for _ in range(niter):
        # X = sum_i E[phi_i] Q_i  (diagonal)
        x = np.zeros(t_len)
        for i in range(q):
            x += qmasks[i] * phi_b[i] * phi_c[i]

        # theta update (Eq 19/20)
        prec = np.diag(prior_prec) + jac.T @ (x[:, None] * jac)
        cov = np.linalg.inv(prec)
        m_tmp = jac.T @ (x * (y - offset + jac @ centre))
        m = cov @ (m_tmp + prior_prec * prior_mean)

        # noise update (Eq 21/22)
        k = y - offset + jac @ (centre - m)
        for i in range(q):
            qi = qmasks[i]
            tmp = k @ (qi * k) + np.trace(cov @ jac.T @ np.diag(qi) @ jac)
            phi_b[i] = 1.0 / (tmp * 0.5 + 1.0 / pb[i])
            phi_c[i] = (qi.sum() - 1) * 0.5 + pc[i]
            if locked_sd is not None:
                phi_b[i] = 1.0 / phi_c[i] / locked_sd ** 2

        # re-linearize
        centre = m.copy()
        offset = eval_fn(centre)
        jac = jac_fn(centre)

        if compute_f:
            fs.append(free_energy(y, m, prec, cov, prior_mean, prior_prec,
                                  centre, offset, jac, phi_b, phi_c, pb, pc,
                                  qmasks))

    return {
        "means": m, "cov": cov, "prec": prec,
        "phi_b": phi_b, "phi_c": phi_c,
        "F": fs[-1] if fs else None, "F_history": fs,
    }


def free_energy(y, m, prec, cov, prior_mean, prior_prec, centre, offset,
                jac, phi_b, phi_c, pb, pc, qmasks):
    t_len = int(qmasks.sum())
    p = len(m)
    k = y - offset + jac @ (centre - m)

    sign, logdet_prec = np.linalg.slogdet(prec)
    e_theta = 0.5 * logdet_prec - 0.5 * p * (np.log(2 * np.pi) + 1)

    e_phi = 0.0
    part0 = part2 = part9 = 0.0
    for i in range(qmasks.shape[0]):
        si, ci = phi_b[i], phi_c[i]
        si0, ci0 = pb[i], pc[i]
        e_phi += -gammaln(ci) - ci * np.log(si) - ci \
            + (ci - 1) * (digamma(ci) + np.log(si))
        part0 += (digamma(ci) + np.log(si)) * (qmasks[i].sum() * 0.5 + ci0 - 1)
        part9 += -gammaln(ci0) - ci0 * np.log(si0) - si * ci / si0
        qi = np.diag(qmasks[i])
        ki = qmasks[i] * k
        ji = qmasks[i][:, None] * jac
        part2 += -0.5 * si * ci * (ki @ ki) - 0.5 * np.trace(ji.T @ ji @ cov)

    part3 = 0.5 * np.sum(np.log(prior_prec)) \
        - 0.5 * t_len * np.log(2 * np.pi) - 0.5 * p * np.log(2 * np.pi)
    dm = m - prior_mean
    part4 = -0.5 * dm @ (prior_prec * dm)
    part5 = -0.5 * np.sum(np.diag(cov) * prior_prec)

    return -e_theta - e_phi + part0 + part2 + part3 + part4 + part5 + part9


# the detectors start from a huge negative previous F
# (inference/convergence.py), so their first test never stops a lane
SENTINEL = float(np.finfo(np.float32).min)


def replay_detector(f_history, max_its, tol, freduce):
    """FchangeDetector / FreduceDetector (convergence.cc) replayed on one
    lane's F history (vb_voxel's "F_history"): (updates made, reported
    iteration count, reverted)."""
    prev, its = SENTINEL, 0
    for k, f in enumerate(f_history):
        diff = f - prev
        reduced = freduce and diff < 0
        small = abs(diff) < tol
        if not (reduced or small):
            its += 1
        if reduced or small or its >= max_its:
            return k + 1, its, reduced
        prev = f
    return len(f_history), its, False
