"""Independent NumPy oracle for the NLLS engine (inference/nlls.py).

Implements the damped Gauss-Newton scheme with the reference's
semantics (inference_nlls.cc:90-293: Levenberg default / Marquardt
diag-damping, SSE cost, posterior precision J'J/mse with 1e-6 floor),
one voxel at a time, in plain float64 NumPy. The model is a function
latent -> (signal, jacobian); the single exponential with
log-transformed parameters is the default. Used to pin the engine's
per-iteration accept/reject trajectory and final posterior.
"""

import numpy as np

LAMBDA_INIT = 1e-3
LAMBDA_GROW = 10.0
LAMBDA_SHRINK = 0.1
LAMBDA_MAX = 1e10
PREC_DIAG_FLOOR = 1e-6
CFTOL = 1e-5  # relative cost-gain convergence (engine's CFTOL)
PLATEAU_LAMBDA = 1.0  # rejected-plateau convergence guard (engine's)


def exp_signal_and_jac(latent, t):
    """Latent params [log amp, log r] -> (signal [T], jac [2,T])."""
    amp = np.exp(latent[0])
    r = np.exp(latent[1])
    sig = amp * np.exp(-r * t)
    # d sig / d latent_amp = sig;  d sig / d latent_r = -r*t*sig
    return sig, np.stack([sig, -r * t * sig])


def nlls_voxel(y, t, latent0, max_its=100, marquardt=False,
               signal_and_jac=exp_signal_and_jac):
    """Run the lane algorithm for one voxel. signal_and_jac(latent, t)
    -> (signal [T], jac [P,T]). Returns dict with params, cost,
    iterations, precision, covariance and the per-step trace."""
    p = np.asarray(latent0, float).copy()
    sig, _ = signal_and_jac(p, t)
    cost = float(np.sum((y - sig) ** 2))
    lam = LAMBDA_INIT
    done = False
    its = 0
    trace = []
    for _ in range(max_its):
        if done:
            break
        sig, jac = signal_and_jac(p, t)
        r = y - sig
        jtj = jac @ jac.T
        jtr = jac @ r
        damp = np.diag(np.diag(jtj)) if marquardt else np.eye(len(p))
        delta = np.linalg.solve(jtj + lam * damp, jtr)
        trial = p + delta
        tsig, _ = signal_and_jac(trial, t)
        tcost = float(np.sum((y - tsig) ** 2))
        better = np.isfinite(tcost) and tcost < cost
        converged = False
        if better:
            converged = (cost - tcost) <= CFTOL * max(abs(tcost), 1e-30)
            p, cost = trial, tcost
            lam *= LAMBDA_SHRINK
        else:
            # rejected-plateau convergence (engine semantics): a
            # no-better trial within tolerance at lambda >= 1 ends the
            # lane without climbing the rest of the ladder
            converged = (np.isfinite(tcost) and lam >= PLATEAU_LAMBDA
                         and (tcost - cost) <= CFTOL * max(abs(cost),
                                                           1e-30))
            lam *= LAMBDA_GROW
        done = lam > LAMBDA_MAX or converged
        its += 1
        trace.append((p.copy(), cost, lam, done))

    sig, jac = signal_and_jac(p, t)
    mse = cost / (len(t) - len(p))
    prec = (jac @ jac.T) / mse
    for i in range(len(p)):
        prec[i, i] = max(prec[i, i], PREC_DIAG_FLOOR)
    cov = np.linalg.inv(prec)
    return {"params": p, "cost": cost, "iterations": its,
            "prec": prec, "cov": cov, "trace": trace}
