"""Batched distribution math: MVN and Gamma over voxel arrays.

The reference holds one MVNDist object per voxel with lazy
precision<->covariance inversion (dist_mvn.cc:197-260).  Here posterior
state is arrays (means [V,P], prec/cov [V,P,P]) and inversion points are
explicit in the update step, mirroring where the reference inverts:
precision is formed, then covariance is computed once from it.

All functions are jittable and shard over leading batch dims.
"""

import jax
import jax.numpy as jnp
import numpy as np

# Jitter used when a matrix fails to invert, matching the reference's
# singular-matrix fallback (dist_mvn.cc:223 adds 1e-10 to the diagonal).
SINGULAR_JITTER = 1e-10


def _eye_like(mat):
    return jnp.eye(mat.shape[-1], dtype=mat.dtype)


def chol_inv_logdet(mat):
    """Batched symmetric-PD inverse + log-determinant via Cholesky.

    Returns (inv, logdet, ok) where ok is False for lanes where even the
    jittered factorization failed (non-PD matrix -> bad voxel).
    """
    eye = _eye_like(mat)
    chol = jnp.linalg.cholesky(mat)
    bad = jnp.any(~jnp.isfinite(chol), axis=(-2, -1))
    # Retry with diagonal jitter on failed lanes only (all lanes recompute;
    # XLA has no per-lane early exit, and the second factorization fuses).
    jitter = jnp.where(bad[..., None, None], SINGULAR_JITTER, 0.0)
    chol = jnp.linalg.cholesky(mat + jitter * eye)
    ok = jnp.all(jnp.isfinite(chol), axis=(-2, -1))
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    # Inverse via two triangular solves (Cholesky-based inversion is
    # both faster than LU and what the symmetric structure calls for).
    eye_b = jnp.broadcast_to(eye, mat.shape)
    linv = jax.scipy.linalg.solve_triangular(chol, eye_b, lower=True)
    inv = jnp.einsum("...ki,...kj->...ij", linv, linv)
    inv = 0.5 * (inv + jnp.swapaxes(inv, -1, -2))  # keep exactly symmetric
    return inv, logdet, ok


def sym_inv(mat):
    """Batched symmetric inverse with jitter fallback (no logdet)."""
    inv, _, _ = chol_inv_logdet(mat)
    return inv


def sym_logdet(mat):
    _, logdet, _ = chol_inv_logdet(mat)
    return logdet


# -- Gamma distribution (b, c) parameterization --------------------------
# mean = b*c, var = b^2*c (dist_gamma.h:15-28)

def gamma_mean(b, c):
    return b * c


def gamma_var(b, c):
    return b * b * c


def gamma_from_mean_var(mean, var):
    """Inverse of (mean, var) -> (b, c): b = var/mean, c = mean^2/var."""
    b = var / mean
    c = mean * mean / var
    return b, c


# -- concatenated MVN (model params (+) noise params) ---------------------

def concat_mvn(means1, cov1, means2, cov2):
    """Block-diagonal MVN concat (dist_mvn.cc:57-100 semantics)."""
    means1, cov1 = jnp.asarray(means1), jnp.asarray(cov1)
    means2, cov2 = jnp.asarray(means2), jnp.asarray(cov2)
    v = means1.shape[0]
    p1, p2 = means1.shape[1], means2.shape[1]
    means = jnp.concatenate([means1, means2], axis=1)
    cov = jnp.zeros((v, p1 + p2, p1 + p2), dtype=cov1.dtype)
    cov = cov.at[:, :p1, :p1].set(cov1)
    cov = cov.at[:, p1:, p1:].set(cov2)
    return means, cov


def split_mvn(means, cov, p1):
    """Split a concatenated MVN back into (model, noise) blocks."""
    return (means[:, :p1], cov[:, :p1, :p1]), (means[:, p1:], cov[:, p1:, p1:])


def diag_mvn(means, variances):
    """Build [V,P,P] covariance from diagonal variances [V,P]."""
    means = np.asarray(means)
    variances = np.asarray(variances)
    v, p = means.shape
    cov = np.zeros((v, p, p), dtype=variances.dtype)
    idx = np.arange(p)
    cov[:, idx, idx] = variances
    return cov
