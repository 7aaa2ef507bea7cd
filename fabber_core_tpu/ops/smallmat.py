"""Unrolled small-matrix algebra over voxel planes (SoA layout).

The per-voxel P x P systems (P ~ 2-20) are far too small for matrix
units or batched LAPACK kernels: a [V,P,P] layout leaves most of every
vector register idle when P=3. Instead every matrix entry lives as a
separate [V]-shaped plane (array shape [P,P,V], voxels on the fastest
axis), and Cholesky/solve/inverse are unrolled at trace time into pure
elementwise arithmetic that runs at full vector width. XLA fuses the
whole chain into a handful of vectorized loops.

All functions are jittable and preserve any sharding on the V axis.
"""

import jax.numpy as jnp

JITTER = 1e-10  # singular-matrix retry, as dist_mvn.cc:223


def cholesky_planes(a):
    """Lower Cholesky of symmetric [P,P,V] planes. Returns [P,P,V]
    with zeros above the diagonal."""
    p = a.shape[0]
    l = [[None] * p for _ in range(p)]
    for i in range(p):
        s = a[i, i]
        for k in range(i):
            s = s - l[i][k] * l[i][k]
        l[i][i] = jnp.sqrt(s)
        inv_lii = 1.0 / l[i][i]
        for j in range(i + 1, p):
            s = a[j, i]
            for k in range(i):
                s = s - l[j][k] * l[i][k]
            l[j][i] = s * inv_lii
    zero = jnp.zeros_like(a[0, 0])
    rows = [jnp.stack([l[i][j] if j <= i else zero for j in range(p)])
            for i in range(p)]
    return jnp.stack(rows)


def cholesky_jittered(a):
    """Cholesky with the singular-matrix jitter retry.

    Returns (L, ok): lanes where the plain factorization produced
    non-finite values are refactorized with +1e-10 on the diagonal;
    ok is False where even that failed.
    """
    l0 = cholesky_planes(a)
    diag0 = jnp.stack([l0[i, i] for i in range(a.shape[0])])
    bad = jnp.any(~jnp.isfinite(diag0), axis=0)
    jitter = jnp.where(bad, JITTER, 0.0)
    p = a.shape[0]
    a2 = a
    for i in range(p):
        a2 = a2.at[i, i].add(jitter)
    l = cholesky_planes(a2)
    diag = jnp.stack([l[i, i] for i in range(p)])
    ok = jnp.all(jnp.isfinite(diag), axis=0)
    return l, ok


def logdet_from_chol(l):
    """log det A = 2 * sum log diag(L). Returns [V]."""
    p = l.shape[0]
    s = jnp.log(l[0, 0])
    for i in range(1, p):
        s = s + jnp.log(l[i, i])
    return 2.0 * s


def solve_chol_vec(l, b):
    """Solve A x = b with A = L L^T; b and x are [P,V] planes."""
    p = l.shape[0]
    # forward: L y = b
    y = [None] * p
    for i in range(p):
        s = b[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i, i]
    # backward: L^T x = y
    x = [None] * p
    for i in reversed(range(p)):
        s = y[i]
        for k in range(i + 1, p):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i, i]
    return jnp.stack(x)


def inverse_from_chol(l):
    """A^-1 from the Cholesky factor, as [P,P,V] planes.

    Computes L^-1 by forward substitution then A^-1 = L^-T L^-1,
    unrolled; only the lower triangle is formed and mirrored.
    """
    p = l.shape[0]
    # invl[i][j] for j <= i
    invl = [[None] * p for _ in range(p)]
    for i in range(p):
        invl[i][i] = 1.0 / l[i, i]
    for i in range(p):
        for j in range(i - 1, -1, -1):
            s = 0.0
            for k in range(j + 1, i + 1):
                s = s + l[k][j] * invl[i][k]
            invl[i][j] = -s / l[j, j]
    # ainv[i][j] = sum_k invl[k][i] * invl[k][j] for k >= max(i,j)
    rows = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            s = 0.0
            for k in range(i, p):
                s = s + invl[k][i] * invl[k][j]
            rows[i][j] = s
            rows[j][i] = s
    return jnp.stack([jnp.stack(r) for r in rows])


def matvec_planes(a, b):
    """[P,P,V] x [P,V] -> [P,V]."""
    p = a.shape[0]
    return jnp.stack([sum(a[i, j] * b[j] for j in range(p))
                      for i in range(p)])


def diag_planes(d):
    """[P,V] -> [P,P,V] diagonal planes."""
    p = d.shape[0]
    zero = jnp.zeros_like(d[0])
    return jnp.stack([
        jnp.stack([d[i] if i == j else zero for j in range(p)])
        for i in range(p)])


def add_diag(a, d):
    """[P,P,V] + diag([P,V])."""
    for i in range(d.shape[0]):
        a = a.at[i, i].add(d[i])
    return a


def diag_of(a):
    """[P,P,V] -> [P,V]."""
    return jnp.stack([a[i, i] for i in range(a.shape[0])])
