"""Spectral (eigenbasis) route for fixed-design white-noise VB.

For a fixed design D, white noise with a SINGLE phi group, and
voxel-uniform prior precisions, one VB iteration is

    prec   = phi * A + diag(pp),      A = D'QD   (constant)
    means  = prec^-1 (phi * u_y + pp*pm)
    kqk    = r'Qr - 2 d'u_0 + d'A d,  d = means - m0
    tr     = tr(prec^-1 A)
    phi'   = c_post / (0.5*(kqk + tr) + 1/b0)

(noisemodel_white.cc Eq 19-22 via the sufficient-statistics form).
Whitening by W = diag(pp)^-1/2 and diagonalizing the CONSTANT matrix
W A W = E diag(lam) E' turns every iteration into P independent scalar
rationals per voxel:

    denom_i = phi*lam_i + 1
    mt_i    = (phi*ut_i + vt_i) / denom_i          (means, eigenbasis)
    tr      = sum_i lam_i / denom_i
    quad    = sum_i lam_i * (mt_i - m0t_i)^2
    cross   = sum_i (mt_i - m0t_i) * u0t_i

~20 flops per voxel-iteration instead of a P x P Cholesky/inverse —
the whole 10-iteration fixed point costs less than reading the
sufficient statistics. The P x P posterior (means/prec/cov in the
original basis) is reconstructed ONCE from the final phi. Everything
is plain XLA (the loop body fuses).

The fixed point is algebraically identical to the stats route; only
the floating-point evaluation order differs, so results match to
roundoff at the problem's conditioning (tests/test_spectral.py pins
engine-level agreement). The eigendecomposition of the P x P constant
runs in float64 numpy at trace time.

Eligibility (gated by the engine): fixed design + white noise with
one phi group + iteration-invariant priors (the same gates as the
whole-loop nonlinear kernel) + no locked noise stdev. Detectors: the plain loop
below serves maxits; make_spectral_detector_loop serves the F-based
family (pointzeroone / freduce / trialmode) by evaluating the ELBO in
the eigenbasis each iteration (~15 extra flops/voxel) and running the
batched detector state machines (inference/convergence.py) on it —
per-lane save/revert needs only TWO scalars (the generating phi mean
and the noise b), because every spectral posterior is a pure function
of its generating phi.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
from scipy.special import digamma as _digamma, gammaln as _gammaln


def spectral_basis(design_host, qmask_host, pp_host):
    """Host-side f64 eigendecomposition of the whitened design Gram.

    design [T,P], qmask [T] 0/1 (single phi group), pp [P] prior
    precisions. Returns (A [P,P], lam [P], ew [P,P], winv [P]) where
    ew = W @ E (the means reconstruction operator), winv = 1/sqrt(pp)
    = W's diagonal, and columns of E are eigenvectors of W A W.
    """
    d = np.asarray(design_host, np.float64)
    q = np.asarray(qmask_host, np.float64)
    pp = np.asarray(pp_host, np.float64).reshape(-1)
    a = d.T @ (q[:, None] * d)
    w = 1.0 / np.sqrt(pp)
    lam, e = np.linalg.eigh(w[:, None] * a * w[None, :])
    lam = np.maximum(lam, 0.0)  # Gram matrix: clip f64 roundoff
    return a, lam, w[:, None] * e, w


def make_spectral_loop(design_host, qmask_host, pp_host, n_iters,
                       init_b, init_c, inv_b0, c_post, dtype):
    """Build fn(m0 [P,V], rtqr [1,V] or [V], dtqr [P,V], pm [P,V])
    -> (means [P,V], prec [P,P,V], cov [P,P,V], b [1,V], c [1,V]).

    All inputs are the single-group white DesignStats planes; pm is
    the (possibly voxelwise, e.g. image-prior) prior means.
    """
    a_h, lam_h, ew_h, winv_h = spectral_basis(design_host, qmask_host,
                                              pp_host)
    p = a_h.shape[0]
    pp_h = np.asarray(pp_host, np.float64).reshape(-1)

    def run(m0, rtqr, dtqr, pm):
        dt = m0.dtype
        ew = jnp.asarray(ew_h, dt)                     # [P,P]  W E
        # etw applies E'W ( = (WE)' since W is diagonal), etwi applies
        # E'W^-1 ( = (W^-1 E)'); both built from the host f64 factors
        e_h = ew_h / winv_h[:, None]                   # E (host)
        etw = jnp.asarray(ew_h.T, dt)                         # E' W
        etwi = jnp.asarray((e_h / winv_h[:, None]).T, dt)     # E' W^-1
        a = jnp.asarray(a_h, dt)
        pp = jnp.asarray(pp_h, dt)[:, None]            # [P,1]

        rtqr = rtqr.reshape(-1)[None, :] if rtqr.ndim == 1 else rtqr
        dtqy = dtqr + a @ m0                           # D'Qy  [P,V]
        # the P axis is UNROLLED into per-mode [V] rows: a [P,V] loop
        # body makes XLA emit one reduction kernel per cross/quad/tr
        # sum, each round-tripping its [P,V] input through device
        # memory every iteration. With [V] rows the whole body fuses into ONE
        # elementwise kernel per iteration reading only the 4P+1
        # loop-invariant rows.
        ut = [r[0] for r in jnp.split(etw @ dtqy, p)]
        u0t = [r[0] for r in jnp.split(etw @ dtqr, p)]
        vt = [r[0] for r in jnp.split(etw @ (pp * pm), p)]
        m0t = [r[0] for r in jnp.split(etwi @ m0, p)]
        lam = [dt.type(float(x)) for x in lam_h]

        s0 = jnp.full_like(rtqr[0], float(init_b) * float(init_c))
        ib0 = dt.type(float(inv_b0))
        cpost = dt.type(float(c_post))

        def quadratics(s):
            cross = 0.0
            quad = 0.0
            tr = 0.0
            mt = []
            for i in range(p):
                rden = 1.0 / (s * lam[i] + 1.0)
                mt_i = (s * ut[i] + vt[i]) * rden
                d_ = mt_i - m0t[i]
                cross = cross + d_ * u0t[i]
                quad = quad + lam[i] * d_ * d_
                tr = tr + lam[i] * rden
                mt.append(mt_i)
            return mt, cross, quad, tr

        def body(_, carry):
            s, _b = carry
            _, cross, quad, tr = quadratics(s)
            kqk = jnp.maximum(rtqr[0] - 2.0 * cross + quad, 0.0)
            b = 1.0 / ((kqk + tr) * 0.5 + ib0)
            return b * cpost, b

        s_fin, b_fin = jax.lax.fori_loop(
            jnp.int32(0), jnp.int32(n_iters - 1), body, (s0, s0))
        # the last iteration's posterior is reconstructed from the
        # phi that produced it (s entering iteration n)
        mt, cross, quad, tr = quadratics(s_fin)
        mt_m = jnp.stack(mt)
        means = ew @ mt_m
        rden = jnp.stack([1.0 / (s_fin * lam[i] + 1.0) for i in range(p)])
        # cov_ij = sum_k (WE)_ik (WE)_jk / denom_k ; prec = s A + diag(pp)
        cov = jnp.einsum("ik,jk,kv->ijv", ew, ew, rden)
        # run the final noise update so b/c reflect the final means
        kqk = jnp.maximum(rtqr[0] - 2.0 * cross + quad, 0.0)
        b = (1.0 / ((kqk + tr) * 0.5 + ib0))[None, :]
        c = jnp.full_like(b, cpost)
        prec = (s_fin[None, None, :] * a[:, :, None]
                + jnp.eye(p, dtype=dt)[:, :, None] * pp[:, None])
        return means, prec, cov, b, c

    return run


def eigen_elbo_const(qmask_host, c_post, c0, b0, p):
    """Host-f64 constant block of the eigenbasis ELBO (derivation in
    make_spectral_detector_loop's docstring)."""
    t_n = float(np.asarray(qmask_host, np.float64).sum())
    cpost_f = float(c_post)
    return (0.5 * p - 0.5 * t_n * math.log(2 * math.pi)
            + float(_gammaln(cpost_f)) + cpost_f
            + 0.5 * float(_digamma(cpost_f))
            - float(_gammaln(float(c0)))
            - float(c0) * math.log(float(b0)))


def make_spectral_detector_loop(design_host, qmask_host, pp_host, detector,
                                max_iter_cap, init_b, init_c, inv_b0,
                                c_post, b0, c0, dtype):
    """Spectral fixed point under an F-based convergence detector
    (pointzeroone / freduce / trialmode — the batched state machines of
    inference/convergence.py run verbatim inside the loop).

    The ELBO (noisemodel_white.cc:365-454 via free_energy_from_parts)
    collapses in the eigenbasis: with denom = s*lam+1 from the phi mean
    s that GENERATED the current posterior and b the current noise
    scale (c is the constant c_post after any update),

      F = C - 0.5*sum(log denom) + (c_post+0.5)*log b
          - b*c_post*(1/b0 + 0.5*kqk) - 0.5*tr
          - 0.5*sum((mt-vt)^2) - 0.5*sum(1/denom)

    (the log b coefficient is 1 [entropy] + T/2+c0-1 [part0]
    = c_post+1/2; part4 uses vt = E'W^-1 pm = E'W(pp*pm)).

    Per-lane save/revert state is the scalar pair (generating phi,
    noise b) — every spectral posterior is a pure function of its
    generating phi — plus an is-initial flag: the engine's initial
    posterior is off the spectral manifold (freduce reverts restore
    it, and trialmode initializes its best-state there), so lanes
    whose selected state is the initial one are reconstructed by the
    caller from the initial planes.

    Returns fn(m0, rtqr, dtqr, pm, conv0) ->
      (means, prec, cov, b [1,V], sel_init [V] bool, conv)
    where lanes with sel_init must be overwritten by the caller and
    conv carries the per-lane iteration counts / done flags.
    """
    a_h, lam_h, ew_h, winv_h = spectral_basis(design_host, qmask_host,
                                              pp_host)
    p = a_h.shape[0]
    pp_h = np.asarray(pp_host, np.float64).reshape(-1)
    cpost_f = float(c_post)
    # host-side f64 constant block of the ELBO (derivation above)
    const = eigen_elbo_const(qmask_host, c_post, c0, b0, p)

    def run(m0, rtqr, dtqr, pm, conv0):
        dt = m0.dtype
        ew = jnp.asarray(ew_h, dt)
        e_h = ew_h / winv_h[:, None]
        etw = jnp.asarray(ew_h.T, dt)
        etwi = jnp.asarray((e_h / winv_h[:, None]).T, dt)
        a = jnp.asarray(a_h, dt)
        pp = jnp.asarray(pp_h, dt)[:, None]

        rtqr = rtqr.reshape(-1)[None, :] if rtqr.ndim == 1 else rtqr
        dtqy = dtqr + a @ m0
        # P unrolled into [V] rows: one fused elementwise kernel per
        # iteration instead of per-sum reduction kernels (see
        # make_spectral_loop)
        ut = [r[0] for r in jnp.split(etw @ dtqy, p)]
        u0t = [r[0] for r in jnp.split(etw @ dtqr, p)]
        vt = [r[0] for r in jnp.split(etw @ (pp * pm), p)]
        m0t = [r[0] for r in jnp.split(etwi @ m0, p)]
        lam = [dt.type(float(x)) for x in lam_h]

        nv = m0.shape[-1]
        s0 = jnp.full(nv, float(init_b) * float(init_c), dt)
        b_init = jnp.full(nv, float(init_b), dt)
        ib0 = dt.type(float(inv_b0))
        cpost = dt.type(cpost_f)
        cbig = dt.type(const)
        true_v = jnp.ones(nv, bool)

        def quadratics(g):
            """cross/quad/tr + the ELBO's log/recip sums at phi g."""
            cross = 0.0
            quad = 0.0
            tr = 0.0
            logden = 0.0
            rdensum = 0.0
            mv2 = 0.0
            mt = []
            for i in range(p):
                den = g * lam[i] + 1.0
                rden = 1.0 / den
                mt_i = (g * ut[i] + vt[i]) * rden
                d_ = mt_i - m0t[i]
                cross = cross + d_ * u0t[i]
                quad = quad + lam[i] * d_ * d_
                tr = tr + lam[i] * rden
                logden = logden + jnp.log(den)
                rdensum = rdensum + rden
                mv2 = mv2 + (mt_i - vt[i]) ** 2
                mt.append(mt_i)
            return mt, cross, quad, tr, logden, rdensum, mv2

        # carry: (it, cur_s [phi mean of current noise], cur_b,
        #         gen_s [phi that generated current posterior],
        #         is_init, best_gen, best_b, best_init, conv)
        carry0 = (jnp.int32(0), s0, b_init, s0, true_v,
                  s0, b_init, true_v, conv0)

        def cond(c):
            it, _, _, _, _, _, _, _, conv = c
            return (~jnp.all(conv.done)) & (it < max_iter_cap)

        def body(c):
            it, cur_s, cur_b, gen_s, is_init, bg, bb, bi, conv = c
            # 1. save current state as best where flagged (engine
            #    _iteration step 1, inference_vb.cc:451)
            bg_n = jnp.where(conv.save, gen_s, bg)
            bb_n = jnp.where(conv.save, cur_b, bb)
            bi_n = jnp.where(conv.save, is_init, bi)

            # 2. theta update generated by the current phi mean
            g = cur_s
            (_, cross, quad, tr, logden, rdensum,
             mv2) = quadratics(g)
            kqk = jnp.maximum(rtqr[0] - 2.0 * cross + quad, 0.0)
            # 3. noise update
            b_new = 1.0 / ((kqk + tr) * 0.5 + ib0)
            s_new = b_new * cpost
            # 4. ELBO at (new means, new noise)
            f = (cbig - 0.5 * logden
                 + (cpost + 0.5) * jnp.log(b_new)
                 - b_new * cpost * (ib0 + 0.5 * kqk) - 0.5 * tr
                 - 0.5 * mv2 - 0.5 * rdensum)
            conv_new = detector.test(conv, f)

            # freeze lanes that were done before this iteration
            fro = conv.done
            sel = lambda n, o: jnp.where(fro, o, n)  # noqa: E731
            conv_m = jax.tree_util.tree_map(sel, conv_new, conv)
            return (it + 1, sel(s_new, cur_s), sel(b_new, cur_b),
                    sel(g, gen_s), is_init & fro,
                    sel(bg_n, bg), sel(bb_n, bb), sel(bi_n, bi), conv_m)

        (_, cur_s, cur_b, gen_s, is_init, bg, bb, bi,
         conv) = jax.lax.while_loop(cond, body, carry0)

        # post-loop save/revert (engine _finalize,
        # inference_vb.cc:505-525)
        bg = jnp.where(conv.save, gen_s, bg)
        bb = jnp.where(conv.save, cur_b, bb)
        bi = jnp.where(conv.save, is_init, bi)
        sel_gen = jnp.where(conv.revert, bg, gen_s)
        sel_b = jnp.where(conv.revert, bb, cur_b)
        sel_init = jnp.where(conv.revert, bi, is_init)

        mt, *_ = quadratics(sel_gen)
        means = ew @ jnp.stack(mt)
        rden = jnp.stack([1.0 / (sel_gen * lam[i] + 1.0)
                          for i in range(p)])
        cov = jnp.einsum("ik,jk,kv->ijv", ew, ew, rden)
        prec = (sel_gen[None, None, :] * a[:, :, None]
                + jnp.eye(p, dtype=dt)[:, :, None] * pp[:, None])
        return means, prec, cov, sel_b[None, :], sel_init, conv

    return run
