"""Motion correction: rigid/affine timepoint registration on the device.

Capability parity with the reference's MCobj (motioncorr.cc:25-94): the
original 4-D data is re-registered, one timepoint at a time, to the
current model prediction, and VB continues on the realigned data. The
reference shells out to FSL mcflirt (affine, dof<=12) or a
diffeomorphic field update (dof>12); here the registration is a jitted
Gauss-Newton loop over a 6-dof rigid (or 12-dof affine) transform with
trilinear resampling — pure JAX, so it runs on the device alongside the
inference instead of round-tripping to an external binary.

Semantics mirrored from motioncorr.cc:
- each timepoint gets its OWN transform (per-volume affmat rows,
  motioncorr.cc:88-92);
- the source image is always the ORIGINAL data (`wholeimage`), so
  transforms do not compound across MC steps;
- the target is the model prediction at the current posterior means;
- 10 optimizer iterations per call (num_iter, motioncorr.cc:47).

Gauge fixing: registering every volume to the model prediction leaves
a common-mode transform undetermined (the fit sits at the
motion-weighted centroid, so ALL volumes would be dragged to it and
resampled). The output frame is anchored by composing each estimated
transform with the EXACT inverse of the componentwise-median-parameter
transform (the analogue of mcflirt's reference-volume anchoring);
volumes whose adjusted transform is near-identity pass through
unresampled, so still timepoints pay no interpolation-smoothing cost.

Dispatch shape: ONE jitted lax.map over timepoints for estimation and
one for application (per-timepoint dispatches would each wait on the
host); only the
[T,3] translation diagnostics are fetched to host.

Capture range: the Gauss-Newton cost is only locally convex, so a
single-resolution registration captures roughly +-2 voxels of
translation. A MULTI-RESOLUTION pyramid (mcflirt's own strategy)
extends this: coarse levels average-pool both volumes by a factor f
and register over the dense coarse grid (+-2 COARSE voxels = +-2f fine
voxels of capture), and each level's estimate — translations rescaled
— seeds the next finer level, down to the original masked-voxel cost.
Default levels (4, 1): ~+-8 voxels of capture. Estimates near the top
level's range still trigger the caller's saturation warning
(reg.capture_range).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.ndimage import map_coordinates


def _rotation(rx, ry, rz):
    """Full (not small-angle) rotation matrix Rz @ Ry @ Rx."""
    cx, sx = jnp.cos(rx), jnp.sin(rx)
    cy, sy = jnp.cos(ry), jnp.sin(ry)
    cz, sz = jnp.cos(rz), jnp.sin(rz)
    rx_m = jnp.stack([
        jnp.stack([jnp.ones_like(cx), jnp.zeros_like(cx), jnp.zeros_like(cx)]),
        jnp.stack([jnp.zeros_like(cx), cx, -sx]),
        jnp.stack([jnp.zeros_like(cx), sx, cx])])
    ry_m = jnp.stack([
        jnp.stack([cy, jnp.zeros_like(cy), sy]),
        jnp.stack([jnp.zeros_like(cy), jnp.ones_like(cy), jnp.zeros_like(cy)]),
        jnp.stack([-sy, jnp.zeros_like(cy), cy])])
    rz_m = jnp.stack([
        jnp.stack([cz, -sz, jnp.zeros_like(cz)]),
        jnp.stack([sz, cz, jnp.zeros_like(cz)]),
        jnp.stack([jnp.zeros_like(cz), jnp.zeros_like(cz),
                   jnp.ones_like(cz)])])
    return rz_m @ ry_m @ rx_m


def _linear_part(params, dof, dtype):
    if dof == 6:
        return _rotation(params[3], params[4], params[5])
    if dof == 12:
        return jnp.eye(3, dtype=dtype) + params[3:12].reshape(3, 3)
    raise ValueError(f"dof must be 6 or 12, got {dof}")


def _warp_coords(params, coords, centre, dof):
    """Transformed sample coordinates [3,V].

    params: [dof] — [tx,ty,tz,rx,ry,rz] for dof=6, or translations +
    row-major (A - I) entries for dof=12. Rotation about the volume
    centre.
    """
    t = params[:3][:, None]
    a = _linear_part(params, dof, params.dtype)
    return a @ (coords - centre[:, None]) + centre[:, None] + t


def params_to_affine(params, centre, dof):
    """(A [3,3], b [3]) with S(x) = A x + b equal to the centred
    parameterization A(x-c)+c+t."""
    a = _linear_part(params, dof, params.dtype)
    c = jnp.asarray(centre, params.dtype)
    b = c - a @ c + params[:3]
    return a, b


@functools.lru_cache(maxsize=8)
def _compiled_fns(shape, dof, n_iters, damping, dtype_name,
                  levels=(4, 1)):
    """Jitted registration callables for one static configuration.

    The volume-sized bindings — coords [3,V], scatter index tuple
    (3×[V]) and the grid centre — are THREADED THROUGH as arguments
    rather than closure-captured, so they travel as device buffers
    instead of being baked into the HLO as constants (volume-sized
    constants bloat the program), and the compiled executables are reused
    across MC steps and run() calls (jit caches on shapes).

    levels: descending pool factors of the registration pyramid; the
    final entry must be 1 (full-resolution masked-voxel cost). Coarse
    levels too large for the volume are skipped statically.
    """
    dtype = jnp.dtype(dtype_name)
    eye = jnp.eye(dof, dtype=dtype)
    # statically drop pyramid levels the volume can't support (a
    # pooled axis below ~4 cells makes the demeaned cost degenerate
    # and the coarse estimate can seed the fine level OUTSIDE its
    # capture range — worse than no pyramid)
    levels = tuple(f for f in levels
                   if f == 1 or min(shape) // f >= 4)
    if levels[-1] != 1:
        raise ValueError("pyramid levels must end at full resolution")

    def to_grid(vals, idx):
        return jnp.zeros(shape, dtype).at[idx].set(vals)

    def sample(grid, params, coords, centre):
        pts = _warp_coords(params, coords, centre, dof)
        return map_coordinates(grid, [pts[0], pts[1], pts[2]], order=1,
                               mode="nearest")

    def pool_grid(grid, f):
        """Average-pool a [nx,ny,nz] grid by factor f (zero-padded to
        a multiple; the padding dilutes only boundary cells)."""
        ns = [(s + (-s) % f) // f for s in shape]
        g = jnp.pad(grid, [(0, (-s) % f) for s in shape])
        return g.reshape(ns[0], f, ns[1], f, ns[2], f).mean(axis=(1, 3, 5))

    def coarse_coords(f):
        """Dense sample coordinates of the level-f grid (static)."""
        ns = [(s + (-s) % f) // f for s in shape]
        gx, gy, gz = np.meshgrid(*[np.arange(n) for n in ns],
                                 indexing="ij")
        return jnp.asarray(np.stack([gx.ravel(), gy.ravel(),
                                     gz.ravel()]), dtype)

    def gn_loop(params0, sample_c, target_c):
        def gn_step(_, params):
            resid = sample_c(params) - target_c            # [V]
            jac = jax.jacfwd(sample_c)(params)             # [V,dof]
            g = jac.T @ resid
            h = jac.T @ jac + damping * eye
            return params - jnp.linalg.solve(h, g)

        return jax.lax.fori_loop(0, n_iters, gn_step, params0)

    def _rescale(params, ratio):
        """Level transition: translations are in current-level voxel
        units; the linear part (angles / A-I entries) is scale-free."""
        return params.at[:3].multiply(dtype.type(ratio))

    def estimate(data_t, pred_t, coords, idx, centre):
        grid = to_grid(data_t.astype(dtype), idx)
        # offset-invariant cost (mcflirt's normalized-correlation
        # family): both volumes are demeaned, so a global intensity
        # mismatch (e.g. a temporal trend the model carries) cannot
        # leak into spurious translation along the image gradient
        pred_c = pred_t.astype(dtype)
        pred_c = pred_c - jnp.mean(pred_c)
        pred_grid = None

        params = jnp.zeros((dof,), dtype)
        prev_f = levels[0]
        for f in levels:
            params = _rescale(params, prev_f / f)
            prev_f = f
            if f == 1:
                def sample_fine(p):
                    s = sample(grid, p, coords, centre)
                    return s - jnp.mean(s)

                params = gn_loop(params, sample_fine, pred_c)
                continue
            # coarse level: dense registration of the pooled volumes
            if pred_grid is None:
                pred_grid = to_grid(pred_c, idx)
            gd = pool_grid(grid, f)
            gp = pool_grid(pred_grid, f)
            target = (gp - jnp.mean(gp)).ravel()
            ccoords = coarse_coords(f)
            ccentre = centre / dtype.type(f)

            def sample_coarse(p, gd=gd, cc=ccoords, cn=ccentre):
                s = sample(gd, p, cc, cn)
                return s - jnp.mean(s)

            params = gn_loop(params, sample_coarse, target)
        return params

    def apply_affine(data_t, a, b, coords, idx):
        grid = to_grid(data_t.astype(dtype), idx)
        pts = a @ coords + b[:, None]
        return map_coordinates(grid, [pts[0], pts[1], pts[2]], order=1,
                               mode="nearest")

    @jax.jit
    def register_one(data_t, pred_t, coords, idx, centre):
        params = estimate(data_t, pred_t, coords, idx, centre)
        grid = to_grid(data_t.astype(dtype), idx)
        return sample(grid, params, coords, centre), params

    estimate_all = jax.jit(lambda d, p, coords, idx, centre: jax.lax.map(
        lambda dp: estimate(dp[0], dp[1], coords, idx, centre), (d, p)))
    apply_all = jax.jit(lambda d, a, b, coords, idx: jax.lax.map(
        lambda dab: apply_affine(dab[0], dab[1], dab[2], coords, idx),
        (d, a, b)))
    return register_one, estimate_all, apply_all


class _Registerer:
    """Bound registerer: static config compiled once (shared via
    _compiled_fns), voxel-sized bindings held as device arrays."""

    def __init__(self, coords, shape, dof, n_iters, damping, dtype,
                 levels=(4, 1)):
        dtype = jnp.dtype(dtype)
        coords = jnp.asarray(coords, dtype)
        if coords.shape[0] != 3:
            coords = coords.T  # -> [3,V]
        self.coords = coords
        self.idx = tuple(jnp.asarray(
            np.asarray(coords, np.float64).round(), jnp.int32))
        self.centre = jnp.asarray(
            (np.asarray(shape, np.float64) - 1) / 2.0, dtype)
        self.dof = dof
        # pyramid levels actually usable at this volume size; the top
        # level sets the capture range (+-2 of its voxels)
        used = tuple(f for f in levels
                     if f == 1 or min(int(s) for s in shape) // f >= 4)
        self.levels = used
        self.capture_range = 2.0 * used[0]
        self._one, self._est_all, self._apply_all = _compiled_fns(
            tuple(int(s) for s in shape), int(dof), int(n_iters),
            float(damping), dtype.name, levels=tuple(levels))

    def __call__(self, data_t, pred_t):
        return self._one(data_t, pred_t, self.coords, self.idx,
                         self.centre)

    def estimate_all(self, data, pred):
        return self._est_all(data, pred, self.coords, self.idx,
                             self.centre)

    def apply_all(self, data, a, b):
        return self._apply_all(data, a, b, self.coords, self.idx)


def make_registerer(coords, shape, dof=6, n_iters=10, damping=1e-4,
                    dtype=jnp.float32):
    """Build a per-timepoint registerer.

    coords: [V,3] (or [3,V]) integer voxel coordinates of the masked
    voxels; shape: (nx,ny,nz) grid extent.

    Returns reg with reg(data_t [V], pred_t [V]) -> (realigned_t [V],
    params [dof]): estimates the transform minimising masked SSD
    between the resampled data volume and the prediction, and returns
    the data resampled through it. Batched variants reg.estimate_all /
    reg.apply_all map over the leading timepoint axis in one dispatch.
    """
    return _Registerer(coords, shape, dof, n_iters, damping, dtype)


# adjusted transforms closer to identity than this (linear-part entries
# and centre displacement, voxels) pass through unresampled
IDENTITY_TOL = 1e-2

# capture range of a SINGLE level of the Gauss-Newton registration, in
# that level's voxels; the pyramid's top pool factor multiplies it
# (reg.capture_range). Estimates approaching the top range mean real
# motion may exceed it and be under-corrected — callers warn at 75%
CAPTURE_RANGE_VOXELS = 2.0


def register_timeseries(data, pred, coords, shape, dof=6, n_iters=10,
                        reg=None):
    """Realign every timepoint of `data` to the model prediction.

    data, pred: [T,V] planes (voxels on lanes, the engine layout).
    Returns (realigned [T,V] device array, translations [T,3] numpy —
    the gauge-adjusted displacement of the volume centre per
    timepoint). Equivalent of MCobj::run_mc (motioncorr.cc:70-94):
    per-timepoint transforms estimated from the ORIGINAL data each
    call, then composed with the exact inverse of the median-parameter
    transform (gauge anchoring, see module docstring).

    Pass `reg` (a make_registerer result) to reuse one set of device
    bindings across MC steps instead of re-uploading coords each call.
    """
    if reg is None:
        reg = make_registerer(coords, shape, dof=dof, n_iters=n_iters)
    data = jnp.asarray(data)
    pred = jnp.asarray(pred)

    params = np.asarray(reg.estimate_all(data, pred), np.float64)  # [T,dof]

    # exact gauge composition: S_adj = S_t o S_med^-1 in affine form
    p_med = jnp.asarray(np.median(params, axis=0), jnp.float32)
    a_med, b_med = params_to_affine(p_med, reg.centre, dof)
    a_med_inv = np.linalg.inv(np.asarray(a_med, np.float64))
    abs_ = []
    for t in range(params.shape[0]):
        a_t, b_t = params_to_affine(jnp.asarray(params[t], jnp.float32),
                                    reg.centre, dof)
        a_t = np.asarray(a_t, np.float64)
        b_t = np.asarray(b_t, np.float64)
        a_adj = a_t @ a_med_inv
        b_adj = b_t - a_adj @ np.asarray(b_med, np.float64)
        abs_.append((a_adj, b_adj))
    a_all = np.stack([ab[0] for ab in abs_])                # [T,3,3]
    b_all = np.stack([ab[1] for ab in abs_])                # [T,3]

    centre = np.asarray(reg.centre, np.float64)
    disp = (np.einsum("tij,j->ti", a_all, centre) + b_all
            - centre)                                       # [T,3]
    ident = (np.abs(a_all - np.eye(3)).max(axis=(1, 2)) < IDENTITY_TOL) \
        & (np.abs(disp).max(axis=1) < IDENTITY_TOL)

    resampled = reg.apply_all(data, jnp.asarray(a_all, jnp.float32),
                              jnp.asarray(b_all, jnp.float32))
    realigned = jnp.where(jnp.asarray(ident)[:, None], data,
                          resampled.astype(data.dtype))
    return realigned, disp
