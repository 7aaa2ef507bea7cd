"""Spatial VB: MRF / Penny priors coupling voxels over the 6-neighbour
graph.

Reference semantics (inference_vb.cc:578-767, priors.cc:183-488): an
iteration-major sweep where each parameter with prior type M/m/P/p gets
a per-voxel prior built from neighbouring posterior means, and a single
global spatial-precision scalar aK per parameter updated once per sweep
from a whole-volume reduction (Penny 2005 Fig 4).

Design notes:
  * The reference updates posteriors in place while sweeping voxels
    lexicographically (Gauss-Seidel-ish). Here the sweep is a *Jacobi*
    iteration: every voxel's spatial prior reads the previous sweep's
    posterior means. This is the parallel-correct formulation — it
    converges to the same fixed point, is deterministic under any
    sharding, and makes the neighbour reads a pure gather.
  * The aK update is a global sum reduction — under a sharded mesh this
    is exactly one psum per spatial parameter per sweep; the neighbour
    gathers become halo exchanges at shard boundaries, both inserted
    automatically by GSPMD from the voxel-axis sharding.
  * Numerically-failed voxels are excised from the graph by zeroing
    their weight (the IgnoreVoxel semantics, inference_vb.cc:266-297)
    rather than by list surgery.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.neighbours import calc_neighbours
from ..exceptions import FabberError, InvalidOptionValue
from ..models.base import (PRIOR_SPATIAL_M, PRIOR_SPATIAL_m,
                           PRIOR_SPATIAL_P, PRIOR_SPATIAL_p)
from ..options import OptionSpec, OPT_INT, OPT_STR, OPT_BOOL, OPT_FLOAT
from ..ops import smallmat as sm
from ..devices import device_memory_limit
from .vb import (VBInference, VBLoopState, PosteriorState,
                 _lane_where)

AK_INIT = 1e-8
AK_FLOOR = 1e-50
MRF_JITTER = 1e-8  # invertibility term for type M (priors.cc:259,408)


class SpatialState(NamedTuple):
    post: PosteriorState
    centre: jnp.ndarray
    f: jnp.ndarray
    ak: jnp.ndarray   # [n_spatial_params]
    bad: jnp.ndarray  # [V] bool — excised voxels
    # linearization is recomputed from `centre` each sweep, not carried
    its: jnp.ndarray = ()  # sweeps executed; set by the loop driver


class SpatialVBInference(VBInference):
    """method=spatialvb (also reached via spatial prior type chars)."""

    @classmethod
    def get_options(cls):
        return VBInference.get_options() + [
            OptionSpec("spatial-dims", OPT_INT, "Number of spatial dimensions",
                       default="3"),
            OptionSpec("spatial-speed", OPT_STR,
                       "Restrict speed of spatial smoothing", default="-1"),
            OptionSpec("param-spatial-priors", OPT_STR,
                       "Type of spatial priors per parameter: N=nonspatial, "
                       "M=Markov random field, P=Penny, A=ARD", default="N+"),
            # description empty in the reference (inference_vb.cc:72);
            # filled in here so --help is self-explanatory
            OptionSpec("update-spatial-prior-on-first-iteration", OPT_BOOL,
                       "Update the spatial prior (aK) on iteration 0"),
            OptionSpec("spatial-q1", OPT_FLOAT,
                       "Prior Gamma scale for aK", default="10.0"),
            OptionSpec("spatial-q2", OPT_FLOAT,
                       "Prior Gamma shape for aK", default="1.0"),
            OptionSpec("spatial-sweep-mode", OPT_STR,
                       "jacobi (parallel; deterministic under sharding) "
                       "or gauss-seidel (the reference's sequential "
                       "in-place voxel ordering; single-device parity "
                       "mode)", default="jacobi"),
            OptionSpec("spatial-stencil", OPT_STR,
                       "Neighbour-sum implementation: auto, dense "
                       "(scatter to the 3-D grid + shifted adds) or "
                       "gather (padded index arrays)", default="auto"),
            OptionSpec("spatial-block-voxels", OPT_INT,
                       "Beyond-HBM escape: stream the volume through "
                       "the device in voxel blocks of this size, one "
                       "block per dispatch per sweep (cross-voxel "
                       "neighbour sums and the aK reduction run on the "
                       "host between sweeps — block-sequential IS the "
                       "Jacobi sweep, results are unchanged). "
                       "0 = whole volume on device", default="0"),
            OptionSpec("spatial-mem-gb", OPT_FLOAT,
                       "Device memory budget for the capacity "
                       "pre-check, GB (0 = FABBER_TPU_MEM_GB env, else "
                       "the device's memory limit, else unchecked)",
                       default="0"),
            OptionSpec("spatial-fchange", OPT_FLOAT,
                       "Stop sweeping early once the absolute change "
                       "of the global free energy (sum of F over "
                       "non-excised voxels) between sweeps drops below "
                       "this. 0 = reference-faithful blind "
                       "max-iterations count (the reference's counting "
                       "detector ignores its Fglobal argument, "
                       "convergence.cc CountingConvergenceDetector)",
                       default="0"),
        ]

    def __init__(self, model, options, data, coords, suppdata=None,
                 voxel_data_getter=None, dtype=None, data_plane=None,
                 supp_plane=None):
        # Blocked streaming mode keeps the [T,V] plane on the HOST so
        # volumes beyond device HBM never materialize there; peeked
        # before super() because that is where the device plane would
        # otherwise be created.
        blocked = options.get_int("spatial-block-voxels", 0, minval=0)
        if blocked > 0 and data_plane is None and data is not None:
            data_plane = np.ascontiguousarray(
                np.asarray(data, np.float32).T)   # host [T,V]
        super().__init__(model, options, data, coords, suppdata,
                         voxel_data_getter, dtype, data_plane=data_plane,
                         supp_plane=supp_plane)
        self.block_voxels = blocked
        self.mem_gb = options.get_float("spatial-mem-gb", 0.0)
        if blocked > 0:
            if not isinstance(self.data, np.ndarray):
                raise InvalidOptionValue(
                    "spatial-block-voxels", str(blocked),
                    "Blocked sweeps are the single-process beyond-HBM "
                    "escape; incompatible with pre-sharded device data "
                    "planes (--distributed shards instead of blocking)")
            # voxel-local side planes move to the host too: the blocked
            # runner ships only per-block slices
            self.coords = np.asarray(self.coords)
            if self.suppdata is not None:
                self.suppdata = np.asarray(self.suppdata)
        self.save_fhist = False  # per-iteration history is a voxelwise-mode feature
        if self.num_mcsteps > 0:
            # motion correction is wired for voxelwise VB only; reject
            # explicitly rather than parse-and-ignore
            raise InvalidOptionValue(
                "mcsteps", str(self.num_mcsteps),
                "Motion correction is implemented for method=vb only")
        self.spatial_dims = options.get_int("spatial-dims", 3, 0, 3)
        self.spatial_speed = options.get_float("spatial-speed", -1.0)
        self.update_first_iter = options.get_bool(
            "update-spatial-prior-on-first-iteration")
        self.q1 = options.get_float("spatial-q1", 10.0)
        self.q2 = options.get_float("spatial-q2", 1.0)
        self.max_its = options.get_int("max-iterations", 10, minval=1)
        # The spatial loop uses a fixed iteration count, as the
        # reference hardcodes a counting detector on Fglobal
        # (inference_vb.cc:599-602). Reject other detectors explicitly
        # instead of silently ignoring the option.
        conv_name = options.get_string("convergence", "maxits")
        if conv_name != "maxits":
            raise InvalidOptionValue(
                "convergence", conv_name,
                "Spatial VB supports only the maxits detector (the "
                "reference hardcodes a counting detector for the "
                "spatial loop); for an Fglobal-based early stop use "
                "--spatial-fchange")
        self.f_stop_tol = options.get_float("spatial-fchange", 0.0)
        if self.f_stop_tol > 0:
            self.need_f = True  # the early stop tests sum-of-F
        # voxel count entering the aK shape term hK (priors.cc:302);
        # a padded sharded run sets this to the REAL voxel count so
        # padding lanes (pre-excised) don't alter the Penny update
        self.ak_nvoxels = self.nvoxels
        self.sweep_mode = options.get_string("spatial-sweep-mode", "jacobi")
        if self.sweep_mode not in ("jacobi", "gauss-seidel"):
            raise InvalidOptionValue("spatial-sweep-mode", self.sweep_mode,
                                     "Must be jacobi or gauss-seidel")
        if self.block_voxels > 0 and self.sweep_mode != "jacobi":
            raise InvalidOptionValue(
                "spatial-block-voxels", str(self.block_voxels),
                "Blocked sweeps are only exact for the jacobi sweep "
                "mode (gauss-seidel needs the sequential full volume)")

        # method=spatialvb with all-N priors is legal in the reference
        # (the golden outdata_linear_spatialvb run is exactly that): the
        # iteration-major sweep runs with no cross-voxel coupling
        self.spatial_params = [
            (i, p.prior_type) for i, p in enumerate(self.params)
            if p.prior_type in (PRIOR_SPATIAL_M, PRIOR_SPATIAL_m,
                                PRIOR_SPATIAL_P, PRIOR_SPATIAL_p)]

        neigh, neigh2 = calc_neighbours(np.asarray(coords),
                                        self.spatial_dims)
        self.neigh = jnp.asarray(neigh)
        self.neigh2 = jnp.asarray(neigh2)
        # host copies for the blocked runner's between-sweep reductions
        self._neigh_np = np.asarray(neigh)
        self._neigh2_np = np.asarray(neigh2)

        # Dense-stencil neighbour sums: scatter voxels into the 3-D
        # grid, sum 2*spatial_dims shifted copies, extract — one
        # monotonic scatter+gather instead of a [V,6]/[V,30] random
        # gather (the device-friendly stencil formulation; the gather path
        # remains for grids much larger than the masked voxel count).
        stencil_mode = options.get_string("spatial-stencil", "auto")
        self._dense = None
        if stencil_mode != "gather":
            ci = np.asarray(coords).astype(np.int64)
            xs, ys, zs = (int(ci[:, 0].max()) + 1, int(ci[:, 1].max()) + 1,
                          int(ci[:, 2].max()) + 1)
            dsize = xs * ys * zs
            if stencil_mode == "dense" or dsize <= 4 * self.nvoxels:
                off = (ci[:, 2] * xs * ys + ci[:, 1] * xs
                       + ci[:, 0]).astype(np.int32)
                # voxels->grid as a GATHER, not a scatter: scatters
                # serialize on the device, a gather through the inverse
                # permutation vectorizes. Full contiguous grids (off ==
                # 0..V-1) skip indexing entirely and just reshape.
                if dsize == self.nvoxels and np.array_equal(
                        off, np.arange(self.nvoxels, dtype=np.int32)):
                    inv = None   # pure reshape both ways
                else:
                    inv_np = np.zeros(dsize, np.int32)
                    occ = np.zeros(dsize, bool)
                    inv_np[off] = np.arange(self.nvoxels, dtype=np.int32)
                    occ[off] = True
                    inv = (jnp.asarray(inv_np), jnp.asarray(occ))
                self._dense = (xs, ys, zs, jnp.asarray(off), inv)

    def route_description(self):
        """Human-readable sweep/stencil selection, logged by the
        runner (mirrors VBInference.route_description)."""
        stencil = ("dense-stencil neighbour sums"
                   if self._dense is not None
                   else "gather neighbour sums")
        blocked = (f", blocked streaming sweeps ({self.block_voxels} "
                   "voxels/block)" if self.block_voxels > 0 else "")
        stats = " + fixed-design stats" if self.use_stats else ""
        return (f"spatial {self.sweep_mode} sweeps, {stencil}"
                f"{stats}{blocked}")

    def _bind(self, lo=0, hi=None):
        # spatial mode never chunks (MRF coupling needs the full graph)
        return super()._bind(lo, hi)._replace(neigh=self.neigh,
                                              neigh2=self.neigh2)

    # -- spatial prior math ----------------------------------------------
    def _gather_sum(self, values, idx, active):
        """Sum `values` over a padded neighbour index array, counting
        only valid + active entries. Returns (sums [V], counts [V])."""
        valid = idx >= 0
        safe = jnp.maximum(idx, 0)
        vals = values[safe]          # [V, K]
        act = active[safe]           # [V, K]
        w = (valid & act).astype(values.dtype)
        return jnp.sum(vals * w, axis=1), jnp.sum(w, axis=1)

    def _stencil_sum(self, dense):
        """Sum of the 2*spatial_dims unit-shifted copies of a dense
        [Z,Y,X] field, zero-filled at the grid boundary."""
        axes = [2, 1, 0][:self.spatial_dims]
        out = None
        for ax in axes:
            zeros = jnp.zeros_like(
                jax.lax.slice_in_dim(dense, 0, 1, axis=ax))
            fwd = jnp.concatenate(
                [jax.lax.slice_in_dim(dense, 1, None, axis=ax), zeros],
                axis=ax)
            bwd = jnp.concatenate(
                [zeros, jax.lax.slice_in_dim(dense, 0,
                                             dense.shape[ax] - 1, axis=ax)],
                axis=ax)
            s = fwd + bwd
            out = s if out is None else out + s
        return out

    def _neighbour_sums(self, post, active, bind):
        """Per spatial parameter: (nsum [V], nn [V], nsum2, nn2) —
        neighbour sums of posterior means and neighbour counts, plus
        the second-neighbour versions (with duplicates, self excluded;
        only for P/p types, else ()). Computed once per sweep and
        shared by the aK reduction and the prior construction (both
        read the same pre-sweep posterior means in the Jacobi sweep)."""
        actf = active.astype(self.dtype)
        out = []
        if self._dense is not None:
            xs, ys, zs, off, inv = self._dense

            if inv is None:
                # contiguous full grid: voxel order IS grid order
                def to_dense(vals):
                    return vals.reshape(zs, ys, xs)

                def extract(d):
                    return d.reshape(-1)
            else:
                inv_idx, occ = inv

                def to_dense(vals):
                    return jnp.where(occ, vals[inv_idx],
                                     jnp.zeros((), self.dtype)
                                     ).reshape(zs, ys, xs)

                def extract(d):
                    return d.reshape(-1)[off]

            md = to_dense(actf)
            s_m = self._stencil_sum(md)
            nn = extract(s_m)
            nn2_cache = None
            for slot, (k, tcode) in enumerate(self.spatial_params):
                w = post.means[k]
                s_w = self._stencil_sum(to_dense(w * actf))
                nsum = extract(s_w)
                if tcode in (PRIOR_SPATIAL_P, PRIOR_SPATIAL_p):
                    # sum over neighbours-of-neighbours keeping
                    # duplicates = S[m*S[.]], minus the self terms
                    # (each of the nn neighbours lists v once)
                    nsum2 = extract(self._stencil_sum(md * s_w)) - w * nn
                    if nn2_cache is None:
                        nn2_cache = extract(
                            self._stencil_sum(md * s_m)) - nn
                    out.append((nsum, nn, nsum2, nn2_cache))
                else:
                    out.append((nsum, nn, (), ()))
            return out

        for slot, (k, tcode) in enumerate(self.spatial_params):
            nsum, nn = self._gather_sum(post.means[k], bind.neigh, active)
            if tcode in (PRIOR_SPATIAL_P, PRIOR_SPATIAL_p):
                nsum2, nn2 = self._gather_sum(post.means[k], bind.neigh2,
                                              active)
                out.append((nsum, nn, nsum2, nn2))
            else:
                out.append((nsum, nn, (), ()))
        return out

    def _calculate_ak(self, post, active, bind, nsums=None):
        """Penny 2005 Fig 4 update for each spatial parameter's global
        precision (priors.cc:221-344). Pure reduction — psum under
        sharding."""
        dtype = self.dtype
        sd = self.spatial_dims
        actf = active.astype(dtype)
        if nsums is None:
            nsums = self._neighbour_sums(post, active, bind)
        aks = []
        for slot, (k, tcode) in enumerate(self.spatial_params):
            sigma_k = post.cov[k, k]
            w_k = post.means[k]
            nsum, nn = nsums[slot][0], nsums[slot][1]

            if tcode == PRIOR_SPATIAL_m:
                trace_w = jnp.full_like(sigma_k, sd * 2)
            elif tcode == PRIOR_SPATIAL_M:
                trace_w = nn + MRF_JITTER
            elif tcode == PRIOR_SPATIAL_p:
                trace_w = jnp.full_like(sigma_k, 4 * sd * sd + 2 * sd)
            else:  # P
                trace_w = nn * nn + nn
            trace_term = jnp.sum(sigma_k * trace_w * actf)

            swk = nn * w_k - nsum
            if tcode in (PRIOR_SPATIAL_p, PRIOR_SPATIAL_m):
                # no boundary correction: missing neighbours act as 0
                swk = swk + w_k * (sd * 2 - nn)
            if tcode in (PRIOR_SPATIAL_m, PRIOR_SPATIAL_M):
                term2 = jnp.sum(swk * w_k * actf)
            else:
                term2 = jnp.sum(swk * swk * actf)

            gk = 1.0 / (0.5 * trace_term + 0.5 * term2 + 1.0 / self.q1)
            hk = self.ak_nvoxels * 0.5 + self.q2
            ak = jnp.maximum(gk * hk, AK_FLOOR)
            if self.spatial_speed > 0:
                ak_max = jnp.maximum(ak * self.spatial_speed, 0.5)
                ak = jnp.minimum(ak, ak_max)
            aks.append(ak)
        return jnp.stack(aks)

    def _apply_spatial_priors(self, post, prior_means, prior_prec, ak,
                              active, bind, nsums=None):
        """Per-voxel spatial prior mean/precision from neighbour
        posterior means (priors.cc:346-488)."""
        dtype = self.dtype
        sd = self.spatial_dims
        if nsums is None:
            nsums = self._neighbour_sums(post, active, bind)
        for slot, (k, tcode) in enumerate(self.spatial_params):
            w_k = post.means[k]
            contrib_nn, nn, nsum2, nn2 = nsums[slot]
            if tcode in (PRIOR_SPATIAL_M, PRIOR_SPATIAL_m):
                # M/m never read second neighbours
                nsum2 = nn2 = jnp.zeros_like(nn)
            contrib_nn2 = -nsum2

            if tcode in (PRIOR_SPATIAL_p, PRIOR_SPATIAL_m):
                nn = jnp.full_like(nn, 2 * sd)
                nn2 = jnp.full_like(nn2, 4 * sd * sd - 2 * sd)

            base_mean = self.params[k].prior.mean
            base_prec = self.params[k].prior.prec
            akk = ak[slot]

            if tcode == PRIOR_SPATIAL_M:
                spatial_prec = akk * (nn + MRF_JITTER)
            elif tcode == PRIOR_SPATIAL_m:
                spatial_prec = akk * nn
            else:  # P/p
                spatial_prec = akk * (nn * nn + nn)

            if tcode in (PRIOR_SPATIAL_p, PRIOR_SPATIAL_m):
                new_prec = spatial_prec
            else:
                new_prec = base_prec + spatial_prec

            if tcode in (PRIOR_SPATIAL_m, PRIOR_SPATIAL_M):
                spatial_mean = contrib_nn * (1.0 / jnp.maximum(nn, 1e-30))
                new_mean = (1.0 / new_prec) * spatial_prec * spatial_mean
            else:
                denom = 8.0 * nn - nn2
                spatial_mean = jnp.where(
                    nn != 0,
                    (8.0 * contrib_nn + contrib_nn2)
                    / jnp.where(denom != 0, denom, 1.0),
                    0.0)
                new_mean = (1.0 / new_prec) * (
                    spatial_prec * spatial_mean + base_prec * base_mean)

            prior_means = prior_means.at[k].set(new_mean.astype(dtype))
            prior_prec = prior_prec.at[k].set(new_prec.astype(dtype))
        return prior_means, prior_prec

    def _spatial_prior_voxel(self, v, k, tcode, means_k, ak_k, active, bind):
        """Spatial prior (mean, precision) for one voxel/parameter from
        the CURRENT means plane — the scalar core of
        _apply_spatial_priors, used by the Gauss-Seidel sweep."""
        sd = self.spatial_dims
        dtype = self.dtype

        def gather(idx_row):
            valid = idx_row >= 0
            safe = jnp.maximum(idx_row, 0)
            w = (valid & active[safe]).astype(dtype)
            return jnp.sum(means_k[safe] * w), jnp.sum(w)

        contrib_nn, nn = gather(bind.neigh[v])
        if tcode in (PRIOR_SPATIAL_M, PRIOR_SPATIAL_m):
            nsum2 = nn2 = jnp.zeros_like(nn)
        else:
            nsum2, nn2 = gather(bind.neigh2[v])
        contrib_nn2 = -nsum2

        if tcode in (PRIOR_SPATIAL_p, PRIOR_SPATIAL_m):
            nn = jnp.asarray(2 * sd, dtype)
            nn2 = jnp.asarray(4 * sd * sd - 2 * sd, dtype)

        base_mean = self.params[k].prior.mean
        base_prec = self.params[k].prior.prec

        if tcode == PRIOR_SPATIAL_M:
            spatial_prec = ak_k * (nn + MRF_JITTER)
        elif tcode == PRIOR_SPATIAL_m:
            spatial_prec = ak_k * nn
        else:  # P/p
            spatial_prec = ak_k * (nn * nn + nn)

        if tcode in (PRIOR_SPATIAL_p, PRIOR_SPATIAL_m):
            new_prec = spatial_prec
        else:
            new_prec = base_prec + spatial_prec

        if tcode in (PRIOR_SPATIAL_m, PRIOR_SPATIAL_M):
            spatial_mean = contrib_nn / jnp.maximum(nn, 1e-30)
            new_mean = (1.0 / new_prec) * spatial_prec * spatial_mean
        else:
            denom = 8.0 * nn - nn2
            spatial_mean = jnp.where(
                nn != 0,
                (8.0 * contrib_nn + contrib_nn2)
                / jnp.where(denom != 0, denom, 1.0), 0.0)
            new_mean = (1.0 / new_prec) * (
                spatial_prec * spatial_mean + base_prec * base_mean)
        return new_mean.astype(dtype), new_prec.astype(dtype)

    def _phase_a_gs(self, s, bind, stats, prior_means0, prior_prec0,
                    active, ak, lin=None):
        """Sequential prior+theta pass in the reference's voxel order
        (inference_vb.cc:614-672): voxel v's spatial prior reads the
        ALREADY-UPDATED posteriors of voxels < v. lax.scan over voxels;
        O(V) sequential steps — a single-device parity mode, not the
        production path."""
        post = s.post
        noise_post = post.noise

        def slice_v(x, v):
            return jax.lax.dynamic_slice_in_dim(x, v, 1, axis=-1)

        def body(carry, v):
            means, prec, cov, pm, pp = carry
            pm_v = slice_v(pm, v)  # [P,1]
            pp_v = slice_v(pp, v)
            for slot, (k, tcode) in enumerate(self.spatial_params):
                nm, npv = self._spatial_prior_voxel(
                    v, k, tcode, means[k], ak[slot], active, bind)
                pm_v = pm_v.at[k, 0].set(nm)
                pp_v = pp_v.at[k, 0].set(npv)

            noise_v = jax.tree_util.tree_map(
                lambda x: slice_v(x, v), noise_post)
            if stats is not None:
                stats_v = self.noise.design_stats_voxel(stats, v)
                m_v, prec_v, cov_v, _ok = self.noise.update_theta_stats(
                    noise_v, pm_v, pp_v, stats_v)
            else:
                offset_c, jac_c = lin
                # jac_c is () on the fixed-design route (J = design)
                jac_v = slice_v(jac_c, v) if self.design is None else ()
                m_v, prec_v, cov_v, _ok = self.noise.update_theta(
                    noise_v, slice_v(means, v), pm_v, pp_v,
                    slice_v(s.centre, v), slice_v(offset_c, v),
                    jac_v, slice_v(bind.data, v), None,
                    design=self._design_arg(bind))

            # frozen (excised) voxels keep their pre-sweep state
            upd = active[v]
            def put(full, new_col, old_col):
                col = jnp.where(upd, new_col, old_col)
                return jax.lax.dynamic_update_slice_in_dim(
                    full, col, v, axis=-1)
            means = put(means, m_v, slice_v(means, v))
            prec = put(prec, prec_v, slice_v(prec, v))
            cov = put(cov, cov_v, slice_v(cov, v))
            pm = put(pm, pm_v, slice_v(pm, v))
            pp = put(pp, pp_v, slice_v(pp, v))
            return (means, prec, cov, pm, pp), None

        init = (post.means, post.prec, post.cov, prior_means0, prior_prec0)
        (means, prec, cov, pm, pp), _ = jax.lax.scan(
            body, init, jnp.arange(self.nvoxels, dtype=jnp.int32))
        return means, prec, cov, pm, pp

    # -- sweep ------------------------------------------------------------
    def _sweep(self, it, s, bind, stats=None, skip_f=False):
        active = ~s.bad
        post = s.post

        # aK: updated at sweep start from previous sweep's posteriors
        # (skipped on sweep 0 unless update-first-iteration)
        do_update = (it > 0) | self.update_first_iter
        if self.spatial_params:
            nsums = self._neighbour_sums(post, active, bind)
            ak = jnp.where(
                do_update,
                self._calculate_ak(post, active, bind, nsums), s.ak)
        else:
            nsums = []
            ak = s.ak
        return self._sweep_core(it, s, bind, stats, nsums, ak, active,
                                skip_f=skip_f)

    def _sweep_core(self, it, s, bind, stats, nsums, ak, active,
                    skip_f=False):
        """Everything in a sweep AFTER the cross-voxel reductions
        (neighbour sums + aK): voxel-local prior application, theta and
        noise updates, free energy, failure excision. Shared by the
        full-volume sweep and the blocked streaming sweep (which feeds
        host-computed nsums/ak per voxel block)."""
        post = s.post
        if stats is None:
            offset_c, jac_c = self._recentre(s.centre, bind)

        # priors: non-spatial family first (voxel-local, reads only
        # pre-sweep state in both sweep modes), spatial overrides
        prior_means, prior_prec, f_contribs = self.prior_setup.apply(
            post.prior_means, post.prior_prec, post.means,
            sm.diag_of(post.cov), it, base_means=bind.prior_base_means)
        # spatial mode *sums* prior F contributions (inference_vb.cc:630)
        fprior = jnp.sum(f_contribs, axis=0)

        # phase A (priors + theta), then noise + relinearize (phase B)
        if self.sweep_mode == "gauss-seidel":
            means, prec, cov, prior_means, prior_prec = self._phase_a_gs(
                s, bind, stats, prior_means, prior_prec, active, ak,
                lin=None if stats is not None else (offset_c, jac_c))
            if stats is not None:
                noise_post = self.noise.update_noise_stats(
                    post.noise, self.noise_prior, means, cov, stats)
            else:
                noise_post = self.noise.update_noise(
                    post.noise, self.noise_prior, means, cov,
                    s.centre, offset_c, jac_c, bind.data,
                    design=self._design_arg(bind))
        elif stats is not None:
            prior_means, prior_prec = self._apply_spatial_priors(
                post, prior_means, prior_prec, ak, active, bind, nsums)
            means, prec, cov, _ok = self.noise.update_theta_stats(
                post.noise, prior_means, prior_prec, stats)
            noise_post = self.noise.update_noise_stats(
                post.noise, self.noise_prior, means, cov, stats)
        else:
            prior_means, prior_prec = self._apply_spatial_priors(
                post, prior_means, prior_prec, ak, active, bind, nsums)
            means, prec, cov, _ok = self.noise.update_theta(
                post.noise, post.means, prior_means, prior_prec,
                s.centre, offset_c, jac_c, bind.data, None,
                design=self._design_arg(bind))
            noise_post = self.noise.update_noise(
                post.noise, self.noise_prior, means, cov,
                s.centre, offset_c, jac_c, bind.data,
                design=self._design_arg(bind))

        new_post = PosteriorState(means, prec, cov, prior_means, prior_prec,
                                  noise_post)
        need_f_here = self.need_f and not skip_f
        if need_f_here and stats is not None:
            f = self.noise.free_energy_stats(
                noise_post, self.noise_prior, means, prec, cov,
                prior_means, prior_prec, stats) + fprior
        elif need_f_here:
            offset, jac = self._recentre(means, bind)
            f = self.noise.free_energy(
                noise_post, self.noise_prior, means, prec, cov,
                prior_means, prior_prec, means, offset, jac, bind.data,
                design=self._design_arg(bind))
            f = f + fprior
        else:
            f = s.f

        # newly-failed voxels revert to their pre-sweep state and are
        # excised from the neighbour graph for all future sweeps.
        # ONE select pass: keep `new` exactly where the lane is
        # neither frozen (s.bad) nor newly bad — identical selection
        # to the two-step frozen-then-revert merge (a frozen lane is
        # never newly bad), at half the plane traffic.
        finite = (jnp.all(jnp.isfinite(means), axis=0)
                  & jnp.all(jnp.isfinite(cov), axis=(0, 1)))
        bad = s.bad | ~finite

        new = SpatialState(post=new_post, centre=means, f=f, ak=ak, bad=bad)
        merged = _lane_where(~bad, new._replace(ak=(), bad=()),
                             s._replace(ak=(), bad=()))
        return merged._replace(ak=ak, bad=bad)

    # -- capacity / blocked streaming (beyond-HBM escape) ------------------
    def _device_mem_budget(self):
        """Device memory budget in bytes for the capacity pre-check:
        --spatial-mem-gb, else the device's memory limit
        (devices.device_memory_limit, which honours FABBER_TPU_MEM_GB);
        None (unchecked) on hosts without a hard device limit."""
        if self.mem_gb > 0:
            return self.mem_gb * 1e9
        return device_memory_limit()

    def _estimate_device_bytes(self):
        """Rough (within ~2x) peak device bytes of the unblocked
        spatial program: the [T,V] data plane, the double-buffered
        sweep state, the route's loop temporaries, and the dense
        stencil grids."""
        item_s = jnp.dtype(self.store_dtype).itemsize
        item = jnp.dtype(self.dtype).itemsize
        p, t, v = self.nparams, self.nt, self.nvoxels
        state_planes = 3 * p * p + 6 * p + 8
        per_vox = t * item_s + 2 * state_planes * item
        if self.use_stats:
            per_vox += 3 * t * item   # one-time stats reduction
        else:
            per_vox += t * (6 if self.design is not None
                            else 8 * (p + 1)) * item
        total = per_vox * v
        if self._dense is not None:
            xs, ys, zs = self._dense[0], self._dense[1], self._dense[2]
            total += ((2 + 2 * len(self.spatial_params))
                      * xs * ys * zs * item)
        return total

    def _capacity_check(self):
        budget = self._device_mem_budget()
        if budget is None:
            return
        est = self._estimate_device_bytes()
        if est > budget:
            raise FabberError(
                f"Spatial VB needs ~{est / 1e9:.2f} GB of device memory "
                f"for {self.nvoxels} voxels x {self.nt} timepoints but "
                f"the budget is {budget / 1e9:.2f} GB (spatial VB holds "
                "the whole MRF graph on device). Escapes: "
                "--spatial-block-voxels=N streams the volume through "
                "the device in N-voxel blocks on a single chip (exact "
                "same Jacobi results); --distributed shards voxels "
                "over multiple chips; --dtype=bf16 halves the data "
                "plane. If the budget is wrong, set --spatial-mem-gb "
                "or FABBER_TPU_MEM_GB.")

    # host twins of the cross-voxel reductions (numpy, between sweeps)
    def _np_gather_sum(self, values, idx, active):
        valid = idx >= 0
        safe = np.maximum(idx, 0)
        w = (valid & active[safe]).astype(values.dtype)
        return (values[safe] * w).sum(1), w.sum(1)

    def _np_neighbour_sums(self, means, active):
        """Host twin of _neighbour_sums (gather formulation):
        means [P,V] numpy, active [V] bool."""
        out = []
        for slot, (k, tcode) in enumerate(self.spatial_params):
            nsum, nn = self._np_gather_sum(means[k], self._neigh_np,
                                           active)
            if tcode in (PRIOR_SPATIAL_P, PRIOR_SPATIAL_p):
                nsum2, nn2 = self._np_gather_sum(
                    means[k], self._neigh2_np, active)
                out.append((nsum, nn, nsum2, nn2))
            else:
                out.append((nsum, nn, (), ()))
        return out

    def _np_calculate_ak(self, post_h, active, nsums):
        """Host twin of _calculate_ak (f64 accumulation)."""
        sd = self.spatial_dims
        actf = active.astype(np.float64)
        nv = active.shape[0]
        aks = []
        for slot, (k, tcode) in enumerate(self.spatial_params):
            sigma_k = np.asarray(post_h.cov[k, k, :nv], np.float64)
            w_k = np.asarray(post_h.means[k, :nv], np.float64)
            nsum = np.asarray(nsums[slot][0], np.float64)
            nn = np.asarray(nsums[slot][1], np.float64)
            if tcode == PRIOR_SPATIAL_m:
                trace_w = np.full_like(sigma_k, sd * 2)
            elif tcode == PRIOR_SPATIAL_M:
                trace_w = nn + MRF_JITTER
            elif tcode == PRIOR_SPATIAL_p:
                trace_w = np.full_like(sigma_k, 4 * sd * sd + 2 * sd)
            else:  # P
                trace_w = nn * nn + nn
            trace_term = float(np.sum(sigma_k * trace_w * actf))
            swk = nn * w_k - nsum
            if tcode in (PRIOR_SPATIAL_p, PRIOR_SPATIAL_m):
                swk = swk + w_k * (sd * 2 - nn)
            if tcode in (PRIOR_SPATIAL_m, PRIOR_SPATIAL_M):
                term2 = float(np.sum(swk * w_k * actf))
            else:
                term2 = float(np.sum(swk * swk * actf))
            gk = 1.0 / (0.5 * trace_term + 0.5 * term2 + 1.0 / self.q1)
            hk = self.ak_nvoxels * 0.5 + self.q2
            ak = max(gk * hk, AK_FLOOR)
            if self.spatial_speed > 0:
                ak = min(ak, max(ak * self.spatial_speed, 0.5))
            aks.append(ak)
        return np.asarray(aks, np.float64)

    def _compiled_block_step(self):
        """Jitted voxel-local part of one sweep for ONE voxel block
        (nsums/ak computed on the host between sweeps)."""
        use_stats = self.use_stats

        @jax.jit
        def step(it, s, bind, nsums, stats):
            active = ~s.bad
            return self._sweep_core(it, s, bind,
                                    stats if use_stats else None,
                                    nsums, s.ak, active)
        return step

    def _run_blocked(self, continue_means=None, continue_cov=None,
                     continue_noise=None):
        """Beyond-HBM streaming run: the volume lives on the HOST; each
        sweep ships voxel blocks through the device one dispatch at a
        time. Because the Jacobi sweep reads only the PREVIOUS sweep's
        posterior means across voxels (through nsums, computed on the
        host between sweeps), block-sequential execution IS the Jacobi
        sweep — results match the unblocked run to roundoff.

        Reference semantics preserved: priors.cc:346-488 (spatial
        priors), inference_vb.cc:578-767 (sweep structure)."""
        from .vb import RunBindings

        vbk = self.block_voxels
        nv = self.nvoxels
        nblocks = -(-nv // vbk)
        blocks = [(b * vbk, min((b + 1) * vbk, nv))
                  for b in range(nblocks)]
        tree_map = jax.tree_util.tree_map

        def pad_b(x, width):
            x = np.asarray(x)
            if width == 0:
                return x
            return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, width)],
                          mode="edge")

        # initial state, built per block, assembled on the host
        self._ensure_noise_prior()
        post_bs, centre_bs, f_bs = [], [], []
        for lo, hi in blocks:
            st = self.initial_state(continue_means, continue_cov,
                                    continue_noise, lo=lo, hi=hi)
            post_bs.append(tree_map(np.asarray, st.post))
            centre_bs.append(np.asarray(st.centre))
            f_bs.append(np.asarray(st.f))
        vpad = nblocks * vbk
        post_h = tree_map(
            lambda *xs: pad_b(np.concatenate(xs, -1), vpad - nv),
            *post_bs)
        centre_h = pad_b(np.concatenate(centre_bs, -1), vpad - nv)
        f_h = pad_b(np.concatenate(f_bs, -1), vpad - nv)
        bad_h = np.zeros(vpad, bool)
        bad_h[nv:] = True  # padding lanes are frozen from the start
        if self._pre_excised is not None:
            bad_h[:nv] |= np.asarray(self._pre_excised)
        ak_h = np.full(len(self.spatial_params), AK_INIT, np.float64)

        # per-block bindings (host numpy; shipped per dispatch). On the
        # stats route the [T,Vb] data block is reduced ONCE here and
        # never shipped again.
        design = self.design if self.design is not None else ()
        base = np.asarray(self.prior_setup.base_means)
        stats_bs = []
        binds = []
        if self.use_stats:
            mkstats = jax.jit(
                lambda d: self.noise.make_design_stats(self.design, d))
        for lo, hi in blocks:
            bpad = vbk - (hi - lo)

            def pb(x):
                return pad_b(np.asarray(x)[..., lo:hi], bpad)

            data_b = pb(self.data)
            if self.use_stats:
                stats_bs.append(tree_map(np.asarray, mkstats(data_b)))
                data_b = np.zeros((0, vbk), np.float32)
            binds.append(RunBindings(
                data=data_b, coords=pb(self.coords),
                supp=pb(self.suppdata) if self.suppdata is not None
                else np.zeros((0, vbk), np.float32),
                prior_base_means=pb(base) if base.shape[-1] == nv
                else base,
                design=design,
                locked_centres=pb(self._locked_centres)
                if self._locked_centres is not None else ()))

        step = self._compiled_block_step()
        report = getattr(self, "progress_cb", None)
        fg_prev = None
        nswept = self.max_its
        for it in range(self.max_its):
            active = ~bad_h[:nv]
            if self.spatial_params:
                nsums = self._np_neighbour_sums(post_h.means[:, :nv],
                                                active)
                if it > 0 or self.update_first_iter:
                    ak_h = self._np_calculate_ak(post_h, active, nsums)
                nsums_pad = [
                    tuple(pad_b(x, vpad - nv)
                          if isinstance(x, np.ndarray) else ()
                          for x in tup) for tup in nsums]
            else:
                nsums_pad = []
            ak_dev = np.asarray(ak_h, jnp.dtype(self.dtype))

            for bi, (lo, hi) in enumerate(blocks):
                sl = slice(bi * vbk, (bi + 1) * vbk)
                s_b = SpatialState(
                    post=tree_map(lambda x: x[..., sl], post_h),
                    centre=centre_h[:, sl], f=f_h[sl], ak=ak_dev,
                    bad=bad_h[sl])
                nsums_b = [tuple(x[sl] if isinstance(x, np.ndarray)
                                 else () for x in tup)
                           for tup in nsums_pad]
                out = step(jnp.int32(it), s_b, binds[bi], nsums_b,
                           stats_bs[bi] if self.use_stats else ())
                out = tree_map(np.asarray, out)
                tree_map(lambda dst, src: dst.__setitem__(
                    (Ellipsis, sl), src), post_h, out.post)
                centre_h[:, sl] = out.centre
                f_h[sl] = out.f
                bad_h[sl] = out.bad
            if report is not None:
                report((it + 1) * nv // self.max_its, nv)
            if self.f_stop_tol > 0:
                fm = np.where(bad_h[:nv] | ~np.isfinite(f_h[:nv]),
                              0.0, f_h[:nv])
                fg = float(np.sum(fm, dtype=np.float32))
                if fg_prev is not None \
                        and abs(fg - fg_prev) <= self.f_stop_tol:
                    nswept = it + 1
                    break
                fg_prev = fg

        self.final_ak = np.asarray(ak_h, jnp.dtype(self.dtype))
        p = self.nparams
        diag = post_h.cov[np.arange(p), np.arange(p)][:, :nv]
        gamma = 1.0 - diag * post_h.prior_prec[:, :nv]
        gamma = np.where(bad_h[None, :nv] | ~np.isfinite(gamma),
                         0.0, gamma)
        self.coefficient_resels = gamma.sum(1) / self.ak_nvoxels

        conv = self.detector.init_state(nv, self.dtype)
        trimmed = tree_map(lambda x: x[..., :nv], post_h)
        final = VBLoopState(
            it=np.int32(nswept), post=trimmed,
            centre=centre_h[:, :nv], f=f_h[:nv],
            fprior=np.zeros(nv, jnp.dtype(self.dtype)),
            conv=conv._replace(its=np.full(nv, nswept, np.int32)),
            best=trimmed, fhist=())
        result = self._to_result(final, None)
        result = result._replace(
            bad_voxels=result.bad_voxels | bad_h[:nv])
        if self.options.get_bool("spatial-prior-output-correction"):
            result = self.compute_noprior(result)
        return result

    # -- driver -----------------------------------------------------------
    def _dense_p1_eligible(self):
        """Gate for the grid-carried P=1 fast sweep (below)."""
        return (self.sweep_mode == "jacobi"
                and getattr(self, "mesh", None) is None
                and float(self.f_stop_tol) <= 0
                and self.use_stats
                and getattr(self.noise, "name", "") == "white"
                and self.noise.nphis == 1
                and self.noise.locked_noise_stdev <= 0
                and self.nparams == 1
                and len(self.spatial_params) == 1
                and self.spatial_params[0][1] == PRIOR_SPATIAL_M
                and self._dense is not None
                and self._dense[4] is None  # contiguous full grid
                and not self.prior_setup.has_ard
                and jnp.dtype(self.dtype) == jnp.dtype(jnp.float32))

    def _compiled_sweeps_dense_p1(self):
        """P=1 / single-M-prior / contiguous-grid fast sweep: every
        state plane is carried GRID-shaped [Z,Y,X] instead of [1,V].

        Why: the MRF stencil becomes plain shifted adds on the grid
        layout, and [1,V] planes can get a one-row tile layout that
        leaves most of each vector register idle. The arithmetic is the general sweep's
        P=1/M specialization, phase for phase (aK update ->
        spatial prior -> theta stats -> noise stats -> excision
        merge); F is assembled once at the final state (identical
        inputs to the general path's deferred last-sweep F). Pinned
        against the general sweep by tests/test_spatial_fast.py."""
        from ..noise.white import WhiteNoiseState
        report = getattr(self, "progress_cb", None)
        nvox, max_its = self.nvoxels, self.max_its
        xs, ys, zs, off, inv = self._dense
        G = (zs, ys, xs)
        self._ensure_noise_prior()
        b0 = float(np.asarray(self.noise_prior.b).reshape(-1)[0])
        c0 = float(np.asarray(self.noise_prior.c).reshape(-1)[0])
        ntg = float(np.asarray(self.noise.ntimes_per_group).reshape(-1)[0])
        cpost = (ntg - 1.0) * 0.5 + c0
        q1, q2 = float(self.q1), float(self.q2)
        base_prec = float(self.params[0].prior.prec)
        upd_first = bool(self.update_first_iter)
        speed = float(self.spatial_speed)
        dt = self.dtype

        def report_sweep(i):
            report(int(i) * nvox // max_its, nvox)

        @jax.jit
        def loop(s, bind):
            stats = self.noise.make_design_stats(bind.design, bind.data)
            dtqd = stats.dtqd[0, 0, 0].astype(dt)

            def g(x):
                return x.reshape(G).astype(dt)

            m0 = g(stats.m0[0])
            rtqr = g(stats.rtqr[0])
            dtqr = g(stats.dtqr[0, 0])
            dtqy = dtqr + dtqd * m0
            inv_b0 = np.float32(1.0 / b0)
            hk = np.float32(self.ak_nvoxels * 0.5 + q2)

            init = (g(s.post.means[0]), g(s.post.prec[0, 0]),
                    g(s.post.cov[0, 0]), g(s.post.prior_means[0]),
                    g(s.post.prior_prec[0]), g(s.post.noise.b[0]),
                    g(s.post.noise.c[0]), s.bad.reshape(G),
                    s.ak[0].astype(dt))

            def sweep(i, carry):
                m, prec, cov, pmn, ppr, b, c, bad, ak = carry
                act = (~bad).astype(dt)
                # cross-voxel phase: stencil sums + the aK reduction
                # (_neighbour_sums / _calculate_ak, M branch)
                nn = self._stencil_sum(act)
                nsum = self._stencil_sum(m * act)
                tr_term = jnp.sum(cov * (nn + MRF_JITTER) * act)
                swk = nn * m - nsum
                term2 = jnp.sum(swk * m * act)
                gk = 1.0 / (0.5 * tr_term + 0.5 * term2 + 1.0 / q1)
                ak_new = jnp.maximum(gk * hk, AK_FLOOR)
                if speed > 0:
                    ak_new = jnp.minimum(
                        ak_new, jnp.maximum(ak_new * speed, 0.5))
                ak2 = jnp.where((i > 0) | upd_first, ak_new, ak)
                # spatial prior, M type (_apply_spatial_priors)
                sp_prec = ak2 * (nn + MRF_JITTER)
                new_pp = base_prec + sp_prec
                sp_mean = nsum * (1.0 / jnp.maximum(nn, 1e-30))
                new_pm = (1.0 / new_pp) * sp_prec * sp_mean
                # theta update, P=1 stats (white.py update_theta_stats)
                phi = b * c
                prec2 = phi * dtqd + new_pp
                cov2 = 1.0 / prec2
                m2 = cov2 * (phi * dtqy + new_pp * new_pm)
                # noise update (white.py update_noise_stats)
                delta = m2 - m0
                kqk = jnp.maximum(
                    rtqr - 2.0 * delta * dtqr + dtqd * delta * delta,
                    0.0)
                tr = dtqd * cov2
                b2 = 1.0 / ((kqk + tr) * 0.5 + inv_b0)
                c2 = jnp.full_like(b2, cpost)
                # excision merge (one select; newly-bad lanes revert)
                finite = jnp.isfinite(m2) & jnp.isfinite(cov2)
                bad2 = bad | ~finite
                keep = ~bad2

                def sel(n, o):
                    return jnp.where(keep, n, o)

                if report is not None:
                    jax.debug.callback(report_sweep, i + 1)
                return (sel(m2, m), sel(prec2, prec), sel(cov2, cov),
                        sel(new_pm, pmn), sel(new_pp, ppr),
                        sel(b2, b), sel(c2, c), bad2, ak2)

            (m, prec, cov, pmn, ppr, b, c, bad, ak) = jax.lax.fori_loop(
                0, max_its, sweep, init)

            # back to SoA planes; F assembled once at the final state
            # (identical inputs to the general path's last-sweep F)
            def u(x):
                return x.reshape(1, -1)

            means_p = u(m)
            prec_p = u(prec)[None]
            cov_p = u(cov)[None]
            pm_p = u(pmn)
            pp_p = u(ppr)
            noise_post = WhiteNoiseState(u(b), u(c))
            post = PosteriorState(means_p, prec_p, cov_p, pm_p, pp_p,
                                  noise_post)
            if self.need_f:
                f = self.noise.free_energy_stats(
                    noise_post, self.noise_prior, means_p, prec_p,
                    cov_p, pm_p, pp_p, stats)
            else:
                f = s.f
            return SpatialState(
                post=post, centre=means_p, f=f,
                ak=ak[None].astype(self.dtype), bad=bad.reshape(-1),
                its=jnp.array(max_its, jnp.int32))

        return loop

    def compiled_sweeps(self):
        """The full jitted spatial computation: state -> final state."""
        if self._dense_p1_eligible():
            return self._compiled_sweeps_dense_p1()
        report = getattr(self, "progress_cb", None)
        nvox, max_its = self.nvoxels, self.max_its

        def report_sweep(i):
            # per-sweep progress in completed-voxel units (ProgressCheck
            # parity, rundata.h:102-169); only traced in when a callback
            # is registered, so the bench path pays nothing
            report(int(i) * nvox // max_its, nvox)

        fstop = float(self.f_stop_tol)

        @jax.jit
        def loop(s, bind):
            stats = self.noise.make_design_stats(bind.design, bind.data) \
                if self.use_stats else None

            def body(i, st):
                st = self._sweep(i, st, bind, stats)
                if report is not None:
                    jax.debug.callback(report_sweep, i + 1)
                return st

            if fstop <= 0:
                # fixed sweep count: only the LAST sweep's F is ever
                # observed, so the first max_its-1 sweeps skip the
                # whole-volume ELBO assembly (~1/3 of a sweep's plane
                # traffic at P=1). lax.cond keeps the skipped branch
                # unexecuted at runtime; the final F is computed by the
                # identical in-sweep path, so results are bitwise
                # unchanged.
                def body_defer(i, st):
                    st = jax.lax.cond(
                        i == max_its - 1,
                        lambda s_: self._sweep(i, s_, bind, stats),
                        lambda s_: self._sweep(i, s_, bind, stats,
                                               skip_f=True),
                        st)
                    if report is not None:
                        jax.debug.callback(report_sweep, i + 1)
                    return st

                out = jax.lax.fori_loop(
                    0, max_its, body_defer if self.need_f else body, s)
                return out._replace(
                    its=jnp.array(max_its, jnp.int32))

            # optional Fglobal early stop (--spatial-fchange): stop
            # when |sum_v F| changes less than the tolerance between
            # sweeps. Beyond the reference, whose counting detector
            # ignores Fglobal (convergence.cc).
            def fglobal(st):
                f = jnp.where(st.bad | ~jnp.isfinite(st.f), 0.0, st.f)
                return jnp.sum(f)

            def cond(c):
                i, df, _, _ = c
                return (i < max_its) & (df > fstop)

            def wbody(c):
                i, _, fg, st = c
                st2 = body(i, st)
                fg2 = fglobal(st2)
                return (i + 1, jnp.abs(fg2 - fg), fg2, st2)

            carry0 = (jnp.int32(0), jnp.array(jnp.inf, self.dtype),
                      fglobal(s), s)
            i, _, _, out = jax.lax.while_loop(cond, wbody, carry0)
            return out._replace(its=i)
        return loop

    def run(self, continue_means=None, continue_cov=None, continue_noise=None):
        if self.block_voxels > 0:
            return self._run_blocked(continue_means, continue_cov,
                                     continue_noise)
        self._capacity_check()
        base = self.initial_state(continue_means, continue_cov,
                                  continue_noise)
        bad0 = jnp.zeros(self.nvoxels, bool) if self._pre_excised is None \
            else jnp.asarray(self._pre_excised)
        s0 = SpatialState(
            post=base.post, centre=base.centre, f=base.f,
            ak=jnp.full(len(self.spatial_params), AK_INIT, self.dtype),
            bad=bad0)

        s = self.compiled_sweeps()(s0, self._bind())
        self.final_ak = np.asarray(s.ak)
        nswept = int(np.asarray(s.its))

        # "Coefficient resels" diagnostic, Penny 2005
        # (inference_vb.cc:727-756): per parameter the mean over voxels
        # of 1 - sigma_post/sigma_prior; excised voxels contribute 0
        gamma = 1.0 - sm.diag_of(s.post.cov) * s.post.prior_prec
        gamma = jnp.where(s.bad[None] | ~jnp.isfinite(gamma), 0.0, gamma)
        self.coefficient_resels = (
            self._fetch(jnp.sum(gamma, axis=1)) / self.ak_nvoxels)

        # wrap into the VBLoopState shape expected by _to_result
        conv = self.detector.init_state(self.nvoxels, self.dtype)
        final = VBLoopState(
            it=jnp.array(nswept, jnp.int32), post=s.post,
            centre=s.centre, f=s.f,
            fprior=jnp.zeros(self.nvoxels, self.dtype),
            conv=conv._replace(its=jnp.full(self.nvoxels, nswept,
                                            jnp.int32)),
            best=s.post, fhist=())
        result = self._to_result(final, None)
        # mark excised voxels bad in the result
        result = result._replace(
            bad_voxels=result.bad_voxels | self._fetch(s.bad))
        if self.options.get_bool("spatial-prior-output-correction"):
            result = self.compute_noprior(result)
        return result
