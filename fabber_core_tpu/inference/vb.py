"""Batched Variational Bayes engine (voxelwise mode), SoA layout.

The reference's hot loop (inference_vb.cc:415-576) iterates voxels
serially, each with its own convergence detector and save/revert
bookkeeping. Here one jitted fixed-point iteration advances *all*
voxels at once:

    state: pytree of [..., V] planes — voxels live on the fastest
           (vectorized) axis: posterior means [P,V], precision/
           covariance [P,P,V], diagonal prior [P,V], Gamma noise [Q,V],
           detector lanes [V], best-so-far copies.
    step:  priors -> UpdateTheta -> UpdateNoise -> ReCentre -> F ->
           detector test; converged lanes are frozen with jnp.where.

This reproduces the serial semantics exactly (each lane sees the same
sequence of updates it would have seen in the C++ loop) while mapping
the arithmetic onto full-width vector planes: with P ~ 2-20 parameters the
per-voxel P x P algebra is unrolled elementwise (ops/smallmat.py), so
nothing is wasted padding tiny matrices into vector tiles. A deliberate
deviation: the reference computes the free energy four times per
iteration (inference_vb.cc:468-495) but only the post-ReCentre value
feeds the convergence test or outputs, so we compute it once.
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import resolve_parameters, PRIOR_IMAGE
from ..noise import get_noise_class
from ..ops import smallmat as sm
from ..options import OptionSpec, OPT_STR, OPT_INT, OPT_BOOL, OPT_MVN
from ..devices import planning_budget, spectral_by_default
from .convergence import ConvState, get_detector_class
from .linearize import Linearizer
from .priors import PriorSetup

# engine-kernel option values (VBInference.__init__ route selection)
ENGINE_KERNELS = ("auto", "spectral", "xla")

class RunBindings(NamedTuple):
    """Per-run device arrays threaded through every jitted function as
    arguments (never closure-captured: captures are baked into the HLO
    as constants, which breaks at volume scale)."""
    data: Any        # [T,V]
    coords: Any      # [3,V]
    supp: Any        # [S,V] (S may be 0)
    prior_base_means: Any  # [P,V] or [P,1]
    design: Any = ()  # [T,P] fixed design matrix, when the fast path is on
    locked_centres: Any = ()  # [P,V] fixed linearization centres
    neigh: Any = ()   # spatial mode: [V,6]
    neigh2: Any = ()  # spatial mode: [V,30]


class PosteriorState(NamedTuple):
    means: Any       # [P,V] latent
    prec: Any        # [P,P,V]
    cov: Any         # [P,P,V]
    prior_means: Any  # [P,V]
    prior_prec: Any  # [P,V] diagonal prior precision
    noise: Any       # noise-model state pytree (e.g. WhiteNoiseState)


class VBLoopState(NamedTuple):
    it: Any          # scalar int32
    post: PosteriorState
    centre: Any      # [P,V] linearization centre
    f: Any           # [V]
    fprior: Any      # [V]
    conv: ConvState
    best: PosteriorState
    fhist: Any       # [cap,V] or () if history disabled
    # NB the linearization (offset [T,V], jacobian [P,T,V]) is NOT
    # carried: it is recomputed from `centre` at the top of each
    # iteration, keeping the large planes out of the loop state (and
    # its double buffering)


class VBResult(NamedTuple):
    means: np.ndarray        # [V,P] latent posterior means
    cov: np.ndarray          # [V,P,P]
    noise_means: np.ndarray  # [V,Q]
    noise_cov: np.ndarray    # [V,Q,Q]
    free_energy: np.ndarray  # [V] or None
    fhistory: np.ndarray     # [iters,V] or None
    iterations: np.ndarray   # [V]
    bad_voxels: np.ndarray   # [V] bool
    # likelihood-only posterior (thetaWithoutPrior, set only under
    # --spatial-prior-output-correction; noisemodel.h:132)
    noprior_means: np.ndarray = None  # [V,P] or None
    noprior_cov: np.ndarray = None    # [V,P,P] or None


def _concat_results(results):
    """Concatenate per-chunk VBResults along the voxel axis."""
    def cat(field):
        vals = [getattr(r, field) for r in results]
        if vals[0] is None:
            return None
        if field == "fhistory":
            # chunks may have converged in different iteration counts;
            # pad shorter histories by repeating their final row
            rows = max(v.shape[0] for v in vals)
            vals = [np.concatenate([v] + [v[-1:]] * (rows - v.shape[0]))
                    if v.shape[0] < rows else v for v in vals]
            return np.concatenate(vals, axis=1)
        return np.concatenate(vals, axis=0)
    return VBResult(**{f: cat(f) for f in VBResult._fields})


def _shard_kernel(mesh, fn, in_vox_dims, out_vox_dims):
    """Per-shard dispatch of a lane-local route over a 1-D voxel mesh:
    under shard_map each device runs `fn` on its local voxel planes, so
    the spectral routes' eigenbasis loops run without cross-device
    traffic. dims entries are the rank of each [..., V] plane (voxels
    last), or None for a replicated argument. No mesh -> fn runs
    as-is."""
    if mesh is None:
        return fn
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def vox(nd):
        return P(*([None] * (nd - 1) + ["vox"]))

    def spec(nd):
        return P() if nd is None else vox(nd)

    # replication checking is off: the eigenbasis loops start their
    # carries from replicated constants, which the checker would have
    # cast to per-shard values by hand
    return shard_map(
        fn, mesh=mesh,
        in_specs=tuple(spec(nd) for nd in in_vox_dims),
        out_specs=tuple(vox(nd) for nd in out_vox_dims),
        check_vma=False)


def _lane_where(mask, new, old):
    """Per-lane select over a pytree of [..., V] planes."""
    def sel(n, o):
        m = mask.reshape((1,) * (n.ndim - 1) + mask.shape)
        return jnp.where(m, n, o)
    return jax.tree_util.tree_map(sel, new, old)


class VBInference:
    """Voxelwise VB (method=vb). Spatial VB subclasses/wraps this."""

    @classmethod
    def get_options(cls):
        return [
            OptionSpec("noise", OPT_STR, "Noise model to use (white or ar1)", True),
            OptionSpec("convergence", OPT_STR,
                       "Name of method for detecting convergence", default="maxits"),
            OptionSpec("max-iterations", OPT_INT,
                       "Iterations for the maxits convergence detector", default="10"),
            OptionSpec("min-fchange", OPT_STR,
                       "Change in F to stop at (fchange detector)", default="0.01"),
            OptionSpec("max-trials", OPT_STR,
                       "Max trials after F reduction (trialmode)", default="10"),
            OptionSpec("print-free-energy", OPT_BOOL, "Output the free energy"),
            OptionSpec("continue-from-mvn", OPT_MVN,
                       "Continue previous run from output MVN files"),
            OptionSpec("output-only", OPT_BOOL,
                       "Skip model fitting, just output requested data from supplied MVN"),
            OptionSpec("noise-pattern", OPT_STR,
                       "Repeating noise-variance pattern", default="1"),
            OptionSpec("allow-bad-voxels", OPT_BOOL,
                       "Continue if numerical error found in a voxel"),
            OptionSpec("linearization", OPT_STR,
                       "Jacobian source: auto (jax autodiff) or fd "
                       "(reference-parity finite differences)", default="auto"),
            OptionSpec("save-free-energy-history", OPT_BOOL,
                       "Record free energy at every iteration"),
            OptionSpec("noise-initial-prior", OPT_STR,
                       "MVN matrix file for the initial noise prior"),
            OptionSpec("noise-initial-posterior", OPT_STR,
                       "MVN matrix file for the initial noise posterior"),
            OptionSpec("locked-linear-from-mvn", OPT_MVN,
                       "MVN data containing fixed centres for linearization"),
            OptionSpec("spatial-prior-output-correction", OPT_BOOL,
                       "Also output the likelihood-only posterior "
                       "(thetaWithoutPrior): parameter maps with NO "
                       "prior term — under spatial priors, the "
                       "unshrunk per-voxel estimates (mean_noprior_*/"
                       "std_noprior_* images)"),
            OptionSpec("mcsteps", OPT_INT,
                       "Number of motion correction steps", default="0"),
            OptionSpec("mc-dof", OPT_INT,
                       "Motion correction degrees of freedom: 6 (rigid) "
                       "or 12 (affine)", default="6"),
            OptionSpec("voxel-chunk-size", OPT_INT,
                       "Voxels per device pass (0 = auto from memory "
                       "budget; bounds device memory at any volume size)",
                       default="0"),
            OptionSpec("chunk-streaming", OPT_STR,
                       "Chunked-volume execution: auto (stream the "
                       "window loop inside ONE compiled dispatch when "
                       "the data plane fits on device) or off "
                       "(host-side dispatch per window)", default="auto"),
            OptionSpec("engine-kernel", OPT_STR,
                       "Iteration backend: auto (the fastest route the "
                       "configuration and device allow), spectral "
                       "(eigenbasis scalar fixed point) or xla",
                       default="auto"),
            OptionSpec("fixed-design-route", OPT_STR,
                       "Fixed-design update arithmetic: stats (sufficient "
                       "statistics; the iteration loop never touches "
                       "[T,V] data) or direct", default="stats"),
        ]

    def __init__(self, model, options, data, coords, suppdata=None,
                 voxel_data_getter=None, dtype=None, data_plane=None,
                 supp_plane=None):
        """data [V,T] float, coords [V,3], suppdata [V,S] or None
        (voxel-major at the API boundary; transposed to SoA here).

        data_plane/supp_plane: pre-built [T,V]/[S,V] device planes
        (possibly sharded over a multi-host mesh) used verbatim instead
        of converting `data`/`suppdata` — the multi-host path feeds
        each process's voxel range locally (parallel/distributed.py),
        so the full array never lands on one device."""
        self.model = model
        self.options = options
        dstr = options.get_string("dtype", "double")
        if dstr not in ("double", "single", "bf16"):
            from ..exceptions import InvalidOptionValue
            raise InvalidOptionValue("dtype", dstr,
                                     "Must be double, single or bf16")
        self.dtype = dtype or (jnp.float64 if dstr == "double"
                               else jnp.float32)
        # bf16 tier: bfloat16 DATA STORAGE, float32 compute/accumulation
        # — the [T,V] plane is the memory-bandwidth term of every route, so
        # halving its bytes pays where the one-time stats pass (or the
        # per-iteration residual read) dominates. All state stays f32;
        # mixed ops promote to f32 (tests/test_bf16.py pins tolerance).
        self.store_dtype = jnp.bfloat16 if dstr == "bf16" and dtype is None \
            else self.dtype

        self.data = data_plane if data_plane is not None \
            else jnp.asarray(data, self.store_dtype).T    # [T,V]
        self.coords = jnp.asarray(coords, self.dtype).T   # [3,V]
        if supp_plane is not None:
            self.suppdata = supp_plane
        else:
            self.suppdata = None if suppdata is None \
                or suppdata.shape[1] == 0 \
                else jnp.asarray(suppdata, self.dtype).T  # [S,V]
        self.nt, self.nvoxels = self.data.shape
        # device->host conversion hook for results; multi-host runs
        # replace it with a process allgather (parallel/distributed.py)
        self._fetch = np.asarray
        # voxel lanes excised before the run starts (padding voxels in
        # a sharded run); spatial mode removes them from the MRF graph
        self._pre_excised = None

        self.masked_tpoints = options.get_int_list("mt", 1)
        self.params = resolve_parameters(model, options)
        self.nparams = len(self.params)

        noise_cls = get_noise_class(options.get_string("noise"))
        self.noise = noise_cls(options, self.nt, self.masked_tpoints)

        conv_name = options.get_string("convergence", "maxits")
        self.detector = get_detector_class(conv_name)(options)
        self.is_lm = conv_name == "lm"

        self.need_f = (self.detector.uses_f
                       or options.get_bool("print-free-energy")
                       or options.get_bool("save-free-energy")
                       or options.get_bool("save-free-energy-history"))
        self.save_fhist = options.get_bool("save-free-energy-history")
        self.allow_bad_voxels = options.get_bool("allow-bad-voxels")

        self._voxel_data = voxel_data_getter or (lambda key: (_ for _ in ()).throw(
            KeyError(key)))
        self.prior_setup = PriorSetup(self.params, self._voxel_data,
                                      self.nvoxels, self.dtype)

        lin_mode = options.get_string("linearization", "auto")
        self.linearizer = Linearizer(model, self.params, self.nt,
                                     mode=lin_mode)

        # Constant-Jacobian fast path: for models that are linear in
        # their (untransformed) parameters the [P,T,V] Jacobian is never
        # materialized; the T-contractions become large matmuls.
        self.design = None
        if (getattr(self.noise, "supports_fixed_design", False)
                and lin_mode == "auto"
                and all(pm.transform.is_identity for pm in self.params)):
            d = model.fixed_design(self.nt)
            if d is not None:
                self.design = jnp.asarray(d, self.dtype)
        # Fixed linearization centres (inference_vb.cc:169-179,227-236)
        self.locked_linear = options.get_string("locked-linear-from-mvn",
                                                "") != ""
        self._locked_centres = None
        if self.locked_linear:
            from ..io import mvn as mvn_io
            lmeans, _ = mvn_io.unpack(np.asarray(
                self._voxel_data("locked-linear-from-mvn")).T)
            self._locked_centres = jnp.asarray(
                lmeans[:, :self.nparams].T, self.dtype)

        # Motion correction (core/motion.py): mcsteps>0 interleaves
        # per-timepoint rigid/affine re-registration of the ORIGINAL
        # data to the current model prediction between VB passes
        # (motioncorr.cc:70-94 semantics; the reference parses mcsteps
        # at inference_vb.cc:116 but its run_mc hook needs FSL mcflirt)
        self.num_mcsteps = options.get_int("mcsteps", 0)
        self.mc_dof = options.get_int("mc-dof", 6)
        if self.mc_dof not in (6, 12):
            from ..exceptions import InvalidOptionValue
            raise InvalidOptionValue(
                "mc-dof", str(self.mc_dof),
                "Motion-correction dof must be 6 (rigid) or 12 (affine)")

        # Route selection; route_description names the outcome. The
        # engine-kernel option narrows it: auto picks from what the
        # configuration and the device allow, spectral asks for the
        # eigenbasis fixed point, xla for the plain routes only.
        kernel_mode = options.get_string("engine-kernel", "auto")
        if kernel_mode not in ENGINE_KERNELS:
            from ..exceptions import InvalidOptionValue
            raise InvalidOptionValue(
                "engine-kernel", kernel_mode,
                "Must be one of " + ", ".join(ENGINE_KERNELS))

        # Sufficient-statistics route: one [T,V] pass at loop entry,
        # then the fixed point runs on [P,V] planes only
        self.use_stats = (
            self.design is not None
            and options.get_string("fixed-design-route", "stats") == "stats"
            and hasattr(self.noise, "make_design_stats"))
        if self.design is not None and not self.use_stats \
                and not getattr(self.noise, "fixed_design_direct", True):
            # stats-only noise model (e.g. AR): there is no direct
            # design route, fall back to the generic Jacobian path
            self.design = None

        noise_name = getattr(self.noise, "name", "")
        det_name = type(self.detector).name
        one_group = (noise_name == "white" and self.noise.nphis == 1)
        # gates shared by the fast routes: default initial dists,
        # iteration-invariant priors, f32, no per-iteration F history
        fast_common = (
            options.get_string("continue-from-mvn", "") == ""
            and not self.save_fhist
            and not self.prior_setup.has_ard
            and not self.prior_setup.spatial_params
            and not self.locked_linear
            and jnp.dtype(self.dtype) == jnp.dtype(jnp.float32)
            and options.get_string("noise-initial-posterior",
                                   "modeldefault") == "modeldefault")

        # Spectral route (ops/spectral.py): with ONE phi group the
        # fixed point collapses to a scalar rational iteration per
        # voxel in the whitened design eigenbasis, pure XLA. The
        # F-based detectors run their lane state machines inside the
        # eigenbasis loop (make_spectral_detector_loop).
        spectral_ok = (fast_common and self.use_stats and one_group
                       and not self.is_lm
                       and self.noise.locked_noise_stdev <= 0)
        want_spectral = kernel_mode == "spectral" or (
            kernel_mode == "auto" and spectral_by_default())
        self.use_spectral = (
            spectral_ok and want_spectral and det_name == "maxits"
            and int(self.detector.max_iterations) >= 1)
        self.use_spectral_fdet = (
            spectral_ok and want_spectral
            and det_name in ("pointzeroone", "freduce", "trialmode"))

        # Iteration cap for the while loop (detector guarantees
        # termination well below this; cap is a safety net)
        self.max_iter_cap = int(self.detector.max_iterations) + 2

    def route_description(self):
        """Human-readable name of the update route this engine selected
        — logged by the runner so a user (especially a plugin author)
        can see whether their configuration landed on a fast route and,
        if not, which option gated it (docs/MIGRATION.md 'Plugin
        models and the fast routes')."""
        if self.use_spectral_fdet:
            return ("spectral eigenbasis fixed point (XLA) "
                    "with in-loop F-based convergence detector")
        if self.use_spectral:
            return "spectral eigenbasis fixed point (XLA)"
        if self.use_stats:
            return "fixed-design sufficient-statistics route (XLA)"
        if self.design is not None:
            return "fixed-design direct route (XLA)"
        return "generic-Jacobian XLA route"

    def _bind(self, lo=0, hi=None):
        """Per-run (optionally per-voxel-chunk) device array bundle."""
        hi = self.nvoxels if hi is None else hi
        if lo == 0 and hi == self.nvoxels:
            # full range: no slicing ops (each eager slice is a dispatch)
            sl = slice(None)
        else:
            sl = slice(lo, hi)
        supp = self.suppdata[:, sl] if self.suppdata is not None \
            else jnp.zeros((0, hi - lo), self.dtype)
        base = self.prior_setup.base_means
        if base.shape[-1] == self.nvoxels:
            base = base[:, sl]
        return RunBindings(
            data=self.data[:, sl], coords=self.coords[:, sl], supp=supp,
            prior_base_means=base,
            design=self.design if self.design is not None else (),
            locked_centres=self._locked_centres[:, sl]
            if self._locked_centres is not None else ())

    def _recentre(self, means, bind):
        if self.locked_linear:
            means = bind.locked_centres
        if self.design is not None:
            return bind.design @ means, ()
        return self.linearizer(means, bind.data, bind.coords, bind.supp)

    def _design_arg(self, bind):
        return bind.design if self.design is not None else None

    def _noise_state_from_file(self, key, default_state, nvox):
        """Replace an initial noise dist from an MVN matrix file
        (inference_vb.cc:132-142). The file holds one MVN applied to
        every voxel."""
        filename = self.options.get_string(key, "modeldefault")
        if filename == "modeldefault":
            return default_state
        from ..io import mvn as mvn_io
        means, cov = mvn_io.load_matrix(filename)
        means_v = np.broadcast_to(means[None, :], (nvox, len(means)))
        cov_v = np.broadcast_to(cov[None, :, :], (nvox,) + cov.shape)
        state = self.noise.state_from_mvn(means_v, cov_v)
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, self.dtype), state)

    def evaluate_model(self, means_planes, key=""):
        """Model prediction [T,V] at latent means [P,V] (for outputs)."""
        v = np.shape(means_planes)[-1]
        if v != self.nvoxels:
            # padded sharded engine called with a sliced (real-voxel)
            # result: pad by edge copy, evaluate, slice back
            means_planes = np.concatenate(
                [np.asarray(means_planes)] +
                [np.asarray(means_planes)[..., -1:]] * (self.nvoxels - v),
                axis=-1)
            out = self.evaluate_model(means_planes, key)
            return self._fetch(out)[..., :v]
        bind = self._bind()
        if key:
            lin = Linearizer(self.model, self.params, self.nt, key=key)
            return lin.evaluate(jnp.asarray(means_planes, self.dtype),
                                bind.data, bind.coords, bind.supp)
        if self.design is not None:
            return self.design @ jnp.asarray(means_planes, self.dtype)
        return self.linearizer.evaluate(
            jnp.asarray(means_planes, self.dtype),
            bind.data, bind.coords, bind.supp)

    # -- initial state ----------------------------------------------------
    def initial_posterior(self, lo=0, hi=None, data=None):
        """Build latent-space initial posterior (fwdmodel.cc:284-313).
        Returns means [P,V], prec [P,P,V], cov [P,P,V].

        Built on device: only per-parameter scalars (and image-prior
        planes, when present) come from the host. Traceable when `data`
        is passed and no image priors are in play (see compiled_full).
        """
        hi = self.nvoxels if hi is None else hi
        v, p = hi - lo, self.nparams
        cols = []
        for spec in self.params:
            if spec.prior_type == PRIOR_IMAGE:
                img = np.asarray(self._voxel_data(spec.options["image"]))
                cols.append(jnp.asarray(
                    img.reshape(self.nvoxels, -1)[lo:hi, 0], self.dtype))
            else:
                cols.append(jnp.full((v,), spec.post.mean, self.dtype))
        means_vox = jnp.stack(cols, axis=1)  # [V,P] model space

        # voxelwise model init hook (model space, voxel-major API)
        if data is None:
            data = self.data[:, lo:hi]
        means_vox = self.model.init_posterior(data.T, means_vox)

        # transform to latent space, building SoA planes
        lmeans, lvars = [], []
        for i, spec in enumerate(self.params):
            var = jnp.full((v,), spec.post.var, self.dtype)
            m, lv = spec.transform.to_latent_moments(means_vox[:, i], var)
            lmeans.append(m.astype(self.dtype))
            lvars.append(lv.astype(self.dtype))
        lmeans = jnp.stack(lmeans)
        lvars = jnp.stack(lvars)
        return lmeans, sm.diag_planes(1.0 / lvars), sm.diag_planes(lvars)

    def _ensure_noise_prior(self):
        if getattr(self, "noise_prior", None) is None:
            prior, _ = self.noise.initial_state(1, self.dtype)
            self.noise_prior = self._noise_state_from_file(
                "noise-initial-prior", prior, 1)

    def initial_state(self, continue_means=None, continue_cov=None,
                      continue_noise=None, lo=0, hi=None, data=None):
        hi = self.nvoxels if hi is None else hi
        v, p = hi - lo, self.nparams
        # the noise prior is voxel-uniform ([.,1] planes, broadcast in
        # the updates) and is built EAGERLY exactly once: initial_state
        # may run under jit (compiled_full), and storing a traced prior
        # on self would leak a tracer out of the trace
        self._ensure_noise_prior()
        _, noise_post = self.noise.initial_state(v, self.dtype)
        noise_post = self._noise_state_from_file(
            "noise-initial-posterior", noise_post, v)

        if continue_means is not None:
            # voxel-major [V,P] / [V,P,P] in, SoA planes internally
            means = jnp.asarray(continue_means[lo:hi], self.dtype).T
            cov = jnp.moveaxis(
                jnp.asarray(continue_cov[lo:hi], self.dtype), 0, -1)
            chol, _ = sm.cholesky_jittered(cov)
            prec = sm.inverse_from_chol(chol)
            if continue_noise is not None:
                noise_post = jax.tree_util.tree_map(
                    lambda x: jnp.asarray(x[..., lo:hi], self.dtype),
                    continue_noise)
        else:
            means, prec, cov = self.initial_posterior(lo, hi, data=data)

        # Initial prior: identity precision, zero mean; real values are
        # written by the prior sweep inside iteration 0.
        prior_means = jnp.zeros((p, v), self.dtype)
        prior_prec = jnp.ones((p, v), self.dtype)

        post = PosteriorState(means, prec, cov, prior_means, prior_prec,
                              noise_post)
        conv = self.detector.init_state(v, self.dtype)
        fhist = jnp.zeros((self.max_iter_cap, v), self.dtype) \
            if self.save_fhist else ()
        # detectors without a save/revert protocol need no best-state
        # copy: dropping it removes ~(P^2+P) planes of loop traffic
        best = post if self.detector.tracks_best else ()
        return VBLoopState(
            it=jnp.array(0, jnp.int32),
            post=post, centre=means,
            f=jnp.full(v, 1234.5678, self.dtype),
            fprior=jnp.zeros(v, self.dtype),
            conv=conv, best=best, fhist=fhist)

    # -- one iteration ----------------------------------------------------
    def _iteration(self, s, bind, stats=None):
        post = s.post
        # linearization at the current centre (recomputed, not carried;
        # the stats route needs no linearization at all)
        if stats is None:
            offset_c, jac_c = self._recentre(s.centre, bind)

        # 1. Save current state as best-so-far where flagged by the
        #    detector (top of the reference do-loop, inference_vb.cc:451)
        best = _lane_where(s.conv.save, post, s.best) \
            if self.detector.tracks_best else ()

        # 2. Apply priors
        prior_means, prior_prec, f_contribs = self.prior_setup.apply(
            post.prior_means, post.prior_prec, post.means,
            sm.diag_of(post.cov), s.it, base_means=bind.prior_base_means)
        # Voxelwise mode quirk: the reference *assigns* (not sums) each
        # prior's F contribution in turn, so only the last parameter's
        # survives (inference_vb.cc:460-463). Mirrored for parity.
        fprior = f_contribs[-1]

        # 3+4. Theta update (Eq 19/20) then noise update (Eq 21/22)
        if stats is not None:
            lm_alpha = s.conv.alpha if self.is_lm else None
            means, prec, cov, _ok = self.noise.update_theta_stats(
                post.noise, prior_means, prior_prec, stats,
                lm_alpha, s.centre)
            noise_post = self.noise.update_noise_stats(
                post.noise, self.noise_prior, means, cov, stats)
        else:
            lm_alpha = s.conv.alpha if self.is_lm else None
            means, prec, cov, _ok = self.noise.update_theta(
                post.noise, post.means, prior_means, prior_prec,
                s.centre, offset_c, jac_c, bind.data, lm_alpha,
                design=self._design_arg(bind))
            noise_post = self.noise.update_noise(
                post.noise, self.noise_prior, means, cov,
                s.centre, offset_c, jac_c, bind.data,
                design=self._design_arg(bind))

        # 5. The next iteration re-linearizes about the new posterior
        #    means (or the fixed centres when locked-linear is in force)
        centre = bind.locked_centres if self.locked_linear else means

        new_post = PosteriorState(means, prec, cov, prior_means, prior_prec,
                                  noise_post)

        # 6. Free energy at the new linearization (only the final
        #    per-iteration value is observable; see module docstring)
        if self.need_f and stats is not None:
            f = self.noise.free_energy_stats(
                noise_post, self.noise_prior, means, prec, cov,
                prior_means, prior_prec, stats)
            f = f + fprior
        elif self.need_f:
            offset, jac = self._recentre(centre, bind)
            f = self.noise.free_energy(
                noise_post, self.noise_prior, means, prec, cov,
                prior_means, prior_prec, centre, offset, jac, bind.data,
                design=self._design_arg(bind))
            f = f + fprior
        else:
            f = s.f

        # 7. Convergence test
        conv = self.detector.test(s.conv, f)

        new = VBLoopState(it=s.it + 1, post=new_post, centre=centre,
                          f=f, fprior=fprior,
                          conv=conv, best=best, fhist=s.fhist)

        # Freeze lanes that were already done before this iteration.
        # fhist is [iter, V]-shaped and handled separately below.
        frozen = s.conv.done
        merged = _lane_where(~frozen, new._replace(fhist=()),
                             s._replace(fhist=()))
        fhist = s.fhist
        if self.save_fhist:
            # Frozen lanes keep writing their last F, reproducing the
            # reference's history padding (inference_vb.cc:1035-1044)
            fhist = fhist.at[s.it].set(merged.f)
        return merged._replace(it=new.it, fhist=fhist)

    # -- driver -----------------------------------------------------------
    def _compiled_loop_spectral(self):
        """Spectral route (ops/spectral.py): scalar rational fixed
        point in the whitened design eigenbasis. Same fixed point as
        the stats route; see the module docstring for the algebra."""
        from ..noise.white import WhiteNoiseState
        from ..ops.spectral import make_spectral_loop

        self._ensure_noise_prior()
        _, post1 = self.noise.initial_state(1, self.dtype)
        init_b = float(post1.b[0, 0])
        init_c = float(post1.c[0, 0])
        b0 = float(np.asarray(self.noise_prior.b).reshape(-1)[0])
        c0 = float(np.asarray(self.noise_prior.c).reshape(-1)[0])
        nt_g = float(np.asarray(self.noise.ntimes_per_group).reshape(-1)[0])
        n_iters = int(self.detector.max_iterations)
        p = self.nparams

        spectral = make_spectral_loop(
            np.asarray(self.design, np.float64),
            np.asarray(self.noise.qmasks, np.float64)[0],
            np.asarray(self.prior_setup.base_precs, np.float64),
            n_iters, init_b, init_c,
            inv_b0=1.0 / b0, c_post=(nt_g - 1.0) * 0.5 + c0,
            dtype=self.dtype)

        dispatch = _shard_kernel(
            getattr(self, "mesh", None), spectral,
            in_vox_dims=(2, 2, 2, 2),
            out_vox_dims=(2, 3, 3, 2, 2))

        @jax.jit
        def loop(s, bind):
            nv = bind.data.shape[1]
            stats = self.noise.make_design_stats(bind.design, bind.data)
            prior_means = jnp.broadcast_to(
                jnp.asarray(bind.prior_base_means, self.dtype), (p, nv))
            prior_prec = jnp.broadcast_to(
                jnp.asarray(self.prior_setup.base_precs, self.dtype),
                (p, nv))
            means, prec, cov, nb, nc = dispatch(
                stats.m0, stats.rtqr[0][None, :].astype(self.dtype),
                stats.dtqr[0].astype(self.dtype), prior_means)

            noise_post = WhiteNoiseState(nb, nc)
            post = PosteriorState(means, prec, cov, prior_means,
                                  prior_prec, noise_post)
            if self.need_f:
                f = self.noise.free_energy_stats(
                    noise_post, self.noise_prior, means, prec, cov,
                    prior_means, prior_prec, stats)
            else:
                f = s.f
            conv = s.conv._replace(
                its=jnp.full(nv, n_iters, jnp.int32),
                done=jnp.ones(nv, bool))
            out = s._replace(it=jnp.array(n_iters, jnp.int32), post=post,
                             centre=means, f=f, conv=conv)
            return out, None

        return loop

    def _compiled_loop_spectral_fdet(self):
        """Spectral route under an F-based detector (pointzeroone /
        freduce / trialmode): the detector state machines run inside
        the eigenbasis loop; per-lane save/revert state is the scalar
        (generating phi, noise b) pair. Lanes whose selected state is
        the engine-initial posterior (freduce reverts, trialmode best
        init) are filled from the initial planes here."""
        from ..noise.white import WhiteNoiseState
        from ..ops.spectral import make_spectral_detector_loop

        self._ensure_noise_prior()
        _, post1 = self.noise.initial_state(1, self.dtype)
        init_b = float(post1.b[0, 0])
        init_c = float(post1.c[0, 0])
        b0 = float(np.asarray(self.noise_prior.b).reshape(-1)[0])
        c0 = float(np.asarray(self.noise_prior.c).reshape(-1)[0])
        nt_g = float(np.asarray(self.noise.ntimes_per_group).reshape(-1)[0])
        p = self.nparams

        spectral = make_spectral_detector_loop(
            np.asarray(self.design, np.float64),
            np.asarray(self.noise.qmasks, np.float64)[0],
            np.asarray(self.prior_setup.base_precs, np.float64),
            self.detector, self.max_iter_cap, init_b, init_c,
            inv_b0=1.0 / b0, c_post=(nt_g - 1.0) * 0.5 + c0,
            b0=b0, c0=c0, dtype=self.dtype)

        dispatch = _shard_kernel(
            getattr(self, "mesh", None), spectral,
            in_vox_dims=(2, 2, 2, 2, 1),
            out_vox_dims=(2, 3, 3, 2, 1, 1))

        @jax.jit
        def loop(s, bind):
            nv = bind.data.shape[1]
            stats = self.noise.make_design_stats(bind.design, bind.data)
            prior_means = jnp.broadcast_to(
                jnp.asarray(bind.prior_base_means, self.dtype), (p, nv))
            prior_prec = jnp.broadcast_to(
                jnp.asarray(self.prior_setup.base_precs, self.dtype),
                (p, nv))
            means, prec, cov, nb, sel_init, conv = dispatch(
                stats.m0, stats.rtqr[0][None, :].astype(self.dtype),
                stats.dtqr[0].astype(self.dtype), prior_means, s.conv)

            # lanes that reverted to (or saved) the initial posterior:
            # it is off the spectral manifold, restore from s — INCLUDING
            # the placeholder prior planes, which is what the XLA
            # route's best-state copy carries for a state saved before
            # iteration 0's prior sweep (the final F of a reverted-to-
            # initial lane is implementation-defined garbage either
            # way; matching keeps the routes bit-comparable)
            means = jnp.where(sel_init[None, :], s.post.means, means)
            prec = jnp.where(sel_init[None, None, :], s.post.prec, prec)
            cov = jnp.where(sel_init[None, None, :], s.post.cov, cov)
            nb = jnp.where(sel_init[None, :], s.post.noise.b, nb)
            nc = jnp.where(sel_init[None, :], s.post.noise.c,
                           jnp.full_like(nb, (nt_g - 1.0) * 0.5 + c0))
            prior_means = jnp.where(sel_init[None, :],
                                    s.post.prior_means, prior_means)
            prior_prec = jnp.where(sel_init[None, :],
                                   s.post.prior_prec, prior_prec)

            noise_post = WhiteNoiseState(nb, nc)
            post = PosteriorState(means, prec, cov, prior_means,
                                  prior_prec, noise_post)
            if self.need_f:
                # recompute on the final (possibly reverted) state:
                # identical inputs to the lane's frozen in-loop value
                # for non-reverted lanes, and exactly the engine's
                # _finalize recompute for reverted ones; fprior is
                # zero for the priors this route admits
                f = self.noise.free_energy_stats(
                    noise_post, self.noise_prior, means, prec, cov,
                    prior_means, prior_prec, stats)
            else:
                f = s.f
            out = s._replace(it=jnp.array(self.max_iter_cap, jnp.int32),
                             post=post, centre=means, f=f, conv=conv)
            return out, None

        return loop

    def compiled_loop(self):
        """The full jitted device computation: state -> final state."""
        if self.use_spectral_fdet:
            return self._compiled_loop_spectral_fdet()
        if self.use_spectral:
            return self._compiled_loop_spectral()

        def cond(s):
            return (~jnp.all(s.conv.done)) & (s.it < self.max_iter_cap)

        # maxits runs a deterministic iteration count on every lane: a
        # static-bound fori_loop lets XLA schedule across iterations
        # (no dynamic convergence test on the critical path)
        static_trip = (type(self.detector).name == "maxits"
                       and not self.is_lm)

        @jax.jit
        def loop(s, bind):
            stats = self.noise.make_design_stats(bind.design, bind.data) \
                if self.use_stats else None
            if static_trip:
                s = jax.lax.fori_loop(
                    0, self.detector.max_iterations,
                    lambda i, st: self._iteration(st, bind, stats), s)
            else:
                s = jax.lax.while_loop(
                    cond, lambda st: self._iteration(st, bind, stats), s)
            return self._finalize(s, bind, stats)

        return loop

    def _can_trace_init(self, continue_means):
        """True when initial_state is pure device math on bind.data —
        no host-side reads that would bake volume-sized constants into
        the compiled program."""
        return (continue_means is None
                and all(spec.prior_type != PRIOR_IMAGE
                        for spec in self.params)
                and self.options.get_string(
                    "noise-initial-prior", "modeldefault") == "modeldefault"
                and self.options.get_string(
                    "noise-initial-posterior",
                    "modeldefault") == "modeldefault")

    def compiled_full(self):
        """Jitted bind -> finalized state, constructing the initial
        state on device: a whole chunk's VB run is ONE dispatch."""
        inner = self.compiled_loop()

        # prior construction must happen eagerly, before tracing
        self._ensure_noise_prior()

        @jax.jit
        def full(bind):
            v = bind.data.shape[1]
            s0 = self.initial_state(lo=0, hi=v, data=bind.data)
            return inner(s0, bind)

        return full

    # -- in-program chunk streaming ---------------------------------------
    def _window_bind(self, bind, lo, chunk):
        """The bindings of voxel window [lo, lo+chunk) (traced lo)."""
        dsl = jax.lax.dynamic_slice
        p = self.nparams
        z = jnp.int32(0)  # literal 0 would promote to i64 under x64
        d = dsl(bind.data, (z, lo), (self.nt, chunk))
        coords = dsl(bind.coords, (z, lo), (3, chunk))
        supp = dsl(bind.supp, (z, lo), (bind.supp.shape[0], chunk))
        base = bind.prior_base_means
        if base.shape[-1] != 1:
            base = dsl(base, (z, lo), (p, chunk))
        locked = bind.locked_centres
        if not isinstance(locked, tuple):
            locked = dsl(locked, (z, lo), (p, chunk))
        return bind._replace(data=d, coords=coords, supp=supp,
                             prior_base_means=base, locked_centres=locked)

    def compiled_streamed(self, chunk):
        """Whole-volume single-dispatch execution: lax.scan over
        fixed-size voxel windows INSIDE one compiled program.

        The host-chunked fallback (the loop in _run_vb) dispatches one
        compiled program per window, each waiting on the host. Here the
        window loop runs on device: the [T,V] data plane is
        the only volume-scale input, per-window temporaries stay
        window-sized, and the outputs are written into volume-scale
        planes with lax.dynamic_update_slice. The final window is slid
        back to end exactly at V (same convention as the host path);
        overlapping voxels recompute identically — all routes are
        lane-independent — so the overwrite is a no-op.

        Returns a jitted fn(bind, starts[int32 W]) -> (means [P,V],
        cov [P,P,V], noise pytree [..,V], f [V], its [V], fhist, itmax).
        """
        inner = self.compiled_loop()
        self._ensure_noise_prior()
        p = self.nparams


        # output-plane prototypes at window size (shape/dtype only)
        _, noise_proto = self.noise.initial_state(1, self.dtype)

        # per-window progress (ProgressCheck parity): only traced in
        # when a callback is registered, so the bench path pays nothing
        report = getattr(self, "progress_cb", None)
        nv_total = self.nvoxels

        def report_window(lo):
            report(min(int(lo) + chunk, nv_total), nv_total)

        @jax.jit
        def streamed(bind, starts):
            nv = bind.data.shape[1]

            def vol(proto_shape, dtype):
                return jnp.zeros(proto_shape[:-1] + (nv,), dtype)

            outs0 = (
                vol((p, 0), self.dtype),                 # means
                vol((p, p, 0), self.dtype),              # cov
                jax.tree_util.tree_map(
                    lambda x: vol(x.shape, x.dtype), noise_proto),
                vol((0,), self.dtype),                   # f
                vol((0,), jnp.int32),                    # its
                vol((self.max_iter_cap, 0), self.dtype)
                if self.save_fhist else (),              # fhist
                jnp.int32(0),                            # itmax
            )

            def body(outs, lo):
                wbind = self._window_bind(bind, lo, chunk)
                s0 = self.initial_state(lo=0, hi=chunk, data=wbind.data)
                fin, _ = inner(s0, wbind)

                def upd(full, w):
                    start = (jnp.int32(0),) * (full.ndim - 1) + (lo,)
                    return jax.lax.dynamic_update_slice(full, w, start)

                means, cov, noise, f, its, fhist, itn = outs
                means = upd(means, fin.post.means)
                cov = upd(cov, fin.post.cov)
                noise = jax.tree_util.tree_map(upd, noise, fin.post.noise)
                f = upd(f, fin.f)
                its = upd(its, fin.conv.its)
                if self.save_fhist:
                    # rows past this window's own iteration count keep
                    # the final F (the host path's _concat_results pads
                    # shorter chunk histories the same way)
                    last = jax.lax.dynamic_index_in_dim(
                        fin.fhist, jnp.maximum(fin.it - 1, 0), 0,
                        keepdims=False)
                    rows = jnp.arange(self.max_iter_cap)[:, None] < fin.it
                    fhist = upd(fhist, jnp.where(rows, fin.fhist,
                                                 last[None, :]))
                itn = jnp.maximum(itn, fin.it)
                if report is not None:
                    jax.debug.callback(report_window, lo)
                return (means, cov, noise, f, its, fhist, itn), None

            outs, _ = jax.lax.scan(body, outs0, starts)
            return outs

        return streamed

    def compiled_streamed_map(self, chunk):
        """Equal-window streaming without volume-scale carries: when
        the window count divides the volume exactly, lax.map stacks
        per-window outputs [W, ..., chunk] and one device-side
        transpose+reshape assembles the [..., V] planes — the scan
        path's dynamic_update_slice carries double-buffer the
        volume-scale output planes per window."""
        inner = self.compiled_loop()
        self._ensure_noise_prior()
        p = self.nparams


        report = getattr(self, "progress_cb", None)
        nv_total = self.nvoxels

        def report_window(lo):
            report(min(int(lo) + chunk, nv_total), nv_total)

        def unstack(x):
            """[W, ..., chunk] -> [..., W*chunk]."""
            if x.ndim == 1:
                return x  # per-window scalars stay stacked
            return jnp.moveaxis(x, 0, -2).reshape(
                x.shape[1:-1] + (x.shape[0] * x.shape[-1],))

        @jax.jit
        def streamed(bind, starts):
            def body(lo):
                wbind = self._window_bind(bind, lo, chunk)
                s0 = self.initial_state(lo=0, hi=chunk, data=wbind.data)
                fin, _ = inner(s0, wbind)
                fhist = ()
                if self.save_fhist:
                    last = jax.lax.dynamic_index_in_dim(
                        fin.fhist, jnp.maximum(fin.it - 1, 0), 0,
                        keepdims=False)
                    rows = jnp.arange(self.max_iter_cap)[:, None] < fin.it
                    fhist = jnp.where(rows, fin.fhist, last[None, :])
                if report is not None:
                    jax.debug.callback(report_window, lo)
                return (fin.post.means, fin.post.cov, fin.post.noise,
                        fin.f, fin.conv.its, fhist, fin.it)

            means, cov, noise, f, its, fhist, itn = jax.lax.map(
                body, starts)
            return (unstack(means), unstack(cov),
                    jax.tree_util.tree_map(unstack, noise),
                    unstack(f), unstack(its),
                    unstack(fhist) if self.save_fhist else (),
                    jnp.max(itn))

        return streamed

    def _stream_result_bytes(self):
        """Per-voxel bytes of the streamed output planes (resident for
        the whole dispatch, on top of the data plane)."""
        item = jnp.dtype(self.dtype).itemsize
        _, noise_proto = self.noise.initial_state(1, self.dtype)
        nplanes = sum(int(np.prod(x.shape[:-1]))
                      for x in jax.tree_util.tree_leaves(noise_proto))
        per = (self.nparams + self.nparams ** 2 + nplanes + 1) * item + 4
        if self.save_fhist:
            per += self.max_iter_cap * item
        return per

    def _stream_chunk(self):
        """Window size for the streamed path: the usual per-window
        budget minus the volume-scale residents (data plane + output
        planes). Returns None when the residents alone exceed the
        budget — the volume cannot live on device, fall back to
        host-side chunk dispatches."""
        explicit = self.options.get_int("voxel-chunk-size", 0)
        if explicit > 0:
            return explicit
        budget = planning_budget()
        resident = (self.nt * jnp.dtype(self.store_dtype).itemsize
                    + self._stream_result_bytes()) * self.nvoxels
        left = budget - resident
        if left < 0.05 * budget:
            return None
        return self._chunk_size(budget_bytes=left)

    def _run_streamed(self, chunk):
        nv = self.nvoxels
        nwin = -(-nv // chunk)
        if nv % nwin == 0:
            # equal windows: the carry-free map path (shrinking the
            # window to the exact divisor only reduces temporaries)
            chunk = nv // nwin
            starts = np.arange(nwin, dtype=np.int64) * chunk
            streamed = self.compiled_streamed_map(chunk)
        else:
            starts = np.arange(nwin, dtype=np.int64) * chunk
            starts[-1] = nv - chunk
            streamed = self.compiled_streamed(chunk)
        outs = streamed(self._bind(),
                        jnp.asarray(starts, jnp.int32))
        cb = getattr(self, "progress_cb", None)
        if cb is not None:
            cb(nv, nv)
        return self._streamed_to_result(outs)

    def _streamed_to_result(self, outs):
        means_p, cov_p, noise, f, its, fhist_p, itn = outs
        noise_host = jax.tree_util.tree_map(self._fetch, noise)
        noise_means, noise_cov = self.noise.state_to_mvn(noise_host)

        means = self._fetch(means_p).T.copy()              # [V,P]
        cov = np.moveaxis(self._fetch(cov_p), -1, 0).copy()
        nmeans = np.array(noise_means)
        ncov = np.array(noise_cov)
        f_h = np.asarray(self._fetch(f)) if self.need_f else None

        bad = ~(np.isfinite(means).all(axis=1)
                & np.isfinite(cov).reshape(cov.shape[0], -1).all(axis=1)
                & np.isfinite(nmeans).all(axis=1))
        if bad.any():
            p, q = means.shape[1], nmeans.shape[1]
            means[bad] = 0.0
            cov[bad] = np.eye(p)
            nmeans[bad] = 0.0
            ncov[bad] = np.eye(q)

        fhist = None
        if self.save_fhist:
            nit = int(np.asarray(itn))
            fhist = self._fetch(fhist_p)[:nit]
            if f_h is not None:
                fhist = np.concatenate([fhist, f_h[None]], axis=0)

        return VBResult(
            means=means, cov=cov, noise_means=nmeans, noise_cov=ncov,
            free_energy=f_h, fhistory=fhist,
            iterations=np.asarray(self._fetch(its)),
            bad_voxels=bad)

    def _chunk_size(self, budget_bytes=None):
        """Voxels per device pass. 0 = auto from a memory budget.

        Chunking bounds device memory at any volume size: each chunk
        runs the same compiled loop (identical shapes, one trace).
        Voxelwise VB has no cross-voxel coupling so results are
        unchanged; the spatial engine never chunks.
        """
        explicit = self.options.get_int("voxel-chunk-size", 0)
        if explicit > 0:
            return explicit
        item = jnp.dtype(self.dtype).itemsize
        p, t = self.nparams, self.nt
        budget = budget_bytes if budget_bytes is not None \
            else planning_budget()
        if self.use_spectral or self.use_spectral_fdet:
            # eigenbasis fixed point: loop state is a few scalar lanes
            # (no double-buffered best-state pytree); temps are the
            # [T,V] data + one matmul operand for the one-time stats
            # pass, plus the P x P posterior outputs
            per_vox = (2 * t + 3 * p * p + 6 * p + 12) * item
            return max(16384, int(budget / per_vox))
        # state+best (x2 for while-loop double buffering)
        per_vox = 4 * (3 * p * p + 8 * p + 24) * item
        # loop temporaries: [T,V]-sized planes; generic path also
        # carries the [P,T,V] Jacobian and autodiff intermediates
        if self.use_stats:
            # loop carries no [T,V] planes; the one-time stats pass
            # needs data + r0 + a matmul operand
            per_vox += t * 3 * item
        else:
            per_vox += t * (6 if self.design is not None
                            else 8 * (p + 1)) * item
        return max(16384, int(budget / per_vox))

    def run(self, continue_means=None, continue_cov=None, continue_noise=None):
        result = self._run_vb(continue_means, continue_cov, continue_noise)
        if self.num_mcsteps > 0 and type(self) is VBInference:
            result = self._run_mc_steps(result)
        if self.options.get_bool("spatial-prior-output-correction"):
            result = self.compute_noprior(result)
        return result

    def compute_noprior(self, result):
        """thetaWithoutPrior (--spatial-prior-output-correction): the
        likelihood-only posterior — precision J'XJ with NO prior term,
        means (J'XJ)^-1 J'X(data - g(m) + Jm) — at the final state
        (noisemodel.h:132, noisemodel_white.cc:357-362,
        noisemodel_ar.cc:612-632; the reference snapshot declares this
        surface but its loops pass NULL, so finalize-time evaluation is
        our defined semantics). Runs update_theta with zero prior
        planes — one extra chunked dispatch per run."""
        p = self.nparams
        noise_state = self.noise.state_from_mvn(result.noise_means,
                                                result.noise_cov)
        chunk = self._chunk_size()
        outs_m, outs_c = [], []
        tmap = jax.tree_util.tree_map
        for lo in range(0, self.nvoxels, chunk):
            hi = min(lo + chunk, self.nvoxels)
            bind = self._bind(lo, hi)
            means = jnp.asarray(result.means[lo:hi].T, self.dtype)
            nst = tmap(lambda x: jnp.asarray(x[..., lo:hi], self.dtype),
                       noise_state)
            offset, jac = self._recentre(means, bind)
            zeros = jnp.zeros((p, hi - lo), self.dtype)
            m, _, cov, _ok = self.noise.update_theta(
                nst, means, zeros, zeros, means, offset, jac,
                jnp.asarray(bind.data, self.dtype), None,
                design=self._design_arg(bind))
            outs_m.append(np.asarray(m).T)
            outs_c.append(np.moveaxis(np.asarray(cov), -1, 0))
        return result._replace(
            noprior_means=np.concatenate(outs_m, axis=0),
            noprior_cov=np.concatenate(outs_c, axis=0))

    def _run_mc_steps(self, result):
        """Interleave motion correction with VB continuation passes
        (MCobj::run_mc semantics: per-timepoint transforms estimated
        from the ORIGINAL data against the current model fit)."""
        from ..core.motion import make_registerer, register_timeseries

        from ..exceptions import InvalidOptionValue
        if getattr(self, "mesh", None) is not None:
            # the registration operates on whole volumes; re-feeding
            # realigned data through a sharded/multi-process engine is
            # not wired up — fail loudly rather than silently break
            raise InvalidOptionValue(
                "mcsteps", str(self.num_mcsteps),
                "Motion correction is not supported with "
                "--distributed/--shard-voxels")

        # repeated run() calls must register from the TRUE original
        # data, never from already-realigned (transforms would
        # compound and still volumes would be resampled twice)
        if not hasattr(self, "_mc_orig_data"):
            self._mc_orig_data = self.data
        orig = self._mc_orig_data
        coords = np.asarray(self._fetch(self.coords)).T        # [V,3]
        shape = tuple(int(c) + 1 for c in coords.max(axis=0))
        # one registerer for all steps: device bindings uploaded once,
        # compiled executables shared (advisor finding: closure-captured
        # coords became HLO constants and recompiled per step)
        if getattr(self, "_mc_registerer", None) is None:
            self._mc_registerer = make_registerer(coords, shape,
                                                  dof=self.mc_dof)
        self.mc_translations = []  # per-step max |translation|, logged
        # estimates near the PYRAMID's capture range (+-2 voxels of
        # its top pool level) mean the TRUE motion may exceed it and
        # be under-corrected (the cost surface is only locally
        # convex); flagged for the runner's warning
        self.mc_saturated = False
        self.mc_capture_range = self._mc_registerer.capture_range
        for step in range(self.num_mcsteps):
            fit = self.evaluate_model(np.asarray(result.means).T)  # [T,V]
            realigned, disp = register_timeseries(
                orig, fit, coords, shape, dof=self.mc_dof,
                reg=self._mc_registerer)
            step_max = float(np.abs(disp).max())
            self.mc_translations.append(step_max)
            if step_max >= 0.75 * self._mc_registerer.capture_range:
                self.mc_saturated = True
            self.data = jnp.asarray(realigned, self.data.dtype)
            cn = self.noise.state_from_mvn(result.noise_means,
                                           result.noise_cov)
            result = self._run_vb(continue_means=result.means,
                                  continue_cov=result.cov,
                                  continue_noise=cn)
        return result

    def _run_vb(self, continue_means=None, continue_cov=None,
                continue_noise=None):
        routes = ("use_spectral", "use_spectral_fdet")
        if any(getattr(self, r) for r in routes) \
                and (continue_means is not None
                     or continue_noise is not None):
            # these routes always start from the model-default init; a
            # programmatic initial posterior/noise must take the XLA
            # route (the option-string gate above only sees
            # continue-from-mvn). Restore after — a later run() without
            # continuation (e.g. a fresh MC sequence) keeps the fast
            # route.
            saved_route = [getattr(self, r) for r in routes]
            for r in routes:
                setattr(self, r, False)
            try:
                return self._run_vb(continue_means, continue_cov,
                                    continue_noise)
            finally:
                for r, v in zip(routes, saved_route):
                    setattr(self, r, v)
        chunk = self._chunk_size()
        # single-dispatch path: initial state built on device inside
        # the compiled program
        traced_init = self._can_trace_init(continue_means)

        # In-program chunk streaming: when the volume exceeds one
        # window but the data plane + result planes fit on device, run
        # the window loop INSIDE one compiled program (one dispatch for
        # the whole volume) instead of serialized per-window dispatches
        if (chunk < self.nvoxels and traced_init
                and continue_noise is None
                and getattr(self, "mesh", None) is None
                and type(self) is VBInference
                and self.options.get_string("chunk-streaming",
                                            "auto") != "off"):
            schunk = self._stream_chunk()
            if schunk is not None:
                return self._run_streamed(min(schunk, self.nvoxels))
        full = self.compiled_full() if traced_init else None
        loop = None if traced_init else self.compiled_loop()

        def run_window(lo, hi):
            if traced_init:
                return full(self._bind(lo, hi))
            s0 = self.initial_state(continue_means, continue_cov,
                                    continue_noise, lo=lo, hi=hi)
            return loop(s0, self._bind(lo, hi))

        if chunk >= self.nvoxels:
            final, result = run_window(0, self.nvoxels)
            return self._to_result(final, result)

        # chunked execution: fixed-size windows; the final window is
        # slid back to end exactly at V (some voxels recomputed, which
        # is correct and avoids padding)
        results = []
        lo = 0
        while lo < self.nvoxels:
            hi = lo + chunk
            take_from = 0
            if hi > self.nvoxels:
                take_from = hi - self.nvoxels
                lo, hi = self.nvoxels - chunk, self.nvoxels
            final, result = run_window(lo, hi)
            res = self._to_result(final, result)
            if take_from:
                res = jax.tree_util.tree_map(
                    lambda x: x[..., take_from:] if (
                        hasattr(x, "ndim") and x.ndim >= 1
                        and x.shape[-1] == chunk) else (
                        x[take_from:] if hasattr(x, "ndim") and x.ndim >= 1
                        and x.shape[0] == chunk else x), res)
            results.append(res)
            lo = hi
            # per-chunk progress (ProgressCheck parity: the reference
            # reports per voxel, rundata.h:102-169; a chunk is our unit
            # of completed voxels)
            cb = getattr(self, "progress_cb", None)
            if cb is not None:
                cb(min(lo, self.nvoxels), self.nvoxels)
        return _concat_results(results)

    def _finalize(self, s, bind, stats=None):
        """Post-loop save/revert (inference_vb.cc:505-525)."""
        if self.detector.tracks_best:
            best = _lane_where(s.conv.save, s.post, s.best)
            post = _lane_where(s.conv.revert, best, s.post)
        else:
            post = s.post

        if self.need_f and self.detector.tracks_best:
            if stats is not None:
                f_rev = self.noise.free_energy_stats(
                    post.noise, self.noise_prior, post.means, post.prec,
                    post.cov, post.prior_means, post.prior_prec,
                    stats) + s.fprior
            else:
                offset, jac = self._recentre(post.means, bind)
                f_rev = self.noise.free_energy(
                    post.noise, self.noise_prior, post.means, post.prec,
                    post.cov, post.prior_means, post.prior_prec, post.means,
                    offset, jac, bind.data,
                    design=self._design_arg(bind)) + s.fprior
            f = jnp.where(s.conv.revert, f_rev, s.f)
        else:
            f = s.f
        return s._replace(post=post, centre=post.means, f=f), None

    def _to_result(self, s, _):
        post = s.post
        # noise state planes are [..,V]-sharded; bring them to host
        # through _fetch (allgather under multi-process sharding) so
        # state_to_mvn's numpy reshaping sees addressable data
        noise_host = jax.tree_util.tree_map(self._fetch, post.noise)
        noise_means, noise_cov = self.noise.state_to_mvn(noise_host)

        means = self._fetch(post.means).T.copy()           # [V,P]
        cov = np.moveaxis(self._fetch(post.cov), -1, 0).copy()  # [V,P,P]
        nmeans = np.array(noise_means)  # writable copies
        ncov = np.array(noise_cov)      # (bad-voxel fixup)
        f = self._fetch(s.f) if self.need_f else None

        bad = ~(np.isfinite(means).all(axis=1)
                & np.isfinite(cov).reshape(cov.shape[0], -1).all(axis=1)
                & np.isfinite(nmeans).all(axis=1))

        if bad.any():
            # Degrade failed voxels to zero-mean/identity-covariance,
            # as the reference does (inference_vb.cc:556-570)
            p, q = means.shape[1], nmeans.shape[1]
            means[bad] = 0.0
            cov[bad] = np.eye(p)
            nmeans[bad] = 0.0
            ncov[bad] = np.eye(q)

        fhist = None
        if self.save_fhist:
            nit = int(np.asarray(s.it))
            fhist = self._fetch(s.fhist)[:nit]
            # final (possibly reverted) F is appended, as in the
            # reference (inference_vb.cc:553-554)
            if f is not None:
                fhist = np.concatenate([fhist, np.asarray(f)[None]], axis=0)

        return VBResult(
            means=means, cov=cov, noise_means=nmeans, noise_cov=ncov,
            free_energy=np.asarray(f) if f is not None else None,
            fhistory=fhist,
            iterations=self._fetch(s.conv.its),
            bad_voxels=bad)
