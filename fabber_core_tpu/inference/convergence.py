"""Convergence detectors as batched per-voxel lane state machines.

The reference runs one stateful detector object per voxel
(convergence.cc). Under SIMD batching every voxel carries detector
state in arrays and a single jitted ``test`` advances all lanes; the
engine freezes lanes whose ``done`` flag is set, which reproduces the
heterogeneous per-voxel iteration counts of the serial loop without
data-dependent control flow.

Semantics are lane-exact ports of the five detectors:
  maxits (convergence.cc:43-55), pointzeroone/fchange (86-103),
  freduce (117-131), trialmode (162-243), lm (278-378).
"""

from typing import NamedTuple

import jax.numpy as jnp

from ..exceptions import InvalidOptionValue
from ..options import OptionSpec, OPT_INT, OPT_FLOAT


def _bsel(cond, a, b):
    """Boolean select as logical ops on the lane masks."""
    return (cond & a) | (~cond & b)


class ConvState(NamedTuple):
    its: jnp.ndarray        # [V] int32
    prev_f: jnp.ndarray     # [V]
    save: jnp.ndarray       # [V] bool — current params are best so far
    revert: jnp.ndarray     # [V] bool — revert to saved params at end
    done: jnp.ndarray       # [V] bool — lane converged/frozen
    trials: jnp.ndarray     # [V] int32 (trialmode)
    trialmode: jnp.ndarray  # [V] bool (trialmode)
    lm_on: jnp.ndarray      # [V] bool (lm)
    alpha: jnp.ndarray      # [V] LM damping factor


class ConvergenceDetector:
    name = None
    uses_f = False
    # Whether the VB loop must keep a best-so-far state copy for this
    # detector's save/revert protocol. False lets the engine drop ~P^2
    # planes of per-iteration loop-state traffic.
    tracks_best = False

    def __init__(self, options):
        pass

    @classmethod
    def get_options(cls):
        return [OptionSpec("max-iterations", OPT_INT,
                           "Maximum iterations", default="10")]

    def init_state(self, nvoxels, dtype, init_save=False):
        return ConvState(
            its=jnp.zeros(nvoxels, jnp.int32),
            # reference sentinel is -99e99 (convergence.h); clamp to the
            # dtype's finite range so float32 doesn't overflow to -inf
            prev_f=jnp.full(nvoxels,
                            max(-99e99, float(jnp.finfo(dtype).min)),
                            dtype),
            save=jnp.full(nvoxels, init_save, bool),
            revert=jnp.zeros(nvoxels, bool),
            done=jnp.zeros(nvoxels, bool),
            trials=jnp.zeros(nvoxels, jnp.int32),
            trialmode=jnp.zeros(nvoxels, bool),
            lm_on=jnp.zeros(nvoxels, bool),
            alpha=jnp.zeros(nvoxels, dtype),
        )

    def test(self, state, f):
        raise NotImplementedError

    @property
    def max_iterations(self):
        """Static upper bound on iterations, for the engine's loop cap."""
        raise NotImplementedError


_DETECTORS = {}


def register_detector(cls):
    _DETECTORS[cls.name] = cls
    return cls


def get_detector_class(name):
    try:
        return _DETECTORS[name]
    except KeyError:
        raise InvalidOptionValue("convergence", name,
                                 "Unrecognized convergence detector")


def known_detectors():
    return sorted(_DETECTORS)


@register_detector
class CountingDetector(ConvergenceDetector):
    """Fixed number of iterations."""
    name = "maxits"

    def __init__(self, options):
        self.max_its = options.get_int("max-iterations", 10, minval=1)

    @property
    def max_iterations(self):
        return self.max_its

    def test(self, state, f):
        its = state.its + 1
        return state._replace(its=its, done=its >= self.max_its)


@register_detector
class FchangeDetector(CountingDetector):
    """Stop when |dF| < min-fchange (a.k.a. 'pointzeroone')."""
    name = "pointzeroone"
    uses_f = True

    def __init__(self, options):
        super().__init__(options)
        self.min_fchange = options.get_float("min-fchange", 0.01)
        if self.min_fchange <= 0:
            raise InvalidOptionValue("min-fchange", self.min_fchange, "Must be positive")

    @classmethod
    def get_options(cls):
        return super().get_options() + [
            OptionSpec("min-fchange", OPT_FLOAT,
                       "Change in F to stop at", default="0.01")]

    def test(self, state, f):
        diff = f - state.prev_f
        fsmall = jnp.abs(diff) < self.min_fchange
        its = jnp.where(fsmall, state.its, state.its + 1)
        done = fsmall | (its >= self.max_its)
        return state._replace(its=its, prev_f=f, done=done)


@register_detector
class FreduceDetector(FchangeDetector):
    """Like fchange, but also stop (and revert) if F decreased."""
    name = "freduce"
    tracks_best = True

    def test(self, state, f):
        diff = f - state.prev_f
        reduced = diff < 0
        fsmall = jnp.abs(diff) < self.min_fchange
        its = jnp.where(reduced | fsmall, state.its, state.its + 1)
        done = reduced | fsmall | (its >= self.max_its)
        return state._replace(
            its=its,
            prev_f=jnp.where(reduced, state.prev_f, f),
            revert=reduced | state.revert,
            done=done,
        )


@register_detector
class TrialModeDetector(FchangeDetector):
    """Allow up to max-trials iterations for F to recover after a drop."""
    name = "trialmode"
    tracks_best = True

    def __init__(self, options):
        super().__init__(options)
        # +1 for consistency with previous versions (convergence.cc:144-145)
        self.max_its += 1
        self.max_trials = options.get_int("max-trials", 10, minval=1)

    @classmethod
    def get_options(cls):
        return super().get_options() + [
            OptionSpec("max-trials", OPT_INT,
                       "Maximum trials after an initial reduction in F",
                       default="10")]

    @property
    def max_iterations(self):
        # a worst case bound: each successful step may be followed by a
        # full trial sequence
        return self.max_its * (self.max_trials + 1) + self.max_trials + 2

    def init_state(self, nvoxels, dtype, init_save=True):
        return super().init_state(nvoxels, dtype, init_save=True)

    def test(self, state, f):
        diff = f - state.prev_f
        reduced = diff < 0
        fsmall = jnp.abs(diff) < self.min_fchange
        tm = state.trialmode

        # --- not in trial mode ------------------------------------------
        # reduced      -> enter trial mode, revert later, keep best F
        # fsmall       -> converged, no revert
        # otherwise    -> save as best, continue
        n_its = jnp.where(reduced, 1,
                          jnp.where(fsmall, state.its, state.its + 1))
        n_trials = jnp.where(reduced, 1, state.trials)
        n_tm = reduced
        n_save = ~reduced & ~fsmall
        n_revert = reduced
        n_prev = jnp.where(reduced | fsmall, state.prev_f, f)
        n_done = ~reduced & (fsmall | (n_its >= self.max_its))

        # --- in trial mode ----------------------------------------------
        t_trials = state.trials + 1
        improved = diff > 0
        # improved & fsmall  -> converged, no revert
        # improved & !fsmall -> leave trial mode, save best, continue
        # !improved & trials>=max -> stop and revert to best
        # otherwise          -> stay in trial mode
        exhausted = ~improved & (t_trials >= self.max_trials)
        t_its = state.its
        t_tm = ~(improved & ~fsmall)
        t_trials = jnp.where(improved & ~fsmall, 0, t_trials)
        t_save = improved & ~fsmall
        t_revert = exhausted
        t_prev = jnp.where(improved & ~fsmall, f, state.prev_f)
        t_done = (improved & fsmall) | exhausted

        return state._replace(
            its=jnp.where(tm, t_its, n_its),
            prev_f=jnp.where(tm, t_prev, n_prev),
            save=_bsel(tm, t_save, n_save),
            revert=_bsel(tm, t_revert, n_revert),
            done=_bsel(tm, t_done, n_done),
            trials=jnp.where(tm, t_trials, n_trials),
            trialmode=_bsel(tm, t_tm, n_tm),
        )


@register_detector
class LMDetector(ConvergenceDetector):
    """Levenberg-Marquardt-style damping control on F decreases."""
    name = "lm"
    uses_f = True
    tracks_best = True

    ALPHA_START = 1e-6
    ALPHA_MAX = 1e6

    def __init__(self, options):
        self.max_its = options.get_int("max-iterations", 10, minval=1)
        self.max_fchange = options.get_float("max-fchange", 0.01)
        if self.max_fchange <= 0:
            raise InvalidOptionValue("max-fchange", self.max_fchange, "Must be positive")

    @classmethod
    def get_options(cls):
        return super().get_options() + [
            OptionSpec("max-fchange", OPT_FLOAT,
                       "Change in F considered converged", default="0.01")]

    @property
    def max_iterations(self):
        # alpha can be raised log10(max/start)+1 times per successful step
        return self.max_its * 16 + 16

    def init_state(self, nvoxels, dtype, init_save=True):
        return super().init_state(nvoxels, dtype, init_save=True)

    def test(self, state, f):
        diff = f - state.prev_f
        absdiff = jnp.abs(diff)
        lm = state.lm_on

        # --- not in LM mode ---------------------------------------------
        dropped = diff < 0
        n_converged = ~dropped & (absdiff < self.max_fchange)
        n_maxed = ~dropped & ~n_converged & (state.its >= self.max_its)
        n_cont = ~dropped & ~n_converged & ~n_maxed
        n_lm_on = dropped
        n_alpha = jnp.where(dropped, self.ALPHA_START, state.alpha)
        n_revert = dropped
        n_prev = jnp.where(n_cont, f, state.prev_f)
        n_its = jnp.where(n_cont, state.its + 1, state.its)
        n_done = n_converged | n_maxed

        # --- in LM mode -------------------------------------------------
        improved = diff > 0
        at_start = state.alpha == self.ALPHA_START
        l_alpha_imp = jnp.where(at_start, state.alpha, state.alpha / 10.0)
        l_lm_imp = ~at_start
        alpha_maxed = ~improved & (state.alpha >= self.ALPHA_MAX)
        its_maxed = ~improved & ~alpha_maxed & (state.its >= self.max_its)
        grow = ~improved & ~alpha_maxed & ~its_maxed

        l_lm_on = _bsel(improved, l_lm_imp, state.lm_on)
        l_alpha = jnp.where(improved, l_alpha_imp,
                            jnp.where(grow, state.alpha * 10.0, state.alpha))
        l_revert = ~improved & _bsel(alpha_maxed, alpha_maxed,
                                     ~its_maxed)
        l_prev = jnp.where(improved, f, state.prev_f)
        l_its = jnp.where(improved, state.its + 1, state.its)
        l_done = alpha_maxed | its_maxed

        return state._replace(
            its=jnp.where(lm, l_its, n_its),
            prev_f=jnp.where(lm, l_prev, n_prev),
            revert=_bsel(lm, l_revert, n_revert),
            done=_bsel(lm, l_done, n_done),
            lm_on=_bsel(lm, l_lm_on, n_lm_on),
            alpha=jnp.where(lm, l_alpha, n_alpha),
        )
