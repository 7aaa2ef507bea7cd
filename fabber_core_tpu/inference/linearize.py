"""Batched linearization of forward models (SoA layout).

Replaces the reference's per-voxel LinearizedFwdModel::ReCentre
(fwdmodel_linear.cc:126-182) with a single vmapped evaluation +
Jacobian over all voxels, with voxels on the *last* axis so results
land directly in the engine's voxels-last layout. Two Jacobian sources:

  * "auto" (default): jax.jacfwd through the latent->model transform
    and the model function — exact derivatives, one fused XLA
    computation, and what a batched device design should use.
  * "fd": central finite differences with the reference's step rule
    delta = max(|m_i| * 1e-5, 1e-10), for bit-level parity testing
    against the C++ pipeline.

The Jacobian is taken in *latent* space (including the transform chain),
matching EvaluateFabber-based differencing in the reference.
"""

import jax
import jax.numpy as jnp

from ..models.base import EvalContext

FD_REL_STEP = 1e-5
FD_MIN_STEP = 1e-10


def make_latent_evaluator(model, params, nt, key=""):
    """Single-voxel latent-space evaluation fn (latent [P], data [T],
    coords [3], supp [S]) -> signal [T]."""
    transforms = [p.transform for p in params]
    all_identity = all(t.is_identity for t in transforms)

    def latent_to_model(latent):
        if all_identity:
            return latent
        return jnp.stack([t.to_model(latent[i])
                          for i, t in enumerate(transforms)])

    def evaluate(latent, data, coords, supp):
        ctx = EvalContext(data=data, coords=coords, suppdata=supp, nt=nt)
        return model.evaluate(latent_to_model(latent), ctx, key=key)

    return evaluate


class Linearizer:
    """recentre(means [P,V], data, coords, supp) -> (offset [T,V],
    jacobian [P,T,V]).

    Per-run arrays are passed per call rather than captured — closure
    captures would be baked into the compiled HLO as constants (fatal
    for large volumes and for remote compilation).
    """

    def __init__(self, model, params, nt, mode="auto", key=""):
        self.nt = nt
        self._eval_one = make_latent_evaluator(model, params, nt, key)
        self._eval_batch = jax.vmap(self._eval_one, in_axes=-1, out_axes=-1)
        self.mode = mode
        if mode == "auto":
            # per voxel: [T,P] jacobian; stacked on last axis -> [T,P,V]
            self._jac_batch = jax.vmap(jax.jacfwd(self._eval_one, argnums=0),
                                       in_axes=-1, out_axes=-1)
        elif mode != "fd":
            raise ValueError(f"Unknown linearization mode: {mode}")

    def evaluate(self, means, data, coords, supp):
        """Just the model signal at the given latent means: [T,V]."""
        return self._eval_batch(means, data, coords, supp)

    def __call__(self, means, data, coords, supp):
        offset = self.evaluate(means, data, coords, supp)
        if self.mode == "auto":
            jac = self._jac_batch(means, data, coords, supp)
            jac = jnp.moveaxis(jac, 1, 0)  # [T,P,V] -> [P,T,V]
        else:
            jac = self._fd_jacobian(means, data, coords, supp)
        return offset, jac

    def _fd_jacobian(self, means, data, coords, supp):
        """Central differences with the reference's step rule."""
        p = means.shape[0]
        delta = jnp.maximum(jnp.abs(means) * FD_REL_STEP, FD_MIN_STEP)  # [P,V]
        rows = []
        for i in range(p):
            d = delta[i]
            up = means.at[i].add(d)
            dn = means.at[i].add(-d)
            f_up = self.evaluate(up, data, coords, supp)
            f_dn = self.evaluate(dn, data, coords, supp)
            denom = (up[i] - dn[i])[None, :]
            rows.append((f_up - f_dn) / denom)
        return jnp.stack(rows)  # [P,T,V]
