"""Sum-of-exponentials decay model: sum_i amp_i * exp(-r_i * t).

Capability parity with the reference's plugin example
(examples/fwdmodel_exp.cc:43-91): log-transformed amp/r parameters,
priors N(1, 1e5) / posteriors N(1, 1.5) in model space, and data-driven
posterior initialization of the amplitudes from the data maximum.
Also registered as "biexp" with num-exps defaulting to 2
(doc/models.rst biexp example).
"""

import jax.numpy as jnp

from ..core.transforms import TRANSFORM_LOG
from ..options import OptionSpec, OPT_FLOAT, OPT_INT
from .base import DistParams, Model, ParamSpec, register_model


@register_model
class ExpModel(Model):
    name = "exp"
    default_num_exps = 1

    def __init__(self, options):
        self.dt = options.get_float("dt")
        self.num = options.get_int("num-exps", self.default_num_exps)

    @classmethod
    def get_options(cls):
        return [
            OptionSpec("dt", OPT_FLOAT, "Time separation between samples", True),
            OptionSpec("num-exps", OPT_INT, "Number of independent decay rates",
                       default="1"),
        ]

    @classmethod
    def describe(cls):
        return "Example model of a sum of exponentials"

    def param_defaults(self):
        params = []
        p = 0
        for i in range(self.num):
            params.append(ParamSpec(p, f"amp{i + 1}", DistParams(1, 1e5),
                                    DistParams(1, 1.5), transform=TRANSFORM_LOG))
            p += 1
            params.append(ParamSpec(p, f"r{i + 1}", DistParams(1, 1e5),
                                    DistParams(1, 1.5), transform=TRANSFORM_LOG))
            p += 1
        return params

    def evaluate(self, params, ctx, key=""):
        # scalar indexing (not params[0::2]) traces to slices, not a
        # gather
        t = jnp.arange(ctx.nt, dtype=params.dtype) * self.dt
        sig = params[0] * jnp.exp(-params[1] * t)
        for i in range(1, self.num):
            sig = sig + params[2 * i] * jnp.exp(-params[2 * i + 1] * t)
        return sig

    def init_posterior(self, data, means):
        # amp_i starts at data_max / (num + i) (fwdmodel_exp.cc:84-91)
        data_max = jnp.max(data, axis=1)  # [V]
        for i in range(self.num):
            means = means.at[:, 2 * i].set(data_max / (self.num + i))
        return means


@register_model
class BiexpModel(ExpModel):
    name = "biexp"
    default_num_exps = 2

    @classmethod
    def describe(cls):
        return "Bi-exponential decay model (sum of two exponentials)"
