"""Example user model plugin — the template for writing your own.

Equivalent of the reference's plugin example (examples/fwdmodel_exp.cc):
a sum-of-exponentials model with log-transformed parameters and
data-driven posterior initialization. Load it with

    python -m fabber_core_tpu.cli --loadmodels=examples/fwdmodel_exp.py \
        --model=myexp ...

(The built-in `exp`/`biexp` models are equivalent; this file exists to
demonstrate the plugin surface.)
"""

import jax.numpy as jnp

from fabber_core_tpu.core.transforms import TRANSFORM_LOG
from fabber_core_tpu.models.base import (DistParams, Model, ParamSpec,
                                         register_model)
from fabber_core_tpu.options import OptionSpec, OPT_FLOAT, OPT_INT


@register_model
class MyExpModel(Model):
    name = "myexp"

    def __init__(self, options):
        self.dt = options.get_float("dt")
        self.num = options.get_int("num-exps", 1)

    @classmethod
    def get_options(cls):
        return [
            OptionSpec("dt", OPT_FLOAT, "Time separation between samples",
                       True),
            OptionSpec("num-exps", OPT_INT,
                       "Number of independent decay rates", default="1"),
        ]

    @classmethod
    def describe(cls):
        return "Example model of a sum of exponentials (plugin template)"

    def param_defaults(self):
        params = []
        for i in range(self.num):
            params.append(ParamSpec(2 * i, f"amp{i + 1}",
                                    DistParams(1, 1e5), DistParams(1, 1.5),
                                    transform=TRANSFORM_LOG))
            params.append(ParamSpec(2 * i + 1, f"r{i + 1}",
                                    DistParams(1, 1e5), DistParams(1, 1.5),
                                    transform=TRANSFORM_LOG))
        return params

    def evaluate(self, params, ctx, key=""):
        # scalar indexing (not params[0::2], which traces to a gather)
        t = jnp.arange(ctx.nt, dtype=params.dtype) * self.dt
        sig = params[0] * jnp.exp(-params[1] * t)
        for i in range(1, self.num):
            sig = sig + params[2 * i] * jnp.exp(-params[2 * i + 1] * t)
        return sig

    def init_posterior(self, data, means):
        data_max = jnp.max(data, axis=1)
        for i in range(self.num):
            means = means.at[:, 2 * i].set(data_max / (self.num + i))
        return means
