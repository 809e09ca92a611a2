from .returns import gae, lambda_values, nstep_returns
from .transforms import symexp, symlog, two_hot_decoder, two_hot_encoder, unrolled_cumprod

__all__ = [
    "gae",
    "lambda_values",
    "nstep_returns",
    "symexp",
    "symlog",
    "two_hot_decoder",
    "two_hot_encoder",
    "unrolled_cumprod",
]
