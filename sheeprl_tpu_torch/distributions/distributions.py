"""Probability distributions for the Dreamer losses and actors (the port's
copy of ``sheeprl_tpu/distributions/distributions.py``).

Sampling takes its noise explicitly: a categorical draw is
``argmax(log_softmax(logits) + gumbel)`` (exactly what
``jax.random.categorical`` computes), a normal draw is
``loc + scale * eps``, and a truncated-normal draw is the inverse CDF of a
uniform in ``[eps, 1 - eps]`` (``eps`` the float32 machine epsilon). A
caller passes pre-drawn ``noise`` of the distribution's shape (gumbel,
standard normal or that uniform), or a ``torch.Generator`` that draws it.
The tests hand the port JAX's own draws this way, so both packages sample
the same actions and latents.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.transforms import symexp, symlog


def gumbel_noise(
    shape, generator: Optional[torch.Generator] = None, device=None, dtype=torch.float32
) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, u uniform in [tiny, 1) (the
    form of ``jax.random.gumbel``)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    u = u.clamp_min(torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


class Distribution:
    def sample(self, noise=None, generator=None) -> torch.Tensor:
        raise NotImplementedError

    def rsample(self, noise=None, generator=None) -> torch.Tensor:
        return self.sample(noise, generator)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def entropy(self) -> torch.Tensor:
        raise NotImplementedError

    @property
    def mode(self) -> torch.Tensor:
        raise NotImplementedError

    @property
    def mean(self) -> torch.Tensor:
        raise NotImplementedError


class Normal(Distribution):
    """``scale`` a tensor or a number (a 0-d tensor on ``loc``'s device)."""

    def __init__(self, loc: torch.Tensor, scale):
        self.loc = loc.float()
        self.scale = scale.float() if isinstance(scale, torch.Tensor) else torch.full((), float(scale),
                                                                                      device=self.loc.device)

    def sample(self, noise=None, generator=None):
        shape = torch.broadcast_shapes(self.loc.shape, self.scale.shape)
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=self.loc.device)
        return self.loc + self.scale * noise

    def log_prob(self, value):
        var = self.scale**2
        return -0.5 * ((value - self.loc) ** 2 / var + torch.log(2 * math.pi * var))

    def entropy(self):
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale) * torch.ones_like(self.loc)

    @property
    def mode(self):
        return self.loc

    @property
    def mean(self):
        return self.loc


class Independent(Distribution):
    """Sum log-probs/entropy over the last ``reinterpreted_batch_ndims`` dims."""

    def __init__(self, base: Distribution, reinterpreted_batch_ndims: int = 1):
        self.base = base
        self.ndims = reinterpreted_batch_ndims

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self.ndims == 0:
            return x
        return x.sum(dim=tuple(range(-self.ndims, 0)))

    def sample(self, noise=None, generator=None):
        return self.base.sample(noise, generator)

    def rsample(self, noise=None, generator=None):
        return self.base.rsample(noise, generator)

    def log_prob(self, value):
        return self._reduce(self.base.log_prob(value))

    def entropy(self):
        return self._reduce(self.base.entropy())

    @property
    def mode(self):
        return self.base.mode

    @property
    def mean(self):
        return self.base.mean


class Categorical(Distribution):
    """Integer-valued categorical over the last axis of ``logits``."""

    def __init__(self, logits: torch.Tensor):
        self.logits = torch.log_softmax(logits.float(), dim=-1)

    @property
    def probs(self):
        return torch.exp(self.logits)

    def _draw(self, noise, generator):
        if noise is None:
            noise = gumbel_noise(self.logits.shape, generator, self.logits.device)
        return torch.argmax(self.logits + noise, dim=-1)

    def sample(self, noise=None, generator=None):
        return self._draw(noise, generator)

    def log_prob(self, value):
        return torch.gather(self.logits, -1, value.long()[..., None])[..., 0]

    def entropy(self):
        return -(self.probs * self.logits).sum(-1)

    @property
    def mode(self):
        return torch.argmax(self.logits, dim=-1)


class OneHotCategorical(Categorical):
    def sample(self, noise=None, generator=None):
        idx = self._draw(noise, generator)
        return F.one_hot(idx, self.logits.shape[-1]).to(self.logits.dtype)

    def log_prob(self, value):
        return (value * self.logits).sum(-1)

    @property
    def mode(self):
        return F.one_hot(torch.argmax(self.logits, dim=-1), self.logits.shape[-1]).to(self.logits.dtype)

    @property
    def mean(self):
        return self.probs


class OneHotCategoricalStraightThrough(OneHotCategorical):
    """One-hot sample with straight-through gradients to ``probs`` — the
    discrete-RSSM sampler."""

    def rsample(self, noise=None, generator=None):
        sample = self.sample(noise, generator).detach()
        probs = self.probs
        return sample + probs - probs.detach()


class Bernoulli(Distribution):
    def __init__(self, logits: torch.Tensor):
        self.logits = logits.float()

    @property
    def probs(self):
        return torch.sigmoid(self.logits)

    def sample(self, noise=None, generator=None):
        if noise is None:
            noise = torch.rand(self.logits.shape, generator=generator, device=self.logits.device)
        return (noise < self.probs).float()

    def log_prob(self, value):
        l = self.logits
        return -(torch.clamp_min(l, 0) - l * value + torch.log1p(torch.exp(-torch.abs(l))))

    def entropy(self):
        p = self.probs
        return -(p * torch.log(p.clamp_min(1e-12)) + (1 - p) * torch.log((1 - p).clamp_min(1e-12)))

    @property
    def mean(self):
        return self.probs

    @property
    def mode(self):
        return (self.probs > 0.5).float()


class BernoulliSafeMode(Bernoulli):
    """Bernoulli whose mode is well-defined at p=0.5."""


class SymlogDistribution(Distribution):
    """log_prob is ``-|symlog(x) - mode|^p`` summed (or averaged) over the
    last ``dims`` axes; the DV3 vector-obs decoder."""

    def __init__(self, mode: torch.Tensor, dims: int = 1, dist: str = "mse", agg: str = "sum"):
        self._mode = mode.float()
        self._dims = tuple(range(-dims, 0))
        self._dist = dist
        self._agg = agg

    @property
    def mode(self):
        return symexp(self._mode)

    @property
    def mean(self):
        return symexp(self._mode)

    def log_prob(self, value):
        if self._mode.dim() != value.dim():
            raise ValueError(f"shape mismatch {tuple(self._mode.shape)} vs {tuple(value.shape)}")
        if self._dist == "mse":
            distance = (self._mode - symlog(value)) ** 2
        elif self._dist == "abs":
            distance = torch.abs(self._mode - symlog(value))
        else:
            raise NotImplementedError(self._dist)
        loss = distance.mean(self._dims) if self._agg == "mean" else distance.sum(self._dims)
        return -loss

    def sample(self, noise=None, generator=None):
        return self.mode


class MSEDistribution(Distribution):
    """``-MSE`` log_prob over the last ``dims`` axes; the DV3 image decoder."""

    def __init__(self, mode: torch.Tensor, dims: int = 3, agg: str = "sum"):
        self._mode = mode.float()
        self._dims = tuple(range(-dims, 0))
        self._agg = agg

    @property
    def mode(self):
        return self._mode

    @property
    def mean(self):
        return self._mode

    def log_prob(self, value):
        distance = (self._mode - value) ** 2
        loss = distance.mean(self._dims) if self._agg == "mean" else distance.sum(self._dims)
        return -loss

    def sample(self, noise=None, generator=None):
        return self._mode


def _linspace(low: float, high: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace`` in float32: low·(1-s) + high·s with s = i/(num-1), so
    the two-hot support rounds exactly as in the JAX package."""
    s = torch.arange(num, dtype=torch.float32, device=device) / float(num - 1)
    out = low * (1 - s) + high * s
    out[-1] = high
    return out


class TwoHotEncodingDistribution(Distribution):
    """Two-hot categorical over a symexp-spaced support — the DV3 reward and
    critic heads. ``log_prob(x) = sum(two_hot(x) * log_softmax(logits))``."""

    def __init__(self, logits: torch.Tensor, dims: int = 1, low: float = -20.0, high: float = 20.0):
        self.logits = logits.float()
        self._dims = tuple(range(-dims, 0))
        self.bins = symexp(_linspace(low, high, self.logits.shape[-1], self.logits.device))
        self.low, self.high = low, high

    @property
    def probs(self):
        return torch.softmax(self.logits, dim=-1)

    @property
    def mean(self):
        return (self.probs * self.bins).sum(-1, keepdim=True)

    @property
    def mode(self):
        return self.mean

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        nbins = self.logits.shape[-1]
        below = (self.bins <= x).to(torch.int64).sum(-1) - 1
        above = nbins - (self.bins > x).to(torch.int64).sum(-1)
        below = below.clamp(0, nbins - 1)
        above = above.clamp(0, nbins - 1)
        equal = below == above
        one = torch.ones_like(x[..., 0])
        dist_to_below = torch.where(equal, one, torch.abs(self.bins[below] - x[..., 0]))
        dist_to_above = torch.where(equal, one, torch.abs(self.bins[above] - x[..., 0]))
        total = dist_to_below + dist_to_above
        w_below = dist_to_above / total
        w_above = dist_to_below / total
        target = (
            F.one_hot(below, nbins).float() * w_below[..., None]
            + F.one_hot(above, nbins).float() * w_above[..., None]
        )
        log_pred = self.logits - torch.logsumexp(self.logits, dim=-1, keepdim=True)
        dims = self._dims + (-1,) if len(self._dims) > 1 else -1
        return (target * log_pred).sum(dims)

    def sample(self, noise=None, generator=None):
        return self.mean


CONST_SQRT_2 = math.sqrt(2)
CONST_INV_SQRT_2PI = 1 / math.sqrt(2 * math.pi)
CONST_INV_SQRT_2 = 1 / math.sqrt(2)
CONST_LOG_INV_SQRT_2PI = math.log(CONST_INV_SQRT_2PI)
CONST_LOG_SQRT_2PI_E = 0.5 * math.log(2 * math.pi * math.e)
F32_EPS = float(torch.finfo(torch.float32).eps)


def truncnorm_uniform(shape, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """The uniform a truncated-normal draw inverts: ``[eps, 1 - eps)`` in
    float32, as the JAX package draws it (``jax.random.uniform`` with
    ``minval=eps, maxval=1-eps``)."""
    u = torch.rand(shape, generator=generator, device=device)
    return torch.clamp_min(u * (1 - 2 * F32_EPS) + F32_EPS, F32_EPS)


class TruncatedStandardNormal(Distribution):
    """The standard normal truncated to ``[a, b]``; ``rsample`` is the
    inverse CDF of a uniform in ``[eps, 1 - eps]`` clipped to ``[a, b]``
    (differentiable in ``a`` and ``b``). ``_Z``, the mass inside, is clipped
    at 1e-8."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        self.a = torch.as_tensor(a).float()
        self.b = torch.as_tensor(b).float()
        self._little_phi_a = self._little_phi(self.a)
        self._little_phi_b = self._little_phi(self.b)
        self._big_phi_a = self._big_phi(self.a)
        self._big_phi_b = self._big_phi(self.b)
        self._Z = torch.clamp_min(self._big_phi_b - self._big_phi_a, 1e-8)
        self._log_Z = torch.log(self._Z)
        self._lpbb_m_lpaa_d_Z = (self._little_phi_b * self.b - self._little_phi_a * self.a) / self._Z

    @staticmethod
    def _little_phi(x):
        return torch.exp(-0.5 * x * x) * CONST_INV_SQRT_2PI

    @staticmethod
    def _big_phi(x):
        return 0.5 * (1 + torch.erf(x * CONST_INV_SQRT_2))

    @staticmethod
    def _inv_big_phi(x):
        return CONST_SQRT_2 * torch.erfinv(2 * x - 1)

    @property
    def mean(self):
        return -(self._little_phi_b - self._little_phi_a) / self._Z

    @property
    def mode(self):
        return torch.clamp(torch.zeros_like(self.a), self.a, self.b)

    @property
    def variance(self):
        return 1 - self._lpbb_m_lpaa_d_Z - ((self._little_phi_b - self._little_phi_a) / self._Z) ** 2

    def entropy(self):
        return CONST_LOG_SQRT_2PI_E + self._log_Z - 0.5 * self._lpbb_m_lpaa_d_Z

    def cdf(self, value):
        return torch.clamp((self._big_phi(value) - self._big_phi_a) / self._Z, 0, 1)

    def _std_icdf(self, value):
        return self._inv_big_phi(self._big_phi_a + value * self._Z)

    def icdf(self, value):
        return self._std_icdf(value)

    def log_prob(self, value):
        return CONST_LOG_INV_SQRT_2PI - self._log_Z - 0.5 * value**2

    def sample(self, noise=None, generator=None):
        if noise is None:
            noise = truncnorm_uniform(torch.broadcast_shapes(self.a.shape, self.b.shape), generator, self.a.device)
        return torch.clamp(self._std_icdf(noise), self.a, self.b)


class TruncatedNormal(TruncatedStandardNormal):
    """``loc + scale · TruncatedStandardNormal((a-loc)/scale, (b-loc)/scale)``:
    the DreamerV1/V2 continuous actor's default (``trunc_normal``)."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, a: float = -1.0, b: float = 1.0):
        self.loc = loc.float()
        self.scale = scale.float()
        super().__init__((a - self.loc) / self.scale, (b - self.loc) / self.scale)
        self._raw_a, self._raw_b = a, b

    def _to_std(self, value):
        return (value - self.loc) / self.scale

    def _from_std(self, value):
        return value * self.scale + self.loc

    @property
    def mean(self):
        return self._from_std(super().mean)

    @property
    def mode(self):
        return torch.clamp(self.loc, self._raw_a, self._raw_b)

    @property
    def variance(self):
        return super().variance * self.scale**2

    def entropy(self):
        return super().entropy() + torch.log(self.scale) * torch.ones_like(self.loc)

    def log_prob(self, value):
        return super().log_prob(self._to_std(value)) - torch.log(self.scale)

    def sample(self, noise=None, generator=None):
        return self._from_std(super().sample(noise, generator))

    def cdf(self, value):
        return super().cdf(self._to_std(value))

    def icdf(self, value):
        return self._from_std(super().icdf(value))


class TanhNormal(Distribution):
    """``tanh`` of a Normal (the DreamerV1/V2 ``tanh_normal`` actor):
    ``log_prob`` clips to ±(1 - 1e-6) before ``atanh``; the entropy has no
    closed form and raises ``NotImplementedError`` (the actor loss then
    takes zeros, as the JAX package does)."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.base = Normal(loc, scale)

    def sample(self, noise=None, generator=None):
        return torch.tanh(self.base.sample(noise, generator))

    def log_prob(self, value):
        eps = 1e-6
        clipped = torch.clamp(value, -1 + eps, 1 - eps)
        return self.base.log_prob(torch.atanh(clipped)) - torch.log1p(-clipped**2)

    @property
    def mode(self):
        return torch.tanh(self.base.loc)

    @property
    def mean(self):
        return torch.tanh(self.base.loc)


def kl_divergence(p: Distribution, q: Distribution) -> torch.Tensor:
    """KL(p || q) for the pairs the Dreamer losses need: categorical pairs
    and (DreamerV1's Gaussian state) normal pairs, under ``Independent``."""
    if isinstance(p, Independent) and isinstance(q, Independent):
        return p._reduce(kl_divergence(p.base, q.base))
    if isinstance(p, Independent):
        return p._reduce(kl_divergence(p.base, q))
    if isinstance(q, Independent):
        return q._reduce(kl_divergence(p, q.base))
    if isinstance(p, Normal) and isinstance(q, Normal):
        var_ratio = (p.scale / q.scale) ** 2
        t1 = ((p.loc - q.loc) / q.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))
    if isinstance(p, Categorical) and isinstance(q, Categorical):
        return (p.probs * (p.logits - q.logits)).sum(-1)
    raise NotImplementedError(f"KL not implemented for {type(p)} / {type(q)}")
