"""The port's numeric leaves against the JAX package on the same numpy
inputs: transforms, return estimators and the DreamerV3 distributions
(rtol = atol = 1e-5 unless stated)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu import distributions as jd
from sheeprl_tpu.ops import returns as jr
from sheeprl_tpu.ops import transforms as jt
from sheeprl_tpu_torch import distributions as td
from sheeprl_tpu_torch.ops import returns as tr
from sheeprl_tpu_torch.ops import transforms as tt

TOL = dict(rtol=1e-5, atol=1e-5)


def _r(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


@pytest.mark.parametrize("name", ["symlog", "symexp", "unrolled_cumprod"])
def test_transforms(name):
    x = _r((6, 4, 1), scale=3.0) if name != "symexp" else _r((6, 4, 1))
    _close(getattr(tt, name)(torch.from_numpy(x)), getattr(jt, name)(jnp.asarray(x)))


def test_two_hot_round_trip():
    x = _r((5, 1), scale=10.0)
    enc_t, enc_j = tt.two_hot_encoder(torch.from_numpy(x)), jt.two_hot_encoder(jnp.asarray(x))
    _close(enc_t, enc_j, rtol=1e-4, atol=1e-5)
    _close(tt.two_hot_decoder(enc_t), jt.two_hot_decoder(enc_j), rtol=1e-4, atol=1e-4)


def test_lambda_values_gae_nstep():
    T, B = 7, 3
    rew, val, cont = _r((T, B, 1), 1), _r((T, B, 1), 2), (np.random.default_rng(3).random((T, B, 1)) > 0.2).astype(np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    _close(tr.lambda_values(t(rew), t(val), t(cont) * 0.99, 0.95), jr.lambda_values(rew, val, cont * 0.99, 0.95))
    nv = _r((B, 1), 4)
    for a, b in zip(tr.gae(t(rew), t(val), t(1 - cont), t(nv), T, 0.99, 0.95), jr.gae(rew, val, 1 - cont, nv, T, 0.99, 0.95)):
        _close(a, b)
    _close(tr.nstep_returns(t(rew), t(val), t(1 - cont), 0.9), jr.nstep_returns(rew, val, 1 - cont, 0.9))


def test_categorical_family_and_kl():
    logits, other = _r((4, 3, 5), 1), _r((4, 3, 5), 2)
    value = np.eye(5, dtype=np.float32)[np.random.default_rng(3).integers(0, 5, (4, 3))]
    tp = td.Independent(td.OneHotCategoricalStraightThrough(logits=torch.from_numpy(logits)), 1)
    jp = jd.Independent(jd.OneHotCategoricalStraightThrough(logits=jnp.asarray(logits)), 1)
    tq = td.Independent(td.OneHotCategoricalStraightThrough(logits=torch.from_numpy(other)), 1)
    jq = jd.Independent(jd.OneHotCategoricalStraightThrough(logits=jnp.asarray(other)), 1)
    _close(tp.entropy(), jp.entropy())
    _close(tp.log_prob(torch.from_numpy(value)), jp.log_prob(jnp.asarray(value)))
    _close(tp.mode, jp.mode)
    _close(td.kl_divergence(tp, tq), jd.kl_divergence(jp, jq))


def test_categorical_sample_with_jax_gumbel():
    """jax.random.categorical(k, l) == argmax(l + jax.random.gumbel(k, l.shape)):
    the port handed JAX's gumbel draws samples what JAX samples."""
    logits = _r((64, 6), 5)
    key = jax.random.key(3)
    j = jd.OneHotCategoricalStraightThrough(logits=jnp.asarray(logits)).rsample(key)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, logits.shape)))
    t = td.OneHotCategoricalStraightThrough(logits=torch.from_numpy(logits)).rsample(noise)
    _close(t, j, atol=1e-6)


def test_two_hot_distribution():
    logits = _r((6, 255), 6)
    x = _r((6, 1), 7, scale=50.0)
    t = td.TwoHotEncodingDistribution(torch.from_numpy(logits), dims=1)
    j = jd.TwoHotEncodingDistribution(jnp.asarray(logits), dims=1)
    _close(t.log_prob(torch.from_numpy(x)), j.log_prob(jnp.asarray(x)), rtol=1e-4, atol=1e-4)
    _close(t.mean, j.mean, rtol=1e-4, atol=1e-2)


def test_bernoulli_normal_mse_symlog():
    logits, y = _r((5, 1), 8), (np.random.default_rng(9).random((5, 1)) > 0.5).astype(np.float32)
    tb, jb = td.BernoulliSafeMode(torch.from_numpy(logits)), jd.BernoulliSafeMode(jnp.asarray(logits))
    _close(tb.log_prob(torch.from_numpy(y)), jb.log_prob(jnp.asarray(y)))
    _close(tb.mode, jb.mode)
    _close(tb.entropy(), jb.entropy())
    loc, scale, v = _r((5, 2), 10), np.abs(_r((5, 2), 11)) + 0.1, _r((5, 2), 12)
    tn, jn = td.Normal(torch.from_numpy(loc), torch.from_numpy(scale)), jd.Normal(jnp.asarray(loc), jnp.asarray(scale))
    _close(tn.log_prob(torch.from_numpy(v)), jn.log_prob(jnp.asarray(v)))
    _close(tn.entropy(), jn.entropy())
    tn2, jn2 = td.Normal(torch.from_numpy(v), torch.from_numpy(scale)), jd.Normal(jnp.asarray(v), jnp.asarray(scale))
    _close(td.kl_divergence(tn, tn2), jd.kl_divergence(jn, jn2))
    mode, obs = _r((2, 3, 4, 4, 3), 13), _r((2, 3, 4, 4, 3), 14)
    _close(td.MSEDistribution(torch.from_numpy(mode), dims=3).log_prob(torch.from_numpy(obs)),
           jd.MSEDistribution(jnp.asarray(mode), dims=3).log_prob(jnp.asarray(obs)), rtol=1e-5, atol=1e-4)
    _close(td.SymlogDistribution(torch.from_numpy(mode), dims=1).log_prob(torch.from_numpy(obs)),
           jd.SymlogDistribution(jnp.asarray(mode), dims=1).log_prob(jnp.asarray(obs)))
