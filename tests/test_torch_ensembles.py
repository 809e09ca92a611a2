"""The port's Plan2Explore ensembles (``models/ensembles.py``, an
``EnsembleMLP``) against the JAX package's ``build_ensembles`` (``n`` flax
MLPs stacked on a leading axis under ``jax.vmap``): the same stacked
parameters give the same outputs, for n = 1 and n = 8, from inputs with
one and with two leading axes.

Tolerance: atol 1e-5 (float32 products of widths 16-40 summed in another
order; measured with ``PYTHONPATH=. python tests/torch_p2e.py``: 7.2e-7)."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.models import build_ensembles as jax_build_ensembles
from sheeprl_tpu_torch import convert
from sheeprl_tpu_torch.models import EnsembleLinear, EnsembleMLP, apply_ensembles, build_ensembles

ATOL = 1e-5
IN, OUT, UNITS = 40, 12, 16


@pytest.mark.parametrize("n,layers,act", [(1, 2, "silu"), (8, 2, "silu"), (8, 1, "elu")])
def test_ensembles_match_the_jax_package(n, layers, act):
    apply, params = jax_build_ensembles(jax.random.PRNGKey(n), n, IN, OUT, layers, UNITS, act)
    rng = np.random.default_rng(n)
    # non-zero biases, so a bias in the wrong place shows
    params = jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(np.float32), params)
    ens = build_ensembles(n, IN, OUT, layers, UNITS, act)
    assert isinstance(ens, EnsembleMLP) and ens.n == n
    convert.load_params(params, ens)
    for lead in ((5,), (3, 7)):
        x = rng.standard_normal((*lead, IN)).astype(np.float32)
        want = np.asarray(apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
        with torch.no_grad():
            got = apply_ensembles(ens, torch.from_numpy(x)).numpy()
        assert got.shape == (n, *lead, OUT) == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_members_have_their_own_draws_and_no_layer_norm():
    torch.manual_seed(0)
    ens = build_ensembles(8, IN, OUT, 3, UNITS, "silu")
    layers = [m for m in ens.modules() if isinstance(m, EnsembleLinear)]
    assert len(layers) == 4 and not ens.layer_norm
    for layer in layers:
        w = layer.weight.detach()
        assert w.shape[0] == 8 and float(layer.bias.detach().abs().max()) == 0.0
        assert all(not torch.equal(w[0], w[i]) for i in range(1, 8))
        # flax's lecun-normal: a truncated normal of variance 1 / fan_in
        assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1.0) < 0.1
