"""Per-module parity through sheeprl_tpu_torch.convert: each flax module of
the JAX package and its PyTorch counterpart give the same outputs on the
same numpy inputs once the flax parameters are converted (rtol = atol =
1e-5, f32), and one clipped Adam update moves the parameters alike."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jagent
from sheeprl_tpu.models import LayerNorm as JLayerNorm
from sheeprl_tpu.models import LayerNormGRUCell as JGRUCell
from sheeprl_tpu.optim import adam as jadam
from sheeprl_tpu.optim import clipped as jclipped
from sheeprl_tpu_torch import convert
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tagent
from sheeprl_tpu_torch.models import LayerNorm, LayerNormGRUCell
from sheeprl_tpu_torch.optim import adam, clipped

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _perturb(params, seed=1):
    """Random values for every leaf (LN scales and biases included), so a
    mapping that swapped or dropped a leaf cannot pass."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(x.shape)).astype(np.float32), params)


def _jax_and_torch(jmod, tmod, *inputs, method=None):
    params = _perturb(jmod.init(jax.random.key(0), *map(jnp.asarray, inputs))["params"])
    jout = jmod.apply({"params": params}, *map(jnp.asarray, inputs), method=method)
    convert.load_params(params, tmod)
    with torch.no_grad():
        tout = tmod(*[torch.from_numpy(x) for x in inputs])
    return jout, tout


def test_dense():
    x = _rand((3, 7))
    jout, tout = _jax_and_torch(fnn.Dense(5), torch.nn.Linear(7, 5), x)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_conv_4x4_stride2():
    x = _rand((2, 16, 16, 3))
    jmod = fnn.Conv(4, (4, 4), strides=(2, 2), padding=((1, 1), (1, 1)), use_bias=False)
    conv = torch.nn.Conv2d(3, 4, 4, stride=2, padding=1, bias=False)
    params = _perturb(jmod.init(jax.random.key(0), jnp.asarray(x))["params"])
    jout = jmod.apply({"params": params}, jnp.asarray(x))
    convert.load_params(params, conv)
    with torch.no_grad():
        tout = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("flip", [False, True], ids=["axis_swap", "with_flip"])
def test_conv_transpose_maps_by_axis_swap_alone(flip):
    """flax ConvTranspose(transpose_kernel=True, padding 2) ≡ torch
    ConvTranspose2d(k4, s2, p1) with the kernel's axes swapped; a spatial
    flip on top breaks it."""
    x = _rand((2, 4, 4, 16))
    jmod = fnn.ConvTranspose(8, (4, 4), strides=(2, 2), padding=((2, 2), (2, 2)), use_bias=False,
                             transpose_kernel=True)
    params = _perturb(jmod.init(jax.random.key(0), jnp.asarray(x))["params"])
    jout = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    ct = torch.nn.ConvTranspose2d(16, 8, 4, stride=2, padding=1, bias=False)
    convert.load_params(params, ct)
    if flip:
        with torch.no_grad():
            ct.weight.copy_(ct.weight.flip(-1, -2))
    with torch.no_grad():
        tout = ct(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.allclose(tout, jout, **TOL) is (not flip)


def test_layer_norm_eps_1e3():
    """The JAX package's LayerNorm wraps flax's (``LayerNorm_k/LayerNorm_0``);
    the port's holds weight and bias itself (``LayerNorm_k``)."""
    x = _rand((4, 9), scale=3.0)
    jln = JLayerNorm(eps=1e-3)
    params = _perturb(jln.init(jax.random.key(0), jnp.asarray(x))["params"])
    jout = jln.apply({"params": params}, jnp.asarray(x))
    parent = torch.nn.Module()
    parent.LayerNorm_0 = LayerNorm(9, eps=1e-3)
    convert.load_params({"LayerNorm_0": params}, parent)
    with torch.no_grad():
        tout = parent.LayerNorm_0(torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_layer_norm_gru_cell():
    h, x = _rand((3, 8), 1), _rand((3, 5), 2)
    jcell = JGRUCell(8)
    params = _perturb(jcell.init(jax.random.key(0), jnp.asarray(h), jnp.asarray(x))["params"])
    jnew, _ = jcell.apply({"params": params}, jnp.asarray(h), jnp.asarray(x))
    tcell = LayerNormGRUCell(5, 8)
    convert.load_params(params, tcell)
    with torch.no_grad():
        tnew = tcell(torch.from_numpy(h), torch.from_numpy(x))
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), **TOL)


def _obs(lead=(2, 3)):
    rng = np.random.default_rng(4)
    return {
        "rgb": (rng.integers(0, 255, (*lead, 64, 64, 3)) / 255.0 - 0.5).astype(np.float32),
        "state": rng.standard_normal((*lead, 10)).astype(np.float32),
    }


def test_dv3_encoder():
    obs = _obs()
    jenc = jagent.DV3Encoder(("rgb",), ("state",), cnn_channels_multiplier=2, mlp_layers=2, dense_units=16,
                             conv_impl="xla")
    params = _perturb(jenc.init(jax.random.key(0), jax.tree.map(jnp.asarray, obs))["params"])
    jout = jenc.apply({"params": params}, jax.tree.map(jnp.asarray, obs))
    tenc = tagent.DV3Encoder(("rgb",), ("state",), cnn_in_channels=3, mlp_input_dim=10, image_size=64,
                             cnn_channels_multiplier=2, mlp_layers=2, dense_units=16)
    convert.load_params(params, tenc)
    with torch.no_grad():
        tout = tenc({k: torch.from_numpy(v) for k, v in obs.items()})
    assert tout.shape == jout.shape == (2, 3, tenc.output_dim)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_dv3_decoder():
    latent = _rand((2, 3, 24), 5)
    jdec = jagent.DV3Decoder(("rgb",), ("state",), [3], [10], cnn_channels_multiplier=2, image_size=(64, 64),
                             mlp_layers=2, dense_units=16, conv_impl="xla")
    params = _perturb(jdec.init(jax.random.key(0), jnp.asarray(latent))["params"])
    jout = jdec.apply({"params": params}, jnp.asarray(latent))
    tdec = tagent.DV3Decoder(("rgb",), ("state",), [3], [10], latent_size=24, cnn_channels_multiplier=2,
                             image_size=(64, 64), mlp_layers=2, dense_units=16)
    convert.load_params(params, tdec)
    with torch.no_grad():
        tout = tdec(torch.from_numpy(latent))
    for k in ("rgb", "state"):
        assert tout[k].shape == jout[k].shape
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), **TOL)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clipped", "unclipped"])
def test_adam_update_after_global_norm_clip(max_norm):
    """optax chain(clip_by_global_norm, adam) and the port's clipped Adam
    make the same first update, whether or not the clip fires (eps outside
    the square root in both)."""
    w0, b0 = _rand((4, 3), 6), _rand((3,), 7)
    gw, gb = _rand((4, 3), 8, scale=2.0), _rand((3,), 9, scale=2.0)
    tx = jclipped(jadam(lr=1e-2, eps=1e-5), max_norm)
    params = {"Dense_0": {"kernel": jnp.asarray(w0), "bias": jnp.asarray(b0)}}
    grads = {"Dense_0": {"kernel": jnp.asarray(gw), "bias": jnp.asarray(gb)}}
    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    import optax

    new = optax.apply_updates(params, updates)

    lin = torch.nn.Sequential()
    lin.add_module("Dense_0", torch.nn.Linear(4, 3))
    convert.load_params(jax.tree.map(np.asarray, params), lin)
    opt = clipped(adam(list(lin.parameters()), lr=1e-2, eps=1e-5), max_norm)
    lin.Dense_0.weight.grad = torch.from_numpy(gw.T.copy())
    lin.Dense_0.bias.grad = torch.from_numpy(gb.copy())
    opt.step()
    expect = convert.params_to_state_dict(jax.tree.map(np.asarray, new), lin)
    for name, value in lin.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expect[name].numpy(), rtol=1e-6, atol=1e-7)
