"""The LN-GRU sequence of the PyTorch port against the JAX package's Pallas
kernel (run in interpret mode) and its reference scan — the counterparts of
the eight tests of tests/test_pallas_gru.py. The kernels themselves are held
against these plain passes on the card by tests/test_torch_ln_gru_cuda.py.

Tolerances: rtol = atol = 1e-5 for hidden states, 1e-4 for gradients (f32
sums over F+H and over T·B rows taken in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import pallas_gru as pg
from sheeprl_tpu_torch.ops import ln_gru

T, B, F, H = 6, 4, 16, 8
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed=0, batched_hfirst=False):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((T, B, F)).astype(np.float32)
    first = np.zeros((T, B, 1), np.float32)
    first[0] = 1.0
    first[3, 1] = 1.0
    hshape = (B, H) if batched_hfirst else (H,)
    h_first = (0.5 * rng.standard_normal(hshape)).astype(np.float32)
    w = (rng.standard_normal((F + H, 3 * H)) / np.sqrt(F + H)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(3 * H)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(3 * H)).astype(np.float32)
    return feats, first, h_first, w, scale, bias


def _torch(args, grad=()):
    out = []
    for i, a in enumerate(args):
        t = torch.from_numpy(a.copy())
        out.append(t.requires_grad_(i in grad))
    return out


def test_forward_parity_with_jax_kernel():
    args = _inputs()
    ref = np.asarray(pg.gru_sequence(*map(jnp.asarray, args), True))
    out = ln_gru.gru_sequence(*_torch(args))
    assert out.shape == (T, B, H)
    np.testing.assert_allclose(out.numpy(), ref, **FWD_TOL)


def test_is_first_resets_are_honored():
    feats, first, h_first, w, scale, bias = _inputs()
    out = ln_gru.gru_sequence(*_torch((feats, first, h_first, w, scale, bias)))
    # env 1 resets at t=3: its state there is a fresh one-step rollout from
    # h_first, whatever it saw before — in both packages
    fresh = ln_gru.reference_sequence(
        *_torch((feats[3:4, 1:2], np.ones((1, 1, 1), np.float32), h_first, w, scale, bias))
    )
    np.testing.assert_allclose(out[3, 1].numpy(), fresh[0, 0].numpy(), **FWD_TOL)
    jfresh = pg.reference_sequence(
        jnp.asarray(feats[3:4, 1:2]), jnp.ones((1, 1, 1)), *map(jnp.asarray, (h_first, w, scale, bias))
    )
    np.testing.assert_allclose(out[3, 1].numpy(), np.asarray(jfresh[0, 0]), **FWD_TOL)


def test_gradient_parity_with_jax_kernel():
    args = _inputs(1)
    ja = list(map(jnp.asarray, args))

    def loss(feats, w, scale, bias):
        return jnp.sum(pg.gru_sequence(feats, ja[1], ja[2], w, scale, bias, True) ** 2)

    jg = jax.grad(loss, argnums=(0, 1, 2, 3))(ja[0], ja[3], ja[4], ja[5])
    ta = _torch(args, grad=(0, 3, 4, 5))
    (ln_gru.gru_sequence(*ta) ** 2).sum().backward()
    for t, j in zip((ta[0], ta[3], ta[4], ta[5]), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **GRAD_TOL)


def test_fits_smem_guard():
    assert ln_gru.fits_smem(512, 512)  # DreamerV3-S: 22 KB forward, 40 KB backward
    assert ln_gru.fits_smem(1024, 4096)  # XL: the backward's rows take 224 KB of 227
    assert not ln_gru.fits_smem(2048, 8192)
    assert not ln_gru.fits_smem(512, 510)  # W's rows are read as float4


def test_transposed_weight_view_matches_contiguous():
    """The train step passes ``fused.weight.t()`` (a strided view); the
    wrapper takes it like a contiguous [F+H, 3H] matrix, gradient included."""
    args = _inputs(2)
    ta = _torch(args)
    w_t = torch.from_numpy(np.ascontiguousarray(args[3].T)).requires_grad_(True)
    out_view = ln_gru.gru_sequence(ta[0], ta[1], ta[2], w_t.t(), ta[4], ta[5])
    out_cont = ln_gru.gru_sequence(*ta)
    assert torch.isfinite(out_view).all()
    np.testing.assert_array_equal(out_view.detach().numpy(), out_cont.numpy())
    out_view.sum().backward()
    wc = torch.from_numpy(args[3].copy()).requires_grad_(True)
    ln_gru.gru_sequence(ta[0], ta[1], ta[2], wc, ta[4], ta[5]).sum().backward()
    np.testing.assert_allclose(w_t.grad.numpy(), wc.grad.numpy().T, rtol=1e-6, atol=1e-6)


def test_decoupled_train_paths_agree():
    """The port's decoupled world model with the LN-GRU sequence (plain
    passes on the CPU) matches its step-by-step decoupled scan: same params,
    batch and noise → same losses."""
    from test_torch_dreamer_v3 import torch_burst

    base = ["algo.world_model.decoupled_rssm=True"]
    ref = torch_burst(base)[0]
    seq = torch_burst(base + ["algo.world_model.pallas_gru=True"])[0]
    for k in ("Loss/world_model_loss", "State/kl", "Loss/reward_loss"):
        assert ref[k] == pytest.approx(seq[k], rel=1e-4), (k, ref[k], seq[k])


@pytest.mark.parametrize("batched", [False, True], ids=["hfirst_H", "hfirst_BH"])
def test_hfirst_gradient_parity(batched):
    """Reset masks route carry cotangents into h_first; the reverse sweep
    accumulates them like the JAX kernel, incl. the [H] broadcast reduction."""
    args = _inputs(3 + batched, batched_hfirst=batched)
    ja = list(map(jnp.asarray, args))
    jg = jax.grad(lambda hf: jnp.sum(pg.gru_sequence(ja[0], ja[1], hf, *ja[3:], True) ** 2))(ja[2])
    ta = _torch(args, grad=(2,))
    (ln_gru.gru_sequence(*ta) ** 2).sum().backward()
    assert ta[2].grad.shape == ((B, H) if batched else (H,))
    np.testing.assert_allclose(ta[2].grad.numpy(), np.asarray(jg), **GRAD_TOL)


def test_plain_passes_match_autograd_reference():
    """The plain reverse sweep + weight reduction (the kernels' CPU path)
    equals autograd through the plain forward scan."""
    args = _inputs(5)
    ta = _torch(args, grad=(0, 2, 3, 4, 5))
    (ln_gru.reference_sequence(*ta) ** 3).sum().backward()
    tb = _torch(args, grad=(0, 2, 3, 4, 5))
    (ln_gru.gru_sequence(*tb, plain=True) ** 3).sum().backward()
    for a, b in zip(ta, tb):
        if a.grad is not None:
            np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), rtol=1e-5, atol=1e-5)
