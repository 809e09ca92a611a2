"""The LN-GRU sequence of the PyTorch port against the JAX package's Pallas
kernel (run in interpret mode) and its reference scan — the counterparts of
the eight tests of tests/test_pallas_gru.py — and the recurrent kernels'
cluster algorithm, emulated CTA by CTA, against the same JAX reference. The
kernels themselves are held against the plain passes on the card by
tests/test_torch_ln_gru_cuda.py.

Tolerances: rtol = atol = 1e-5 for hidden states, 1e-4 for gradients (f32
sums over F+H and over T·B rows taken in different orders)."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
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
    """The fit rule of the two instances: the resident one takes H that
    splits into at most 16 CTAs of 4, 8, 16 or 32 units whose W_h slice and
    buffers fit 227 KB (DreamerV3-XS and S, the presets the JAX kernel
    takes); the streamed one takes H that splits into 16 CTAs of a multiple
    of 8 units, at most 256 (DreamerV3-M, L and XL, which the JAX kernel's
    VMEM budget refuses); F is a multiple of 4. Any other H is refused."""
    assert ln_gru.cluster_split(512) == (16, 32)  # DreamerV3-S: 16 CTAs x 32 units
    assert ln_gru.cluster_split(256) == (16, 16)  # XS
    assert ln_gru.cluster_split(8) == (1, 8)  # a warp covers 8 units x 4 rows
    assert ln_gru.smem_bytes(512) == (218112, 208896)  # what a DreamerV3-S launch requests
    assert f"-DLN_GRU_ROWS={ln_gru.ROWS_PER_CLUSTER}" in ln_gru.NVCC_FLAGS  # the build takes this layout
    assert f"-DLN_GRU_STREAM_STAGES={ln_gru.STREAM_STAGES}" in ln_gru.NVCC_FLAGS
    for F, H in ((256, 256), (512, 512)):  # the presets the JAX kernel takes
        assert pg.fits_vmem(F, H) and ln_gru.fits_smem(F, H)
        assert ln_gru.launch_layout(H)[0] == "resident"
    # M, L, XL: 16 CTAs of H/16 units, W_h tiles of 32, 16, 8 rows; what each launch requests
    streamed = {(640, 1024): (64, 32, (133648, 124416)), (768, 2048): (128, 16, (152080, 145920)),
                (1024, 4096): (256, 8, (188944, 188928))}
    for (F, H), (units, kt, smem) in streamed.items():
        assert not pg.fits_vmem(F, H)  # the JAX package prints UNUSED and runs its scan there
        assert ln_gru.fits_smem(F, H)
        assert ln_gru.launch_layout(H) == ("streamed", 16, units, kt, smem)
        assert ln_gru.smem_bytes(H) == smem and max(smem) <= 227 * 1024
    assert ln_gru.launch_layout(640) == ("streamed", 16, 40, 32, (89104, 79488))  # 40 units: uneven k-groups
    assert not ln_gru.fits_smem(640, 520)  # 16 slices of 32.5 units
    assert not ln_gru.fits_smem(640, 1040)  # 16 slices of 65 units, not a multiple of 8
    assert not ln_gru.fits_smem(640, 8192)  # 512 units a CTA: more than one a thread
    assert not ln_gru.fits_smem(512, 510)  # no whole slices
    assert not ln_gru.fits_smem(12, 12)
    assert not ln_gru.fits_smem(510, 512)  # x is copied as float4
    assert not ln_gru.fits_smem(642, 1024)


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


EMU = dict(T=5, B=3, F=24, H=32)


def _emu_inputs(seed):
    """Mid-sequence resets in every row but one; h_first [B, H]."""
    T, B, F, H = EMU.values()
    rng = np.random.default_rng(seed)
    first = np.zeros((T, B, 1), np.float32)
    first[0] = 1.0
    first[2, 1] = 1.0
    first[3, 0] = 1.0
    return (
        rng.standard_normal((T, B, F)).astype(np.float32),
        first,
        (0.5 * rng.standard_normal((B, H))).astype(np.float32),
        (rng.standard_normal((F + H, 3 * H)) / np.sqrt(F + H)).astype(np.float32),
        (1.0 + 0.1 * rng.standard_normal(3 * H)).astype(np.float32),
        (0.1 * rng.standard_normal(3 * H)).astype(np.float32),
        rng.standard_normal((T, B, H)).astype(np.float32),
    )


@pytest.mark.parametrize("n_cta", [4, 16])
def test_cluster_forward_emulation_matches_jax(n_cta):
    """The recurrent kernel's decomposition — Gx out of the loop, gate-column
    slices per CTA, Chan-combined LN statistics — gives the JAX reference's
    hidden states, and the yn/istd it saves are the plain forward's."""
    args = _emu_inputs(8)[:6]
    ref = np.asarray(pg.reference_sequence(*map(jnp.asarray, args)))
    ta = _torch(args)
    hs, yn, istd = ln_gru.forward_cluster_emulated(*ta, n_cta)
    np.testing.assert_allclose(hs.numpy(), ref, **FWD_TOL)
    F = EMU["F"]
    gx = ln_gru.xproj_plain(ta[0].reshape(-1, F), ta[3][:F]).reshape(EMU["T"], EMU["B"], -1)
    _, yn_p, istd_p = ln_gru.forward_plain(gx, ta[1], ta[2], ta[3][F:], ta[4], ta[5])
    np.testing.assert_allclose(yn.numpy(), yn_p.numpy(), **FWD_TOL)
    np.testing.assert_allclose(istd.numpy(), istd_p.numpy(), **FWD_TOL)


@pytest.mark.parametrize("n_cta", [4, 16])
def test_cluster_backward_emulation_matches_jax_vjp(n_cta):
    """The reverse sweep's decomposition — cell backward from the saved yn
    (no recompute), LN row sums over the CTAs, per-CTA partial dh_in and the
    fixed-order reduce-scatter, dfeats after the loop — gives the five
    gradients of the JAX reference's VJP."""
    args = _emu_inputs(9)
    ja = list(map(jnp.asarray, args))
    _, vjp = jax.vjp(
        lambda feats, hf, w, scale, bias: pg.reference_sequence(feats, ja[1], hf, w, scale, bias),
        ja[0], ja[2], ja[3], ja[4], ja[5],
    )
    want = vjp(ja[6])
    feats, first, h_first, w, scale, bias, g = _torch(args)
    hs, yn, istd = ln_gru.forward_cluster_emulated(feats, first, h_first, w, scale, bias, n_cta)
    got = ln_gru.backward_cluster_emulated(feats, first, hs, h_first, w, scale, bias, g, yn, istd, n_cta)
    for name, a, b in zip(("dfeats", "dh_first", "dW", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)


def test_3xtf32_gemms_through_plain_recurrence_match_jax():
    """The GEMM kernels' arithmetic (``matmul_3xtf32``: Gx = x·W_x and
    dfeats = dy_raw·W_xᵀ in 3xTF32; ``wgrad_3xtf32``: dW = xhᵀ·dy_raw in
    3xTF32 and the column sums in partials over row ranges) with the plain
    recurrence and reverse sweep between them gives the JAX package's
    gru_sequence forward and VJP at the f32 tolerances."""
    args = _inputs(6, batched_hfirst=True)
    ja = list(map(jnp.asarray, args))
    hs_j, vjp = jax.vjp(lambda feats, hf, w, scale, bias: pg.gru_sequence(feats, ja[1], hf, w, scale, bias, True),
                        ja[0], ja[2], ja[3], ja[4], ja[5])
    cot = np.random.default_rng(16).standard_normal((T, B, H)).astype(np.float32)
    want = vjp(jnp.asarray(cot))
    feats, first, h_first, w, scale, bias = _torch(args)
    M = T * B
    gx = ln_gru.matmul_3xtf32(feats.reshape(M, F), w[:F]).reshape(T, B, 3 * H)
    hs, yn, istd = ln_gru.forward_plain(gx, first, h_first, w[F:], scale, bias)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), **FWD_TOL)
    dh_first, dy, dy_raw, xh = ln_gru.backward_plain(feats, first, hs, h_first, w[F:], scale, bias,
                                                     torch.from_numpy(cot), yn, istd)
    dfeats = ln_gru.matmul_3xtf32(dy_raw.reshape(M, -1), w[:F].t()).reshape(T, B, F)
    dw, dscale, dbias = ln_gru.wgrad_3xtf32(xh.reshape(M, -1), dy_raw.reshape(M, -1), dy.reshape(M, -1),
                                            yn.reshape(M, -1), slots=5)  # M = 24 rows in 5 uneven slots
    for name, a, b in zip(("dfeats", "dh_first", "dW", "dscale", "dbias"), (dfeats, dh_first, dw, dscale, dbias), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("slots", [1, 5, 7])
def test_wgrad_3xtf32_emulation_matches_jax_vjp(slots):
    """``ln_gru_wgrad``'s arithmetic alone (``wgrad_3xtf32``: dW in 3xTF32,
    dscale and dbias as partial sums over ``slots`` row ranges added in slot
    order; M = T·B = 24 rows, which 5 and 7 do not divide) on the plain
    reverse sweep's xh, dy_raw, dy and yn gives the JAX VJP's dW, dscale and
    dbias at GRAD_TOL; so does the plain version on the same inputs."""
    args = _inputs(11, batched_hfirst=True)
    ja = list(map(jnp.asarray, args))
    _, vjp = jax.vjp(lambda w, scale, bias: pg.gru_sequence(ja[0], ja[1], ja[2], w, scale, bias, True),
                     ja[3], ja[4], ja[5])
    cot = np.random.default_rng(21).standard_normal((T, B, H)).astype(np.float32)
    want = vjp(jnp.asarray(cot))
    feats, first, h_first, w, scale, bias = _torch(args)
    M = T * B
    gx = ln_gru.xproj_plain(feats.reshape(M, F), w[:F]).reshape(T, B, 3 * H)
    hs, yn, istd = ln_gru.forward_plain(gx, first, h_first, w[F:], scale, bias)
    _, dy, dy_raw, xh = ln_gru.backward_plain(feats, first, hs, h_first, w[F:], scale, bias, torch.from_numpy(cot),
                                              yn, istd)
    ins = (xh.reshape(M, -1), dy_raw.reshape(M, -1), dy.reshape(M, -1), yn.reshape(M, -1))
    got = ln_gru.wgrad_3xtf32(*ins, slots=slots)
    for name, a, b, c in zip(("dW", "dscale", "dbias"), got, ln_gru.wgrad_plain(*ins), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **GRAD_TOL)


def test_hfirst_1d_gradient_is_reduced_by_the_backward():
    """For an [H] h_first the autograd Function's backward itself returns the
    [H] gradient (the sum over the batch of the [B, H] carry cotangent), and
    it equals the gradient of the same state given as an expanded [B, H]
    input within 1e-6."""
    args = _inputs(7)
    ta = _torch(args, grad=(2,))
    out = ln_gru.gru_sequence(*ta)
    cot = torch.from_numpy(np.random.default_rng(17).standard_normal((T, B, H)).astype(np.float32))
    raw = out.grad_fn.apply(cot)  # the backward's own outputs, before autograd fits them to the inputs
    assert raw[2].shape == (H,)
    tb = _torch(args, grad=(2,))
    (ln_gru.gru_sequence(tb[0], tb[1], tb[2].expand(B, H), *tb[3:]) * cot).sum().backward()
    np.testing.assert_allclose(raw[2].detach().numpy(), tb[2].grad.numpy(), rtol=1e-6, atol=1e-6)


# the streamed instance at the DreamerV3-M widths (F=640, H=1024: 16 CTAs of
# 64 units, W_h tiles of 32 rows, 4 k-groups) and at H=640 (40 units: 6
# k-groups that do not split a tile evenly); T and B cut to 3 and 2.
# Tolerance: 2e-5 for hidden states and 1e-4 for gradients, rtol and atol
# (f32 sums over F+H = 1664 terms in other orders than XLA's)
STREAMED = {"M": (3, 2, 640, 1024), "units_40": (3, 2, 64, 640)}
STREAMED_FWD_TOL = dict(rtol=2e-5, atol=2e-5)


def _streamed_inputs(shape, seed):
    T_, B_, F_, H_ = shape
    rng = np.random.default_rng(seed)
    first = np.zeros((T_, B_, 1), np.float32)
    first[0] = 1.0
    first[1, 1] = 1.0
    return (
        rng.standard_normal((T_, B_, F_)).astype(np.float32),
        first,
        (0.5 * rng.standard_normal((B_, H_))).astype(np.float32),
        (rng.standard_normal((F_ + H_, 3 * H_)) / np.sqrt(F_ + H_)).astype(np.float32),
        (1.0 + 0.1 * rng.standard_normal(3 * H_)).astype(np.float32),
        (0.1 * rng.standard_normal(3 * H_)).astype(np.float32),
        rng.standard_normal((T_, B_, H_)).astype(np.float32),
    )


@pytest.mark.parametrize("width", list(STREAMED), ids=list(STREAMED))
def test_streamed_emulation_matches_jax(width):
    """The streamed instance's algorithm (``launch_layout``'s CTAs, units and
    tile rows; the forward's k-groups added in group order, the backward's
    column phases, Chan-combined statistics, the reduce-scatter) against the
    JAX package's ``reference_sequence``: hidden states, and the five
    gradients of sum(hs · g) through ``jax.grad``."""
    shape = STREAMED[width]
    instance, n_cta, _, kt, _ = ln_gru.launch_layout(shape[3])
    assert instance == "streamed"
    args = _streamed_inputs(shape, 12)
    ja = list(map(jnp.asarray, args))
    ref = np.asarray(pg.reference_sequence(*ja[:6]))

    def loss(feats, hf, w, scale, bias):
        return jnp.sum(pg.reference_sequence(feats, ja[1], hf, w, scale, bias) * ja[6])

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(ja[0], ja[2], ja[3], ja[4], ja[5])
    feats, first, h_first, w, scale, bias, g = _torch(args)
    hs, yn, istd = ln_gru.forward_cluster_emulated(feats, first, h_first, w, scale, bias, n_cta, kt)
    np.testing.assert_allclose(hs.numpy(), ref, **STREAMED_FWD_TOL)
    got = ln_gru.backward_cluster_emulated(feats, first, hs, h_first, w, scale, bias, g, yn, istd, n_cta, kt)
    for name, a, b in zip(("dfeats", "dh_first", "dW", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)


def test_presets_above_the_resident_limit_take_the_streamed_kernels():
    """``decoupled_rssm=True pallas_gru=True`` at the M, L and XL presets:
    the GRU shape the train step checks (recurrent dense units, recurrent
    state size) is one the kernels take, by the streamed instance, where
    the JAX package's VMEM rule refuses it."""
    from sheeprl_tpu_torch.config import compose

    for preset, (F, H) in {"M": (640, 1024), "L": (768, 2048), "XL": (1024, 4096)}.items():
        cfg = compose("config", ["exp=dreamer_v3", f"algo=dreamer_v3_{preset}", "env=dummy",
                                 "algo.world_model.decoupled_rssm=True", "algo.world_model.pallas_gru=True"])
        rm = cfg.algo.world_model.recurrent_model
        assert (int(rm.dense_units), int(rm.recurrent_state_size)) == (F, H), preset
        assert ln_gru.fits_smem(F, H) and ln_gru.launch_layout(H)[0] == "streamed", preset
        assert not pg.fits_vmem(F, H), preset
