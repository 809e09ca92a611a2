"""The LN-GRU CUDA kernels against their plain PyTorch passes on the card.
Marked ``cuda``: they skip without an NVIDIA GPU (the kernels have no CPU
mode). This file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch:  pytest tests/test_torch_ln_gru_cuda.py

Tolerance: rtol = atol = 1e-4 (f32 sums in another order than cuBLAS);
the 3xTF32 GEMMs' products also within 4x torch.mm's error against
float64."""
import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.ops import ln_gru

T, B, F, H = 6, 4, 16, 8
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


def _card_inputs(shape, seed, batched_hfirst):
    T, B, F, H = shape
    rng = np.random.default_rng(seed)
    first = np.zeros((T, B, 1), np.float32)
    first[0] = 1.0
    first[T // 2, 1] = 1.0
    first[T - 2, 3:6] = 1.0
    hshape = (B, H) if batched_hfirst else (H,)
    return (
        rng.standard_normal((T, B, F)).astype(np.float32),
        first,
        (0.5 * rng.standard_normal(hshape)).astype(np.float32),
        (rng.standard_normal((F + H, 3 * H)) / np.sqrt(F + H)).astype(np.float32),
        (1.0 + 0.1 * rng.standard_normal(3 * H)).astype(np.float32),
        (0.1 * rng.standard_normal(3 * H)).astype(np.float32),
    )


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(8, 16, 512, 512), (8, 16, 256, 256), (5, 6, 24, 32)], ids=["S", "XS", "small_partial_cluster"]
)
@pytest.mark.parametrize("batched", [False, True], ids=["hfirst_H", "hfirst_BH"])
def test_kernels_match_plain_on_card(batched, shape):
    """All five kernels at the DreamerV3-S and XS GRU widths (the cluster
    split changes with H: 16 CTAs of 32 or of 16 units), T cut to 8; and at
    4 CTAs of 8 units with a last cluster that holds 2 of its 4 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _card_inputs(shape, 6, batched)
    dev = [torch.from_numpy(a.copy()).cuda().requires_grad_(i in (0, 2, 3, 4, 5)) for i, a in enumerate(args)]
    ref = [torch.from_numpy(a.copy()).cuda().requires_grad_(i in (0, 2, 3, 4, 5)) for i, a in enumerate(args)]
    before = [k.launches for k in ln_gru.KERNELS]
    out = ln_gru.gru_sequence(*dev)
    (out ** 2).sum().backward()
    want = ln_gru.gru_sequence(*ref, plain=True)
    (want ** 2).sum().backward()
    torch.cuda.synchronize()
    assert [k.launches for k in ln_gru.KERNELS] == [b + 1 for b in before]
    torch.testing.assert_close(out, want, **GRAD_TOL)
    for a, b in zip(dev, ref):
        if b.grad is not None:
            torch.testing.assert_close(a.grad, b.grad, **GRAD_TOL)


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_path():
    """A CUDA tensor the kernel does not take raises; it is not computed by
    the plain version instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    feats, first, h_first, w, scale, bias = (torch.from_numpy(a).cuda() for a in _inputs(7, True))
    gx = ln_gru.ln_gru_xproj(feats.reshape(T * B, F), w[:F]).reshape(T, B, 3 * H)
    with pytest.raises(TypeError):
        ln_gru.ln_gru_fwd(gx.double(), first, h_first, w[F:], scale, bias)
    with pytest.raises(ValueError):
        ln_gru.ln_gru_fwd(gx, first, h_first, w[F:].t(), scale, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1024, 510], ids=["M_width", "no_whole_slices"])
def test_shape_outside_the_cluster_fit_raises_on_card(H):
    """An H the clusters do not take (more than 16 CTAs of 32 units, or no
    whole slices) raises on a CUDA tensor, in the wrapper and through
    gru_sequence; nothing falls back to the plain passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    Tn, Bn, Fn = 2, 8, 64
    rng = np.random.default_rng(11)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()  # noqa: E731
    feats, w, hf = mk(Tn, Bn, Fn), mk(Fn + H, 3 * H), mk(Bn, H)
    first = torch.ones(Tn, Bn, 1, device="cuda")
    scale, bias = torch.ones(3 * H, device="cuda"), torch.zeros(3 * H, device="cuda")
    fwd_before = ln_gru.ln_gru_fwd.launches
    with pytest.raises(ValueError, match="not a shape the kernels take"):
        ln_gru.ln_gru_fwd(mk(Tn, Bn, 3 * H), first, hf, w[Fn:], scale, bias)
    with pytest.raises(ValueError, match="not a shape the kernels take"):
        ln_gru.gru_sequence(feats, first, hf, w, scale, bias)
    assert ln_gru.ln_gru_fwd.launches == fwd_before


# (M, F, N) of the GEMMs: Gx[M, N] = x[M, F]·W_x[F, N], dfeats[M, F] = dy_raw[M, N]·W_xᵀ,
# dW[K, N] = xh[M, K]ᵀ·dy_raw[M, N] with K = WGRAD_K[shape] (F+H where N = 3H)
GEMM_SHAPES = {
    "S": (1024, 512, 1536),
    "XS": (1024, 256, 768),
    "small_partial_cluster": (30, 24, 96),
    "ragged": (77, 52, 148),  # M, F and N off every tile and stage size
}
# ragged: K off the tile's rows, three rows of blocks, so three uneven partials of M = 77 rows
WGRAD_K = {"S": 1024, "XS": 512, "small_partial_cluster": 56, "ragged": 260}


def _gemm_case(kernel, M, F, N, seed, K=None):
    """(wrapper, its inputs, the plain version's output(s), a, b of the
    product a·b that is its first output)."""
    rng = np.random.default_rng(seed)
    if kernel == "wgrad":
        xh, yn = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda() for s in ((M, K), (M, N)))
        dyr, dy = (torch.from_numpy((rng.standard_normal((M, N)) / np.sqrt(M)).astype(np.float32)).cuda()
                   for _ in range(2))
        args = (xh, dyr, dy, yn)
        return ln_gru.ln_gru_wgrad, args, ln_gru.wgrad_plain(*args), xh.t(), dyr
    wx = torch.from_numpy((rng.standard_normal((F, N)) / np.sqrt(F)).astype(np.float32)).cuda()
    if kernel == "xproj":
        x = torch.from_numpy(rng.standard_normal((M, F)).astype(np.float32)).cuda()
        return ln_gru.ln_gru_xproj, (x, wx), ln_gru.xproj_plain(x, wx), x, wx
    dyr = torch.from_numpy((rng.standard_normal((M, N)) / np.sqrt(N)).astype(np.float32)).cuda()
    return ln_gru.ln_gru_dx, (dyr, wx), ln_gru.dx_plain(dyr, wx), dyr, wx.t()


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(GEMM_SHAPES), ids=list(GEMM_SHAPES))
@pytest.mark.parametrize("kernel", ["xproj", "dx", "wgrad"])
def test_3xtf32_gemm_on_card(kernel, shape):
    """Each 3xTF32 GEMM alone against its plain version (f32, TF32 off; for
    ln_gru_wgrad dW, dscale and dbias), its product within 4x torch.mm's
    error against a float64 product, and every output bitwise the same from
    launch to launch; one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dims = GEMM_SHAPES[shape]
    fn, args, plain, a, b = _gemm_case(kernel, *dims, seed=sum(dims), K=WGRAD_K[shape])
    before = fn.launches
    got, again = _outputs(fn(*args)), _outputs(fn(*args))
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    torch.testing.assert_close(got, _outputs(plain), **GRAD_TOL)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    ref = a.double() @ b.double()
    err = (got[0].double() - ref).abs().max().item()
    mm_err = ((a @ b).double() - ref).abs().max().item()
    assert err <= 4 * mm_err, (err, mm_err)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["xproj", "dx", "wgrad"])
@pytest.mark.parametrize("fault", ["misaligned", "F_not_multiple_of_4"])
def test_3xtf32_gemm_refuses_rows_it_cannot_copy(kernel, fault):
    """A CUDA operand whose rows are not whole 16-byte chunks (F % 4 != 0,
    so for ln_gru_wgrad K = F+H too) or whose data is not 16-byte aligned
    raises, and counts no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    M, F, N = 30, (26 if fault == "F_not_multiple_of_4" else 24), 96
    fn, args, _, _, _ = _gemm_case(kernel, M, F, N, seed=5, K=F + N // 3)
    if fault == "misaligned":  # the same values one float into a fresh buffer
        first = args[0]
        shifted = torch.empty(first.numel() + 1, device="cuda")[1:].view(first.shape)
        shifted.copy_(first)
        args = (shifted, *args[1:])
    before = fn.launches
    with pytest.raises(ValueError, match="16-byte aligned|multiple of 4"):
        fn(*args)
    assert fn.launches == before


def _decoupled_train_fn(device, recurrent_size, gru_mode):
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces

    cfg = compose("config", [
        "exp=dreamer_v3", "algo=dreamer_v3_XS", "algo.dense_units=16",
        "algo.world_model.encoder.cnn_channels_multiplier=2",
        f"algo.world_model.recurrent_model.recurrent_state_size={recurrent_size}",
        "algo.world_model.recurrent_model.dense_units=16", "algo.world_model.transition_model.hidden_size=16",
        "algo.world_model.representation_model.hidden_size=16", "algo.world_model.discrete_size=4",
        "algo.world_model.stochastic_size=4", "algo.world_model.decoupled_rssm=True",
        f"algo.world_model.pallas_gru={gru_mode}",
    ])
    space = spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)})
    wm, actor, critic, target = build_agent(cfg, space, [4], False, torch.device(device))
    opts = dv3.build_optimizers(cfg, wm, actor, critic)
    return dv3.make_train_fn(wm, actor, critic, target, opts, cfg, False, [4])


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_train_step_refuses_a_shape_the_kernels_do_not_take(device):
    """pallas_gru=True with an H the kernels do not take (6 splits into no
    whole CTA slices of 8, 16 or 32 units) raises when the train step is
    built, on the card as on the host; the plain passes
    (pallas_gru=interpret) take it."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    with pytest.raises(ValueError, match="do not take"):
        _decoupled_train_fn(device, 6, True)
    assert callable(_decoupled_train_fn(device, 6, "interpret"))
    assert callable(_decoupled_train_fn(device, 8, True))
