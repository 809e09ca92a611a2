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
    "shape", [(8, 16, 512, 512), (8, 16, 256, 256), (5, 6, 24, 32), (4, 16, 640, 1024), (3, 6, 64, 640)],
    ids=["S", "XS", "small_partial_cluster", "M", "streamed_40_units"],
)
@pytest.mark.parametrize("batched", [False, True], ids=["hfirst_H", "hfirst_BH"])
def test_kernels_match_plain_on_card(batched, shape):
    """All five kernels at the DreamerV3-S and XS GRU widths (the resident
    instance; the cluster split changes with H: 16 CTAs of 32 or of 16
    units), T cut to 8; at 4 CTAs of 8 units with a last cluster that holds
    2 of its 4 rows; and through the streamed instance at DreamerV3-M (16
    CTAs of 64 units, T cut to 4) and at 16 CTAs of 40 units (uneven
    k-groups, a last cluster of 2 rows)."""
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
@pytest.mark.parametrize("H", [1040, 510], ids=["units_not_multiple_of_8", "no_whole_slices"])
def test_shape_outside_the_cluster_fit_raises_on_card(H):
    """An H neither instance takes (16 CTAs of 65 units, not a multiple of 8,
    and too wide for the resident one; or no whole slices) raises on a CUDA
    tensor, in the wrapper and through gru_sequence; nothing falls back to
    the plain passes."""
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


# the streamed instance at the DreamerV3-M, L and XL GRU widths, T cut to 3
STREAMED_SHAPES = {"M": (3, 16, 640, 1024), "L": (3, 16, 768, 2048), "XL": (3, 16, 1024, 4096)}


@pytest.mark.cuda
@pytest.mark.parametrize("width", list(STREAMED_SHAPES), ids=list(STREAMED_SHAPES))
def test_streamed_recurrences_match_plain_on_card(width):
    """``ln_gru_fwd`` and ``ln_gru_bwd`` through the streamed instance (16
    CTAs of H/16 units, W_h streamed through shared memory) against
    ``forward_plain`` and ``backward_plain`` on the same inputs, resets in
    mid-sequence and a [B, H] h_first; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    T_, B_, F_, H_ = STREAMED_SHAPES[width]
    assert ln_gru.launch_layout(H_)[0] == "streamed"
    inputs = _card_inputs(STREAMED_SHAPES[width], 4, True)
    feats, first, h_first, w, scale, bias = (torch.from_numpy(a).cuda() for a in inputs)
    rng = np.random.default_rng(5)
    cot = torch.from_numpy(rng.standard_normal((T_, B_, H_)).astype(np.float32)).cuda()
    gx = (feats.reshape(T_ * B_, F_) @ w[:F_]).reshape(T_, B_, 3 * H_)
    wh = w[F_:]
    before = ln_gru.ln_gru_fwd.launches, ln_gru.ln_gru_bwd.launches
    fw = ln_gru.ln_gru_fwd(gx, first, h_first, wh, scale, bias)
    fw_plain = ln_gru.forward_plain(gx, first, h_first, wh, scale, bias)
    for a, b in zip(fw, fw_plain):
        torch.testing.assert_close(a, b, **GRAD_TOL)
    hs, yn, istd = fw_plain
    bw = ln_gru.ln_gru_bwd(feats, first, hs, h_first, wh, scale, bias, cot, yn, istd)
    bw_plain = ln_gru.backward_plain(feats, first, hs, h_first, wh, scale, bias, cot, yn, istd)
    torch.cuda.synchronize()
    for a, b in zip(bw, bw_plain):
        torch.testing.assert_close(a, b, **GRAD_TOL)
    assert (ln_gru.ln_gru_fwd.launches, ln_gru.ln_gru_bwd.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_wgrad_launches_on_two_streams_share_no_scratch():
    """Two ``ln_gru_wgrad`` launches at once on two streams (different
    inputs, the same shape): each equals ``wgrad_plain`` on its own inputs.
    Their arrival counters and partial slots are each launch's own scratch.
    Checked on the second pass, after each stream has allocated once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    M, F, N = GEMM_SHAPES["S"]
    cases = [_gemm_case("wgrad", M, F, N, seed=s, K=WGRAD_K["S"]) for s in (31, 32)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for _ in range(2):
        outs = []
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)  # both launches queue behind the spin, then run together
        for (fn, args, _, _, _), st in zip(cases, streams):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                outs.append(fn(*args))
        torch.cuda.synchronize()
    for (_, _, plain, _, _), got in zip(cases, outs):
        torch.testing.assert_close(got, plain, **GRAD_TOL)


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


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_train_step_takes_a_width_above_the_resident_limit(device):
    """pallas_gru=True with H = 1024 (DreamerV3-M's GRU width, the streamed
    instance) builds the train step and takes a step: through the plain
    passes on the host, through all five kernels on the card."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments

    train = _decoupled_train_fn(device, 1024, True)
    rng = np.random.default_rng(3)
    T_, B_ = 4, 2
    batch = {
        "rgb": torch.from_numpy(rng.integers(0, 255, (1, T_, B_, 64, 64, 3), np.uint8)),
        "actions": torch.from_numpy(np.eye(4, dtype=np.float32)[rng.integers(0, 4, (1, T_, B_))]),
        "rewards": torch.from_numpy(rng.standard_normal((1, T_, B_, 1)).astype(np.float32)),
        "terminated": torch.zeros(1, T_, B_, 1),
        "truncated": torch.zeros(1, T_, B_, 1),
        "is_first": torch.zeros(1, T_, B_, 1),
    }
    batch = {k: v.to(device) for k, v in batch.items()}
    ln_gru.reset_launch_counts()
    _, metrics = train(init_moments(torch.device(device)), batch, generator=torch.Generator(device).manual_seed(0))
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    counts = [k.launches for k in ln_gru.KERNELS]
    assert (min(counts) >= 1) if device == "cuda" else (max(counts) == 0), counts
