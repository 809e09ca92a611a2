"""The 3xTF32 arithmetic of the port's GEMM kernels (``ln_gru_xproj``,
``ln_gru_dx``), emulated in PyTorch on the CPU (``tf32_round``,
``matmul_3xtf32`` in ``sheeprl_tpu_torch/ops/ln_gru.py``) and held against
float64 products made with numpy from a seed.

Tolerance: the 3xTF32 product's largest error against float64 is at most
``REL_TOL`` times the largest |product| and at most ``F32_FACTOR`` times the
plain float32 product's error (the same factor ``chip_smoke.py`` holds the
kernels to against ``torch.mm`` on the card). Plain TF32 (one product of the
rounded operands) misses both by two orders of magnitude."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.ops import ln_gru

REL_TOL = 1e-5
F32_FACTOR = 4


def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """Round to 11 significant bits, ties away from zero, in float64."""
    mag = np.abs(x.astype(np.float64))
    _, e = np.frexp(mag)
    ulp = np.ldexp(1.0, e - 11)
    return np.sign(x) * np.floor(mag / ulp + 0.5) * ulp


def test_tf32_round_ties_away_and_passes_specials():
    tie = 1.0 + 2.0**-11  # exactly half of TF32's last bit above 1
    x = torch.tensor([tie, -tie, tie - 2.0**-23, 1.0 + 3 * 2.0**-11, float("inf"), -float("inf"), 0.0, -0.0])
    got = ln_gru.tf32_round(x)
    want = [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 1.0 + 2.0**-9, float("inf"), -float("inf"), 0.0, -0.0]
    assert got.tolist() == want
    assert torch.signbit(got[-1])
    assert torch.isnan(ln_gru.tf32_round(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.5e3, 1e30])
def test_tf32_round_is_nearest_with_ten_mantissa_bits(scale):
    rng = np.random.default_rng(1)
    x = (scale * rng.standard_normal(4096)).astype(np.float32)
    got = ln_gru.tf32_round(torch.from_numpy(x))
    assert not (got.view(torch.int32) & 0x1FFF).any()  # the 13 dropped mantissa bits are clear
    np.testing.assert_array_equal(got.numpy().astype(np.float64), _tf32_reference(x))


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    return a, b, a.astype(np.float64) @ b.astype(np.float64)


def _f32_accurate(err: float, ref: np.ndarray, f32_err: float) -> bool:
    return err <= REL_TOL * np.abs(ref).max() and err <= F32_FACTOR * f32_err


SHAPES = {
    "xproj_S_slice": (64, 512, 96),  # a sum over F = 512
    "dx_S_slice": (32, 1536, 64),  # a sum over 3H = 1536
    "ragged": (30, 24, 96),  # the card tests' small shape: M = T·B = 30, a sum of 24
}


@pytest.mark.parametrize("b_layout", ["row_major", "transposed_view"])
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_3xtf32_product_is_f32_accurate_and_plain_tf32_is_not(shape, b_layout):
    """``transposed_view`` passes b as the transpose of a contiguous [N, K]
    array, the way ``ln_gru_dx`` reads W_x [F, 3H] along the sum."""
    a, b, ref = _operands(*shape, seed=sum(shape))
    f32_err = np.abs(a @ b - ref).max()
    ta = torch.from_numpy(a)
    tb = torch.from_numpy(np.ascontiguousarray(b.T)).t() if b_layout == "transposed_view" else torch.from_numpy(b)
    err3 = np.abs(ln_gru.matmul_3xtf32(ta, tb).numpy() - ref).max()
    assert _f32_accurate(err3, ref, f32_err), (err3, f32_err)
    err1 = np.abs((ln_gru.tf32_round(ta) @ ln_gru.tf32_round(tb)).numpy() - ref).max()
    assert not _f32_accurate(err1, ref, f32_err), (err1, f32_err)
