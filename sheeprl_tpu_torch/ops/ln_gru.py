"""LayerNorm-GRU over a whole sequence: the Hopper kernels and their plain
PyTorch versions.

Port of ``sheeprl_tpu/ops/pallas_gru.py``. Per step (eps 1e-3)::

    h   = (1 - first) * h + first * h_first
    y   = LN([x, h] @ W) * scale + bias
    r, c, u = split(y, 3)
    h'  = sigmoid(u - 1) * tanh(sigmoid(r) * c) + (1 - sigmoid(u - 1)) * h

Three kernels, written by hand in CUDA C++ (``csrc/ln_gru.cu``, which explains
their design and bound):

* ``ln_gru_fwd``   — the forward scan (replaces ``_pallas_forward``);
* ``ln_gru_bwd``   — the reverse BPTT sweep: recompute, cell + LN backward,
  ``dX = dy_raw·Wᵀ`` (replaces ``_pallas_backward``);
* ``ln_gru_wgrad`` — ``dW = Σ xhᵀ·dy_raw``, ``dscale``, ``dbias`` over all
  T·B rows (the accumulators of ``_pallas_backward``).

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
kernel's plain version (``forward_plain``, ``backward_plain``,
``wgrad_plain``) for CPU tensors. ``gru_sequence`` binds the three into a
``torch.autograd.Function``. The shared library is built with ``nvcc`` at
first use, into ``csrc/build/`` keyed by a hash of the source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

_EPS = 1e-3
_THREADS = 768  # kThreads of the CUDA source
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory one Hopper block may use
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCE = _CSRC / "ln_gru.cu"
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


# --------------------------------------------------------------------------
# fit check
# --------------------------------------------------------------------------
def smem_bytes(in_features: int, hidden_size: int) -> Tuple[int, int]:
    """(forward, backward) shared-memory bytes of one block: the matvec's
    partial rows (4 floats a thread), the input row and the 3H output row
    (+ the backward's three 3H cotangent rows and three H rows), each padded
    to 4 floats, plus 32 floats of reduction scratch — the sums of
    ``ln_gru_{fwd,bwd}_smem_bytes`` in the CUDA source."""
    F, H = int(in_features), int(hidden_size)
    pad4 = lambda n: (n + 3) // 4 * 4  # noqa: E731
    psum = 4 * _THREADS
    return (
        (psum + pad4(F + H) + pad4(3 * H) + 32) * 4,
        (psum + pad4(F + H) + 3 * pad4(3 * H) + 3 * pad4(H) + 32) * 4,
    )


def fits_smem(in_features: int, hidden_size: int) -> bool:
    """Whether the kernels take this shape: both kernels' rows fit one
    block's shared memory on Hopper (227 KB; W itself streams from L2), and
    H is a multiple of 4 (W's rows are read as float4)."""
    return hidden_size % 4 == 0 and max(smem_bytes(in_features, hidden_size)) <= _SMEM_LIMIT


# --------------------------------------------------------------------------
# plain versions (the CPU path and the reference on the card)
# --------------------------------------------------------------------------
def _cell_parts(x, h_in, w, scale, bias, hidden_size: int):
    """One step from the reset-blended carry ``h_in``; returns every
    intermediate the backward needs: (xh, istd, yn, r, y2, c, u, h_out)."""
    xh = torch.cat([x, h_in], dim=-1)
    y_raw = xh @ w
    mu = y_raw.mean(-1, keepdim=True)
    var = ((y_raw - mu) ** 2).mean(-1, keepdim=True)
    istd = torch.rsqrt(var + _EPS)
    yn = (y_raw - mu) * istd
    y = yn * scale + bias
    H = hidden_size
    r = torch.sigmoid(y[..., :H])
    y2 = y[..., H : 2 * H]
    c = torch.tanh(r * y2)
    u = torch.sigmoid(y[..., 2 * H :] - 1.0)
    return xh, istd, yn, r, y2, c, u, u * c + (1.0 - u) * h_in


def forward_plain(feats, first, h_first, w, scale, bias) -> torch.Tensor:
    """The forward scan in PyTorch ops (``h_first`` [B, H] or [H])."""
    T, B, _ = feats.shape
    H = h_first.shape[-1]
    h_first = h_first.expand(B, H)
    h = feats.new_zeros(B, H)
    outs = []
    for t in range(T):
        h_in = (1.0 - first[t]) * h + first[t] * h_first
        h = _cell_parts(feats[t], h_in, w, scale, bias, H)[-1]
        outs.append(h)
    return torch.stack(outs, dim=0)


def reference_sequence(feats, first, h_first, w, scale, bias) -> torch.Tensor:
    """Autograd through the plain scan: the reference the kernels' gradients
    are held against."""
    return forward_plain(feats, first, h_first, w, scale, bias)


def backward_plain(feats, first, hs, h_first, w, scale, bias, g):
    """The kernel's reverse sweep step by step, in PyTorch ops. ``h_first``
    is [B, H]. Returns (dfeats [T,B,F], dh_first [B,H], dy, dy_raw, yn
    [T,B,3H], xh [T,B,F+H]) — the last four are what ``ln_gru_bwd`` writes
    to scratch for ``ln_gru_wgrad``."""
    T, B, F = feats.shape
    H = h_first.shape[-1]
    dfeats = torch.empty_like(feats)
    dy_s = feats.new_empty(T, B, 3 * H)
    dyr_s = torch.empty_like(dy_s)
    yn_s = torch.empty_like(dy_s)
    xh_s = feats.new_empty(T, B, F + H)
    dh = feats.new_zeros(B, H)
    dh_first = feats.new_zeros(B, H)
    for t in range(T - 1, -1, -1):
        f = first[t]
        h_prev = hs[t - 1] if t > 0 else torch.zeros_like(dh)
        h_in = (1.0 - f) * h_prev + f * h_first
        xh, istd, yn, r, y2, c, u, _ = _cell_parts(feats[t], h_in, w, scale, bias, H)
        d = g[t] + dh
        du = d * (c - h_in)
        dc = d * u
        dh_in = d * (1.0 - u)
        d_rc = dc * (1.0 - c * c)
        dy = torch.cat([d_rc * y2 * r * (1.0 - r), d_rc * r, du * u * (1.0 - u)], dim=-1)
        dyn = dy * scale
        dy_raw = istd * (
            dyn - dyn.mean(-1, keepdim=True) - yn * (dyn * yn).mean(-1, keepdim=True)
        )
        dxh = dy_raw @ w.t()
        dfeats[t] = dxh[..., :F]
        dh_in = dh_in + dxh[..., F:]
        dh = (1.0 - f) * dh_in
        dh_first = dh_first + f * dh_in
        dy_s[t], dyr_s[t], yn_s[t], xh_s[t] = dy, dy_raw, yn, xh
    return dfeats, dh_first, dy_s, dyr_s, yn_s, xh_s


def wgrad_plain(xh, dy_raw, dy, yn):
    """dW = xhᵀ·dy_raw, dscale = Σ dy·yn, dbias = Σ dy over the M rows."""
    return xh.t() @ dy_raw, (dy * yn).sum(0), dy.sum(0)


# --------------------------------------------------------------------------
# the CUDA library: built with nvcc at first use, bound with ctypes
# --------------------------------------------------------------------------
_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the LN-GRU kernels are built with the CUDA toolkit")
    return found


def build(force: bool = False) -> Tuple[Path, str]:
    """Compile ``csrc/ln_gru.cu`` to ``csrc/build/ln_gru-<hash>.so`` unless a
    library of this source already exists. Returns (path, compiler log)."""
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"ln_gru-{digest}.so"
    log = lib.with_suffix(".log")
    if lib.is_file() and not force:
        return lib, log.read_text() if log.is_file() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
    log.write_text(text)
    os.replace(tmp, lib)
    return lib, text


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            lib.ln_gru_fwd.argtypes = [_P] * 7 + [_I] * 4 + [_P]
            lib.ln_gru_bwd.argtypes = [_P] * 14 + [_I] * 4 + [_P]
            lib.ln_gru_wgrad.argtypes = [_P] * 7 + [_I] * 3 + [_P]
            for fn in (lib.ln_gru_fwd, lib.ln_gru_bwd, lib.ln_gru_wgrad):
                fn.restype = _I
            lib.ln_gru_error_string.argtypes = [_I]
            lib.ln_gru_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _check(name: str, device: torch.device, **tensors) -> None:
    for arg, (t, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        msg = _lib().ln_gru_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ln_gru_fwd(feats, first, h_first, w, scale, bias) -> torch.Tensor:
    """Forward scan: feats [T,B,F], first [T,B,1], h_first [B,H],
    w [F+H,3H], scale/bias [3H] → hs [T,B,H]."""
    if not feats.is_cuda:
        return forward_plain(feats, first, h_first, w, scale, bias)
    T, B, F = feats.shape
    H = h_first.shape[-1]
    _check(
        "ln_gru_fwd", feats.device, feats=(feats, (T, B, F)), first=(first, (T, B, 1)),
        h_first=(h_first, (B, H)), w=(w, (F + H, 3 * H)), scale=(scale, (3 * H,)),
        bias=(bias, (3 * H,)),
    )
    if not fits_smem(F, H) or w.data_ptr() % 16:
        raise ValueError(f"ln_gru_fwd: F={F}, H={H} (or W's alignment) is not a shape the kernel takes")
    lib = _lib()
    out = torch.empty(T, B, H, device=feats.device, dtype=torch.float32)
    _launch(
        "ln_gru_fwd", lib.ln_gru_fwd, feats.data_ptr(), first.data_ptr(), h_first.data_ptr(),
        w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), T, B, F, H, _stream(),
    )
    ln_gru_fwd.launches += 1
    return out


ln_gru_fwd.launches = 0


def ln_gru_bwd(feats, first, hs, h_first, w, scale, bias, g):
    """Reverse sweep: the forward's inputs plus hs and g [T,B,H] → (dfeats,
    dh_first [B,H], dy, dy_raw, yn [T,B,3H], xh [T,B,F+H])."""
    if not feats.is_cuda:
        return backward_plain(feats, first, hs, h_first, w, scale, bias, g)
    T, B, F = feats.shape
    H = h_first.shape[-1]
    _check(
        "ln_gru_bwd", feats.device, feats=(feats, (T, B, F)), first=(first, (T, B, 1)),
        hs=(hs, (T, B, H)), h_first=(h_first, (B, H)), w=(w, (F + H, 3 * H)),
        scale=(scale, (3 * H,)), bias=(bias, (3 * H,)), g=(g, (T, B, H)),
    )
    if not fits_smem(F, H) or w.data_ptr() % 16:
        raise ValueError(f"ln_gru_bwd: F={F}, H={H} (or W's alignment) is not a shape the kernel takes")
    lib = _lib()
    kw = dict(device=feats.device, dtype=torch.float32)
    dfeats = torch.empty(T, B, F, **kw)
    dh_first = torch.empty(B, H, **kw)
    dy = torch.empty(T, B, 3 * H, **kw)
    dy_raw = torch.empty(T, B, 3 * H, **kw)
    yn = torch.empty(T, B, 3 * H, **kw)
    xh = torch.empty(T, B, F + H, **kw)
    _launch(
        "ln_gru_bwd", lib.ln_gru_bwd, feats.data_ptr(), first.data_ptr(), hs.data_ptr(),
        h_first.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), g.data_ptr(),
        dfeats.data_ptr(), dh_first.data_ptr(), dy.data_ptr(), dy_raw.data_ptr(), yn.data_ptr(),
        xh.data_ptr(), T, B, F, H, _stream(),
    )
    ln_gru_bwd.launches += 1
    return dfeats, dh_first, dy, dy_raw, yn, xh


ln_gru_bwd.launches = 0


def ln_gru_wgrad(xh, dy_raw, dy, yn):
    """xh [M,K], dy_raw/dy/yn [M,N] → (dW [K,N], dscale [N], dbias [N])."""
    if not xh.is_cuda:
        return wgrad_plain(xh, dy_raw, dy, yn)
    M, K = xh.shape
    N = dy_raw.shape[-1]
    _check(
        "ln_gru_wgrad", xh.device, xh=(xh, (M, K)), dy_raw=(dy_raw, (M, N)), dy=(dy, (M, N)),
        yn=(yn, (M, N)),
    )
    lib = _lib()
    kw = dict(device=xh.device, dtype=torch.float32)
    dW = torch.empty(K, N, **kw)
    dscale = torch.empty(N, **kw)
    dbias = torch.empty(N, **kw)
    _launch(
        "ln_gru_wgrad", lib.ln_gru_wgrad, xh.data_ptr(), dy_raw.data_ptr(), dy.data_ptr(),
        yn.data_ptr(), dW.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), M, K, N, _stream(),
    )
    ln_gru_wgrad.launches += 1
    return dW, dscale, dbias


ln_gru_wgrad.launches = 0
KERNELS = (ln_gru_fwd, ln_gru_bwd, ln_gru_wgrad)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# --------------------------------------------------------------------------
# autograd binding
# --------------------------------------------------------------------------
class _LNGRUSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, first, h_first, w, scale, bias, plain):
        T, B, _ = feats.shape
        H = h_first.shape[-1]
        args = [feats, first, h_first.expand(B, H), w, scale, bias]
        args = [a.contiguous().float() for a in args]
        hs = (forward_plain if plain else ln_gru_fwd)(*args)
        ctx.save_for_backward(*args, hs)
        ctx.plain = plain
        ctx.h_first_1d = h_first.dim() == 1
        return hs

    @staticmethod
    def backward(ctx, g):
        feats, first, h_first, w, scale, bias, hs = ctx.saved_tensors
        bwd, wgrad = (backward_plain, wgrad_plain) if ctx.plain else (ln_gru_bwd, ln_gru_wgrad)
        dfeats, dh_first, dy, dy_raw, yn, xh = bwd(
            feats, first, hs, h_first, w, scale, bias, g.contiguous().float()
        )
        M = feats.shape[0] * feats.shape[1]
        dw, dscale, dbias = wgrad(
            xh.reshape(M, -1), dy_raw.reshape(M, -1), dy.reshape(M, -1), yn.reshape(M, -1)
        )
        if ctx.h_first_1d:  # forward broadcast [H] -> [B, H]: reduce back
            dh_first = dh_first.sum(0)
        return dfeats, None, dh_first, dw, dscale, dbias, None


def gru_sequence(feats, first, h_first, w, scale, bias, plain: bool = False) -> torch.Tensor:
    """LN-GRU over a whole [T, B, F] sequence with ``is_first`` resets.

    Args:
        feats:   [T, B, F] per-step GRU inputs.
        first:   [T, B, 1] episode-start mask (data, never differentiated).
        h_first: [H] or [B, H] state the carry resets to where first == 1.
        w:       [F+H, 3H] fused gate weights; ``scale``/``bias``: [3H].
        plain:   run the plain PyTorch passes on any device (the config value
                 ``pallas_gru: interpret``). Otherwise CUDA tensors launch the
                 kernels and CPU tensors take the plain passes.

    Returns [T, B, H] hidden states; the backward is the reverse sweep plus
    the weight-gradient reduction."""
    return _LNGRUSequence.apply(feats, first, h_first, w, scale, bias, plain)
