"""LayerNorm-GRU over a whole sequence: the Hopper kernels and their plain
PyTorch versions.

Port of ``sheeprl_tpu/ops/pallas_gru.py``. Per step (eps 1e-3)::

    h   = (1 - first) * h + first * h_first
    y   = LN(x @ W_x + h @ W_h) * scale + bias        W = [W_x; W_h]: [F+H, 3H]
    r, c, u = split(y, 3)
    h'  = sigmoid(u - 1) * tanh(sigmoid(r) * c) + (1 - sigmoid(u - 1)) * h

Five kernels, written by hand in CUDA C++ (``csrc/ln_gru.cu``, which explains
their design and bound):

* ``ln_gru_xproj`` — ``Gx = x·W_x`` for all T·B rows, outside the time loop,
  on the tensor cores in 3xTF32 (f32 accuracy from three TF32 products);
* ``ln_gru_fwd``   — the recurrence on thread-block clusters, each CTA with
  its slice of ``W_h`` resident in shared memory (the resident instance) or
  streamed through it every step (the streamed instance, for wider H); saves
  ``yn`` and ``istd`` (together with ``ln_gru_xproj`` it replaces
  ``_pallas_forward``);
* ``ln_gru_bwd``   — the reverse sweep on the same clusters, from the saved
  ``yn`` (no recompute);
* ``ln_gru_dx``    — ``dfeats = dy_raw·W_xᵀ`` for all T·B rows after it, in
  3xTF32 like ``ln_gru_xproj``;
* ``ln_gru_wgrad`` — ``dW = xhᵀ·dy_raw`` over all T·B rows in 3xTF32 like
  ``ln_gru_xproj``, and ``dscale``, ``dbias`` in the same launch (with the two
  before it, ``_pallas_backward``).

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
kernel's plain version (``xproj_plain``, ``forward_plain``,
``backward_plain``, ``dx_plain``, ``wgrad_plain``) for CPU tensors.
``forward_cluster_emulated`` and ``backward_cluster_emulated`` replay the
recurrent kernels' algorithm CTA by CTA in PyTorch, ``matmul_3xtf32`` the
GEMMs' split arithmetic and ``wgrad_3xtf32`` the weight gradient's, for the
CPU tests.
``gru_sequence`` binds the kernels into a ``torch.autograd.Function``. The
shared library is built with ``nvcc`` at first use, into ``csrc/build/``
keyed by a hash of the source.

The recurrent kernels come in two instances (``launch_layout``):

* resident — H splits into at most 16 CTAs of 4, 8, 16 or 32 hidden units
  (``cluster_split``) and a CTA's W_h slice fits its shared memory: H <= 512,
  DreamerV3-XS and S;
* streamed — otherwise, when H splits into 16 CTAs of a multiple of 8 units,
  at most 256 (``stream_split``): a CTA streams its W_h slice through a ring
  of ``STREAM_STAGES`` k-tiles each step. DreamerV3-M, L and XL (H = 1024,
  2048, 4096) take it.

Any other H is refused (``fits_smem``); so is F not a multiple of 4, and
the GEMMs copy rows as 16-byte chunks (F, F+H and 3H multiples of 4, data
pointers 16-byte aligned). A cluster takes ``ROWS_PER_CLUSTER`` batch rows.
This module holds the recurrent kernels' layout: ``build`` passes it to
nvcc, and the wrappers pass each launch its units per CTA, tile rows and
shared-memory bytes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

_EPS = 1e-3
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory one Hopper block may use (232,448 bytes)
# the recurrent kernels' layout, compiled into the CUDA source as -D flags
ROWS_PER_CLUSTER = 4  # batch rows of one cluster (LN_GRU_ROWS)
_WARPS = 8  # warps of one CTA (LN_GRU_THREADS / 32)
_MAX_CLUSTER = 16  # CTAs of the largest (non-portable) cluster on Hopper (LN_GRU_MAX_CLUSTER)
STREAM_STAGES = 4  # k-tiles of the streamed instance's W_h ring (LN_GRU_STREAM_STAGES)
_STREAM_TILE = 2048  # a streamed k-tile holds at most this many rows x units (a stage near 24 KB)
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCE = _CSRC / "ln_gru.cu"
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    f"-DLN_GRU_ROWS={ROWS_PER_CLUSTER}", f"-DLN_GRU_THREADS={32 * _WARPS}", f"-DLN_GRU_MAX_CLUSTER={_MAX_CLUSTER}",
    f"-DLN_GRU_STREAM_STAGES={STREAM_STAGES}", f"-DLN_GRU_STREAM_TILE={_STREAM_TILE}",
)


# --------------------------------------------------------------------------
# fit check
# --------------------------------------------------------------------------
def cluster_split(hidden_size: int) -> Optional[Tuple[int, int]]:
    """(CTAs of a cluster, hidden units of a CTA): the smallest of 4, 8, 16,
    32 units (at least 32 / ROWS_PER_CLUSTER, so that a warp's lanes cover a
    CTA's units x rows) that splits H into at most 16 CTAs — 16 x 32 at
    DreamerV3-S — or None when none does, or when H does not split over the
    warps of a CTA's product."""
    H = int(hidden_size)
    if H % _WARPS:
        return None
    for units in (4, 8, 16, 32):
        if units * ROWS_PER_CLUSTER >= 32 and H % units == 0 and H // units <= _MAX_CLUSTER:
            return H // units, units
    return None


def _resident_smem(hidden_size: int) -> Tuple[int, int]:
    """(forward, backward) shared-memory bytes of one CTA of the resident
    instance; (0, 0) when H does not split. The kernels carve their shared
    memory in the order of these sums. Forward: the W_h slice [H, 3·units],
    h_in [H, rows], each warp's partial product [rows, 3·units], every
    CTA's row statistics and the CTA's next h_in [units, rows].
    Backward: the W_h slice with rows padded by one float, the
    reduce-scatter receive buffer [CTAs, units, rows], dy_raw
    [3·units, rows] and every CTA's row sums."""
    split = cluster_split(hidden_size)
    if split is None:
        return 0, 0
    nc, units = split
    H, ncol, R = int(hidden_size), 3 * units, ROWS_PER_CLUSTER
    fwd = H * ncol + H * R + _WARPS * R * ncol + nc * R * 2 + units * R
    bwd = H * (ncol + 1) + nc * R * units + ncol * R + nc * R * 2
    return 4 * fwd, 4 * bwd


def stream_split(hidden_size: int) -> Optional[Tuple[int, int, int]]:
    """(CTAs of a cluster, hidden units of a CTA, rows of a W_h k-tile) of
    the streamed instance: 16 CTAs of H / 16 units, a multiple of 8 (whole
    16-byte chunks of each gate's columns) and at most one a thread of the
    forward's product (256); tiles of the largest power of two from 8 to 64
    rows with rows x units <= 2048 — 16 x 64 x 32 at DreamerV3-M, 16 x 128 x
    16 at L, 16 x 256 x 8 at XL — or None."""
    H = int(hidden_size)
    units = H // _MAX_CLUSTER
    if H % (8 * _MAX_CLUSTER) or not 0 < units <= 32 * _WARPS:
        return None
    kt = 64
    while kt > 8 and kt * units > _STREAM_TILE:
        kt //= 2
    return _MAX_CLUSTER, units, kt


def _streamed_smem(hidden_size: int) -> Tuple[int, int]:
    """(forward, backward) shared-memory bytes of one CTA of the streamed
    instance, in the order the kernels carve them; (0, 0) when H does not
    split. Both: the ring of STREAM_STAGES tiles [kt, 3·units + 256 / kt]
    (rows padded so that the backward's lanes hit distinct banks). Forward:
    h_in [H, rows], the k-groups' partial products [256 / units, rows,
    3·units], every CTA's row statistics, the CTA's next h_in [units, rows],
    the row sums' shares [rows, units] and the CTA's row means. Backward: the
    reduce-scatter receive buffer [CTAs, units, rows], dy_raw [3·units,
    rows], every CTA's row sums and their shares [rows, units, 2]."""
    split = stream_split(hidden_size)
    if split is None:
        return 0, 0
    nc, units, kt = split
    H, ncol, R, threads = int(hidden_size), 3 * units, ROWS_PER_CLUSTER, 32 * _WARPS
    ring = STREAM_STAGES * kt * (ncol + threads // kt)
    fwd = ring + H * R + (threads // units) * R * ncol + nc * R * 2 + units * R + R * units + R
    bwd = ring + nc * units * R + ncol * R + nc * R * 2 + 2 * R * units
    return 4 * fwd, 4 * bwd


def launch_layout(hidden_size: int) -> Optional[Tuple[str, int, int, int, Tuple[int, int]]]:
    """(instance, CTAs of a cluster, units of a CTA, W_h tile rows, (forward,
    backward) shared-memory bytes) of the recurrent kernels at this H, or
    None where neither instance takes it. The resident instance takes H when
    ``cluster_split`` splits it and its slice fits 227 KB (H <= 512,
    DreamerV3-XS and S; its tile rows are 0: no ring); the streamed instance
    takes the H the resident one does not, when ``stream_split`` splits it
    and its ring and buffers fit (DreamerV3-M, L and XL)."""
    split, smem = cluster_split(hidden_size), _resident_smem(hidden_size)
    if split is not None and max(smem) <= _SMEM_LIMIT:
        return "resident", split[0], split[1], 0, smem
    split, smem = stream_split(hidden_size), _streamed_smem(hidden_size)
    if split is not None and max(smem) <= _SMEM_LIMIT:
        return "streamed", split[0], split[1], split[2], smem
    return None


def smem_bytes(hidden_size: int) -> Tuple[int, int]:
    """(forward, backward) shared-memory bytes of one CTA that each launch
    requests, for the instance that takes H (``launch_layout``); (0, 0) when
    neither does."""
    layout = launch_layout(hidden_size)
    return layout[4] if layout is not None else (0, 0)


def fits_smem(in_features: int, hidden_size: int) -> bool:
    """Whether the kernels take this shape: one of the two instances takes
    H (``launch_layout``: the resident one at most 16 CTAs of 4 to 32 units
    with the W_h slice in shared memory, the streamed one 16 CTAs of a
    multiple of 8 units, at most 256), and F is a multiple of 4 (the
    backward copies x into the weight-gradient rows as float4)."""
    return in_features % 4 == 0 and launch_layout(hidden_size) is not None


# --------------------------------------------------------------------------
# plain versions (the CPU path and the reference on the card)
# --------------------------------------------------------------------------
def _gates(yn, h_in, scale, bias, hidden_size: int):
    """Affine and gates from the normalised pre-activation [.., 3H]: h'."""
    y = yn * scale + bias
    H = hidden_size
    r = torch.sigmoid(y[..., :H])
    c = torch.tanh(r * y[..., H : 2 * H])
    u = torch.sigmoid(y[..., 2 * H :] - 1.0)
    return u * c + (1.0 - u) * h_in


def _ln_gates(y_raw, h_in, scale, bias, hidden_size: int):
    """LN, affine and gates of one step from its pre-activation; returns
    (istd, yn, h_out)."""
    mu = y_raw.mean(-1, keepdim=True)
    var = ((y_raw - mu) ** 2).mean(-1, keepdim=True)
    istd = torch.rsqrt(var + _EPS)
    yn = (y_raw - mu) * istd
    return istd, yn, _gates(yn, h_in, scale, bias, hidden_size)


def reference_sequence(feats, first, h_first, w, scale, bias) -> torch.Tensor:
    """The scan of the JAX package's ``reference_sequence``, ``[x, h]·W`` in
    one product, in PyTorch ops (``h_first`` [B, H] or [H]): autograd
    through it is the reference the kernels' gradients are held against."""
    T, B, _ = feats.shape
    H = h_first.shape[-1]
    h_first = h_first.expand(B, H)
    h = feats.new_zeros(B, H)
    outs = []
    for t in range(T):
        h_in = (1.0 - first[t]) * h + first[t] * h_first
        h = _ln_gates(torch.cat([feats[t], h_in], dim=-1) @ w, h_in, scale, bias, H)[-1]
        outs.append(h)
    return torch.stack(outs, dim=0)


def xproj_plain(x, wx) -> torch.Tensor:
    """Gx = x·W_x: x [M, F], wx [F, 3H]."""
    return x @ wx


def forward_plain(gx, first, h_first, w_h, scale, bias):
    """The recurrence from Gx [T, B, 3H]; ``h_first`` [B, H], ``w_h``
    [H, 3H]. Returns (hs [T, B, H], yn [T, B, 3H], istd [T, B])."""
    T, B, _ = gx.shape
    H = w_h.shape[0]
    h = gx.new_zeros(B, H)
    hs, yns, istds = [], [], []
    for t in range(T):
        h_in = (1.0 - first[t]) * h + first[t] * h_first
        istd, yn, h = _ln_gates(gx[t] + h_in @ w_h, h_in, scale, bias, H)
        hs.append(h)
        yns.append(yn)
        istds.append(istd[:, 0])
    return torch.stack(hs), torch.stack(yns), torch.stack(istds)


def _cell_backward(d, yn, h_in, scale, bias, H):
    """Cell and affine backward of one step from the saved yn; returns
    (dy [.., 3H], d·(1-u), the direct part of dh_in)."""
    y = yn * scale + bias
    r = torch.sigmoid(y[..., :H])
    y2 = y[..., H : 2 * H]
    c = torch.tanh(r * y2)
    u = torch.sigmoid(y[..., 2 * H :] - 1.0)
    du = d * (c - h_in)
    d_rc = d * u * (1.0 - c * c)
    dy = torch.cat([d_rc * y2 * r * (1.0 - r), d_rc * r, du * u * (1.0 - u)], dim=-1)
    return dy, d * (1.0 - u)


def backward_plain(feats, first, hs, h_first, w_h, scale, bias, g, yn, istd):
    """The kernel's reverse sweep step by step, in PyTorch ops, from the
    forward's yn and istd (no recompute). ``h_first`` is [B, H]. Returns
    (dh_first [B,H], dy, dy_raw [T,B,3H], xh [T,B,F+H]) — the last three are
    what ``ln_gru_dx`` and ``ln_gru_wgrad`` read."""
    T, B, F = feats.shape
    H = w_h.shape[0]
    dy_s = feats.new_empty(T, B, 3 * H)
    dyr_s = torch.empty_like(dy_s)
    xh_s = feats.new_empty(T, B, F + H)
    dh = feats.new_zeros(B, H)
    dh_first = feats.new_zeros(B, H)
    for t in range(T - 1, -1, -1):
        f = first[t]
        h_prev = hs[t - 1] if t > 0 else torch.zeros_like(dh)
        h_in = (1.0 - f) * h_prev + f * h_first
        dy, dh_in = _cell_backward(g[t] + dh, yn[t], h_in, scale, bias, H)
        dyn = dy * scale
        dy_raw = istd[t][:, None] * (
            dyn - dyn.mean(-1, keepdim=True) - yn[t] * (dyn * yn[t]).mean(-1, keepdim=True)
        )
        dh_in = dh_in + dy_raw @ w_h.t()
        dh = (1.0 - f) * dh_in
        dh_first = dh_first + f * dh_in
        dy_s[t], dyr_s[t], xh_s[t] = dy, dy_raw, torch.cat([feats[t], h_in], dim=-1)
    return dh_first, dy_s, dyr_s, xh_s


def dx_plain(dy_raw, wx) -> torch.Tensor:
    """dfeats = dy_raw·W_xᵀ: dy_raw [M, 3H], wx [F, 3H]."""
    return dy_raw @ wx.t()


def wgrad_plain(xh, dy_raw, dy, yn):
    """dW = xhᵀ·dy_raw, dscale = Σ dy·yn, dbias = Σ dy over the M rows."""
    return xh.t() @ dy_raw, (dy * yn).sum(0), dy.sum(0)


# --------------------------------------------------------------------------
# the GEMMs' 3xTF32 arithmetic (for the CPU tests)
# --------------------------------------------------------------------------
_TF32_STEP = 8  # the depth of one mma.sync m16n8k8 step of the sum


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: add half of the last kept bit to
    the magnitude bits of the int32 view, then clear the 13 dropped bits.
    Infinities and NaNs pass as they are."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    special = (bits & 0x7F800000) == 0x7F800000
    return torch.where(special, bits, rounded).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] · b [K, N] in the arithmetic of ``ln_gru_xproj``, ``ln_gru_dx``
    and the product of ``ln_gru_wgrad``. Each operand is split as big = tf32(v), small =
    tf32(v − big); each 8-deep step of the sum forms small·big + big·small +
    big·big (the small·small term is dropped) in a fresh partial, which is
    added to the f32 accumulator. A product of two TF32 values is exact in
    f32. Not modelled: the kernels add their partials every few steps, and
    the tensor cores round a partial's sums toward zero; here every sum
    rounds to nearest."""
    a_big, b_big = tf32_round(a), tf32_round(b)
    a_small, b_small = tf32_round(a - a_big), tf32_round(b - b_big)
    acc = a.new_zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], _TF32_STEP):
        s = slice(k, k + _TF32_STEP)
        acc = acc + (a_small[:, s] @ b_big[s] + a_big[:, s] @ b_small[s] + a_big[:, s] @ b_big[s])
    return acc


def wgrad_3xtf32(xh, dy_raw, dy, yn, slots: int):
    """``ln_gru_wgrad`` in its arithmetic: dW = xhᵀ·dy_raw through
    ``matmul_3xtf32``; dscale = Σ dy·yn and dbias = Σ dy as ``slots``
    partial sums over the rows [p·M // slots, (p+1)·M // slots), added in
    slot order. The kernel has one slot for each row of its blocks
    (``ln_gru_wgrad_slots``: ceil(K / the tile's rows), 8 at DreamerV3-S);
    inside a slot it sums in another order than ``torch.sum``."""
    M, N = dy.shape
    cuts = [p * M // slots for p in range(slots + 1)]
    dscale, dbias = dy.new_zeros(N), dy.new_zeros(N)
    for lo, hi in zip(cuts, cuts[1:]):
        dscale = dscale + (dy[lo:hi] * yn[lo:hi]).sum(0)
        dbias = dbias + dy[lo:hi].sum(0)
    return matmul_3xtf32(xh.t(), dy_raw), dscale, dbias


# --------------------------------------------------------------------------
# the recurrent kernels' algorithm, CTA by CTA (for the CPU tests)
# --------------------------------------------------------------------------
def _cta_layout(H: int, n_cta: int) -> Tuple[List[slice], List[torch.Tensor]]:
    """Units J_c and gate columns {j, H+j, 2H+j : j in J_c} of each CTA."""
    units = H // n_cta
    J = [slice(c * units, (c + 1) * units) for c in range(n_cta)]
    cols = [torch.cat([torch.arange(j.start, j.stop) + g * H for g in range(3)]) for j in J]
    return J, cols


def _in_order(parts):
    """The sum of ``parts`` added left to right."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _phases(n: int, stride: int, period: int) -> List[torch.Tensor]:
    """The indices i < n with i % period % stride == p, for each phase p of
    ``stride``: a streamed kernel's k-groups (the rows kk = p, p + stride, ...
    of every tile of ``period`` rows) or its column phases."""
    i = torch.arange(n)
    return [i[(i % period) % stride == p] for p in range(min(stride, period))]


def forward_cluster_emulated(feats, first, h_first, w, scale, bias, n_cta: int, kt: int = 0):
    """``ln_gru_xproj`` + ``ln_gru_fwd`` as the kernels compute them, with
    ``n_cta`` CTAs a cluster: Gx outside the loop; each CTA's y_raw on its
    gate columns from its W_h slice; per-CTA (mean, M2) combined by Chan's
    formula in CTA order; the gates of the CTA's units; Gx in 3xTF32
    (``matmul_3xtf32``). ``kt`` > 0 is the streamed instance with W_h tiles
    of ``kt`` rows: each CTA's product is the sum, in group order, of its
    k-groups' partials (group g takes the rows kk = g, g + KS, ... of every
    tile, KS = 256 / units); 0 is the resident instance. ``h_first`` is
    [B, H]; returns (hs, yn, istd) like ``forward_plain``."""
    T, B, F = feats.shape
    H = w.shape[1] // 3
    ncol = 3 * H // n_cta
    J, cols = _cta_layout(H, n_cta)
    gx = matmul_3xtf32(feats.reshape(T * B, F), w[:F]).reshape(T, B, 3 * H)
    slices = [w[F:][:, col] for col in cols]
    groups = _phases(H, (32 * _WARPS) // (H // n_cta), kt) if kt else [torch.arange(H)]
    hs, yns, istds = [], [], []
    h_in = first[0] * h_first
    for t in range(T):
        y = [gx[t][:, col] + _in_order([h_in[:, k] @ wc[k] for k in groups]) for col, wc in zip(cols, slices)]
        m, m2 = y[0].new_zeros(B), y[0].new_zeros(B)
        for q, yc in enumerate(y):  # Chan's formula, CTA order
            mq = yc.mean(-1)
            delta = mq - m
            m = m + delta / (q + 1)
            m2 = m2 + ((yc - mq[:, None]) ** 2).sum(-1) + delta * delta * (ncol * q / (q + 1))
        istd = torch.rsqrt(m2 / (3 * H) + _EPS)
        h_new = torch.empty_like(h_in)
        yn = gx.new_empty(B, 3 * H)
        for j, col, yc in zip(J, cols, y):
            ync = (yc - m[:, None]) * istd[:, None]
            yn[:, col] = ync
            h_new[:, j] = _gates(ync, h_in[:, j], scale[col], bias[col], j.stop - j.start)
        hs.append(h_new)
        yns.append(yn)
        istds.append(istd)
        if t + 1 < T:
            h_in = (1.0 - first[t + 1]) * h_new + first[t + 1] * h_first
    return torch.stack(hs), torch.stack(yns), torch.stack(istds)


def backward_cluster_emulated(feats, first, hs, h_first, w, scale, bias, g, yn, istd, n_cta: int, kt: int = 0):
    """``ln_gru_bwd`` + ``ln_gru_dx`` + ``ln_gru_wgrad`` as the kernels
    compute them, with ``n_cta`` CTAs a cluster: each CTA's cell backward
    from the saved yn on its units; the LN-backward row sums added over the
    CTAs in order; each CTA's partial dh_in = dy_raw[:, cols_c]·W_h[:, cols_c]ᵀ
    over all H units; the reduce-scatter that adds the partials of J_d in
    CTA order; dfeats and the weight gradient after the loop, in 3xTF32
    (``wgrad_3xtf32`` with one slot for each 128 rows of dW, as the kernel
    has). ``kt`` > 0 is the streamed instance with W_h tiles of ``kt`` rows:
    a unit's partial is the sum over its CS = 256 / kt lanes, each of which
    adds the columns c = s, s + CS, ... of the CTA's; 0 is the resident
    instance. ``h_first`` is [B, H]. Returns (dfeats, dh_first [B, H], dW,
    dscale, dbias)."""
    T, B, F = feats.shape
    H = w.shape[1] // 3
    J, cols = _cta_layout(H, n_cta)
    slices = [w[F:][:, col] for col in cols]
    ncol = 3 * H // n_cta
    phases = _phases(ncol, (32 * _WARPS) // kt, ncol) if kt else [torch.arange(ncol)]
    dy_s = feats.new_empty(T, B, 3 * H)
    dyr_s = torch.empty_like(dy_s)
    xh_s = feats.new_empty(T, B, F + H)
    dh = feats.new_zeros(B, H)
    dh_first = feats.new_zeros(B, H)
    for t in range(T - 1, -1, -1):
        f = first[t]
        h_prev = hs[t - 1] if t > 0 else torch.zeros_like(dh)
        h_in = (1.0 - f) * h_prev + f * h_first
        dd = torch.empty_like(dh)
        dyn, s1, s2 = [], 0.0, 0.0
        for j, col in zip(J, cols):  # each CTA: cell backward of its units, its row sums
            units = j.stop - j.start
            dy_c, dd[:, j] = _cell_backward(g[t][:, j] + dh[:, j], yn[t][:, col], h_in[:, j],
                                            scale[col], bias[col], units)
            dy_s[t][:, col] = dy_c
            dyn.append(dy_c * scale[col])
            s1 = s1 + dyn[-1].sum(-1)
            s2 = s2 + (dyn[-1] * yn[t][:, col]).sum(-1)
        m1, m2 = s1 / (3 * H), s2 / (3 * H)
        partial = []
        for col, dync, wc in zip(cols, dyn, slices):
            dyr_c = istd[t][:, None] * (dync - m1[:, None] - yn[t][:, col] * m2[:, None])
            dyr_s[t][:, col] = dyr_c
            partial.append(_in_order([dyr_c[:, c] @ wc[:, c].t() for c in phases]))  # [B, H]: this CTA's share
        dh_in = torch.empty_like(dh)
        for j in J:  # reduce-scatter: CTA d adds the partials of J_d in CTA order
            s = partial[0][:, j]
            for p in partial[1:]:
                s = s + p[:, j]
            dh_in[:, j] = dd[:, j] + s
        dh = (1.0 - f) * dh_in
        dh_first = dh_first + f * dh_in
        xh_s[t] = torch.cat([feats[t], h_in], dim=-1)
    M = T * B
    dfeats = matmul_3xtf32(dyr_s.reshape(M, 3 * H), w[:F].t()).reshape(T, B, F)
    dw, dscale, dbias = wgrad_3xtf32(xh_s.reshape(M, -1), dyr_s.reshape(M, -1), dy_s.reshape(M, -1),
                                     yn.reshape(M, -1), slots=-(-(F + H) // 128))
    return dfeats, dh_first, dw, dscale, dbias


# --------------------------------------------------------------------------
# the CUDA library: built with nvcc at first use, bound with ctypes
# --------------------------------------------------------------------------
_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_CAPACITY: Dict[Tuple[int, int], Tuple[int, int]] = {}
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
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
    log.write_text(text)
    os.replace(tmp, lib)
    build.builds += 1
    build.seconds += time.perf_counter() - t0
    return lib, text


build.builds, build.seconds = 0, 0.0  # the compiles this process ran, and their seconds


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            lib.ln_gru_xproj.argtypes = [_P] * 3 + [_I] * 3 + [_P]
            lib.ln_gru_fwd.argtypes = lib.ln_gru_fwd_probe.argtypes = [_P] * 9 + [_I] * 6 + [_P]
            lib.ln_gru_bwd.argtypes = lib.ln_gru_bwd_probe.argtypes = [_P] * 14 + [_I] * 7 + [_P]
            lib.ln_gru_dx.argtypes = [_P] * 3 + [_I] * 3 + [_P]
            lib.ln_gru_wgrad.argtypes = [_P] * 9 + [_I] * 3 + [_P]
            for name in ("wgrad_slots", "wgrad_tiles"):
                getattr(lib, f"ln_gru_{name}").argtypes = [_I]
                getattr(lib, f"ln_gru_{name}").restype = _I
            for name in ("xproj", "fwd", "fwd_probe", "bwd", "bwd_probe", "dx", "wgrad"):
                getattr(lib, f"ln_gru_{name}").restype = _I
            lib.ln_gru_max_active_clusters.argtypes = [_I] * 5
            lib.ln_gru_max_active_clusters.restype = _I
            lib.ln_gru_last_blocks.argtypes = [_I]
            lib.ln_gru_last_blocks.restype = _I
            lib.ln_gru_error_string.argtypes = [_I]
            lib.ln_gru_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _error(code: int) -> str:
    return _lib().ln_gru_error_string(code).decode()


def cluster_capacity(hidden_size: int, device: Optional[torch.device] = None) -> Tuple[int, int]:
    """How many clusters of ``ln_gru_fwd`` and of ``ln_gru_bwd`` the card can
    hold at once at this H (``cudaOccupancyMaxActiveClusters``, with the
    instance's kernels, shared memory and cluster size); raises if the card
    cannot tell. The launch needs ceil(B / ROWS_PER_CLUSTER) clusters; fewer
    than that run in turns, none is refused."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    key = (dev.index if dev.index is not None else torch.cuda.current_device(), int(hidden_size))
    if key not in _CAPACITY:
        lib = _lib()
        _, _, units, kt, smem = launch_layout(key[1])
        with torch.cuda.device(key[0]):
            got = tuple(lib.ln_gru_max_active_clusters(which, key[1], units, kt, n) for which, n in enumerate(smem))
        for name, n in zip(("ln_gru_fwd", "ln_gru_bwd"), got):
            if n < 0:
                raise RuntimeError(f"{name}: the cluster occupancy query failed: {_error(-n)}")
        _CAPACITY[key] = got
    return _CAPACITY[key]


FIT_RULE = ("H must split into at most 16 CTAs of 4, 8, 16 or 32 units whose W_h slice fits shared memory "
            "(H <= 512), or into 16 CTAs of a multiple of 8 units, at most 256, that stream it (H = 128·m <= "
            "4096)")


def _require_clusters(name: str, device: torch.device, hidden_size: int) -> Tuple[int, int, Tuple[int, int]]:
    """Raise unless the kernels take this H and the card holds at least one
    of their clusters: a CUDA tensor never takes the plain path. Returns the
    launch's units per CTA, W_h tile rows (0: resident) and (forward,
    backward) shared-memory bytes."""
    layout = launch_layout(hidden_size)
    if layout is None:
        raise ValueError(f"{name}: H={hidden_size} is not a shape the kernels take ({FIT_RULE})")
    instance, nc, units, kt, smem = layout
    fwd, bwd = cluster_capacity(hidden_size, device)
    if min(fwd, bwd) < 1:
        raise RuntimeError(
            f"{name}: this card cannot hold one {instance} cluster of {nc} CTAs with {max(smem)} bytes of "
            f"shared memory each (clusters: forward {fwd}, backward {bwd})"
        )
    return units, kt, smem


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


def _require_aligned(name: str, **tensors) -> None:
    """Tensors the kernel reads as float4."""
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def _require_gemm_rows(name: str, **tensors) -> None:
    """The 3xTF32 GEMMs copy each row of their operands as 16-byte chunks:
    rows of a multiple of 4 floats, from 16-byte-aligned data."""
    for arg, t in tensors.items():
        if t.shape[-1] % 4:
            raise ValueError(f"{name}: {arg} has rows of {t.shape[-1]} floats, not a shape the kernels take "
                             "(rows of a multiple of 4 floats)")
    _require_aligned(name, **tensors)


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: {_error(rc)}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _empty(device, *shape) -> torch.Tensor:
    return torch.empty(*shape, device=device, dtype=torch.float32)


# Where each launch reports its operations and f32 bytes (each input read
# once, each output written once) while a cost count is open
# (``telemetry.throughput.model_cost``): the work of the train step that
# PyTorch's dispatcher does not see. Process-wide, not per thread: autograd
# runs a CUDA backward on a thread of its own.
_work_sink: Optional[Callable[[int, int], None]] = None


def set_work_sink(sink: Optional[Callable[[int, int], None]]) -> None:
    """Send every launch's (operations, bytes) to ``sink`` until it is set
    back to None."""
    global _work_sink
    _work_sink = sink


def _count_work(flops: int, floats: int) -> None:
    sink = _work_sink
    if sink is not None:
        sink(flops, 4 * floats)


def ln_gru_xproj(x, wx) -> torch.Tensor:
    """x [M, F], wx [F, N] → Gx = x·wx [M, N] (the input half of the
    forward's product, all rows at once)."""
    if not x.is_cuda:
        return xproj_plain(x, wx)
    M, F = x.shape
    N = wx.shape[-1]
    _check("ln_gru_xproj", x.device, x=(x, (M, F)), wx=(wx, (F, N)))
    _require_gemm_rows("ln_gru_xproj", x=x, wx=wx)
    out = _empty(x.device, M, N)
    _launch("ln_gru_xproj", _lib().ln_gru_xproj, x.data_ptr(), wx.data_ptr(), out.data_ptr(), M, F, N, _stream())
    ln_gru_xproj.launches += 1
    _count_work(2 * M * F * N, M * F + F * N + M * N)
    return out


ln_gru_xproj.launches = 0


def ln_gru_fwd(gx, first, h_first, w_h, scale, bias):
    """The recurrence: Gx [T,B,3H], first [T,B,1], h_first [B,H], w_h
    [H,3H], scale/bias [3H] → (hs [T,B,H], yn [T,B,3H], istd [T,B])."""
    if not gx.is_cuda:
        return forward_plain(gx, first, h_first, w_h, scale, bias)
    T, B, N = gx.shape
    H = w_h.shape[0]
    _check(
        "ln_gru_fwd", gx.device, gx=(gx, (T, B, 3 * H)), first=(first, (T, B, 1)), h_first=(h_first, (B, H)),
        w_h=(w_h, (H, 3 * H)), scale=(scale, (3 * H,)), bias=(bias, (3 * H,)),
    )
    _require_aligned("ln_gru_fwd", w_h=w_h)
    units, kt, (smem, _) = _require_clusters("ln_gru_fwd", gx.device, H)
    hs, yn, istd = _empty(gx.device, T, B, H), _empty(gx.device, T, B, 3 * H), _empty(gx.device, T, B)
    _launch(
        "ln_gru_fwd", _lib().ln_gru_fwd, gx.data_ptr(), first.data_ptr(), h_first.data_ptr(), w_h.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), hs.data_ptr(), yn.data_ptr(), istd.data_ptr(), T, B, H, units, kt,
        smem, _stream(),
    )
    ln_gru_fwd.launches += 1
    _count_work(2 * T * B * H * 3 * H, 2 * T * B * 3 * H + 2 * T * B + B * H + 3 * H * H + 6 * H + T * B * H)
    return hs, yn, istd


ln_gru_fwd.launches = 0


def ln_gru_bwd(feats, first, hs, h_first, w_h, scale, bias, g, yn, istd):
    """Reverse sweep: feats [T,B,F], first, hs and g [T,B,H], h_first [B,H],
    w_h [H,3H], scale/bias, and the forward's yn [T,B,3H] and istd [T,B] →
    (dh_first [B,H], dy, dy_raw [T,B,3H], xh [T,B,F+H])."""
    if not feats.is_cuda:
        return backward_plain(feats, first, hs, h_first, w_h, scale, bias, g, yn, istd)
    T, B, F = feats.shape
    H = w_h.shape[0]
    _check(
        "ln_gru_bwd", feats.device, feats=(feats, (T, B, F)), first=(first, (T, B, 1)), hs=(hs, (T, B, H)),
        h_first=(h_first, (B, H)), w_h=(w_h, (H, 3 * H)), scale=(scale, (3 * H,)), bias=(bias, (3 * H,)),
        g=(g, (T, B, H)), yn=(yn, (T, B, 3 * H)), istd=(istd, (T, B)),
    )
    if F % 4:
        raise ValueError(f"ln_gru_bwd: F={F} is not a shape the kernel takes (F must be a multiple of 4)")
    _require_aligned("ln_gru_bwd", feats=feats, w_h=w_h)
    units, kt, (_, smem) = _require_clusters("ln_gru_bwd", feats.device, H)
    dev = feats.device
    dh_first, xh = _empty(dev, B, H), _empty(dev, T, B, F + H)
    dy, dy_raw = _empty(dev, T, B, 3 * H), _empty(dev, T, B, 3 * H)
    _launch(
        "ln_gru_bwd", _lib().ln_gru_bwd, feats.data_ptr(), first.data_ptr(), hs.data_ptr(), h_first.data_ptr(),
        w_h.data_ptr(), scale.data_ptr(), bias.data_ptr(), g.data_ptr(), yn.data_ptr(), istd.data_ptr(),
        dh_first.data_ptr(), dy.data_ptr(), dy_raw.data_ptr(), xh.data_ptr(), T, B, F, H, units, kt, smem,
        _stream(),
    )
    ln_gru_bwd.launches += 1
    _count_work(2 * T * B * H * 3 * H, T * B * (F + 2 * H + 2) + 2 * B * H + 3 * H * H + 6 * H
                + 3 * T * B * 3 * H + T * B * (F + H))
    return dh_first, dy, dy_raw, xh


ln_gru_bwd.launches = 0


def ln_gru_dx(dy_raw, wx) -> torch.Tensor:
    """dy_raw [M, N], wx [F, N] → dfeats = dy_raw·wxᵀ [M, F]."""
    if not dy_raw.is_cuda:
        return dx_plain(dy_raw, wx)
    M, N = dy_raw.shape
    F = wx.shape[0]
    _check("ln_gru_dx", dy_raw.device, dy_raw=(dy_raw, (M, N)), wx=(wx, (F, N)))
    if F % 4:
        raise ValueError(f"ln_gru_dx: F={F} is not a shape the kernels take (a multiple of 4)")
    _require_gemm_rows("ln_gru_dx", dy_raw=dy_raw, wx=wx)
    out = _empty(dy_raw.device, M, F)
    _launch("ln_gru_dx", _lib().ln_gru_dx, dy_raw.data_ptr(), wx.data_ptr(), out.data_ptr(), M, F, N, _stream())
    ln_gru_dx.launches += 1
    _count_work(2 * M * N * F, M * N + F * N + M * F)
    return out


ln_gru_dx.launches = 0


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
    _require_gemm_rows("ln_gru_wgrad", xh=xh, dy_raw=dy_raw, dy=dy, yn=yn)
    lib = _lib()
    dW, dscale, dbias = _empty(xh.device, K, N), _empty(xh.device, N), _empty(xh.device, N)
    # the column sums' scratch, this launch's own: the partial slots and the
    # column tiles' arrival counters (zero)
    part = _empty(xh.device, lib.ln_gru_wgrad_slots(K), 2, N)
    arrivals = torch.zeros(lib.ln_gru_wgrad_tiles(N), device=xh.device, dtype=torch.int32)
    _launch(
        "ln_gru_wgrad", lib.ln_gru_wgrad, xh.data_ptr(), dy_raw.data_ptr(), dy.data_ptr(), yn.data_ptr(),
        part.data_ptr(), arrivals.data_ptr(), dW.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), M, K, N,
        _stream(),
    )
    ln_gru_wgrad.launches += 1
    _count_work(2 * M * K * N + 3 * M * N, M * K + 3 * M * N + K * N + 2 * N)
    return dW, dscale, dbias


ln_gru_wgrad.launches = 0
# in the order of the CUDA source's launch records (ln_gru_last_blocks)
KERNELS = (ln_gru_xproj, ln_gru_fwd, ln_gru_bwd, ln_gru_dx, ln_gru_wgrad)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# --------------------------------------------------------------------------
# autograd binding
# --------------------------------------------------------------------------
class _LNGRUSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, first, h_first, w, scale, bias, plain):
        T, B, F = feats.shape
        H = h_first.shape[-1]
        ctx.h_first_1d = h_first.dim() == 1  # the caller's shape, before the broadcast to [B, H]
        args = [a.contiguous().float() for a in (feats, first, h_first.expand(B, H), w, scale, bias)]
        feats, first, h_first, w, scale, bias = args
        xproj, fwd = (xproj_plain, forward_plain) if plain else (ln_gru_xproj, ln_gru_fwd)
        gx = xproj(feats.reshape(T * B, F), w[:F]).reshape(T, B, 3 * H)
        hs, yn, istd = fwd(gx, first, h_first, w[F:], scale, bias)
        ctx.save_for_backward(*args, hs, yn, istd)
        ctx.plain = plain
        return hs

    @staticmethod
    def backward(ctx, g):
        feats, first, h_first, w, scale, bias, hs, yn, istd = ctx.saved_tensors
        T, B, F = feats.shape
        M = T * B
        if ctx.plain:
            bwd, dx, wgrad = backward_plain, dx_plain, wgrad_plain
        else:
            bwd, dx, wgrad = ln_gru_bwd, ln_gru_dx, ln_gru_wgrad
        dh_first, dy, dy_raw, xh = bwd(feats, first, hs, h_first, w[F:], scale, bias, g.contiguous().float(), yn,
                                       istd)
        dfeats = dx(dy_raw.reshape(M, -1), w[:F]).reshape(T, B, F)
        dw, dscale, dbias = wgrad(xh.reshape(M, -1), dy_raw.reshape(M, -1), dy.reshape(M, -1), yn.reshape(M, -1))
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

    Returns [T, B, H] hidden states; the backward is the reverse sweep, the
    input cotangent and the weight-gradient reduction."""
    return _LNGRUSequence.apply(feats, first, h_first, w, scale, bias, plain)
