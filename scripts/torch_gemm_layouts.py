#!/usr/bin/env python3
"""Check and time the tile layouts tried for the PyTorch port's 3xTF32 GEMMs
(``ln_gru_xproj``, ``ln_gru_dx`` and ``ln_gru_wgrad``,
``sheeprl_tpu_torch/csrc/ln_gru.cu``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 scripts/torch_gemm_layouts.py [S|XS]

The CUDA source launches one layout of each GEMM, given by its macros
``LN_GRU_XPROJ_LAYOUT``, ``LN_GRU_DX_LAYOUT`` and ``LN_GRU_WGRAD_LAYOUT``;
the first entry of each list below is that layout. This script builds the
library once for each index i of the longest list (all nvcc processes at
once, into ``csrc/build/layouts/``) from a source that defines the three
macros, each as its list's entry i or, past its end, its first entry, and
includes ``ln_gru.cu``. On the inputs of ``chip_smoke.py`` at the GRU shape
of DreamerV3-S (the default) or XS (TF32 off) it holds each layout to the
checks ``chip_smoke.py`` holds the kernels to: the plain version within the
tolerance (for ``ln_gru_wgrad`` dW, dscale and dbias), the product within
``F64_FACTOR`` times ``torch.mm``'s error against float64, two launches
bitwise equal. It times each layout, and
``torch.mm`` of each product on the same inputs, with ``chip_smoke.time_ms``.
The first layout must give the bits of the library the port launches.

Prints the card's name and power limit (nvidia-smi), one JSON line for
``torch.mm`` and one for each layout; exits non-zero, and prints no result,
if there is no card or a layout does not build or check. Launches through
these libraries count no launch of the port's kernels.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# GemmLayout's parameters: tile rows, columns and depth (BM, BN, BK); warps
# along the rows and the columns (WM, WN); groups of warps that split a
# stage's k-steps; stages of the cp.async ring; k-steps a partial collects
# before it is added to the f32 accumulator
XPROJ = (
    (128, 96, 64, 4, 2, 1, 3, 4),
    (128, 96, 64, 4, 2, 1, 3, 1),
    (128, 96, 32, 4, 2, 1, 4, 4),
    (64, 96, 32, 2, 2, 1, 4, 4),
    (128, 96, 64, 4, 2, 2, 3, 1),
)
DX = (
    (32, 64, 32, 1, 2, 2, 4, 1),
    (32, 64, 32, 1, 2, 2, 4, 2),
    (64, 64, 32, 2, 2, 2, 4, 2),
    (64, 64, 64, 2, 2, 2, 3, 4),
    (64, 64, 64, 2, 2, 4, 3, 1),
)
WGRAD = (
    (128, 96, 32, 4, 2, 1, 4, 4),
    (128, 96, 64, 4, 2, 1, 3, 4),
    (128, 96, 64, 4, 2, 2, 3, 1),
    (64, 96, 32, 2, 2, 1, 4, 4),
    (32, 96, 32, 1, 2, 2, 4, 1),
    (128, 96, 32, 4, 2, 1, 5, 4),
    (128, 96, 32, 4, 2, 1, 3, 4),
)
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_all(ln_gru):
    """One library for each index i of the longest list, with entry i of each
    list (its first past its end), all nvcc processes at once."""
    out = ln_gru.BUILD_DIR / "layouts"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i in range(max(map(len, (XPROJ, DX, WGRAD)))):
        xl, dl, wl = (lists[i] if i < len(lists) else lists[0] for lists in (XPROJ, DX, WGRAD))
        src, lib = out / f"layouts_{i}.cu", out / f"layouts_{i}.so"
        src.write_text(f"#define LN_GRU_XPROJ_LAYOUT {', '.join(map(str, xl))}\n"
                       f"#define LN_GRU_DX_LAYOUT {', '.join(map(str, dl))}\n"
                       f"#define LN_GRU_WGRAD_LAYOUT {', '.join(map(str, wl))}\n"
                       f'#include "{ln_gru._SOURCE}"\n')
        cmd = [ln_gru._nvcc(), *ln_gru.NVCC_FLAGS, "-o", str(lib), str(src)]
        jobs.append((lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for lib, cmd, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        handle = ctypes.CDLL(str(lib))
        for name in ("ln_gru_xproj", "ln_gru_dx"):
            getattr(handle, name).argtypes = [_P] * 3 + [_I] * 3 + [_P]
        handle.ln_gru_wgrad.argtypes = [_P] * 8 + [_I] * 3 + [_P]
        handle.ln_gru_wgrad_slots.argtypes = [_I]
        for name in ("ln_gru_xproj", "ln_gru_dx", "ln_gru_wgrad", "ln_gru_wgrad_slots"):
            getattr(handle, name).restype = _I
        libs.append(handle)
    return libs


def main(label: str = "S") -> int:
    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"ok": False, "error": "torch.cuda.is_available() is False: this script needs an NVIDIA GPU"}))
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from sheeprl_tpu_torch.ops import ln_gru

    if label not in cs.SHAPES:
        print(json.dumps({"ok": False, "error": f"unknown shape {label!r}: one of {sorted(cs.SHAPES)}"}))
        return 2

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_all(ln_gru)

    # the operands of the three GEMMs at the shape asked for, dy, dy_raw and xh from the plain passes
    dev = torch.device("cuda")
    shape = cs.SHAPES[label]
    T_, B_, F, H = shape
    feats, first, w, scale, bias, cot, g = cs.gru_inputs(torch, shape, dev)
    hf = 0.5 * torch.randn(B_, H, device=dev, generator=g)
    M, N, K = T_ * B_, 3 * H, F + H
    x2, wx = feats.reshape(M, F), w[:F]
    hs, yn, istd = ln_gru.forward_plain(ln_gru.xproj_plain(x2, wx).reshape(T_, B_, N), first, hf, w[F:], scale, bias)
    _, dy, dyr, xh = ln_gru.backward_plain(feats, first, hs, hf, w[F:], scale, bias, cot, yn, istd)
    dy2, dyr2, xh2, yn2 = dy.reshape(M, N), dyr.reshape(M, N), xh.reshape(M, K), yn.reshape(M, N)
    stream = torch.cuda.current_stream().cuda_stream
    wg_in = (xh2, dyr2, dy2, yn2)

    def entry(name, lib, i):
        """A launch of the kernel through library ``lib``: returns its outputs."""
        fn = getattr(lib, name)

        def run(ins, outs, dims):  # ins: inputs and scratch, held until the launch is queued
            rc = fn(*(t.data_ptr() for t in ins + outs), *dims, stream)
            if rc != 0:
                raise RuntimeError(f"{name} layout {i}: CUDA error {rc}: {ln_gru._error(rc)}")
            return outs

        empty = lambda *shape: torch.empty(*shape, device=dev)  # noqa: E731
        if name == "ln_gru_wgrad":
            return lambda: run(wg_in + (empty(lib.ln_gru_wgrad_slots(K), 2, N),), (empty(K, N), empty(N), empty(N)),
                               (M, K, N))
        a, cols = (x2, N) if name == "ln_gru_xproj" else (dyr2, F)
        return lambda: run((a, wx), (empty(M, cols),), (M, F, N))

    cases = (  # kernel, layouts, the product a·b of its first output, its output's rows and columns, tolerance,
        # the plain version's outputs, the port's
        ("ln_gru_xproj", XPROJ, (x2, wx), (M, N), cs.FWD_TOL, (ln_gru.xproj_plain(x2, wx),),
         (ln_gru.ln_gru_xproj(x2, wx),)),
        ("ln_gru_dx", DX, (dyr2, wx.t()), (M, F), cs.GRAD_TOL, (ln_gru.dx_plain(dyr2, wx),),
         (ln_gru.ln_gru_dx(dyr2, wx),)),
        ("ln_gru_wgrad", WGRAD, (xh2.t(), dyr2), (K, N), cs.GRAD_TOL, ln_gru.wgrad_plain(*wg_in),
         ln_gru.ln_gru_wgrad(*wg_in)),
    )
    mm_ms = {name: cs.time_ms(lambda ab=ab: torch.mm(*ab)) for name, _, ab, *_ in cases}
    print(json.dumps({"shape": label, "torch_mm_ms": mm_ms}), flush=True)
    for name, layouts, ab, (rows, cols), tol, plain, port in cases:
        first_out = None
        for i, (layout, lib) in enumerate(zip(layouts, libs)):
            launch = entry(name, lib, i)
            got, errs, f64 = launch(), {}, {}
            for j, (a, b) in enumerate(zip(got, plain)):
                cs.check(f"{name}.{j}", a, b, tol, errs)
            cs.check_gemm(torch, name, got[0], *ab, lambda: launch()[0], f64)
            if not all(torch.equal(a, b) for a, b in zip(launch(), got)):
                raise AssertionError(f"{name} layout {i}: two launches on the same inputs differ")
            if i == 0:
                first_out = got
                if not all(torch.equal(a, b) for a, b in zip(got, port)):
                    raise AssertionError(f"{name}: layout 0 does not give the bits of the port's library")
            bm, bn, bk, wm, wn, groups, stages, fold = layout
            print(json.dumps({
                "kernel": name, "shape": label, "layout": i, "tile": f"{bm}x{bn}x{bk}", "warps": f"{wm}x{wn}x{groups}",
                "stages": stages, "k_steps_a_fold": fold, "blocks": -(-cols // bn) * -(-rows // bm),
                "ms": cs.time_ms(launch), "max_abs_err": max(errs.values()), "err_vs_f64": f64[name]["kernel"],
                "torch_mm_err_vs_f64": f64[name]["torch_mm"],
                "same_bits_as_layout_0": all(torch.equal(a, b) for a, b in zip(got, first_out)),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
