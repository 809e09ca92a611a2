#!/usr/bin/env python3
"""Check and time the tile layouts tried for the PyTorch port's 3xTF32 GEMMs
(``ln_gru_xproj`` and ``ln_gru_dx``, ``sheeprl_tpu_torch/csrc/ln_gru.cu``) on
one NVIDIA GPU.

Run from the root of a checkout:  python3 scripts/torch_gemm_layouts.py

The CUDA source launches one layout of each GEMM, given by its macros
``LN_GRU_XPROJ_LAYOUT`` and ``LN_GRU_DX_LAYOUT``; the first entry of each list
below is that layout. This script builds the library once for each pair of
entries (all nvcc processes at once, into ``csrc/build/layouts/``) from a
source that defines the two macros and includes ``ln_gru.cu``. On the
DreamerV3-S inputs of ``chip_smoke.py`` (TF32 off) it holds each layout to
the checks ``chip_smoke.py`` holds the kernels to: the plain version within
the tolerance, float64 within ``F64_FACTOR`` times ``torch.mm``'s error, two
launches bitwise equal. It times each layout, and ``torch.mm`` on the same
inputs, with ``chip_smoke.time_ms``. The first layout must give the bits of
the library the port launches.

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


def build_all(ln_gru):
    """One library for each (XPROJ[i], DX[i]), all nvcc processes at once."""
    out = ln_gru.BUILD_DIR / "layouts"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (xl, dl) in enumerate(zip(XPROJ, DX)):
        src, lib = out / f"layouts_{i}.cu", out / f"layouts_{i}.so"
        src.write_text(f"#define LN_GRU_XPROJ_LAYOUT {', '.join(map(str, xl))}\n"
                       f"#define LN_GRU_DX_LAYOUT {', '.join(map(str, dl))}\n"
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
            getattr(handle, name).argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            getattr(handle, name).restype = ctypes.c_int
        libs.append(handle)
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"ok": False, "error": "torch.cuda.is_available() is False: this script needs an NVIDIA GPU"}))
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from sheeprl_tpu_torch.ops import ln_gru

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_all(ln_gru)

    # the DreamerV3-S operands of both GEMMs, dy_raw from the plain passes
    dev = torch.device("cuda")
    T_, B_, F, H = cs.SHAPES["S"]
    feats, first, w, scale, bias, cot, g = cs.gru_inputs(torch, cs.SHAPES["S"], dev)
    hf = 0.5 * torch.randn(B_, H, device=dev, generator=g)
    M, N = T_ * B_, 3 * H
    x2, wx = feats.reshape(M, F), w[:F]
    hs, yn, istd = ln_gru.forward_plain(ln_gru.xproj_plain(x2, wx).reshape(T_, B_, N), first, hf, w[F:], scale, bias)
    dyr2 = ln_gru.backward_plain(feats, first, hs, hf, w[F:], scale, bias, cot, yn, istd)[2].reshape(M, N)
    stream = torch.cuda.current_stream().cuda_stream
    cases = (  # kernel, layouts, entry's first operand, the product a·b, output columns, plain output, tolerance
        ("ln_gru_xproj", XPROJ, x2, (x2, wx), N, ln_gru.xproj_plain(x2, wx), cs.FWD_TOL, ln_gru.ln_gru_xproj(x2, wx)),
        ("ln_gru_dx", DX, dyr2, (dyr2, wx.t()), F, ln_gru.dx_plain(dyr2, wx), cs.GRAD_TOL, ln_gru.ln_gru_dx(dyr2, wx)),
    )
    print(json.dumps({"torch_mm_ms": {name: cs.time_ms(lambda ab=ab: torch.mm(*ab)) for name, _, _, ab, *_ in cases}}),
          flush=True)
    for name, layouts, a, ab, cols, plain, tol, port in cases:
        first_out = None
        for i, (layout, lib) in enumerate(zip(layouts, libs)):

            def launch(fn=getattr(lib, name), a=a, cols=cols):
                c = torch.empty(M, cols, device=dev)
                rc = fn(a.data_ptr(), wx.data_ptr(), c.data_ptr(), M, F, N, stream)
                if rc != 0:
                    raise RuntimeError(f"{name} layout {i}: CUDA error {rc}: {ln_gru._error(rc)}")
                return c

            got, errs, f64 = launch(), {}, {}
            cs.check(name, got, plain, tol, errs)
            cs.check_gemm(torch, name, got, *ab, launch, f64)
            if i == 0:
                first_out = got
                if not torch.equal(got, port):
                    raise AssertionError(f"{name}: layout 0 does not give the bits of the port's library")
            bm, bn, bk, wm, wn, groups, stages, fold = layout
            print(json.dumps({
                "kernel": name, "layout": i, "tile": f"{bm}x{bn}x{bk}", "warps": f"{wm}x{wn}x{groups}",
                "stages": stages, "k_steps_a_fold": fold, "blocks": -(-cols // bn) * -(-M // bm),
                "ms": cs.time_ms(launch), "max_abs_err": errs[name], "err_vs_f64": f64[name]["kernel"],
                "torch_mm_err_vs_f64": f64[name]["torch_mm"], "same_bits_as_layout_0": bool(torch.equal(got, first_out)),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
