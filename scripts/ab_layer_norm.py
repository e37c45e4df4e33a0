#!/usr/bin/env python3
"""Time copies of the port's LayerNorm kernel (K1) against each other on one
CUDA card, at every shape the eval request runs it.

    python scripts/ab_layer_norm.py [--legacy DIR] [DIR ...]

Each DIR holds a copy of ``transfusion_torch/csrc/layer_norm.cu`` (with
``sm90.cuh``), edited to try one design change; ``transfusion_torch/csrc``
itself may be given. Each copy is built three times with
``ab_attention_fwd.build`` (the port's nvcc flags; registers and spills
printed), under ``transfusion_torch/_build/ab_layer_norm/``: as it is (the
design by form and row count), and with ``K1_DESIGN`` defined as 1 (rows)
and as 2 (the ring, at widths 896 and 384), and launched through its C
entry. ``--legacy DIR`` adds a copy of the kernel that took
contiguous rows only (C entry ``x, r, w, b, out, rows, d, eps, is_bf16,
stream``); at a view x[:, :n] it is timed with the copy the port's wrapper
then made before it. The shapes, inputs and tolerances are
``chip_smoke.py``'s (``LN_SHAPES``: bf16 one ulp for |y| < 8, 3.2e-2; f32
1e-4). A reading is device time: 40 launches, cycling through input sets
that together pass the L2, captured in a CUDA graph and replayed 5 times
between CUDA events; all copies in turns for three rounds, best reading
printed, with the bound and ``F.layer_norm`` for the plain variant.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = os.path.join(HERE, "transfusion_torch", "_build", "ab_layer_norm")
# K1_DESIGN of each build of a copy (csrc/layer_norm.cu).
DESIGNS = {"auto": 0, "rows": 1, "ring": 2}
# The C entry before batch-strided rows.
LEGACY_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                            ctypes.c_void_p]


def design_builds(dirs: list[str]) -> dict:
    """{build dir: (DIR, design)}: for each DIR a copy of its sources per
    design, ``layer_norm.cu`` led by its ``K1_DESIGN`` define (none for
    auto)."""
    builds = {}
    for i, d in enumerate(dirs):
        for design, code in DESIGNS.items():
            dst = os.path.join(COPIES, f"{i}-{design}")
            shutil.rmtree(dst, ignore_errors=True)
            os.makedirs(dst)
            for src in glob.glob(os.path.join(d, "*.cu")) + glob.glob(os.path.join(d, "*.cuh")):
                shutil.copy(src, dst)
            if code:
                path = os.path.join(dst, "layer_norm.cu")
                with open(path) as f:
                    text = f.read()
                with open(path, "w") as f:
                    f.write(f"#define K1_DESIGN {code}\n{text}")
            builds[dst] = (d, design)
    return builds


def launch(lib, x, r, w, b, out, eps):
    """One launch of a build's C entry on x (read in place, view or not), on
    the current stream (a CUDA graph's, when captured)."""
    from transfusion_torch import kernels
    from transfusion_torch.ops import layer_norm as ln

    rpb, stride = ln.row_layout(x)
    d = x.shape[-1]
    args = (x.data_ptr(), None if r is None else r.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            x.numel() // d, d, rpb, stride, eps, int(x.dtype.itemsize == 2))
    return lambda: kernels.check(lib.tf_layer_norm(*args, kernels.stream_handle(x.device)), "tf_layer_norm")


def legacy(lib, x, r, w, b, out, eps):
    """One launch of a legacy copy, after the copy of a view that the port's
    wrapper then made."""
    from transfusion_torch import kernels

    d = x.shape[-1]

    def run():
        xc = x.contiguous()
        kernels.check(lib.tf_layer_norm(xc.data_ptr(), None if r is None else r.data_ptr(), w.data_ptr(),
                                        b.data_ptr(), out.data_ptr(), x.numel() // d, d, eps,
                                        int(x.dtype.itemsize == 2), kernels.stream_handle(x.device)),
                      "tf_layer_norm")
    return run


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_layer_norm: needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--legacy", action="append", default=[], metavar="DIR",
                    help="a copy of the kernel with the contiguous-rows C entry")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from ab_attention_fwd import build
    from transfusion_torch.ops import layer_norm as ln

    builds = design_builds(args.dirs)
    builds.update({d: (d, "legacy") for d in args.legacy})
    libs = build(list(builds), "layer_norm.cu", ("tf_layer_norm",))
    for d in args.legacy:
        if d in libs:
            libs[d].tf_layer_norm.argtypes = LEGACY_SIGNATURE
    g = torch.Generator(device="cuda").manual_seed(1)
    timers, bounds = {}, {}
    for shape in cs.LN_SHAPES:
        label, dd = shape["label"], shape["d"]
        sets, w, b = cs.ln_inputs(torch, shape, g, cs.ln_copies(shape))
        bf16 = shape["dtype"] == "bf16"
        rows = cs.B * shape["n"]
        outs = [torch.empty(cs.B, shape["n"], dd, dtype=x.dtype, device="cuda") for x, _ in sets]
        tol = 3.2e-2 if bf16 else 1e-4
        eps = shape.get("eps", 1e-6)
        want = ln.layer_norm_plain(sets[0][0], w, b, eps, residual=sets[0][1])

        variants = {}
        for path, lib in libs.items():
            how = legacy if builds[path][1] == "legacy" else launch
            variants[builds[path]] = [how(lib, x, r, w, b, o, eps) for (x, r), o in zip(sets, outs)]
        for key, fns in variants.items():
            fns[0]()
            torch.cuda.synchronize()
            err = cs.max_err(outs[0], want)
            print(f"{label}: {key[0]} {key[1]} {'holds' if err <= tol else 'DISAGREES'} "
                  f"(max|kernel - plain| {err:.3e})")
            timers[(label, *key)] = fns
        if not shape["residual"]:
            wl, bl = w.to(sets[0][0].dtype), b.to(sets[0][0].dtype)
            timers[(label, "library", "F.layer_norm")] = [
                lambda x=x, dd=dd, wl=wl, bl=bl, eps=eps: torch.nn.functional.layer_norm(x, (dd,), wl, bl, eps)
                for x, _ in sets]
        bounds[label] = cs.bound_ms(cs.ln_bytes(shape), rows * dd * (9 if shape["residual"] else 8),
                                    cs.F32_FLOPS)[0]
        del want

    times = {key: [] for key in timers}
    for _ in range(3):
        for key, fns in timers.items():
            times[key].append(cs.graph_ms(torch, fns))
    for (label, d, what), t in times.items():
        print(f"{label}: {d} {what} best {min(t):.4f} ms ({100 * bounds[label] / min(t):.1f} % of the "
              f"{bounds[label]:.4f} ms bound), readings {[round(x, 4) for x in t]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
