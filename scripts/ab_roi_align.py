#!/usr/bin/env python3
"""Time edited copies of the port's RoIAlign kernels, forward (K5) and
backward (K6), against each other on one CUDA card.

    python scripts/ab_roi_align.py [--wrappers] [--f32-acc DIR ...] [DIR ...]

Each DIR holds a copy of ``transfusion_torch/csrc/roi_align.cu`` and/or
``roi_align_bwd.cu`` (with ``roi_align.cuh`` where they include it), edited
to try one design change or to leave part of the work out (a diagnostic
copy, wrong by design); ``transfusion_torch/csrc`` itself may be given as
the baseline. Every copy is built with ``ab_attention_fwd.build`` (the
port's nvcc flags; registers and spills printed) and launched through its C
entry at ``chip_smoke.py``'s shapes and inputs: K5 on the bf16 pyramid
[8, 360, 256, 256] with 1000 RoIs an image, K6 with 128 (g [8, 128, 7, 7,
256]). A copy "holds" when its output is within the card checks' tolerances
of the plain version (K5 3.2e-2, K6 one bf16 ulp of max|plain|). A K6 copy
given with ``--f32-acc`` keeps the older contract: it adds into an f32
accumulator that the caller zeroes and then casts to bf16; it is timed
alone and with that zeroing and cast. Times from CUDA events, 20 launches a
reading, all copies in turns for three rounds; the best reading is printed.
``--wrappers`` adds the port's own wrappers (``pooled_from_packed``,
``roi_align_bwd``; the library built from ``transfusion_torch/csrc``) and the
per-forward parameter preparation (``roi_sample_params``); a reading is host
time where the host, not the card, sets the pace.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_roi_align: needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--f32-acc", action="append", default=[], metavar="DIR",
                    help="a K6 copy that adds into a zeroed f32 accumulator")
    ap.add_argument("--wrappers", action="store_true",
                    help="also time the port's own wrappers (built from transfusion_torch/csrc) "
                         "and roi_sample_params")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from ab_attention_fwd import build
    from transfusion_torch import kernels
    from transfusion_torch.ops import roi_align as ra

    dirs = args.dirs + args.f32_acc
    fwd = build([d for d in dirs if os.path.exists(os.path.join(d, "roi_align.cu"))], "roi_align.cu",
                ("tf_roi_align_fwd",))
    bwd = build([d for d in dirs if os.path.exists(os.path.join(d, "roi_align_bwd.cu"))],
                "roi_align_bwd.cu", ("tf_roi_align_bwd",))
    stream, bf16 = kernels.stream_handle(torch.device("cuda")), torch.bfloat16
    timers = {}

    if fwd or args.wrappers:
        n5 = 1000
        _, _, rois, packed, shapes, offsets, params = cs.roi_inputs(torch, 3, n5, True)
        fp, ip = params["fparams"], params["iparams"]
        out = torch.empty(cs.B, n5, 7, 7, cs.ROI_C, dtype=bf16, device="cuda")

        def k5(lib):
            return lambda: kernels.check(lib.tf_roi_align_fwd(
                packed.data_ptr(), fp.data_ptr(), ip.data_ptr(), out.data_ptr(), cs.B, n5, packed.shape[1],
                packed.shape[2], cs.ROI_C, 7, 1, stream), "tf_roi_align_fwd")

        if args.wrappers:
            kernels.library()
            timers[("wrapper", "K5 pooled_from_packed")] = lambda: ra.pooled_from_packed(packed, params)
            timers[("wrapper", "roi_sample_params")] = lambda: ra.roi_sample_params(
                rois, shapes, offsets, (cs.H, cs.W), 7, 0)
        want = ra.roi_align_plain(packed, params)
        for d, lib in fwd.items():
            k5(lib)()
            torch.cuda.synchronize()
            err = cs.max_err(out, want)
            print(f"{d}: K5 {'holds' if err <= 3.2e-2 else 'DISAGREES'} (max|kernel - plain| {err:.3e})")
            timers[(d, "K5")] = k5(lib)
        del want

    if bwd or args.wrappers:
        n6 = 128
        g, _, _, packed6, _, _, params6 = cs.roi_inputs(torch, 6, n6, False)
        shape = tuple(packed6.shape)
        gout = torch.randn(cs.B, n6, 7, 7, cs.ROI_C, device="cuda", generator=g).to(bf16)
        fp6, ip6 = params6["fparams"], params6["iparams"]
        grad = torch.empty(shape, dtype=bf16, device="cuda")
        acc = torch.zeros(shape, dtype=torch.float32, device="cuda") if args.f32_acc else None

        def k6(lib, dst):
            return lambda: kernels.check(lib.tf_roi_align_bwd(
                gout.data_ptr(), fp6.data_ptr(), ip6.data_ptr(), dst.data_ptr(), cs.B, n6, shape[1], shape[2],
                cs.ROI_C, 7, 1, stream), "tf_roi_align_bwd")

        def zeroed_and_cast(lib):
            launch = k6(lib, acc)

            def run():
                acc.zero_()
                launch()
                grad.copy_(acc)
            return run

        if args.wrappers:
            kernels.library()
            timers[("wrapper", "K6 roi_align_bwd")] = lambda: ra.roi_align_bwd(gout, params6, shape, bf16)
        want = ra.roi_align_bwd_plain(gout, params6, shape, bf16)
        tol = cs.bf16_ulp(float(want.float().abs().max()))
        for d, lib in bwd.items():
            if d in args.f32_acc:
                zeroed_and_cast(lib)()
                timers[(d, "K6 alone")] = k6(lib, acc)
                timers[(d, "K6 with zero and cast")] = zeroed_and_cast(lib)
            else:
                k6(lib, grad)()
                timers[(d, "K6")] = k6(lib, grad)
            torch.cuda.synchronize()
            err = cs.max_err(grad, want)
            print(f"{d}: K6 {'holds' if err <= tol else 'DISAGREES'} (max|kernel - plain| {err:.3e}, "
                  f"tolerance {tol:.1e})")
        del want

    times = {key: [] for key in timers}
    for _ in range(3):
        for key, fn in timers.items():
            times[key].append(cs.cuda_ms(fn, 20, warmup=1))
    for (d, what), t in times.items():
        print(f"{d}: {what} best {min(t):.4f} ms, readings {[round(x, 4) for x in t]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
