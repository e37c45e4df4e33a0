#!/usr/bin/env python3
"""Time edited copies of the port's attention forward kernel (K2, K7) against
each other on one CUDA card.

    python scripts/ab_attention_fwd.py DIR [DIR ...]

Each DIR holds a copy of ``transfusion_torch/csrc/attention.cu`` and the
headers it includes, edited to try one design change; ``transfusion_torch/csrc``
itself may be given as the baseline. Every variant is built with the port's
nvcc flags into ``DIR/attention.so`` (all builds started together; each
kernel's registers and spill bytes and any wgmma serialisation warning
printed), checked against the plain version at the level-0 shape [8, 3136,
4, 224] bf16 with the card checks' tolerances (rates 0 and 0.15, and K7 in
[B, H, N, D]), then timed through its C entry points with CUDA events, 20
launches a reading, all variants in turns for three rounds.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE, SEED = 0.15, 99


def build(dirs: list[str], source: str = "attention.cu",
          entries: tuple = ("tf_attention_fwd", "tf_self_attention")) -> dict:
    """Build ``DIR/source`` of every DIR with the port's nvcc flags into
    ``DIR/<stem>.so`` (all builds started together), print each kernel's
    registers and spill bytes and any wgmma serialisation warning, and bind the C
    ``entries`` with the port's signatures. Returns {DIR: ctypes library}."""
    sys.path.insert(0, HERE)
    import chip_smoke
    from transfusion_torch import kernels

    nvcc = kernels._nvcc()
    stem = os.path.splitext(source)[0]
    procs = [(d, subprocess.Popen([nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", os.path.join(d, f"{stem}.so"),
                                   os.path.join(d, source)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for d in dirs]
    libs = {}
    for d, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"{d}: build failed\n{out[-4000:]}")
            continue
        for line in out.splitlines():
            if "C75" in line:
                print(f"{d}/{source}: {line.strip()[:160]}")
        for r in chip_smoke.ptxas_report({source: out}):
            print(f"{d}/{source}: {r['kernel']}: {r['registers']} registers, "
                  f"{r['spill_stores'] + r['spill_loads']} spill bytes")
        lib = ctypes.CDLL(os.path.abspath(os.path.join(d, f"{stem}.so")))
        for name in entries:
            getattr(lib, name).argtypes = kernels._SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        libs[d] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_attention_fwd: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from transfusion_torch import kernels
    from transfusion_torch.ops import attention as at

    B, N, H, D = cs.B, cs.N0, cs.HEADS, cs.HEAD_DIM
    libs = build(sys.argv[1:])
    q, k, v, mask, _ = cs._attention_inputs(torch, 2)
    bias = at.key_bias(mask, B, N, q.device).contiguous()
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out, outh = torch.empty_like(q), torch.empty_like(qh)
    stats = torch.empty(B, H, N, 2, device="cuda")
    stream, scale = kernels.stream_handle(q.device), 1.0 / math.sqrt(D)
    want = {r: at.attention_plain(q, k, v, mask, r, SEED) for r in (0.0, RATE)}

    def k2(lib, rate):
        return lambda: kernels.check(lib.tf_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), stats.data_ptr(),
            B, N, H, D, scale, 1, *at._dropout_args(rate, SEED), stream), "tf_attention_fwd")

    def k7(lib):
        sb, sh, sn, _ = qh.stride()
        return lambda: kernels.check(lib.tf_self_attention(
            qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), bias.data_ptr(), outh.data_ptr(), B, N, H, D,
            sb, sn, sh, scale, 1, stream), "tf_self_attention")

    def holds(got, ref) -> bool:  # the card checks' bounds (chip_smoke.py::phase_attention)
        mean = float((got.float() - ref.float()).abs().mean() / ref.float().abs().mean())
        return cs.max_err(got, ref) <= 2 * cs.bf16_ulp(float(ref.float().abs().max())) and mean <= 2.0 ** -7

    for d, lib in libs.items():
        for rate in (0.0, RATE):
            k2(lib, rate)()
            torch.cuda.synchronize()
            ref, st = want[rate]
            ok = (holds(out, ref) and cs.max_err(stats[..., 0], st[..., 0]) <= 1e-4
                  and float(((stats[..., 1] - st[..., 1]).abs() / st[..., 1]).max()) <= 1e-4)
            print(f"{d}: K2 rate {rate} {'holds' if ok else 'DISAGREES'}")
        k7(lib)()
        torch.cuda.synchronize()
        print(f"{d}: K7 [B, H, N, D] {'holds' if holds(outh.transpose(1, 2), want[0.0][0]) else 'DISAGREES'}")

    times = {d: {"K2 rate 0": [], f"K2 rate {RATE}": [], "K7 bhnd": []} for d in libs}
    for _ in range(3):
        for d, lib in libs.items():
            times[d]["K2 rate 0"].append(cs.cuda_ms(k2(lib, 0.0), 20, warmup=1))
            times[d][f"K2 rate {RATE}"].append(cs.cuda_ms(k2(lib, RATE), 20, warmup=1))
            times[d]["K7 bhnd"].append(cs.cuda_ms(k7(lib), 20, warmup=1))
    flops = 4 * B * H * N * N * D
    for d, t in times.items():
        print(d, {key: [round(x, 4) for x in xs] for key, xs in t.items()},
              f"K2 rate 0 best {flops / min(t['K2 rate 0']) / 1e9:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
