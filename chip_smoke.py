#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``transfusion_torch``).

    python3 chip_smoke.py [--profile]

Needs one CUDA card (an H100 is what the numbers are read against) and the
CUDA toolkit; exits non-zero at once without a card. Phases:

1. build the hand-written kernels (``transfusion_torch/csrc/*.cu``) for
   sm_90a and print the build time and each kernel's registers and spill
   bytes (a spill in a wgmma kernel, ``*_sm90``, a RoIAlign or a LayerNorm
   kernel fails the run);
2. for each kernel entry -- eval: LayerNorm and residual LayerNorm (at every
   shape of the eval request, LN_SHAPES, the final norm also read in place
   through its view x[:, :n]; timed by CUDA-graph replay), attention
   forward, RoIAlign forward; training: attention forward with dropout,
   attention backward dQ and dK/dV (at rates 0.15 and 0, and two launches
   bit for bit), RoIAlign backward; off both paths: exact self-attention
   (K7) in both layouts -- at the flagship paths' shapes in bf16 plus one
   f32 case: the kernel against its plain PyTorch version (max |diff|
   against a stated tolerance; the dropout mask bit for bit), kernel /
   plain / library-call times from CUDA events, and
   the least time the card could take (bound_ms, from the H100 SXM
   data-sheet rates 3.35 TB/s, 989 TFLOP/s bf16 tensor, 67 TFLOP/s f32);
3. small-input reference checks: the tiny f32 model's trunk on the card
   (kernels) against the same weights on the CPU (plain versions), then one
   tiny f32 train step on the card against the same step on the CPU (same
   weights and sampler draws, dropout off; the level-0 sequence passes the
   2048-token gate so the attention kernels run);
4. the eval slice: the flagship eval forward + ``detections_from_outputs``
   at B 8, 768x1024, 64 language tokens, seeded random weights, for a few
   requests; frames/s, mean kept detections, and the kernel launch counts
   of that run, which must be LN 5 / residual LN 56 (the fusion's 4 + 32 and
   MiniLM-L12's 1 + 24) / attention 4 / RoIAlign 1 a forward;
5. the train slice: the flagship train step (RAdam lr 1e-4, wd 1e-5,
   bbox/obj_prop/noun/verb criterion, the trainer's epoch-0 freeze
   multipliers) on the same input with one GT box an image, one warm-up
   and a few timed steps; frames/s, peak memory, finite losses, no skipped
   step, non-zero gradients upstream of the attention and RoIAlign
   kernels, and launches a step of attention-with-dropout 4 / dQ 4 /
   dK-dV 4 / RoIAlign 1 / RoIAlign backward 1 / LayerNorm 0;
6. the trainer: ``EgoNaoTrainer(flagship_run_config(), ...).fit(1)`` on
   in-memory examples at the 768x1024 bucket (32 train, 16 val, 1-2 GT
   boxes each, v2 label space, narrations through the hash-vocab tokenizer
   at 128 tokens): 4 train steps, 2 validation batches with losses
   (``eval_with_losses``), STA mAP, the result JSON, a checkpoint,
   ``history.jsonl`` and ``best.json``; launches per train step as the
   train slice, per validation batch LN 5 / residual LN 56 / attention 4 /
   RoIAlign 2; then a fresh trainer resumed from the checkpoint must hold
   the same parameters, optimizer state, step and seed bit for bit, and
   evaluate to the same detections bit for bit, the same mAP and losses.

With ``--profile`` the script also times each stage of the eval forward and
traces one request and one train step with ``torch.profiler`` (device-busy
share, top kernels).

The last three lines of stdout are the ``kernels`` JSON line, the card's
name and power limit (nvidia-smi), and ``{"ok": true, "device": ...}``.
Any failed phase exits non-zero without the ``ok`` line. A full record
(with each kernel's share of its bound, the products' TFLOP/s and the
ptxas report) goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
B, H, W, LANG_LEN = 8, 768, 1024, 64
REQUESTS = 10  # the request is host-bound and varies; ten give a steadier mean
TRAIN_STEPS = 4
HBM_BPS = 3.35e12          # H100 SXM HBM3
BF16_TC_FLOPS = 989e12     # dense bf16 tensor cores
F32_FLOPS = 67e12          # f32 outside the tensor cores
EXPECTED_PER_FORWARD = {"layer_norm": 5, "residual_layer_norm": 56, "attention_fwd": 4,
                        "roi_align_fwd": 1}
# The train forward runs the eval forward's 61 LayerNorms on K1 (fusion:
# 4 final norms and 32 residual norms; MiniLM: the embeddings norm and 24
# residual norms); their backward is layer_norm's closed form, no kernel.
EXPECTED_PER_STEP = {"attention_fwd_dropout": 4, "attention_bwd_dq": 4, "attention_bwd_dkv": 4,
                     "roi_align_fwd": 1, "roi_align_bwd": 1, "layer_norm": 5,
                     "residual_layer_norm": 56, "attention_fwd": 0}
TRAIN_KERNELS = ("attention_fwd_dropout", "attention_bwd_dq", "attention_bwd_dkv", "roi_align_bwd")
REPLACES = {
    "layer_norm": "transfusion_tpu/ops/layer_norm.py:55",
    "residual_layer_norm": "transfusion_tpu/ops/layer_norm.py:59",
    "attention_fwd": "transfusion_tpu/ops/attention.py:226",
    "attention_fwd_dropout": "transfusion_tpu/ops/attention.py:226",
    "attention_bwd_dq": "transfusion_tpu/ops/attention.py:253",
    "attention_bwd_dkv": "transfusion_tpu/ops/attention.py:297",
    "self_attention": "transfusion_tpu/ops/attention.py:29",
    "roi_align_fwd": "transfusion_tpu/ops/roi_align_pallas.py:267",
    "roi_align_bwd": "transfusion_tpu/ops/roi_align_pallas.py:370",
}
SOURCES = {
    "layer_norm": "transfusion_torch/csrc/layer_norm.cu",
    "residual_layer_norm": "transfusion_torch/csrc/layer_norm.cu",
    "attention_fwd": "transfusion_torch/csrc/attention.cu",
    "attention_fwd_dropout": "transfusion_torch/csrc/attention.cu",
    "attention_bwd_dq": "transfusion_torch/csrc/attention_bwd.cu",
    "attention_bwd_dkv": "transfusion_torch/csrc/attention_bwd.cu",
    "self_attention": "transfusion_torch/csrc/attention.cu",
    "roi_align_fwd": "transfusion_torch/csrc/roi_align.cu",
    "roi_align_bwd": "transfusion_torch/csrc/roi_align_bwd.cu",
}
TRAINER_TRAIN, TRAINER_VAL, TRAINER_LANG = 32, 16, 128
# eval_with_losses runs the RoI heads twice on one trunk, one RoIAlign each:
# every proposal for the detections, the sampled RoIs for the losses.
EXPECTED_PER_VAL_BATCH = {"layer_norm": 5, "residual_layer_norm": 56, "attention_fwd": 4,
                          "roi_align_fwd": 2}
N0, HEADS, HEAD_DIM = 3136, 4, 224  # fusion level 0: 3072 visual + 64 language tokens
DROPOUT = 0.15  # token_dropout, the rate K2 runs at in training


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 numbers (8 significant bits) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def ptxas_report(logs: dict) -> list[dict]:
    """Registers and spill bytes of every kernel in the build's ``ptxas -v``
    logs, one row per entry function (names demangled by c++filt where the
    toolkit's host has it)."""
    rows = []
    for src, text in logs.items():
        name, spill = None, (0, 0)
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name, spill = m.group(1), (0, 0)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and name:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                rows.append({"source": src, "kernel": name, "registers": int(m.group(1)),
                             "spill_stores": spill[0], "spill_loads": spill[1]})
                name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r["kernel"] for r in rows), capture_output=True,
                               text=True, timeout=60, check=True).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r["kernel"] = re.sub(r"^void |\(.*", "", n.replace("(anonymous namespace)::", ""))
    except (OSError, subprocess.SubprocessError):
        pass
    return rows


def check(name: str, err: float, tol: float, measure: str = "max|kernel - plain|") -> None:
    log(f"  {name}: {measure} = {err:.3e} (tolerance {tol:.1e})")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain version ({err} > {tol})")


# ------------------------------------------------------------------ phases
# K1 at every distinct shape of the eval request: the fusion's norm1/norm2
# (residual) and final norm at level 0 (3072 visual + 64 language tokens) and
# at levels 1-3 (768 + 64), the final norm also as the view x[:, :n] of the
# [B, N, 896] sequence it reads in the model, and MiniLM-L12's norms at
# [B x 64, 384] at MiniLM's eps 1e-12: the residual post-norms in bf16 and
# the embeddings norm in f32 (both variants in both types here); and f32 at
# 896 in both forms, which no request runs. "view": the batch's sequence
# length N when x is x[:, :n] of a contiguous [B, N, d]. Requests launch each
# shape "per_request" times; "eps" is 1e-6 where not given.
LN_SHAPES = [
    {"label": "fusion L0 norm1/norm2", "n": 3136, "d": 896, "dtype": "bf16", "residual": True, "per_request": 8},
    {"label": "fusion L0 final norm", "n": 3072, "d": 896, "dtype": "bf16", "residual": False, "per_request": 0},
    {"label": "fusion L0 final norm, view", "n": 3072, "view": 3136, "d": 896, "dtype": "bf16", "residual": False,
     "per_request": 1},
    {"label": "fusion L1-3 norm1/norm2", "n": 832, "d": 896, "dtype": "bf16", "residual": True, "per_request": 24},
    {"label": "fusion L1-3 final norm", "n": 768, "d": 896, "dtype": "bf16", "residual": False, "per_request": 0},
    {"label": "fusion L1-3 final norm, view", "n": 768, "view": 832, "d": 896, "dtype": "bf16", "residual": False,
     "per_request": 3},
    {"label": "MiniLM post-norms", "n": LANG_LEN, "d": 384, "dtype": "bf16", "residual": True, "per_request": 24,
     "eps": 1e-12},
    {"label": "MiniLM post-norms f32", "n": LANG_LEN, "d": 384, "dtype": "f32", "residual": True, "per_request": 0,
     "eps": 1e-12},
    {"label": "MiniLM plain bf16", "n": LANG_LEN, "d": 384, "dtype": "bf16", "residual": False, "per_request": 0,
     "eps": 1e-12},
    {"label": "MiniLM embeddings norm", "n": LANG_LEN, "d": 384, "dtype": "f32", "residual": False, "per_request": 1,
     "eps": 1e-12},
    {"label": "f32 residual 1,000 x 896", "n": 125, "d": 896, "dtype": "f32", "residual": True, "per_request": 0},
    {"label": "f32 plain 24,576 x 896", "n": 3072, "d": 896, "dtype": "f32", "residual": False, "per_request": 0},
]
L2_BYTES = 50e6  # the H100's L2


def ln_inputs(torch, shape: dict, g, copies: int = 1):
    """``copies`` sets of K1 inputs (x, residual or None) at ``shape``, and
    w, b: x [B, n, d] (mean 1, sd 3), a view x[:, :n] of [B, N, d] where
    the shape says so; the residual N(0, 1)."""
    dt = torch.bfloat16 if shape["dtype"] == "bf16" else torch.float32
    n, d = shape["n"], shape["d"]
    sets = []
    for _ in range(copies):
        x = torch.randn(B, shape.get("view", n), d, device="cuda", generator=g).mul_(3).add_(1).to(dt)[:, :n]
        r = torch.randn(B, n, d, device="cuda", generator=g).to(dt) if shape["residual"] else None
        sets.append((x, r))
    w = torch.randn(d, device="cuda", generator=g).mul_(0.2).add_(1)
    b = torch.randn(d, device="cuda", generator=g).mul_(0.2)
    return sets, w, b


def ln_bytes(shape: dict) -> int:
    """Bytes K1 must move at ``shape``: x (and r) read once, y written once,
    w and b read once."""
    elt = 2 if shape["dtype"] == "bf16" else 4
    return B * shape["n"] * shape["d"] * elt * (3 if shape["residual"] else 2) + 2 * shape["d"] * 4


def ln_copies(shape: dict) -> int:
    """Input sets to cycle through so that a timed run reads past the L2."""
    return max(1, min(8, math.ceil(2 * L2_BYTES / ln_bytes(shape))))


def graph_ms(torch, fns, launches: int = 40, reps: int = 5) -> float:
    """Device ms a call: ``launches`` calls (cycling through ``fns``) captured
    in a CUDA graph, the graph replayed ``reps`` times between CUDA events, so
    the host's launch cost stays out of the reading. What each captured call
    returns is held until the capture ends, so a call that allocates its
    output writes a buffer of its own in every launch rather than one block
    the graph's pool hands to all of them (which could stay in the L2)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()  # outside the capture: first-launch set-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    held = []
    with torch.cuda.graph(graph):
        for i in range(launches):
            held.append(fns[i % len(fns)]())
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * launches)
    del graph, held
    torch.cuda.empty_cache()
    return ms


def phase_layer_norm(torch):
    """K1 at every shape of LN_SHAPES against its plain version (bf16 one ulp
    for |y| < 8, 3.2e-2; f32 1e-4), timed on the card (CUDA-graph replays,
    inputs cycled past the L2) beside its bound, the plain version and, for
    the plain variant, F.layer_norm. The kernel rows of the JSON line are the
    level-0 shapes (the final norm through its view, as the model runs it)."""
    from transfusion_torch.ops import layer_norm as ln

    g = torch.Generator(device="cuda").manual_seed(1)
    shapes, errs = [], {"layer_norm": 0.0, "residual_layer_norm": 0.0}
    for shape in LN_SHAPES:
        name = "residual_layer_norm" if shape["residual"] else "layer_norm"
        sets, w, b = ln_inputs(torch, shape, g, ln_copies(shape))
        x, r = sets[0]
        eps = shape.get("eps", 1e-6)
        got = ln.fused_layer_norm(x, w, b, eps, residual=r)
        want = ln.layer_norm_plain(x.contiguous(), w, b, eps, residual=r)
        torch.cuda.synchronize()
        err = max_err(got, want)
        errs[name] = max(errs[name], err)
        check(f"{name} {shape['label']} [{B * shape['n']}, {shape['d']}] {shape['dtype']}", err,
              3.2e-2 if shape["dtype"] == "bf16" else 1e-4)
        ms = graph_ms(torch, [lambda x=x, r=r: ln.fused_layer_norm(x, w, b, eps, residual=r) for x, r in sets])
        plain = cuda_ms(lambda: ln.layer_norm_plain(x, w, b, eps, residual=r), 5)
        lib = None
        if not shape["residual"]:
            wl, bl = w.to(x.dtype), b.to(x.dtype)
            lib = graph_ms(torch, [lambda x=x: torch.nn.functional.layer_norm(x, (shape["d"],), wl, bl, eps)
                                   for x, _ in sets])
        nbytes = ln_bytes(shape)
        bms, by = bound_ms(nbytes, B * shape["n"] * shape["d"] * (9 if shape["residual"] else 8), F32_FLOPS)
        shapes.append({**shape, "rows": B * shape["n"], "name": name, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain, "library_ms": lib, "bound_ms": bms, "bound_by": by,
                       "pct_of_bound": 100.0 * bms / ms, "input_sets": len(sets)})
        log(f"  {shape['label']}: kernel {ms:.4f} ms, {100.0 * bms / ms:.1f} % of its {bms:.4f} ms bound; "
            f"plain {plain:.4f} ms" + ("" if lib is None else f"; F.layer_norm {lib:.4f} ms"))
        del sets, got, want
    torch.cuda.empty_cache()
    rows = []
    for name, label in (("layer_norm", "fusion L0 final norm, view"), ("residual_layer_norm", "fusion L0 norm1/norm2")):
        s0 = next(s for s in shapes if s["label"] == label)
        rows.append({k: s0[k] for k in ("name", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                    | {"max_abs_err": errs[name], "shapes": [s for s in shapes if s["name"] == name]})
    return rows


def phase_attention(torch):
    from transfusion_torch.ops import attention as at

    g = torch.Generator(device="cuda").manual_seed(2)
    n, nh, hd = 3136, 4, 224
    log(f"[attention_fwd] q/k/v [{B}, {n}, {nh}, {hd}] bf16")
    q, k, v = (torch.randn(B, n, nh, hd, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    mask = torch.zeros(B, n, dtype=torch.bool, device="cuda")
    mask[: B // 2, -40:] = True  # padded language tokens on half the batch
    got, st = at.attention_fwd(q, k, v, mask, return_stats=True)
    want, st_ref = at.attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    err = max_err(got, want)
    # Random q/k give scores ~ N(0, 1), so an output is a softmax-weighted mean
    # of ~3136 values of V: |o| ~ sqrt(e / 3136) ~ 0.03 typically, a few tenths
    # at most. Both sides accumulate in f32 and round P and o to bf16 (P against
    # the running max in the kernel, the final max in the plain version), so
    # they differ by about one bf16 ulp at max|o|. Leaving one 64-key tile out
    # of P V moves o by ~sqrt(64 / 3136) |o|: tens of ulps at the tail and
    # ~14 % of mean|o| on average, which the two checks below catch.
    scale = float(want.float().abs().max())
    log(f"  max|want| {scale:.4f}, mean|want| {float(want.float().abs().mean()):.5f}")
    check("attention bf16 output", err, 2 * bf16_ulp(scale))
    mean_rel = float((got.float() - want.float()).abs().mean() / want.float().abs().mean())
    check("attention bf16 output", mean_rel, 2.0 ** -7, "mean|kernel - plain| / mean|plain|")
    check("attention bf16 row max m", max_err(st[..., 0], st_ref[..., 0]), 1e-4)
    l_rel = float(((st[..., 1] - st_ref[..., 1]).abs() / st_ref[..., 1]).max())
    check("attention bf16 row sum l", l_rel, 1e-4, "max|kernel - plain| / plain")
    qf, kf, vf = (torch.randn(1, 1100, nh, hd, device="cuda", generator=g) for _ in range(3))
    mf = torch.zeros(1, 1100, dtype=torch.bool, device="cuda")
    mf[0, -7:] = True
    check("attention f32 output", max_err(at.attention_fwd(qf, kf, vf, mf),
                                           at.attention_plain(qf, kf, vf, mf)[0]), 1e-5)
    ms = cuda_ms(lambda: at.attention_fwd(q, k, v, mask), 5, warmup=1)
    plain = cuda_ms(lambda: at.attention_plain(q, k, v, mask), 2, warmup=1)
    bias = at.key_bias(mask, B, n, q.device).to(q.dtype)[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias), 5, warmup=1)
    flops = 4 * B * nh * n * n * hd
    bms, by = bound_ms(4 * B * n * nh * hd * 2 + B * n * 4 + B * nh * n * 8, flops, BF16_TC_FLOPS)
    log(f"  {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s achieved")
    return {"name": "attention_fwd", "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": bms, "bound_by": by, "flops": flops}


def _attention_inputs(torch, seed: int):
    """Level-0 q/k/v [B, 3136, 4, 224] bf16 and a key-padding mask (padded
    language tokens on half the batch)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, N0, HEADS, HEAD_DIM, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    mask = torch.zeros(B, N0, dtype=torch.bool, device="cuda")
    mask[: B // 2, -40:] = True
    return q, k, v, mask, g


def _attention_bound(flops: float, tensors: int, d_rows: int = 0):
    """bound_ms of an attention kernel that reads/writes ``tensors`` tensors
    of [B, N, H, D] bf16 plus the f32 statistics and key bias (and, if
    ``d_rows``, the [B, H, N] f32 D rows)."""
    return bound_ms(tensors * B * N0 * HEADS * HEAD_DIM * 2 + B * HEADS * N0 * (8 + 4 * d_rows)
                    + B * N0 * 4, flops, BF16_TC_FLOPS)


def phase_attention_dropout(torch):
    """K2 with probability dropout at rate 0.15: its output against the plain
    version, and its keep mask bit for bit over every (cell, query, key) of
    level 0. With q = k = 0 every probability is 1 / N before dropout, so a
    one-hot V over a window of 224 keys reads those keys' keep bits out of
    the output; 14 windows cover the 3136 keys."""
    from transfusion_torch.ops import attention as at

    q, k, v, mask, g = _attention_inputs(torch, 4)
    seed = -1234567
    log(f"[attention_fwd_dropout] q/k/v [{B}, {N0}, {HEADS}, {HEAD_DIM}] bf16, rate {DROPOUT}")
    got = at.attention_fwd(q, k, v, mask, DROPOUT, seed)
    want, _ = at.attention_plain(q, k, v, mask, DROPOUT, seed)
    torch.cuda.synchronize()
    err = max_err(got, want)
    scale = float(want.float().abs().max())
    check("attention dropout bf16 output", err, 2 * bf16_ulp(scale))
    mean_rel = float((got.float() - want.float()).abs().mean() / want.float().abs().mean())
    check("attention dropout bf16 output", mean_rel, 2.0 ** -7, "mean|kernel - plain| / mean|plain|")
    del want
    keep = at.dropout_keep_mask(B, HEADS, N0, seed, DROPOUT, "cuda")
    zeros = torch.zeros(B, N0, HEADS, HEAD_DIM, dtype=torch.bfloat16, device="cuda")
    eye = torch.eye(HEAD_DIM, dtype=torch.bfloat16, device="cuda")
    mismatches = 0
    for w0 in range(0, N0, HEAD_DIM):
        vw = torch.zeros_like(zeros)
        vw[:, w0:w0 + HEAD_DIM] = eye[None, :, None, :]
        bits = at.attention_fwd(zeros, zeros, vw, None, DROPOUT, seed) > 0      # [B, N, H, 224]
        mismatches += int((bits.permute(0, 2, 1, 3) != keep[..., w0:w0 + HEAD_DIM]).sum())
    kept = float(keep.float().mean())
    log(f"  keep bits compared: {keep.numel()}, kept share {kept:.5f} (1 - rate = {1 - DROPOUT})")
    check("attention dropout keep mask", float(mismatches), 0.0, "mismatching keep bits")
    del keep, zeros, vw, bits
    qf, kf, vf = (torch.randn(1, 1100, HEADS, HEAD_DIM, device="cuda", generator=g) for _ in range(3))
    check("attention dropout f32 output", max_err(at.attention_fwd(qf, kf, vf, None, DROPOUT, 9),
                                                   at.attention_plain(qf, kf, vf, None, DROPOUT, 9)[0]),
          1e-5)
    ms = cuda_ms(lambda: at.attention_fwd(q, k, v, mask, DROPOUT, seed), 5, warmup=1)
    plain = cuda_ms(lambda: at.attention_plain(q, k, v, mask, DROPOUT, seed), 1, warmup=1)
    flops = 4 * B * HEADS * N0 * N0 * HEAD_DIM
    bms, by = _attention_bound(flops, 4)
    log(f"  {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s achieved")
    torch.cuda.empty_cache()
    # No PyTorch call computes this hash mask: no library time.
    return {"name": "attention_fwd_dropout", "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "library_ms": None, "bound_ms": bms, "bound_by": by, "flops": flops}


def phase_attention_bwd(torch):
    """K3 (dQ) and K4 (dK, dV) at rate 0.15 and at rate 0 against the plain
    backward from the same forward output and statistics. The backward
    rounds dS to bf16 from probabilities the two sides compute with
    different exp routines, so a dS may land one ulp apart: outputs are held
    at four bf16 ulps of max|plain| and a mean difference under 2^-7 of
    mean|plain|. No atomics: two launches give the same bits."""
    from transfusion_torch import kernels
    from transfusion_torch.ops import attention as at

    q, k, v, mask, g = _attention_inputs(torch, 5)
    dout = torch.randn(B, N0, HEADS, HEAD_DIM, device="cuda", generator=g).to(torch.bfloat16)
    seed = 424242
    errs = {}
    for rate in (0.0, DROPOUT):
        log(f"[attention_bwd] q/k/v/o/dO [{B}, {N0}, {HEADS}, {HEAD_DIM}] bf16, rate {rate}")
        out, stats = at.attention_fwd(q, k, v, mask, rate, seed, return_stats=True)
        got = at.attention_bwd(q, k, v, out, stats, dout, mask, rate, seed)
        again = at.attention_bwd(q, k, v, out, stats, dout, mask, rate, seed)
        want = at.attention_bwd_plain(q, k, v, out, stats, dout, mask, rate, seed)
        torch.cuda.synchronize()
        for name, a, b, a2 in zip(("dq", "dk", "dv"), got, want, again):
            err = max_err(a, b)
            errs[name] = max(errs.get(name, 0.0), err)
            check(f"attention backward bf16 {name} rate {rate}", err,
                  4 * bf16_ulp(float(b.float().abs().max())))
            mean_rel = float((a.float() - b.float()).abs().mean() / b.float().abs().mean())
            check(f"attention backward bf16 {name} rate {rate}", mean_rel, 2.0 ** -7,
                  "mean|kernel - plain| / mean|plain|")
            check(f"attention backward bf16 {name} rate {rate}, two launches", float((a != a2).sum()),
                  0.0, "differing elements")
        del got, again, want
        torch.cuda.empty_cache()
    qf, kf, vf, df = (torch.randn(1, 700, HEADS, 96, device="cuda", generator=g) for _ in range(4))
    of, sf = at.attention_fwd(qf, kf, vf, None, DROPOUT, 3, return_stats=True)
    for name, a, b in zip(("dq", "dk", "dv"), at.attention_bwd(qf, kf, vf, of, sf, df, None, DROPOUT, 3),
                          at.attention_bwd_plain(qf, kf, vf, of, sf, df, None, DROPOUT, 3)):
        check(f"attention backward f32 {name}", max_err(a, b) / float(b.abs().max()), 1e-4,
              "max|kernel - plain| / max|plain|")
    # Each kernel timed alone through its C entry (the wrapper launches both);
    # K4 reads the D rows K3's warm-up wrote. Rate 0.15 is the train path's.
    lib, stream = kernels.library(), kernels.stream_handle(q.device)
    bias = at.key_bias(mask, B, N0, q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    d_rows = torch.empty(B, HEADS, N0, device="cuda")
    times = {}
    for rate in (0.0, DROPOUT):
        common = (B, N0, HEADS, HEAD_DIM, 1.0 / HEAD_DIM ** 0.5, 1, *at._dropout_args(rate, seed), stream)
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
               bias.data_ptr(), stats.data_ptr(), d_rows.data_ptr())
        times[rate] = (cuda_ms(lambda: lib.tf_attention_bwd_dq(*ins, dq.data_ptr(), *common), 5, warmup=1),
                       cuda_ms(lambda: lib.tf_attention_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *common),
                               5, warmup=1))
    ms_dq, ms_dkv = times[DROPOUT]
    plain = cuda_ms(lambda: at.attention_bwd_plain(q, k, v, out, stats, dout, mask, DROPOUT, seed), 1,
                    warmup=1)
    torch.cuda.empty_cache()
    # Yardstick: the backward of scaled_dot_product_attention at rate 0 (all
    # three gradients in one call).
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    ref = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bias.to(q.dtype)[:, None, None, :])
    lib_ms = cuda_ms(lambda: torch.autograd.grad(ref, (qt, kt, vt), dout.transpose(1, 2),
                                                 retain_graph=True), 5, warmup=1)
    n2d = B * HEADS * N0 * N0 * HEAD_DIM
    b_dq, by_dq = _attention_bound(6 * n2d, 6, d_rows=1)  # q k v o dO read, dQ and D written
    b_dkv, by_dkv = _attention_bound(8 * n2d, 6, d_rows=1)  # q k v dO and D read, dK dV written
    for rate, (a, b) in times.items():
        log(f"  rate {rate}: dQ {a:.4f} ms, {6 * n2d / (a * 1e-3) / 1e12:.1f} TFLOP/s; dK/dV {b:.4f} ms, "
            f"{8 * n2d / (b * 1e-3) / 1e12:.1f} TFLOP/s; together {a + b:.4f} ms, "
            f"{14 * n2d / ((a + b) * 1e-3) / 1e12:.1f} TFLOP/s (SDPA backward {lib_ms:.4f} ms)")
    log(f"  plain backward (dQ, dK, dV together) {plain:.2f} ms")
    del ref, qt, kt, vt
    torch.cuda.empty_cache()
    return [{"name": "attention_bwd_dq", "max_abs_err": errs["dq"], "ms": ms_dq, "plain_ms": plain,
             "library_ms": lib_ms, "bound_ms": b_dq, "bound_by": by_dq, "flops": 6 * n2d},
            {"name": "attention_bwd_dkv", "max_abs_err": max(errs["dk"], errs["dv"]), "ms": ms_dkv,
             "plain_ms": plain, "library_ms": lib_ms, "bound_ms": b_dkv, "bound_by": by_dkv,
             "flops": 8 * n2d}]


def phase_self_attention(torch):
    """K7 (exact self-attention, no statistics) against its plain version in
    both layouts, [B, N, H, D] and [B, H, N, D], read through strides. Its
    bf16 output is held as K2's is (two bf16 ulps of max|plain| and a mean
    difference under 2^-7 of mean|plain|); f32 at 1e-5. No model calls K7:
    it launches 0 times on either path."""
    from transfusion_torch.ops import attention as at

    q, k, v, mask, g = _attention_inputs(torch, 7)
    log(f"[self_attention] q/k/v [{B}, {N0}, {HEADS}, {HEAD_DIM}] and [{B}, {HEADS}, {N0}, {HEAD_DIM}] bf16")
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    err = 0.0
    for layout, fn, args, plain_fn in (
            ("blhd", at.flash_self_attention_blhd, (q, k, v), lambda: at.attention_plain(q, k, v, mask)[0]),
            ("bhnd", at.flash_self_attention, (qh, kh, vh), lambda: at.self_attention_plain(qh, kh, vh, mask))):
        got = fn(*args, mask)
        want = plain_fn()
        torch.cuda.synchronize()
        e = max_err(got, want)
        err = max(err, e)
        check(f"self attention bf16 {layout}", e, 2 * bf16_ulp(float(want.float().abs().max())))
        mean_rel = float((got.float() - want.float()).abs().mean() / want.float().abs().mean())
        check(f"self attention bf16 {layout}", mean_rel, 2.0 ** -7, "mean|kernel - plain| / mean|plain|")
        del got, want
    qf, kf, vf = (torch.randn(1, 1100, HEADS, HEAD_DIM, device="cuda", generator=g) for _ in range(3))
    mf = torch.zeros(1, 1100, dtype=torch.bool, device="cuda")
    mf[0, -7:] = True
    check("self attention f32 blhd", max_err(at.flash_self_attention_blhd(qf, kf, vf, mf),
                                             at.attention_plain(qf, kf, vf, mf)[0]), 1e-5)
    qf, kf, vf = (t.transpose(1, 2).contiguous() for t in (qf, kf, vf))
    check("self attention f32 bhnd", max_err(at.flash_self_attention(qf, kf, vf, mf),
                                             at.self_attention_plain(qf, kf, vf, mf)), 1e-5)
    ms = cuda_ms(lambda: at.flash_self_attention_blhd(q, k, v, mask), 5, warmup=1)
    ms_bhnd = cuda_ms(lambda: at.flash_self_attention(qh, kh, vh, mask), 5, warmup=1)
    plain = cuda_ms(lambda: at.attention_plain(q, k, v, mask), 2, warmup=1)
    bias = at.key_bias(mask, B, N0, q.device).to(q.dtype)[:, None, None, :]
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias),
                  5, warmup=1)
    flops = 4 * B * HEADS * N0 * N0 * HEAD_DIM
    bms, by = bound_ms(4 * B * N0 * HEADS * HEAD_DIM * 2 + B * N0 * 4, flops, BF16_TC_FLOPS)
    log(f"  [B, N, H, D] {ms:.4f} ms, {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s; [B, H, N, D] "
        f"{ms_bhnd:.4f} ms; SDPA [B, H, N, D] {lib:.4f} ms")
    del qh, kh, vh
    torch.cuda.empty_cache()
    return {"name": "self_attention", "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": bms, "bound_by": by, "flops": flops, "ms_bhnd": ms_bhnd}


def _synthetic_rois(torch, g, bsz, n, hw):
    """Proposal-like boxes: log-uniform sides 16..700 px, aspect 0.5..2."""
    side = torch.exp(torch.empty(bsz, n, device="cuda").uniform_(2.77, 6.55, generator=g))
    aspect = torch.exp(torch.empty(bsz, n, device="cuda").uniform_(-0.69, 0.69, generator=g))
    bw, bh = side * aspect.sqrt(), side / aspect.sqrt()
    cx = torch.rand(bsz, n, device="cuda", generator=g) * hw[1]
    cy = torch.rand(bsz, n, device="cuda", generator=g) * hw[0]
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    from transfusion_torch.ops.boxes import clip_boxes

    return clip_boxes(boxes, hw[0], hw[1])


def _cover(torch, rows, cols, empty, h_tot, w_max):
    """[B, H_tot, W_max] bool: the union of per-RoI rectangles of packed
    cells, rows (first, last) and cols (first, last) inclusive, each
    [B, R]; ``empty`` RoIs mark nothing. Rectangles are marked with a 2-D
    difference array."""
    bsz, n = empty.shape
    diff = torch.zeros(bsz, h_tot + 1, w_max + 1, device="cuda")
    bi = torch.arange(bsz, device="cuda")[:, None].expand(bsz, n)
    one = torch.where(empty, 0.0, 1.0)
    ya, yb = rows[0].long(), rows[1].long() + 1
    xa, xb = cols[0].long(), cols[1].long() + 1
    for yy, xx, s in ((ya, xa, 1.0), (ya, xb, -1.0), (yb, xa, -1.0), (yb, xb, 1.0)):
        diff.index_put_((bi, yy, xx), one * s, accumulate=True)
    return diff.cumsum(1).cumsum(2)[:, :h_tot, :w_max] > 0.5


def _roi_touched_bytes(torch, params, shapes, h_tot, w_max, c, elt):
    """Bytes of pyramid cells inside the union of the RoIs' sample
    footprints (each read once)."""
    bsz, n = params["bh"].shape
    p = 7
    hl, wl, off = params["hl"], params["wl"], params["off"].long()
    y0 = torch.clamp(torch.floor(params["y1"]), min=0)
    x0 = torch.clamp(torch.floor(params["x1"]), min=0)
    y1 = torch.minimum(torch.floor(torch.clamp(params["y1"] + p * params["bh"], min=0)) + 1, hl - 1)
    x1 = torch.minimum(torch.floor(torch.clamp(params["x1"] + p * params["bw"], min=0)) + 1, wl - 1)
    y0 = torch.minimum(y0, hl - 1)
    x0 = torch.minimum(x0, wl - 1)
    empty = (params["ry"] == 0) | (params["rx"] == 0)
    cover = _cover(torch, (y0 + off, y1 + off), (x0, x1), empty, h_tot, w_max)
    return int(cover.sum()) * c * elt


ROI_C = 256
ROI_SIZES = [(H // 4, W // 4), (H // 8, W // 8), (H // 16, W // 16), (H // 32, W // 32)]


def roi_inputs(torch, seed: int, n: int, fill: bool):
    """The RoIAlign phases' inputs: the flagship's FPN levels x 256 channels
    in bf16 (random if ``fill``, else uninitialised: the backward reads only
    their shape), ``n`` synthetic RoIs an image, the packed pyramid and the
    sampling parameters. Returns (generator, feats, rois, packed, shapes,
    offsets, params); the generator goes on to draw what a phase needs next."""
    from transfusion_torch.ops import roi_align as ra

    g = torch.Generator(device="cuda").manual_seed(seed)
    feats = {str(i): (torch.randn(B, h, w, ROI_C, device="cuda", generator=g).to(torch.bfloat16) if fill
                      else torch.empty(B, h, w, ROI_C, dtype=torch.bfloat16, device="cuda"))
             for i, (h, w) in enumerate(ROI_SIZES)}
    rois = _synthetic_rois(torch, g, B, n, (H, W))
    packed, shapes, offsets = ra.pack_pyramid(feats)
    params = ra.roi_sample_params(rois, shapes, offsets, (H, W), 7, 0)
    return g, feats, rois, packed, shapes, offsets, params


def phase_roi_align(torch):
    from transfusion_torch import kernels
    from transfusion_torch.ops import roi_align as ra

    c, n = ROI_C, 1000
    log(f"[roi_align_fwd] pyramid {ROI_SIZES} x {c} bf16, rois [{B}, {n}, 4]")
    g, feats, rois, packed, shapes, offsets, params = roi_inputs(torch, 3, n, True)
    got = ra.pooled_from_packed(packed, params)
    want = ra.roi_align_plain(packed, params)
    torch.cuda.synchronize()
    err = max_err(got, want)
    check("roi_align bf16", err, 3.2e-2)  # bf16 output, f32 sums in both
    fsmall = {k: v[:2].float() for k, v in feats.items()}
    pk, sh, of = ra.pack_pyramid(fsmall)
    pr = ra.roi_sample_params(rois[:2, :200], sh, of, (H, W), 7, 0)
    check("roi_align f32", max_err(ra.pooled_from_packed(pk, pr), ra.roi_align_plain(pk, pr)), 1e-5)
    ms = cuda_ms(lambda: ra.pooled_from_packed(packed, params), 20)
    # The kernel alone, through its C entry (the wrapper's reading above adds
    # its host time where the host sets the pace).
    lib, stream, out = kernels.library(), kernels.stream_handle(packed.device), torch.empty_like(got)
    ms_kernel = cuda_ms(lambda: lib.tf_roi_align_fwd(
        packed.data_ptr(), params["fparams"].data_ptr(), params["iparams"].data_ptr(), out.data_ptr(), B, n,
        packed.shape[1], packed.shape[2], c, 7, 1, stream), 20)
    # pack_pyramid (a copy of the whole pyramid into one padded tensor) and
    # its backward (slices of the packed gradient), which sit around K5 and K6.
    leaves = {k: v.detach().requires_grad_() for k, v in feats.items()}
    packed_g = ra.pack_pyramid(leaves)[0]
    pack_ms = cuda_ms(lambda: ra.pack_pyramid(feats), 10)
    pack_bwd_ms = cuda_ms(lambda: torch.autograd.grad(packed_g, list(leaves.values()), packed, retain_graph=True), 10)
    log(f"  pack_pyramid {pack_ms:.4f} ms, its backward {pack_bwd_ms:.4f} ms")
    del leaves, packed_g
    plain = cuda_ms(lambda: ra.roi_align_plain(packed, params), 1, warmup=1)
    samples = float((params["ry"] * params["rx"]).sum()) * 49
    touched = _roi_touched_bytes(torch, params, shapes, packed.shape[1], packed.shape[2], c, 2)
    bms, by = bound_ms(touched + got.numel() * 2 + rois.numel() * 4, samples * c * 8, F32_FLOPS)
    log(f"  {samples:.0f} bilinear samples, {touched / 1e6:.1f} MB of pyramid touched; "
        f"wrapper {ms:.4f} ms, kernel alone {ms_kernel:.4f} ms")
    return {"name": "roi_align_fwd", "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "library_ms": None, "bound_ms": bms, "bound_by": by, "ms_kernel": ms_kernel,
            "pack_ms": pack_ms, "pack_bwd_ms": pack_bwd_ms}


def phase_roi_align_bwd(torch):
    """K6 at the train path's shapes: 128 sampled RoIs an image pooled from
    the bf16 pyramid; the kernel writes the bf16 gradient once, every cell,
    from f32 sums in another order than the plain version's: the result is
    held at one bf16 ulp of max|plain|, its mean error over the touched
    cells at 2^-7 of their mean, every cell outside the RoIs' footprints
    (padding columns included) at exactly 0, and two launches bit for bit."""
    from transfusion_torch import kernels
    from transfusion_torch.ops import roi_align as ra

    c, n = ROI_C, 128
    log(f"[roi_align_bwd] pyramid {ROI_SIZES} x {c} bf16, rois [{B}, {n}, 4], grad [{B}, {n}, 7, 7, {c}]")
    g, feats, rois, packed, shapes, offsets, params = roi_inputs(torch, 6, n, False)
    shape = tuple(packed.shape)
    gout = torch.randn(B, n, 7, 7, c, device="cuda", generator=g).to(torch.bfloat16)
    got = ra.roi_align_bwd(gout, params, shape, torch.bfloat16)
    want = ra.roi_align_bwd_plain(gout, params, shape, torch.bfloat16)
    torch.cuda.synchronize()
    err = max_err(got, want)
    check("roi_align backward bf16", err, bf16_ulp(float(want.float().abs().max())))
    # One lost sample moves a cell by far less than the ulp above; the mean
    # over the cells the RoIs touch sees it.
    touched_cells = (want != 0) | (got != 0)
    mean_rel = float((got.float() - want.float()).abs()[touched_cells].mean()
                     / want.float().abs()[touched_cells].mean())
    check("roi_align backward bf16 (touched cells)", mean_rel, 2.0 ** -7,
          "mean|kernel - plain| / mean|plain|")
    del touched_cells
    foot = ra.roi_footprints(params)
    outside = ~_cover(torch, (foot[..., 0], foot[..., 1]), (foot[..., 2], foot[..., 3]), foot[..., 0] > foot[..., 1],
                      shape[1], shape[2])
    check("roi_align backward bf16 outside every footprint", float((got.ne(0).any(-1) & outside).sum()), 0.0,
          "non-zero cells")
    check("roi_align backward bf16, two launches",
          float((ra.roi_align_bwd(gout, params, shape, torch.bfloat16) != got).sum()), 0.0, "differing elements")
    del outside
    pf = ra.roi_sample_params(rois[:2, :50], shapes, offsets, (H, W), 7, 0)
    gf = torch.randn(2, 50, 7, 7, c, device="cuda", generator=g)
    shape_f = (2,) + shape[1:]
    want_f = ra.roi_align_bwd_plain(gf, pf, shape_f, torch.float32)
    check("roi_align backward f32", max_err(ra.roi_align_bwd(gf, pf, shape_f, torch.float32), want_f)
          / float(want_f.abs().max()), 1e-5, "max|kernel - plain| / max|plain|")
    ms = cuda_ms(lambda: ra.roi_align_bwd(gout, params, shape, torch.bfloat16), 10)
    lib, stream = kernels.library(), kernels.stream_handle(gout.device)
    ms_kernel = cuda_ms(lambda: lib.tf_roi_align_bwd(
        gout.data_ptr(), params["fparams"].data_ptr(), params["iparams"].data_ptr(), got.data_ptr(), B, n,
        shape[1], shape[2], c, 7, 1, stream), 10)
    plain = cuda_ms(lambda: ra.roi_align_bwd_plain(gout, params, shape, torch.bfloat16), 1, warmup=1)
    samples = float((params["ry"] * params["rx"]).sum()) * 49
    # The output is the whole bf16 pyramid, written once; g is read once.
    bms, by = bound_ms(packed.numel() * 2 + gout.numel() * 2 + rois.numel() * 4, samples * c * 8,
                       F32_FLOPS)
    log(f"  {samples:.0f} bilinear samples; wrapper {ms:.4f} ms, kernel alone {ms_kernel:.4f} ms")
    del packed, feats, got, want
    torch.cuda.empty_cache()
    return {"name": "roi_align_bwd", "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "library_ms": None, "bound_ms": bms, "bound_by": by, "ms_kernel": ms_kernel}


def _tiny_cfg(train: bool = False):
    from transfusion_torch.models.detector import DetectorConfig
    from transfusion_torch.models.roi_heads import RoIConfig
    from transfusion_torch.models.rpn import RPNConfig
    from transfusion_torch.models.text_encoder import BertConfig
    from transfusion_torch.models.transfusion import FusionConfig, TransFusionConfig

    # Training: every dropout rate 0 so the card and the CPU take one step.
    off = {"token_dropout": 0.0, "patch_dropout": 0.0, "backproj_dropout": 0.0} if train else {}
    return TransFusionConfig(
        detector=DetectorConfig(
            roi=RoIConfig(num_nouns=7, num_verbs=5, representation_size=64, detections_per_img=10,
                          score_thresh=0.01, ttc_on=True, additional_postprocessing=True,
                          batch_size_per_image=16),
            rpn=RPNConfig(pre_nms_top_n_test=64, post_nms_top_n_test=32, score_thresh=0.01,
                          pre_nms_top_n_train=64, post_nms_top_n_train=32),
            stage_sizes=(1, 1, 1, 1)),
        fusion=FusionConfig(fpn_features=(0, 3), patch_h=(1, 1), patch_w=(1, 1), num_layers=(1, 1),
                            token_dim=64, num_heads=2, use_flash_attention=True, **off),
        bert=BertConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                        intermediate_size=32, max_position_embeddings=16,
                        dropout=0.0 if train else 0.1),
        out_mlp=64, out_dropout=0.0 if train else 0.1)


def phase_small_reference(torch):
    """The tiny f32 model (level-0 sequence 2048 + 8 tokens, so attention
    takes the kernel) on the card against the same weights on the CPU."""
    from transfusion_torch.kernels import LAUNCHES
    from transfusion_torch.models.transfusion import TransFusion
    from transfusion_torch.weights import init_random_

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _tiny_cfg()
    cpu = init_random_(TransFusion(cfg, device="cpu"), seed=5)
    gpu = TransFusion(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(6)
    batch = {"image": torch.randn(2, 128, 256, 3, generator=gen),
             "input_ids": torch.randint(0, 64, (2, 8), generator=gen),
             "attention_mask": torch.ones(2, 8, dtype=torch.int64), "image_hw": (128, 256)}
    batch["attention_mask"][1, 6:] = 0
    LAUNCHES.clear()
    with torch.inference_mode():
        ref = cpu.trunk(batch)
        got = gpu.trunk(batch)
        out = gpu.apply_rpn_roi(got, batch["image_hw"])
    torch.cuda.synchronize()
    # K1: 2 fusion layers x 2 + 1 MiniLM layer x 2 residual norms, 2 final
    # norms and the embeddings norm.
    if (LAUNCHES["attention_fwd"] != 1 or LAUNCHES["residual_layer_norm"] != 6
            or LAUNCHES["layer_norm"] != 3):
        raise AssertionError(f"small reference did not take the kernels: {dict(LAUNCHES)}")
    worst = 0.0
    for key in ref:
        scale = float(ref[key].abs().max())
        worst = max(worst, max_err(got[key].cpu(), ref[key]) / scale)
    check("tiny f32 trunk on the card vs the CPU", worst, 1e-4, "max|card - cpu| / max|cpu|")
    if not torch.isfinite(out["roi_outputs"]["class_logits"]).all():
        raise AssertionError("non-finite RoI outputs in the small reference run")
    torch.backends.cudnn.allow_tf32 = True


def phase_small_train_reference(torch):
    """One tiny f32 train step on the card (kernels K1-K6) against the same
    step on the CPU (plain versions): the same weights, batch, sampler draws
    and optimizer, dropout off. Losses agree to 1e-4 relative; every
    parameter's update to 1e-3 of the tensor's largest update (or two f32
    ulps of the parameter, which new - old carries, or 1e-10 where the
    gradient is zero in exact arithmetic)."""
    from transfusion_torch.kernels import LAUNCHES
    from transfusion_torch.models.transfusion import TransFusion
    from transfusion_torch.train.optim import make_optimizer
    from transfusion_torch.train.step import LossConfig, TrainState, criterion_weights, make_train_step
    from transfusion_torch.weights import init_random_

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _tiny_cfg(train=True)
    cpu = init_random_(TransFusion(cfg, device="cpu"), seed=7)
    gpu = TransFusion(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(8)
    batch = {"image": torch.randn(2, 128, 256, 3, generator=gen),
             "input_ids": torch.randint(0, 64, (2, 8), generator=gen),
             "attention_mask": torch.ones(2, 8, dtype=torch.int64), "image_hw": (128, 256),
             "targets": {"boxes": torch.tensor([[[10.0, 12.0, 90.0, 70.0], [120.0, 30.0, 250.0, 120.0]],
                                                [[5.0, 5.0, 60.0, 44.0], [0.0, 0.0, 0.0, 0.0]]]),
                         "nouns": torch.tensor([[2, 5], [1, 0]]), "verbs": torch.tensor([[1, 3], [999, 0]]),
                         "ttcs": torch.tensor([[0.5, 1.5], [0.9, 0.0]]),
                         "valid": torch.tensor([[True, True], [True, False]])}}
    batch["attention_mask"][1, 6:] = 0
    with torch.no_grad():
        anchors = cpu(batch)["proposals"]["anchors"].shape[0]
    n_roi = cfg.detector.rpn.post_nms_top_n_train + 2
    draws = {"roi": tuple(torch.rand(2, n_roi, generator=gen) for _ in range(2)),
             "rpn": tuple(torch.rand(2, anchors, generator=gen) for _ in range(2))}
    on_card = {k: tuple(t.cuda() for t in v) for k, v in draws.items()}
    lw = criterion_weights({"bbox": 1, "obj_prop": 1, "noun": 1, "verb": 1, "ttc": 0.5})
    loss_cfg = LossConfig(ttc_on=True, rpn_batch_size_per_image=16, last_noun_idx=6)
    results, before = {}, {n: p.detach().clone() for n, p in cpu.named_parameters()}
    for name, model, dr in (("card", gpu, on_card), ("cpu", cpu, draws)):
        tx, _ = make_optimizer({"name": "radam", "lr": 1e-3, "weight_decay": 1e-4}, None, 10, grad_clip=4.0)
        state = TrainState(step=0, opt_state=tx.init(dict(model.named_parameters())))
        step = make_train_step(model, tx, loss_cfg, torch.ones(7), torch.ones(5))
        LAUNCHES.clear()
        results[name] = step(state, batch, lw, None, dr)
        torch.cuda.synchronize()
        if name == "card":
            launches = dict(LAUNCHES)
    need = ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv", "roi_align_fwd", "roi_align_bwd",
            "layer_norm", "residual_layer_norm")
    log(f"[small train reference] launches on the card: {launches}")
    if any(launches.get(k, 0) < 1 for k in need):
        raise AssertionError(f"the tiny train step did not take every kernel: {launches}")
    worst = 0.0
    for key in ("loss", "bbox_loss", "objectness_loss", "loss_rpn_box_reg", "noun_loss", "verb_loss",
                "ttc_loss"):
        a, b = float(results["card"][key]), float(results["cpu"][key])
        worst = max(worst, abs(a - b) / max(abs(b), 1e-6))
    check("tiny f32 train step losses, card vs CPU", worst, 1e-4, "max relative difference")
    card_params = dict(gpu.named_parameters())
    worst = 0.0
    for n, p in cpu.named_parameters():
        du_cpu = p.detach() - before[n]
        du_card = card_params[n].detach().cpu() - before[n]
        tol = max(1e-3 * float(du_cpu.abs().max()), 2.4e-7 * float(before[n].abs().max()), 1e-10)
        worst = max(worst, float((du_card - du_cpu).abs().max()) / tol)
    check("tiny f32 train step updates, card vs CPU", worst, 1.0,
          "max over tensors of max|update difference| / tolerance")
    torch.backends.cudnn.allow_tf32 = True


def phase_slice(torch, np):
    from transfusion_torch.kernels import LAUNCHES
    from transfusion_torch.models.detector import detections_from_outputs
    from transfusion_torch.models.transfusion import TransFusion, flagship_config
    from transfusion_torch.weights import init_random_

    cfg = flagship_config()
    t0 = time.perf_counter()
    model = init_random_(TransFusion(cfg, device="cuda"), seed=0)
    log(f"[slice] flagship model built with seeded random weights in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)")
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.normal(0, 0.7, (B, H, W, 3)).astype(np.float32)).cuda(),
        "input_ids": torch.from_numpy(rng.integers(0, 30000, (B, LANG_LEN))).cuda(),
        "attention_mask": torch.ones(B, LANG_LEN, dtype=torch.int64, device="cuda"),
        "image_hw": (H, W),
    }
    nn_, nv = cfg.detector.roi.num_nouns, cfg.detector.roi.num_verbs
    freqs = torch.from_numpy(((rng.uniform(0, 1, (nn_, nv)) > 0.7)
                              * rng.integers(1, 50, (nn_, nv))).astype(np.float32)).cuda()

    def request():
        with torch.inference_mode():
            return detections_from_outputs(model(batch), cfg.detector, noun_verb_frequencies=freqs)

    t0 = time.perf_counter()
    request()
    torch.cuda.synchronize()
    log(f"  warm-up request {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    times, kept = [], []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        dets = request()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        kept.append(float(dets["valid"].sum()) / B)
    launches = dict(LAUNCHES)
    for key, shape in (("boxes", (B, 100, 4)), ("scores", (B, 100)), ("nouns", (B, 100)),
                       ("verbs", (B, 100)), ("ttcs", (B, 100)), ("valid", (B, 100))):
        if tuple(dets[key].shape) != shape:
            raise AssertionError(f"detections[{key}] has shape {tuple(dets[key].shape)}, want {shape}")
        if dets[key].dtype.is_floating_point and not torch.isfinite(dets[key]).all():
            raise AssertionError(f"non-finite detections[{key}]")
    per_forward = {k: launches.get(k, 0) / REQUESTS for k in EXPECTED_PER_FORWARD}
    log(f"  launches per forward {per_forward} (expected {EXPECTED_PER_FORWARD})")
    if per_forward != EXPECTED_PER_FORWARD:
        raise AssertionError("the main path did not launch every kernel the expected number of times")
    fps = B * REQUESTS / sum(times)
    log(f"  request seconds {[round(t, 4) for t in times]}; {fps:.2f} frames/s; "
        f"mean kept detections/image {np.mean(kept):.1f}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rec = {"frames_per_s": fps, "request_s": times, "mean_kept": float(np.mean(kept)),
           "launches": launches, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    return rec, (model, cfg, batch, freqs)


def phase_train_slice(torch, np, model, cfg, batch):
    """The flagship train step on the eval slice's model and input, with one
    GT box an image (as bench.py::main_train)."""
    from transfusion_torch.kernels import LAUNCHES
    from transfusion_torch.runner.trainer import unfreeze_multipliers
    from transfusion_torch.train.optim import make_optimizer
    from transfusion_torch.train.step import LossConfig, TrainState, criterion_weights, make_train_step

    nn_, nv = cfg.detector.roi.num_nouns, cfg.detector.roi.num_verbs
    dev = "cuda"
    batch = dict(batch, targets={
        "boxes": torch.tensor([[[100.0, 100.0, 400.0, 400.0]]], device=dev).repeat(B, 1, 1),
        "nouns": torch.full((B, 1), 2, device=dev), "verbs": torch.full((B, 1), 1, device=dev),
        "ttcs": torch.full((B, 1), 0.9, device=dev), "valid": torch.ones(B, 1, dtype=torch.bool, device=dev)})
    tx, _ = make_optimizer({"name": "radam", "lr": 1e-4, "weight_decay": 1e-5}, None, 100)
    state = TrainState(step=0, opt_state=tx.init(dict(model.named_parameters())))
    # The v2 flagship's freeze rules at epoch 0 (ego_vis_det_ego4dv2.yml: the
    # body never unfreezes; the narration encoder trains its out_mlp).
    mult = unfreeze_multipliers(model.named_parameters(), 0,
                                {"type": "res50", "train_ep": -1, "trainable_layers": 2}, -1, 1,
                                cfg.bert.num_layers)
    step = make_train_step(model, tx, LossConfig(rpn_batch_size_per_image=256, last_noun_idx=nn_ - 1),
                           torch.ones(nn_), torch.ones(nv))
    lw = criterion_weights({"bbox": 1, "obj_prop": 1, "noun": 1, "verb": 1})
    log(f"[train slice] flagship train step, B {B}, {H}x{W}, {LANG_LEN} tokens; "
        f"{sum(int(m) for m in mult.values())} of {len(mult)} parameter tensors train")
    t0 = time.perf_counter()
    step(state, batch, lw, mult)
    torch.cuda.synchronize()
    log(f"  warm-up step {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    times, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step(state, batch, lw, mult)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = dict(LAUNCHES)
    for m in metrics:
        if not all(math.isfinite(v) for v in m.values()) or m["nonfinite_skipped"] != 0.0:
            raise AssertionError(f"a train step went non-finite or was skipped: {m}")
    per_step = {k: launches.get(k, 0) / TRAIN_STEPS for k in EXPECTED_PER_STEP}
    log(f"  launches per step {per_step} (expected {EXPECTED_PER_STEP})")
    if per_step != EXPECTED_PER_STEP:
        raise AssertionError("the train step did not launch every kernel the expected number of times")
    params = dict(model.named_parameters())
    for name in ("cross_fusion_encoders.0.t_encoder.layers.0.self_attn.in_proj_weight",
                 "backbone.fpn.layer_blocks.0.weight"):
        gnorm = float(params[name].grad.float().norm())
        log(f"  |grad| {name} = {gnorm:.4e}")
        if not gnorm > 0.0:
            raise AssertionError(f"zero gradient on {name}: a kernel cut the gradient")
    fps = B * TRAIN_STEPS / sum(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  step seconds {[round(t, 4) for t in times]}; {fps:.2f} train frames/s; "
        f"losses {[round(m['loss'], 4) for m in metrics]}; peak memory {peak:.2f} GiB")
    rec = {"frames_per_s": fps, "step_s": times, "metrics": metrics, "launches": launches,
           "peak_gib": peak}
    return rec, lambda: step(state, batch, lw, mult)


def flagship_run_config() -> dict:
    """The flagship run config as the trainer reads it after
    ``config.derive_config``: ego_nao_res50_ego4dv2.yml with
    ego_vis_det_ego4dv2.yml folded in, as ``flagship_config()`` mirrors them,
    at precision 16, batch 8 for training and validation, one epoch, RAdam
    lr 1e-4 / wd 1e-5, the bbox/obj_prop/noun/verb criterion and one
    768x1024 resize bucket."""
    return {
        "experiment": "egonao", "debug": False,
        "split": {"subset": 0},
        "aug": {"resize_spec": [[H], [W]], "crop_spec": [1, 1], "flip": False,
                "channel_order": "BGR"},
        "dataset": {"name": "ego4djpgv2", "args": {"narr_structure": "{gt_narr}"}},
        "model": {
            "type": "res50", "train_ep": -1, "trainable_layers": 2, "representation_size": 1280,
            "box_1_dropout": 0.0, "box_2_dropout": 0.0, "adapt_to_detectron": True,
            "additional_postprocessing": True, "batch_norm": {"use": False, "momentum": 0.1},
            "rcnn_kwargs": {"box_score_thresh": 0.01, "rpn_score_thresh": 0.01,
                            "rpn_batch_size_per_image": 256, "box_batch_size_per_image": 128},
            "ttc_hand_head": {"use": False}, "pretrained": None, "load_fpn_rpn": True,
        },
        "run": {
            "seed": 42, "epochs": 1, "val_every": 1.0, "precision": 16,
            "train_bs": B, "val_bs": B, "accumulate_grad_batches": 1, "grad_clip": None,
            "normalization": "ego4d_baseline", "verb_bg": True, "bg_weight": 1,
            "all_class_w": False, "class_dropout": 0.0, "replace_heads": False,
            "freeze_backbone_at_epoch": -1,
            "narration_embeds": {"use": True, "args": {
                "strategy": "current", "pooling": "max", "model_v": "all-MiniLM-L12-v2",
                "text_pooling": "sbert_finetune", "size": 384, "out_mlp": 896,
                "out_dropout": 0.1, "out_tanh": False, "train_ep": -1, "finetune_layers": 1}},
            "narr_fusion": {
                "type": "cross_transformer", "narr_out_mode": "tokens", "share_encoders": False,
                "fpn_features": [0, 1, 2, 3], "patch_h": [4, 4, 2, 1], "patch_w": [4, 4, 2, 1],
                "backproj_dropout": 0.1, "pos_embedding": "sin1d", "forward_language_f": False,
                "vis_mask_type": "global", "replace_fpn_features": True,
                "args": {"input_f_size": 896, "num_layers": [4, 4, 4, 4], "num_heads": 4,
                         "fforward_multiplier": 2, "token_dropout": 0.15, "patch_dropout": 0.1,
                         "final_norm": "ln", "activ_f": "gelu"}},
            "criterion": {"bbox": 1, "obj_prop": 1, "noun": 1, "verb": 1, "agg": "mean"},
            "optimizer": {"name": "radam", "lr": 1e-4, "weight_decay": 1e-5},
            "scheduler": {"use": False},
        },
    }


class MemoryDataset:
    """A split of in-memory examples already at the bucket (normalised f32
    HWC images), in the dataset interface the trainer's loader calls."""

    def __init__(self, examples: list, aug, num_nouns: int, num_verbs: int):
        self.examples, self.aug = examples, aug
        self.num_nouns, self.num_verbs = num_nouns, num_verbs

    def __len__(self):
        return len(self.examples)

    def get_example(self, idx: int, rng, bucket, training: bool) -> dict:
        ex = self.examples[idx]
        assert ex["image"].shape[:2] == tuple(bucket)
        return ex


def trainer_data(np, seed: int = 0):
    """A TrainerData of synthetic examples in the v2 label space (87 nouns +
    background, 74 verbs + background), 1-2 GT boxes an image."""
    from transfusion_torch.data.tokenizer import hash_vocab_tokenizer
    from transfusion_torch.data.transforms import AugConfig
    from transfusion_torch.runner.trainer import TrainerData
    from transfusion_torch.train.losses import build_class_weights

    rng = np.random.default_rng(seed)
    nouns = {f"noun{i}": i + 1 for i in range(87)}
    verbs = {f"verb{i}": i for i in range(74)}
    noun_names, verb_names = list(nouns), list(verbs)

    def example(uid):
        g = int(rng.integers(1, 3))
        xy = rng.uniform(0, 0.7, (g, 2)) * [W, H]
        wh = rng.uniform(0.06, 0.3, (g, 2)) * [W, H]
        n = rng.integers(0, 87, g)
        v = rng.integers(0, 74, g)
        return {"image": rng.normal(0, 0.7, (H, W, 3)).astype(np.float32),
                "boxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
                "nouns": (n + 1).astype(np.int32), "verbs": v.astype(np.int32),
                "ttcs": np.full(g, rng.uniform(0.3, 1.8), np.float32), "id": uid,
                "orig_shape": (H, W),
                "narration": " and ".join(f"{verb_names[a]} {noun_names[b]}" for a, b in zip(v, n))}

    aug = AugConfig(resize_spec=((H,), (W,)), crop_spec=(1, 1), flip=False)
    train = MemoryDataset([example(f"train_{i:04d}") for i in range(TRAINER_TRAIN)], aug, 88, 75)
    val = MemoryDataset([example(f"val_{i:04d}") for i in range(TRAINER_VAL)], aug, 88, 75)
    noun_w, verb_w = build_class_weights(np.ones(88), np.ones(74), 1, True, False)
    freqs = ((rng.uniform(0, 1, (88, 75)) > 0.7) * rng.integers(1, 50, (88, 75))).astype(np.float32)
    return TrainerData(train, val, val, nouns, verbs, noun_w, verb_w, freqs, aug,
                       hash_vocab_tokenizer(max_length=TRAINER_LANG))


def check_trainer_shapes(torch):
    """K1-K4 at the trainer's shapes, which 128 narration tokens make other
    than the eval and train slices' (level 0 3,200 tokens, levels 1-3 896,
    MiniLM 128), against their plain versions with the kernel phases'
    tolerances."""
    from transfusion_torch.ops import attention as at
    from transfusion_torch.ops import layer_norm as ln

    g = torch.Generator(device="cuda").manual_seed(9)
    n0, n1 = 3072 + TRAINER_LANG, 768 + TRAINER_LANG
    for shape in ({"n": n0, "d": 896, "dtype": "bf16", "residual": True},
                  {"n": 3072, "view": n0, "d": 896, "dtype": "bf16", "residual": False},
                  {"n": n1, "d": 896, "dtype": "bf16", "residual": True},
                  {"n": 768, "view": n1, "d": 896, "dtype": "bf16", "residual": False},
                  {"n": TRAINER_LANG, "d": 384, "dtype": "bf16", "residual": True, "eps": 1e-12},
                  {"n": TRAINER_LANG, "d": 384, "dtype": "f32", "residual": False, "eps": 1e-12}):
        sets, w, b = ln_inputs(torch, shape, g)
        x, r = sets[0]
        eps = shape.get("eps", 1e-6)
        err = max_err(ln.fused_layer_norm(x, w, b, eps, residual=r),
                      ln.layer_norm_plain(x.contiguous(), w, b, eps, residual=r))
        label = (f"{'residual_' if r is not None else ''}layer_norm "
                 f"[{B} x {shape['n']}{' of ' + str(shape['view']) if 'view' in shape else ''}, "
                 f"{shape['d']}] {shape['dtype']}")
        check(f"[trainer shapes] {label}", err, 3.2e-2 if shape["dtype"] == "bf16" else 1e-4)
        # The train step's backward: layer_norm (K1 forward, closed-form
        # gradient) against autograd through the plain version, each
        # gradient relative to its largest entry; dx is rounded to the input
        # dtype (two bf16 ulps), dweight and dbias sum every row in f32.
        cot = torch.randn(x.shape, device="cuda", generator=g).to(x.dtype)
        grads = []
        for fn in (ln.layer_norm, ln.layer_norm_plain):
            ins = [t.detach().requires_grad_() for t in (x, w, b) + ((r,) if r is not None else ())]
            fn(ins[0], ins[1], ins[2], eps, ins[3] if r is not None else None).backward(cot)
            grads.append([t.grad for t in ins])
        for name, a, b_ in zip(("dx", "dweight", "dbias", "dresidual"), *grads):
            rel = max_err(a, b_) / float(b_.float().abs().max())
            check(f"[trainer shapes] {label} {name}", rel,
                  2 ** -7 if name in ("dx", "dresidual") and shape["dtype"] == "bf16" else 1e-4,
                  "max|layer_norm - plain autograd| / max|plain|")
    q, k, v, dout = (torch.randn(B, n0, HEADS, HEAD_DIM, device="cuda", generator=g).to(torch.bfloat16)
                     for _ in range(4))
    mask = torch.zeros(B, n0, dtype=torch.bool, device="cuda")
    mask[: B // 2, -50:] = True
    for rate in (0.0, DROPOUT):
        out, stats = at.attention_fwd(q, k, v, mask, rate, 77, return_stats=True)
        pairs = [("output", out, at.attention_plain(q, k, v, mask, rate, 77)[0], 2)]
        if rate:
            grads = zip(("dq", "dk", "dv"), at.attention_bwd(q, k, v, out, stats, dout, mask, rate, 77),
                        at.attention_bwd_plain(q, k, v, out, stats, dout, mask, rate, 77))
            pairs += [(name, a, b_, 4) for name, a, b_ in grads]
        for name, a, b_, ulps in pairs:
            check(f"[trainer shapes] attention bf16 {name} [{B}, {n0}, {HEADS}, {HEAD_DIM}] rate {rate}",
                  max_err(a, b_), ulps * bf16_ulp(float(b_.float().abs().max())))
            check(f"[trainer shapes] attention bf16 {name} rate {rate}",
                  float((a.float() - b_.float()).abs().mean() / b_.float().abs().mean()), 2.0 ** -7,
                  "mean|kernel - plain| / mean|plain|")
    del q, k, v, dout, out, stats, pairs
    torch.cuda.empty_cache()


def _counted(torch, fn, kind: str, counts: dict, times: list, captured: list | None = None):
    """``fn`` with each call's kernel launches added to ``counts[kind]`` and
    its time (to the end of its device work) to ``times``; ``captured``
    keeps each call's detections (its first result) on the host."""
    from transfusion_torch.kernels import LAUNCHES

    def wrapped(*args, **kwargs):
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per = counts.setdefault(kind, {})
        for k, v in LAUNCHES.items():
            per[k] = per.get(k, 0) + v - before.get(k, 0)
        if captured is not None:
            captured.append({k: v.cpu().numpy() for k, v in out[0].items()})
        return out

    return wrapped


def _bits_equal(np, a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a, b, equal_nan=a.dtype.kind == "f")


def phase_trainer(torch, np):
    """The trainer on the card at flagship width: fit(1) on in-memory
    examples, then resume from its checkpoint into a fresh trainer."""
    import shutil
    from dataclasses import replace

    from transfusion_torch.kernels import LAUNCHES
    from transfusion_torch.models.transfusion import flagship_config
    from transfusion_torch.runner.trainer import EgoNaoTrainer

    t_phase = time.perf_counter()
    check_trainer_shapes(torch)
    run_dir = os.path.join(HERE, "chiprun_out", "trainer_run")
    for d in (run_dir, run_dir + "_resume"):
        shutil.rmtree(d, ignore_errors=True)
    data = trainer_data(np)
    cfg = flagship_run_config()
    t0 = time.perf_counter()
    trainer = EgoNaoTrainer(cfg, run_dir, data=data)
    log(f"[trainer] flagship trainer built in {time.perf_counter() - t0:.1f} s; "
        f"{len(data.train_ds)} train / {len(data.val_ds)} val examples at {H}x{W}, "
        f"{TRAINER_LANG} tokens")
    want = flagship_config()
    want = replace(want, detector=replace(want.detector, stop_grad_stages=0))
    if trainer.model_cfg != want:
        raise AssertionError(f"build_transfusion_config(flagship_run_config()) != flagship_config(): "
                             f"{trainer.model_cfg} vs {want}")
    counts: dict = {}
    train_s: list = []
    val_s: list = []
    dets_first: list = []
    trainer.train_step = _counted(torch, trainer.train_step, "train", counts, train_s)
    trainer.eval_loss_step = _counted(torch, trainer.eval_loss_step, "val", counts, val_s, dets_first)
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    history = trainer.fit(1)
    total = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rec = history[0]
    if len(train_s) != TRAINER_TRAIN // B or len(val_s) != TRAINER_VAL // B:
        raise AssertionError(f"{len(train_s)} train steps, {len(val_s)} val batches")
    per_step = {k: counts["train"].get(k, 0) / len(train_s) for k in EXPECTED_PER_STEP}
    per_val = {k: counts["val"].get(k, 0) / len(val_s) for k in EXPECTED_PER_VAL_BATCH}
    log(f"  launches per train step {per_step} (expected {EXPECTED_PER_STEP})")
    log(f"  launches per val batch {per_val} (expected {EXPECTED_PER_VAL_BATCH})")
    if per_step != EXPECTED_PER_STEP or per_val != EXPECTED_PER_VAL_BATCH:
        raise AssertionError("the trainer did not launch every kernel the expected number of times")
    losses = {k: v for k, v in rec.items() if k.endswith("loss")}
    if not all(math.isfinite(v) for v in losses.values()) or rec["train_nonfinite_skipped"] != 0.0:
        raise AssertionError(f"non-finite loss or a skipped step: {rec}")
    maps = {k: v for k, v in rec.items() if k.endswith("_val")}
    if len(maps) != 8 or not all(0.0 <= v <= 100.0 for v in maps.values()):
        raise AssertionError(f"STA mAP out of [0, 100]: {maps}")
    with open(os.path.join(run_dir, "results", "val_epoch0.json")) as f:
        payload = json.load(f)
    if not payload["challenge"].startswith("ego4d_short_term") or len(payload["results"]) != TRAINER_VAL:
        raise AssertionError(f"result JSON: {payload['challenge']}, {len(payload['results'])} uids")
    keys = {"box", "noun_category_id", "verb_category_id", "time_to_contact", "score"}
    if any(set(e) != keys for entries in payload["results"].values() for e in entries):
        raise AssertionError("result JSON entries are not in the challenge schema")
    for f in ("history.jsonl", os.path.join("checkpoints", "best.json")):
        if not os.path.isfile(os.path.join(run_dir, f)):
            raise AssertionError(f"{f} not written")
    step_s, batch_s = float(np.mean(train_s)), float(np.mean(val_s))
    log(f"  train step seconds {[round(t, 4) for t in train_s]}, val batch seconds "
        f"{[round(t, 4) for t in val_s]}")
    log(f"  train {step_s:.4f} s/step ({B / step_s:.2f} frames/s), val {batch_s:.4f} s/batch "
        f"({B / batch_s:.2f} frames/s), train_decode_s_per_batch "
        f"{rec.get('train_decode_s_per_batch')}, train_s_per_batch {rec['train_s_per_batch']}, "
        f"peak {peak:.2f} GiB")
    log(f"  losses {json.dumps(losses)}; mAP {json.dumps(maps)}")

    # Resume into a fresh trainer: the same state, the same evaluation.
    ckpt = trainer.ckpt.epoch_path(0)
    params = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    opt, st = trainer.state.opt_state, trainer.state
    moments = {m: {k: v.clone() for k, v in opt[m].items()} for m in ("mu", "nu")}
    scalars = (opt["count"], st.step, st.seed)
    first = {k: v for k, v in rec.items() if k.endswith("_val") or k.startswith("val_")}
    del trainer, opt, st
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resumed = EgoNaoTrainer(cfg, run_dir + "_resume", data=data)
    resumed.ensure_state(resume_from=ckpt)
    log(f"  fresh trainer built and resumed in {time.perf_counter() - t0:.1f} s")
    got, st = resumed.model.state_dict(), resumed.state
    same = (set(got) == set(params) and all(torch.equal(got[k], v) for k, v in params.items())
            and all(torch.equal(st.opt_state[m][k], v) for m in moments for k, v in moments[m].items())
            and (st.opt_state["count"], st.step, st.seed) == scalars)
    if not same:
        raise AssertionError("the resumed trainer's parameters, moments, step or seed differ")
    dets_resumed: list = []
    resumed.eval_loss_step = _counted(torch, resumed.eval_loss_step, "resume", counts, [],
                                      dets_resumed)
    again = resumed.evaluate(0).metrics
    if len(dets_resumed) != len(dets_first):
        raise AssertionError(f"{len(dets_resumed)} resumed val batches, {len(dets_first)} before")
    for a, b in zip(dets_first, dets_resumed):
        bad = [k for k in a if not _bits_equal(np, a[k], b[k])]
        if bad:
            raise AssertionError(f"resumed detections differ in {bad}")
    diff = {k: (v, again[k]) for k, v in first.items()
            if not (v == again[k] or (math.isnan(v) and math.isnan(again[k])))}
    if diff:
        raise AssertionError(f"resumed evaluation differs: {diff}")
    log("  resume: parameters, moments, step and seed equal bit for bit; detections bit for bit, "
        "mAP and val losses equal")
    os.remove(os.path.join(ckpt, "state.pt"))  # 2.6 GB; the run's other files stay
    wall = time.perf_counter() - t_phase
    log(f"  trainer phase wall time {wall:.1f} s")
    return {"train_s_per_step": step_s, "train_frames_per_s": B / step_s, "train_step_s": train_s,
            "val_batch_s": val_s, "val_s_per_batch": batch_s, "val_frames_per_s": B / batch_s, "peak_gib": peak,
            "history": rec, "launches": total, "launches_train": counts["train"],
            "launches_val": counts["val"], "phase_s": wall}


def phase_profile(torch, model, cfg, batch, freqs):
    """Where a request's time goes: each stage of the forward timed on the
    host clock between synchronisations (so stages do not overlap), then one
    request under torch.profiler for the device-busy share and the top
    kernels by device time."""
    from transfusion_torch.models.detector import detections_from_outputs
    from transfusion_torch.models.rpn import generate_proposals
    from transfusion_torch.ops.roi_align import multiscale_roi_align

    stages: dict = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    def staged_request():
        f = cfg.fusion
        feats = timed("backbone", lambda: model.forward_features(batch["image"]))
        lang, lang_mask = timed("narration", lambda: model.narr_pooling_layer(
            batch["input_ids"], batch["attention_mask"]))
        for i, lvl in enumerate(f.fpn_features):
            feats[str(lvl)] = timed(f"fusion level {lvl}", lambda: model.cross_fusion_encoders[i](
                feats[str(lvl)], lang, lang_mask, model.patches_to_token[i], model.tokens_to_features[i]))
        fpn = timed("fpn", lambda: model.apply_fpn(feats))
        obj, deltas = timed("rpn head", lambda: model.rpn.head(fpn))
        props = timed("rpn proposals + nms", lambda: generate_proposals(
            obj, deltas, batch["image_hw"], cfg.detector.rpn))
        levels = {k: v.permute(0, 2, 3, 1) for k, v in fpn.items() if k.isdigit()}
        pooled = timed("roi_align", lambda: multiscale_roi_align(levels, props["boxes"], batch["image_hw"]))
        roi = timed("roi heads", lambda: model.roi_heads(pooled))
        outputs = {"roi_outputs": {**roi, "proposals": props["boxes"], "proposals_valid": props["valid"]},
                   "proposals": props, "image_sizes": tuple(batch["image_hw"])}
        timed("postprocess", lambda: detections_from_outputs(outputs, cfg.detector,
                                                             noun_verb_frequencies=freqs))

    reps = 3
    with torch.inference_mode():
        staged_request()
        stages.clear()
        for _ in range(reps):
            staged_request()
        stage_ms = {k: v / reps for k, v in stages.items()}
        log(f"[profile] stage ms (synchronised): {json.dumps({k: round(v, 3) for k, v in stage_ms.items()})}")
        rec = _trace(torch, "request", lambda: detections_from_outputs(
            model(batch), cfg.detector, noun_verb_frequencies=freqs))
    return {"stage_ms": stage_ms, **rec}


def _trace(torch, what: str, fn):
    """Run ``fn`` once under torch.profiler: its wall time, the device-busy
    time (sum of kernel times) and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels only: an operator's own entry repeats the time of the kernels it launched.
    kernels_run = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels_run) / 1e3
    top = sorted(kernels_run, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    log(f"[profile] profiled {what} {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"(idle share {1 - busy_ms / wall_ms:.3f})")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return {f"profiled_{what.replace(' ', '_')}_ms": wall_ms, "device_busy_ms": busy_ms,
            "top_kernels_ms": {e.key: e.self_device_time_total / 1e3 for e in top}}


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from transfusion_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the transfusion_torch package is missing beside this script ({e})",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    t_all = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}; {smi}")

    t0 = time.perf_counter()
    kernels.library()
    log(f"[build] {kernels.BUILD_LOG['path']} in {time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_report(kernels.BUILD_LOG.get("ptxas", {}))
    for r in ptxas:
        log(f"  {r['source']}: {r['kernel']}: {r['registers']} registers, {r['spill_stores']} bytes spill "
            f"stores, {r['spill_loads']} bytes spill loads")
    # The wgmma, RoIAlign and LayerNorm kernels are built to keep their values in registers.
    spilled = [r["kernel"] for r in ptxas
               if any(k in r["kernel"] for k in ("sm90", "roi_align", "layer_norm"))
               and r["spill_stores"] + r["spill_loads"]]
    if spilled:
        raise AssertionError(f"ptxas spilled registers in {spilled}")

    results = [*phase_layer_norm(torch), phase_attention(torch), phase_attention_dropout(torch), *phase_attention_bwd(torch),
               phase_self_attention(torch), phase_roi_align(torch), phase_roi_align_bwd(torch)]
    phase_small_reference(torch)
    phase_small_train_reference(torch)
    slice_rec, slice_state = phase_slice(torch, np)
    if "--profile" in sys.argv[1:]:
        slice_rec["profile"] = phase_profile(torch, *slice_state)
    model, cfg, batch, _ = slice_state
    train_rec, train_step = phase_train_slice(torch, np, model, cfg, batch)
    if "--profile" in sys.argv[1:]:
        train_rec["profile"] = _trace(torch, "train step", train_step)
    del model, slice_state, train_step
    torch.cuda.empty_cache()
    trainer_rec = phase_trainer(torch, np)

    rows, records = [], []
    for r in results:
        path = train_rec if r["name"] in TRAIN_KERNELS else slice_rec
        rows.append({
            "name": r["name"], "route": "cuda", "source": SOURCES[r["name"]],
            "replaces": REPLACES[r["name"]], "launches": path["launches"].get(r["name"], 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
        # The record adds the share of the bound reached and, for the products, TFLOP/s.
        records.append({**rows[-1], "pct_of_bound": 100.0 * r["bound_ms"] / r["ms"],
                        "trainer_launches": trainer_rec["launches"].get(r["name"], 0),
                        **({"tflop_s": r["flops"] / (r["ms"] * 1e-3) / 1e12} if "flops" in r else {}),
                        **{k: r[k] for k in ("ms_bhnd", "ms_kernel", "pack_ms", "pack_bwd_ms", "shapes") if k in r}})
        log(f"[{r['name']}] kernel {r['ms']:.4f} ms ({records[-1]['pct_of_bound']:.1f} % of bound), plain "
            f"{r['plain_ms']:.4f} ms, library "
            f"{'n/a' if r['library_ms'] is None else format(r['library_ms'], '.4f') + ' ms'}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "torch": torch.__version__, "kernels": records, "slice": slice_rec,
                   "train": train_rec, "trainer": trainer_rec, "ptxas": ptxas,
                   "build": {k: v for k, v in kernels.BUILD_LOG.items() if k != "ptxas"}}, f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
