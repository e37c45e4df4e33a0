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
   dK-dV 4 / RoIAlign 1 / RoIAlign backward 1 / LayerNorm 5 / residual 56;
6. the trainer: ``EgoNaoTrainer(flagship_run_config(), ...).fit(1)`` on
   in-memory examples at the 768x1024 bucket (32 train, 16 val, 1-2 GT
   boxes each, v2 label space, narrations through the hash-vocab tokenizer
   at 128 tokens): 4 train steps, 2 validation batches with losses
   (``eval_with_losses``), STA mAP, the result JSON, a checkpoint,
   ``history.jsonl`` and ``best.json``; launches per train step as the
   train slice, per validation batch LN 5 / residual LN 56 / attention 4 /
   RoIAlign 2; then a fresh trainer resumed from the checkpoint must hold
   the same parameters, optimizer state, step and seed bit for bit, and
   evaluate to the same detections bit for bit, the same mAP and losses;
7. the fusion options: K1 and its backward at the shapes they add
   (FUSION_OPTION_LN_SHAPES) against the plain versions, then five
   configurations at flagship width and depth, each
   ``flagship_run_config()`` with FUSION_OPTIONS' changes mapped by
   ``build_transfusion_config`` (the LM head with the JAX CLI's lm_args; a
   shared stack with summed language, learned positions and per-level
   heads; asymmetric with a multi-level head; space-time with ReLU;
   SlowFast clip features [8, 6, 2304] with embedding mode and direct
   language forwarding), seeded weights: two eval requests and two train
   steps after a warm-up each, finite losses, a non-zero LM loss, non-zero
   gradients on the LM heads and upstream of the new layers, and launches
   a forward and a step as EXPECTED_FUSION_OPTIONS predicts; eval s, step s
   and peak memory beside the card's name and power limit;
8. the narration towers and the transformer TTC head: K1 and its backward
   at the shapes they add (TOWER_LN_SHAPES: distilgpt2's norms, 512 x 768
   at eps 1e-5; the head's residual norms, 2,240 x 1024) against the plain
   versions, timed beside F.layer_norm; then three configurations at
   flagship width and depth, each ``flagship_run_config()`` with one
   change (TOWER_OPTIONS): distilgpt2 (6 x 768) and flan-t5-large (24 x
   1024, gated GELU) towers on the hash-fallback tokenizers at 64 tokens,
   and the TTC head (4 layers, 1024 wide, 5 detections an image) over a
   seeded hand history; seeded weights, two eval requests (through
   ``make_eval_step``, so the head's second pass runs) and two train
   steps after a warm-up each; launches as EXPECTED_TOWERS predicts,
   finite losses, a non-zero TTC loss whose gradient reaches the head and
   nothing upstream of its detached inputs, non-zero gradients upstream of
   K2-K4 and K6; eval s, step s, peak memory and the phase's wall time;
9. trainable BatchNorm and data parallelism (``dp_run_config()``: the
   flagship with ``model.batch_norm.use`` and the trunk training from epoch
   0, 16 train and 8 val examples, B 8 global): (a) one rank: ``fit(1)``,
   K1-K6 each launched, the BatchNorm against its plain version at every
   shape of the step and its share of the step; (b) a world of 1 over
   NCCL, replicated and fully sharded, against (a), and a resume bit for
   bit; (c) two ranks on the one card over gloo with CUDA tensors, B 4
   each: ``fit(1)`` against (a) (DP_TOL), the gradient all-reduce timed,
   a sharded evaluation of (a)'s checkpoint against (a)'s mAP and result
   keys; a collective gloo refuses on CUDA tensors is reported, and its
   two-rank check is left to the CPU tests; then (c) once more in f32
   (TF32 off) at B 2 global, one step, against (a) in f32 at B 2, held to
   DP_TOL with the CPU's 1e-4 and the noise floor recorded beside it;
10. the model axis (tensor parallelism; ``tp_run_config()``: the flagship
   with flash attention off, 16 train and 8 val examples, B 8): a model
   rank's dropout masks of its heads and hidden columns against the
   one-rank mask, bit for bit; (a) one rank ``fit(1)``, then in f32 (TF32
   off) at B 2; (b) two model ranks on
   the one card over gloo with CUDA tensors, mesh (1, 2), each holding B 8:
   ``fit(1)`` against (a) (DP_TOL), the same result keys, launches a step
   of K1 5 / 56, K5 1, K6 1 and K2-K4 0, the model-group collectives a
   step and a validation batch as TP_EXPECTED_* predicts, step s, the
   last step's collective seconds, peak GiB and parameter bytes a rank;
   (c) the same in f32 at B 2, one step, against (a)'s f32 run: the loss
   within 1e-4 relative and the median update within twice the noise
   floor's (one rank against itself with the fusion's linear1 weights
   scaled by 1 + 1e-6) or 1e-4; (d) (b)'s checkpoint resumed at one rank
   holds (b)'s gathered state bit for bit, its evaluation at one rank
   against model 2's; (e) on the two model ranks of (b), one bf16 step at B 8
   with ``remat_fusion`` against the plain step (a warm-up, then plain /
   remat / remat / plain from the same state): the loss and every update
   within twice the larger run-to-run gap of a setting (predicted equal),
   the recompute's 32 all-reduces on top of the plain step's collectives,
   K1 at 9 / 88 a remat step;
11. the other backbones, each at flagship width (B 8, 768x1024, bf16
   compute, f32 params, seeded weights): (a) ``model.type: mobilenet``
   (trunk training from epoch 0, trainable_layers 3): two eval requests
   and two train steps after a warm-up, finite losses, non-zero gradients
   on the unfrozen blocks, the frozen ones unmoved, launches as
   EXPECTED_MOBILENET predicts; (b) ``model.s2d_stem: true`` with its stem
   folded from the plain flagship's: f32 backbone maps (TF32 off) against
   the plain stem's within S2D_F32_TOL, bf16 detections against the plain
   flagship's at the golden tolerance (recorded), both stems timed, and the
   s2d flagship's request and step launching what the plain one's do; (c)
   ``FasterRCNN(DetectorConfig(dual_stream=True))`` with a seeded flow [8,
   768, 1024, 2]: a forward with detections and a forward + backward
   through the detector's losses (K5 once a forward, K6 once a backward),
   and with every fuse/proj weight zero under sum fusion the f32 RGB maps
   equal to the plain ResNet's bit for bit;
12. the legacy heatmap family: K1 at the widths it adds (HM_LN_SHAPES: the
   fusion's 300-wide tokens at 6,152, 6,672 and 8 rows in both forms, a
   batch-strided view, and an odd width, 301, in f32 and bf16; its
   backward at the two residual shapes) against the plain versions, timed
   beside F.layer_norm and its bound, the flagship's level-0 shapes
   re-timed; a tiny f32 HeatmapCrossFusion of each fusion family on the
   card (TF32 off) against the CPU within 1e-4; then at B 8, 768x1024, f32,
   seeded weights, the flagship's 88 nouns and 75 verbs: (a) ResnetNao
   (ResNet-50, heatmap_blocks 3) with hmap_criterion mse on gaussian
   targets, (b) its multivar_n form with multivar_n_loss (16 draws from a
   seeded generator on the card), (c) ScnnNao at the factory widths with
   kl_div (agg sum), (d1) HeatmapCrossFusion's defaults over seeded
   features [8, 48, 64, 1024] and a narration vector, (d2) its
   cross_transformer / token_embeddings / regroup form over 64 tokens with
   half of one image's padded, each with noun, verb and TTC heads: two
   eval forwards and two train steps (RAdam through make_optimizer) after
   a warm-up, launches as HM_EXPECTED predicts (K1 10 / 1 and 4 / 1 a
   forward for (d1) / (d2), none for (a)-(c)), finite outputs and losses,
   non-zero gradients on the heatmap head and upstream of every K1 norm;
   eval s, step s and peak GiB beside the card's name and power limit;
13. the offline tools: ``label_extraction.main(["extract", ...])`` with no
   ``--device`` at B 8 over 16 seeded JPEG frames at 1080x1440 (the eval
   transform rescales them to the 768x1024 bucket), its detector built from
   ``flagship_run_config()`` written as YAML over an annotations-only Ego4D
   v2 tree, once at threshold 0 and once at the default 0.4: every CSV row
   and every detection bit for bit against the port's ``make_eval_step``
   on the same transformed batch, K1 / K2 / K5 launches as TOOL_EXPECTED
   predicts, decode / transform / device ms a batch; ``label`` on the
   first CSV against ``label_video`` in this process; one extract batch
   under ``utils.profiling.trace``, whose Chrome trace must name K2's and
   K5's kernels; the native STA matcher built and its mAP of phase 6's
   result JSON equal to the numpy matcher's within 1e-12; whether phase
   6's fit wrote its plot;
14. the fusion levels rematerialised: single-level ``roi_align`` on K5 (a
   [50, 68, 256] bf16 map, 512 RoIs, sampling ratios 0 and 2) against
   ``roi_align_plain``, launched once a call, and refused on 8-byte pixels;
   then the flagship train step (the train slice's input, optimizer and
   freeze rules, token dropout 0.15) with ``flagship_config(remat_fusion=
   True)`` against ``False``, at B 8 and at B 32: a warm-up, then plain /
   remat / remat / plain from the same parameters, batch and (seed, step);
   the loss and every parameter's update remat against plain within twice
   the larger run-to-run gap of a setting (predicted equal), launches a
   step (plain K1 5 / 56, K2 4; remat K1 9 / 88, K2 8; K3, K4 4 and K5, K6
   1 in both), step s and peak GiB of each, and remat's peak below plain's
   at each B.

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

import gc
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
REQUESTS_FO, TRAIN_STEPS_FO = 2, 2  # each fusion-option configuration, after a warm-up
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
# A non-zero index of a rank's first image in a data-parallel global batch:
# the dropout checks of K2-K4 run at it, as a rank past the first does.
OFFSET = 3


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


def time_ln_shape(torch, shape: dict, g) -> dict:
    """K1 at ``shape`` against its plain version (bf16 3.2e-2, f32 1e-4),
    timed by CUDA-graph replay over inputs cycled past the L2, beside its
    bound, the plain version and, for the plain variant, F.layer_norm."""
    from transfusion_torch.ops import layer_norm as ln

    name = "residual_layer_norm" if shape["residual"] else "layer_norm"
    sets, w, b = ln_inputs(torch, shape, g, ln_copies(shape))
    x, r = sets[0]
    eps = shape.get("eps", 1e-6)
    got = ln.fused_layer_norm(x, w, b, eps, residual=r)
    want = ln.layer_norm_plain(x.contiguous(), w, b, eps, residual=r)
    torch.cuda.synchronize()
    err = max_err(got, want)
    check(f"{name} {shape['label']} [{B * shape['n']}, {shape['d']}] {shape['dtype']}", err,
          3.2e-2 if shape["dtype"] == "bf16" else 1e-4)
    ms = graph_ms(torch, [lambda x=x, r=r: ln.fused_layer_norm(x, w, b, eps, residual=r) for x, r in sets])
    plain = cuda_ms(lambda: ln.layer_norm_plain(x, w, b, eps, residual=r), 5)
    lib = None
    if not shape["residual"]:
        wl, bl = w.to(x.dtype), b.to(x.dtype)
        lib = graph_ms(torch, [lambda x=x: torch.nn.functional.layer_norm(x, (shape["d"],), wl, bl, eps)
                               for x, _ in sets])
    bms, by = bound_ms(ln_bytes(shape), B * shape["n"] * shape["d"] * (9 if shape["residual"] else 8),
                       F32_FLOPS)
    log(f"  {shape['label']}: kernel {ms:.4f} ms, {100.0 * bms / ms:.1f} % of its {bms:.4f} ms bound; "
        f"plain {plain:.4f} ms" + ("" if lib is None else f"; F.layer_norm {lib:.4f} ms"))
    return {**shape, "rows": B * shape["n"], "name": name, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "library_ms": lib, "bound_ms": bms, "bound_by": by,
            "pct_of_bound": 100.0 * bms / ms, "input_sets": len(sets)}


def phase_layer_norm(torch):
    """K1 at every shape of LN_SHAPES against its plain version (bf16 one ulp
    for |y| < 8, 3.2e-2; f32 1e-4), timed on the card (CUDA-graph replays,
    inputs cycled past the L2) beside its bound, the plain version and, for
    the plain variant, F.layer_norm. The kernel rows of the JSON line are the
    level-0 shapes (the final norm through its view, as the model runs it)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    shapes, errs = [], {"layer_norm": 0.0, "residual_layer_norm": 0.0}
    for shape in LN_SHAPES:
        rec = time_ln_shape(torch, shape, g)
        errs[rec["name"]] = max(errs[rec["name"]], rec["max_abs_err"])
        shapes.append(rec)
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
    """K2 with probability dropout at rate 0.15, its images at the global
    batch offset OFFSET: its output against the plain version, and its keep
    mask bit for bit over every (cell, query, key) of level 0. With q = k =
    0 every probability is 1 / N before dropout, so a one-hot V over a
    window of 224 keys reads those keys' keep bits out of the output; 14
    windows cover the 3136 keys. A rank's launch on the global batch's last
    half (offset B / 2) gives that half of the whole batch's output bit for
    bit."""
    from transfusion_torch.ops import attention as at

    q, k, v, mask, g = _attention_inputs(torch, 4)
    seed = -1234567
    log(f"[attention_fwd_dropout] q/k/v [{B}, {N0}, {HEADS}, {HEAD_DIM}] bf16, rate {DROPOUT}, "
        f"batch offset {OFFSET}")
    got = at.attention_fwd(q, k, v, mask, DROPOUT, seed, batch_offset=OFFSET)
    want, _ = at.attention_plain(q, k, v, mask, DROPOUT, seed, OFFSET)
    torch.cuda.synchronize()
    err = max_err(got, want)
    scale = float(want.float().abs().max())
    check("attention dropout bf16 output", err, 2 * bf16_ulp(scale))
    mean_rel = float((got.float() - want.float()).abs().mean() / want.float().abs().mean())
    check("attention dropout bf16 output", mean_rel, 2.0 ** -7, "mean|kernel - plain| / mean|plain|")
    del want
    whole = at.attention_fwd(q, k, v, mask, DROPOUT, seed)
    half = at.attention_fwd(q[B // 2:], k[B // 2:], v[B // 2:], mask[B // 2:], DROPOUT, seed,
                            batch_offset=B // 2)
    check("attention dropout, the last half at its offset", float((half != whole[B // 2:]).sum()),
          0.0, "elements differing from the whole batch's")
    del whole, half
    keep = at.dropout_keep_mask(B, HEADS, N0, seed, DROPOUT, "cuda", batch_offset=OFFSET)
    zeros = torch.zeros(B, N0, HEADS, HEAD_DIM, dtype=torch.bfloat16, device="cuda")
    eye = torch.eye(HEAD_DIM, dtype=torch.bfloat16, device="cuda")
    mismatches = 0
    for w0 in range(0, N0, HEAD_DIM):
        vw = torch.zeros_like(zeros)
        vw[:, w0:w0 + HEAD_DIM] = eye[None, :, None, :]
        bits = at.attention_fwd(zeros, zeros, vw, None, DROPOUT, seed,
                                batch_offset=OFFSET) > 0                         # [B, N, H, 224]
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
    """K3 (dQ) and K4 (dK, dV) at rate 0.15 (at the batch offset OFFSET) and
    at rate 0 against the plain backward from the same forward output and
    statistics. The backward
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
        off = OFFSET if rate else 0
        log(f"[attention_bwd] q/k/v/o/dO [{B}, {N0}, {HEADS}, {HEAD_DIM}] bf16, rate {rate}, "
            f"batch offset {off}")
        out, stats = at.attention_fwd(q, k, v, mask, rate, seed, return_stats=True, batch_offset=off)
        got = at.attention_bwd(q, k, v, out, stats, dout, mask, rate, seed, off)
        again = at.attention_bwd(q, k, v, out, stats, dout, mask, rate, seed, off)
        want = at.attention_bwd_plain(q, k, v, out, stats, dout, mask, rate, seed, off)
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


def trainer_data(np, seed: int = 0, hw=None, n_train: int | None = None,
                 n_val: int | None = None, lang: int | None = None):
    """A TrainerData of synthetic examples in the v2 label space (87 nouns +
    background, 74 verbs + background), 1-2 GT boxes an image: ``n_train``
    and ``n_val`` examples at ``hw`` (default: the trainer phase's), with
    ``lang`` tokens."""
    from transfusion_torch.data.tokenizer import hash_vocab_tokenizer
    from transfusion_torch.data.transforms import AugConfig
    from transfusion_torch.runner.trainer import TrainerData
    from transfusion_torch.train.losses import build_class_weights

    h, w = hw or (H, W)
    rng = np.random.default_rng(seed)
    nouns = {f"noun{i}": i + 1 for i in range(87)}
    verbs = {f"verb{i}": i for i in range(74)}
    noun_names, verb_names = list(nouns), list(verbs)

    def example(uid):
        g = int(rng.integers(1, 3))
        xy = rng.uniform(0, 0.7, (g, 2)) * [w, h]
        wh = rng.uniform(0.06, 0.3, (g, 2)) * [w, h]
        n = rng.integers(0, 87, g)
        v = rng.integers(0, 74, g)
        return {"image": rng.normal(0, 0.7, (h, w, 3)).astype(np.float32),
                "boxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
                "nouns": (n + 1).astype(np.int32), "verbs": v.astype(np.int32),
                "ttcs": np.full(g, rng.uniform(0.3, 1.8), np.float32), "id": uid,
                "orig_shape": (h, w),
                "narration": " and ".join(f"{verb_names[a]} {noun_names[b]}" for a, b in zip(v, n))}

    aug = AugConfig(resize_spec=((h,), (w,)), crop_spec=(1, 1), flip=False)
    train = MemoryDataset([example(f"train_{i:04d}") for i in range(n_train or TRAINER_TRAIN)],
                          aug, 88, 75)
    val = MemoryDataset([example(f"val_{i:04d}") for i in range(n_val or TRAINER_VAL)], aug, 88, 75)
    noun_w, verb_w = build_class_weights(np.ones(88), np.ones(74), 1, True, False)
    freqs = ((rng.uniform(0, 1, (88, 75)) > 0.7) * rng.integers(1, 50, (88, 75))).astype(np.float32)
    return TrainerData(train, val, val, nouns, verbs, noun_w, verb_w, freqs, aug,
                       hash_vocab_tokenizer(max_length=lang or TRAINER_LANG))


def check_ln_shapes(torch, g, shapes, tag: str) -> None:
    """K1 at each of ``shapes`` (as LN_SHAPES states them) against its plain
    version (bf16 3.2e-2, f32 1e-4), and ``layer_norm``'s backward (K1
    forward, closed-form gradient) against autograd through the plain
    version."""
    from transfusion_torch.ops import layer_norm as ln

    for shape in shapes:
        sets, w, b = ln_inputs(torch, shape, g)
        x, r = sets[0]
        eps = shape.get("eps", 1e-6)
        err = max_err(ln.fused_layer_norm(x, w, b, eps, residual=r),
                      ln.layer_norm_plain(x.contiguous(), w, b, eps, residual=r))
        label = (f"{'residual_' if r is not None else ''}layer_norm "
                 f"[{B} x {shape['n']}{' of ' + str(shape['view']) if 'view' in shape else ''}, "
                 f"{shape['d']}] {shape['dtype']}")
        check(f"[{tag}] {label}", err, 3.2e-2 if shape["dtype"] == "bf16" else 1e-4)
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
            check(f"[{tag}] {label} {name}", rel,
                  2 ** -7 if name in ("dx", "dresidual") and shape["dtype"] == "bf16" else 1e-4,
                  "max|layer_norm - plain autograd| / max|plain|")


def check_trainer_shapes(torch):
    """K1-K4 at the trainer's shapes, which 128 narration tokens make other
    than the eval and train slices' (level 0 3,200 tokens, levels 1-3 896,
    MiniLM 128), against their plain versions with the kernel phases'
    tolerances."""
    g = torch.Generator(device="cuda").manual_seed(9)
    n0, n1 = 3072 + TRAINER_LANG, 768 + TRAINER_LANG
    check_ln_shapes(torch, g, (
        {"n": n0, "d": 896, "dtype": "bf16", "residual": True},
        {"n": 3072, "view": n0, "d": 896, "dtype": "bf16", "residual": False},
        {"n": n1, "d": 896, "dtype": "bf16", "residual": True},
        {"n": 768, "view": n1, "d": 896, "dtype": "bf16", "residual": False},
        {"n": TRAINER_LANG, "d": 384, "dtype": "bf16", "residual": True, "eps": 1e-12},
        {"n": TRAINER_LANG, "d": 384, "dtype": "f32", "residual": False, "eps": 1e-12}),
        "trainer shapes")
    check_attention_shapes(torch, g, n0, 50, "trainer shapes")


def check_attention_shapes(torch, g, n0: int, pad: int, tag: str) -> None:
    """K2 at rates 0 and DROPOUT, and K3/K4 at DROPOUT, over [B, n0, HEADS,
    HEAD_DIM] bf16 with the last ``pad`` keys of half the batch padded,
    against their plain versions: 2 bf16 ulps of the largest output entry
    (4 for the gradients) and a mean relative error under 2^-7."""
    from transfusion_torch.ops import attention as at

    q, k, v, dout = (torch.randn(B, n0, HEADS, HEAD_DIM, device="cuda", generator=g).to(torch.bfloat16)
                     for _ in range(4))
    mask = torch.zeros(B, n0, dtype=torch.bool, device="cuda")
    if pad:
        mask[: B // 2, -pad:] = True
    for rate in (0.0, DROPOUT):
        out, stats = at.attention_fwd(q, k, v, mask, rate, 77, return_stats=True)
        pairs = [("output", out, at.attention_plain(q, k, v, mask, rate, 77)[0], 2)]
        if rate:
            grads = zip(("dq", "dk", "dv"), at.attention_bwd(q, k, v, out, stats, dout, mask, rate, 77),
                        at.attention_bwd_plain(q, k, v, out, stats, dout, mask, rate, 77))
            pairs += [(name, a, b_, 4) for name, a, b_ in grads]
        for name, a, b_, ulps in pairs:
            check(f"[{tag}] attention bf16 {name} [{B}, {n0}, {HEADS}, {HEAD_DIM}] rate {rate}",
                  max_err(a, b_), ulps * bf16_ulp(float(b_.float().abs().max())))
            check(f"[{tag}] attention bf16 {name} rate {rate}",
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


# The fusion-options phase: five configurations of the egonao model, each
# the flagship run config (full width and depth) with the changes below,
# mapped by build_transfusion_config. LM_ARGS are the JAX CLI's lm_args.
LM_ARGS = {"pooling": {"type": "mean", "ln": True, "repr_size": 0}, "multi": False, "use_lm_f": True}
LM_CRITERION = {"lm": 1, "lm_decay": 0.8}
FUSION_OPTIONS = {
    "lm": {"criterion": LM_CRITERION, "narr_fusion": {"lm_args": LM_ARGS}},
    "shared_sum_sep": {"criterion": LM_CRITERION, "narr_fusion": {
        "share_encoders": True, "forward_language_f": "sum", "pos_embedding": "learned",
        "lm_args": {**LM_ARGS, "multi": "sep", "use_lm_f": False}}},
    "asymmetric": {"criterion": LM_CRITERION, "narr_fusion": {
        "type": "asymmetric", "args": {"lang_layers": 2},
        "lm_args": {**LM_ARGS, "multi": True, "use_lm_f": False}}},
    "space_time": {"narr_fusion": {"type": "space_time", "args": {"activ_f": "relu", "final_norm": "ln"}}},
    "vis_lang": {"narration_embeds": {"slowfast_f_v": True},
                 "narr_fusion": {"narr_out_mode": "embedding", "forward_language_f": "direct"}},
}
CLIP_SHAPE = (B, 6, 2304)  # SlowFast clip features a sample


def _launches(ln: int, res: int, k2: bool, step: bool) -> dict:
    """Kernel launches a forward (``step`` False) or a train step: K1 plain
    ``ln`` and residual ``res`` times; K2 4 times (level 0's four layers)
    where ``k2``, with dropout and K3/K4 in a step; K5 once, K6 once a step."""
    out = {"layer_norm": ln, "residual_layer_norm": res, "roi_align_fwd": 1,
           "attention_fwd": 4 if k2 and not step else 0}
    if step:
        out.update(attention_fwd_dropout=4 * k2, attention_bwd_dq=4 * k2, attention_bwd_dkv=4 * k2,
                   roi_align_bwd=1)
    return out


# Predicted per configuration (PERF.md §4): MiniLM runs K1 1 + 24 times; the
# LM head's norm once a call, and once a level under multi / sep; the
# cross-transformer levels 4 final norms and 4 x 4 x 2 residual norms (the
# shared stack the same 16 layer calls); the asymmetric levels 4 x (4 + 2)
# QKV layers x 2 residual norms and no final norm; the space-time levels 4
# x 4 layers x (spatial + temporal) x 2 residual norms and 4 final norms;
# clip fusion 4 x 2 layers x 2 more. Only cross-transformer layers at level
# 0 (3,136 or 3,073 tokens, global mask) pass K2's gate.
EXPECTED_FUSION_OPTIONS = {
    "lm": (6, 56, True), "shared_sum_sep": (9, 56, True), "asymmetric": (5, 72, False),
    "space_time": (5, 88, False), "vis_lang": (5, 72, True)}
# K1 at the shapes the five configurations add: the LM head's norm (8 rows),
# the QKV layers' language (64 tokens) and visual norms (the first layer
# pair's norm1 in f32: bf16 tokens plus an f32 kind embedding, summed and
# normalised in f32 as flax's LayerNorm does), the space-time layers (the
# patch grid, no language; the final norm plain, of an f32 stream), and the
# clip fusion (3,072 + 6 tokens) with its level (3,072 + 1 tokens, final
# norm through its view), at level 0 and at levels 1-3 (768 patches).
FUSION_OPTION_LN_SHAPES = (
    {"n": 1, "d": 896, "dtype": "bf16", "residual": False},
    {"n": LANG_LEN, "d": 896, "dtype": "bf16", "residual": True},
    {"n": LANG_LEN, "d": 896, "dtype": "f32", "residual": True},
    {"n": 3072, "d": 896, "dtype": "bf16", "residual": True},
    {"n": 3072, "d": 896, "dtype": "f32", "residual": True},
    {"n": 3072, "d": 896, "dtype": "f32", "residual": False},
    {"n": 768, "d": 896, "dtype": "bf16", "residual": True},
    {"n": 768, "d": 896, "dtype": "f32", "residual": True},
    {"n": 768, "d": 896, "dtype": "f32", "residual": False},
    {"n": 3078, "d": 896, "dtype": "bf16", "residual": True},
    {"n": 3073, "d": 896, "dtype": "bf16", "residual": True},
    {"n": 3072, "view": 3073, "d": 896, "dtype": "bf16", "residual": False},
    {"n": 774, "d": 896, "dtype": "bf16", "residual": True},
    {"n": 769, "d": 896, "dtype": "bf16", "residual": True},
    {"n": 768, "view": 769, "d": 896, "dtype": "bf16", "residual": False},
)
# A parameter upstream of each configuration's new layers, whose gradient
# must not be zero after a step.
UPSTREAM = {
    "lm": "cross_fusion_encoders.0.t_encoder.layers.0.self_attn.in_proj_weight",
    "shared_sum_sep": "shared_t_encoder.layers.0.self_attn.in_proj_weight",
    "asymmetric": "cross_fusion_encoders.0.vis_layers.0.q_proj.weight",
    "space_time": "cross_fusion_encoders.0.encoder.layers.0.spatial.self_attn.in_proj_weight",
    "vis_lang": "vis_fusion.0.proj.weight",
}


def fusion_option_run_config(name: str) -> dict:
    cfg = flagship_run_config()
    run = cfg["run"]
    for key, changes in FUSION_OPTIONS[name].items():
        node = run[key]
        for k, v in changes.items():
            if k == "args":
                node["args"].update(v)
            else:
                node[k] = v
    return cfg


def fusion_option_batch(torch, np) -> dict:
    """The phase's batch on the card: B images at H x W, LANG_LEN tokens
    (the last quarter padded in half the images), clip features
    CLIP_SHAPE, one GT box an image."""
    rng = np.random.default_rng(1)
    dev = "cuda"
    mask = torch.ones(B, LANG_LEN, dtype=torch.int64, device=dev)
    mask[: B // 2, 3 * LANG_LEN // 4:] = 0
    return {
        "image": torch.from_numpy(rng.normal(0, 0.7, (B, H, W, 3)).astype(np.float32)).to(dev),
        "input_ids": torch.from_numpy(rng.integers(0, 30000, (B, LANG_LEN))).to(dev),
        "attention_mask": mask, "image_hw": (H, W),
        "visual_features": torch.from_numpy(rng.normal(0, 1, CLIP_SHAPE).astype(np.float32)).to(dev),
        "targets": {"boxes": torch.tensor([[[100.0, 100.0, 400.0, 400.0]]], device=dev).repeat(B, 1, 1),
                    "nouns": torch.full((B, 1), 2, device=dev), "verbs": torch.full((B, 1), 1, device=dev),
                    "ttcs": torch.full((B, 1), 0.9, device=dev),
                    "valid": torch.ones(B, 1, dtype=torch.bool, device=dev)}}


def fusion_option_train_step(torch, model, cfg, run_cfg):
    """The train slice's step for a fusion-option model: RAdam (lr 1e-4,
    wd 1e-5), the epoch-0 freeze, the run config's criterion weights.
    Returns (step, state, loss weights, freeze multipliers)."""
    from transfusion_torch.runner.trainer import unfreeze_multipliers
    from transfusion_torch.train.optim import make_optimizer
    from transfusion_torch.train.step import LossConfig, TrainState, criterion_weights, make_train_step

    nn_, nv = cfg.detector.roi.num_nouns, cfg.detector.roi.num_verbs
    tx, _ = make_optimizer({"name": "radam", "lr": 1e-4, "weight_decay": 1e-5}, None, 100)
    state = TrainState(step=0, opt_state=tx.init(dict(model.named_parameters())))
    mult = unfreeze_multipliers(model.named_parameters(), 0, run_cfg["model"], -1, 1,
                                cfg.bert.num_layers)
    step = make_train_step(model, tx, LossConfig(lm_on=cfg.lm_on, rpn_batch_size_per_image=256,
                                                 last_noun_idx=nn_ - 1),
                           torch.ones(nn_), torch.ones(nv))
    return step, state, criterion_weights({**run_cfg["run"]["criterion"]}, 0), mult


def drive_config(torch, np, name: str, model, cfg, run_cfg, batch, want: tuple, watched, smi: str,
                 build_s: float = 0.0, held: float = 0.0, frozen=()):
    """One configuration's model at flagship width: an eval request
    (warm-up, then REQUESTS_FO timed) and the train slice's step (RAdam,
    the run config's epoch-0 freeze; warm-up, then TRAIN_STEPS_FO timed),
    with launch counts against ``want`` (``_launches``' arguments), finite
    detections and losses, non-zero gradients on ``watched`` and on the LM
    heads, and ``frozen`` parameters that no step moved. Returns its record."""
    from transfusion_torch.kernels import LAUNCHES
    from transfusion_torch.models.detector import detections_from_outputs

    nn_ = cfg.detector.roi.num_nouns
    torch.cuda.reset_peak_memory_stats()

    def request():
        with torch.inference_mode():
            out = model(batch)
            return out, detections_from_outputs(out, cfg.detector)

    request()
    torch.cuda.synchronize()
    LAUNCHES.clear()
    eval_s = []
    for _ in range(REQUESTS_FO):
        t0 = time.perf_counter()
        out, dets = request()
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t0)
    per_forward = {k: v / REQUESTS_FO for k, v in LAUNCHES.items()}
    if not all(torch.isfinite(dets[k]).all() for k in ("boxes", "scores", "ttcs")):
        raise AssertionError(f"[{name}] non-finite detections")
    if cfg.lm_on and tuple(out["lm"]["noun_logits"].shape) != (B, nn_ - 1):
        raise AssertionError(f"[{name}] LM logits {tuple(out['lm']['noun_logits'].shape)}")
    del out, dets

    step, state, lw, mult = fusion_option_train_step(torch, model, cfg, run_cfg)
    params = dict(model.named_parameters())
    before = {n: params[n].detach().clone() for n in frozen}
    step(state, batch, lw, mult)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    step_s, metrics = [], []
    for _ in range(TRAIN_STEPS_FO):
        t0 = time.perf_counter()
        m = step(state, batch, lw, mult)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    per_step = {k: v / TRAIN_STEPS_FO for k, v in LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for m in metrics:
        if not all(math.isfinite(v) for v in m.values()) or m["nonfinite_skipped"] != 0.0:
            raise AssertionError(f"[{name}] a train step went non-finite or was skipped: {m}")
        if cfg.lm_on and not m["lm_loss"] > 0.0:
            raise AssertionError(f"[{name}] lm loss {m['lm_loss']}")
    watched = list(watched) + [n for n in params if n.startswith("lm_layer") and n.endswith(
        "mlp_noun.weight")]
    grads = {n: float(params[n].grad.float().norm()) for n in watched}
    if not all(v > 0.0 for v in grads.values()):
        raise AssertionError(f"[{name}] zero gradient: {grads}")
    moved = [n for n in frozen if not torch.equal(params[n].detach(), before[n])]
    if moved or any(mult[n] for n in frozen):
        raise AssertionError(f"[{name}] frozen parameters moved: {moved[:5]}")
    want_fwd, want_step = _launches(*want, step=False), _launches(*want, step=True)
    got_fwd = {k: per_forward.get(k, 0) for k in want_fwd}
    got_step = {k: per_step.get(k, 0) for k in want_step}
    log(f"[{name}] built in {build_s:.1f} s "
        f"({sum(p.numel() for p in params.values()) / 1e6:.1f} M params); launches a forward "
        f"{got_fwd}, a step {got_step}")
    log(f"  eval s {[round(t, 4) for t in eval_s]}, step s {[round(t, 4) for t in step_s]}, "
        f"peak {peak:.2f} GiB ({held:.2f} GiB held before the build; {smi}); losses "
        f"{[round(m['loss'], 4) for m in metrics]}, lm {[round(m['lm_loss'], 4) for m in metrics]}; "
        f"|grad| {json.dumps(grads)}; {len(frozen)} frozen tensors unmoved")
    if got_fwd != want_fwd or got_step != want_step:
        raise AssertionError(f"[{name}] launches differ from the prediction: forward {want_fwd}, "
                             f"step {want_step}")
    return {"eval_s": eval_s, "step_s": step_s, "peak_gib": peak, "held_gib": held, "build_s": build_s,
            "launches_forward": per_forward, "launches_step": per_step, "metrics": metrics,
            "grad_norms": grads, "frozen_unmoved": len(frozen), "card": smi}


def phase_fusion_options(torch, np, smi: str):
    """Each of the five configurations at flagship width and depth: built
    from its run config through build_transfusion_config, seeded weights,
    then ``drive_config``: an eval request and the train slice's step, with
    launch counts, finite losses, and non-zero gradients on the LM head and
    upstream of the new layers."""
    from transfusion_torch.models.transfusion import TransFusion, build_transfusion_config
    from transfusion_torch.weights import init_random_

    g = torch.Generator(device="cuda").manual_seed(10)
    check_ln_shapes(torch, g, FUSION_OPTION_LN_SHAPES, "fusion-option shapes")
    # vis_lang's level 0: 3,072 patches and the one embedding-mode token, no
    # key padded; 48 full 64-row tiles and a tail of one row.
    check_attention_shapes(torch, g, 3073, 0, "fusion-option shapes")
    torch.cuda.empty_cache()
    dev = "cuda"
    batch = fusion_option_batch(torch, np)
    records = {}
    for name in FUSION_OPTIONS:
        gc.collect()  # earlier phases' models may sit in reference cycles until collected
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() / 2 ** 30
        run_cfg = fusion_option_run_config(name)
        t0 = time.perf_counter()
        cfg = build_transfusion_config(run_cfg, 88, 75, dtype=torch.bfloat16)
        model = init_random_(TransFusion(cfg, device=dev), seed=0)
        build_s = time.perf_counter() - t0
        records[name] = drive_config(torch, np, f"fusion options: {name}", model, cfg, run_cfg, batch,
                                     EXPECTED_FUSION_OPTIONS[name], [UPSTREAM[name]], smi, build_s, held)
        del model
        torch.cuda.empty_cache()
    return records


# Phase 8: the narration towers and the transformer TTC head, each
# flagship_run_config() with one change ((section, key, ...) -> value).
TOWER_OPTIONS = {
    "gpt2": {("run", "narration_embeds", "args", "model_v"): "distilgpt2"},
    "flan_t5_large": {("run", "narration_embeds", "args", "model_v"): "flan-t5-large"},
    "ttc_hand": {("run", "criterion", "ttc"): 1,
                 ("model", "ttc_hand_head"): {"use": True, "feat_dim": 1024, "num_layers": 4, "num_heads": 4,
                                              "max_ttc_boxes_per_image": 5},
                 ("run", "hand_args"): {"use": True, "num_steps": 5}},
}
# Predicted launches a forward and a step (PERF.md §4): distilgpt2's 13
# LayerNorms (12 + ln_f, plain) beside the fusion's 4 + 32; flan-t5's
# RMSNorms are not LayerNorms; the TTC head's 4 layers x 2 residual norms
# over B x 5 detections x 56 tokens beside the flagship's 5 + 56.
EXPECTED_TOWERS = {"gpt2": (17, 32, True), "flan_t5_large": (4, 32, True), "ttc_hand": (5, 64, True)}
TTC_BOXES, TTC_TOKENS = 5, 56  # CLS, object feature, 4 object-box, 40 hand-box, 10 hand-pose tokens
HAND_STEPS = 5
# K1 at the shapes the phase adds: distilgpt2's norms (B x 64 rows x 768,
# eps 1e-5), and the TTC head's residual norms (B x 5 x 56 = 2,240 rows x
# 1024; 2,280, a 57-token sequence, too); bf16 as the path runs them, and
# f32.
TOWER_LN_SHAPES = tuple(
    {**shape, "dtype": dt, "label": f"{shape['label']} {dt}"}
    for shape in ({"label": "GPT-2 norms", "n": LANG_LEN, "d": 768, "residual": False, "eps": 1e-5},
                  {"label": "TTC head norm1/norm2", "n": TTC_BOXES * TTC_TOKENS, "d": 1024, "residual": True},
                  {"label": "residual 2,280 x 1024", "n": 285, "d": 1024, "residual": True})
    for dt in ("bf16", "f32"))
NARRATION_WORDS = ("take", "knife", "cut", "onion", "wash", "the", "pan", "put", "plate", "on", "table",
                   "open", "drawer", "and", "then")


def tower_run_config(name: str) -> dict:
    cfg = flagship_run_config()
    for path, value in TOWER_OPTIONS[name].items():
        node = cfg
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
    return cfg


def tower_batch(torch, np, name: str, tokenizer) -> dict:
    """The fusion-option phase's batch without clip features, its tokens
    from ``tokenizer`` (LANG_LEN, padded) over seeded narrations, and for
    the TTC head a hand history of HAND_STEPS steps (boxes [B, 10, 4],
    poses [B, 10, 63]) from the seed."""
    batch = {k: v for k, v in fusion_option_batch(torch, np).items() if k != "visual_features"}
    rng = np.random.default_rng(2)
    texts = [" ".join(rng.choice(NARRATION_WORDS, int(rng.integers(3, 12)))) for _ in range(B)]
    ids, mask = tokenizer.encode_batch(texts, LANG_LEN)
    batch["input_ids"] = torch.from_numpy(ids).long().cuda()
    batch["attention_mask"] = torch.from_numpy(mask).long().cuda()
    if name == "ttc_hand":
        n = 2 * HAND_STEPS
        batch["hand_boxes"] = torch.from_numpy(np.sort(rng.uniform(0, 1, (B, n, 4)), -1).astype(np.float32)).cuda()
        batch["hand_poses"] = torch.from_numpy(rng.normal(0, 0.5, (B, n, 63)).astype(np.float32)).cuda()
    return batch


def tower_stages(torch, model, cfg, batch) -> dict:
    """Host-clock ms (synchronised) of an eval request's forward, its
    postprocess and the TTC head's pass, mean of 3 after a warm-up."""
    from transfusion_torch.models.detector import detections_from_outputs

    stages: dict = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    model.eval()
    with torch.no_grad():
        for rep in range(4):
            if rep == 1:
                stages.clear()
            out = timed("forward", lambda: model(batch))
            dets = timed("postprocess", lambda: detections_from_outputs(out, cfg.detector))
            if cfg.ttc_hand is not None:
                timed("ttc head pass", lambda: model.predict_ttc(dets, out["roi_outputs"], batch, batch["image_hw"]))
    stages = {k: v / 3 for k, v in stages.items()}
    log(f"  stage ms (synchronised): {json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    return stages


def phase_towers(torch, np, smi: str, profile: bool = False):
    """Phase 8: K1 and its backward at TOWER_LN_SHAPES against the plain
    versions (and timed at each), then the three configurations of
    TOWER_OPTIONS at flagship width and depth through
    build_transfusion_config with seeded weights and the hash-fallback
    tokenizers: an eval request through make_eval_step (the TTC head's
    second pass included) and the train step, each a warm-up and then
    REQUESTS_FO / TRAIN_STEPS_FO timed; launches as EXPECTED_TOWERS, finite
    losses, no skipped step, non-zero gradients upstream of K2-K4 and K6
    and on the tower's out_mlp or the TTC head, a non-zero TTC loss, and a
    step on the TTC loss alone that reaches the head and nothing else.
    ``profile`` adds each configuration's stage times and a profiler trace
    of a request and of a step."""
    from transfusion_torch.kernels import LAUNCHES
    from transfusion_torch.models.transfusion import TransFusion, build_transfusion_config
    from transfusion_torch.runner.trainer import build_tokenizer, tower_depth, unfreeze_multipliers
    from transfusion_torch.train.optim import make_optimizer
    from transfusion_torch.train.step import (LossConfig, TrainState, criterion_weights, make_eval_step,
                                              make_train_step)
    from transfusion_torch.weights import init_random_

    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(11)
    check_ln_shapes(torch, g, TOWER_LN_SHAPES, "tower shapes")
    ln_times = [time_ln_shape(torch, shape, g) for shape in TOWER_LN_SHAPES]
    torch.cuda.empty_cache()
    records = {"layer_norm_shapes": ln_times}
    for name in TOWER_OPTIONS:
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() / 2 ** 30
        run_cfg = tower_run_config(name)
        t0 = time.perf_counter()
        cfg = build_transfusion_config(run_cfg, 88, 75, dtype=torch.bfloat16)
        model = init_random_(TransFusion(cfg, device="cuda"), seed=0)
        build_s = time.perf_counter() - t0
        narr_args = run_cfg["run"]["narration_embeds"]["args"]
        tokenizer = build_tokenizer(narr_args["model_v"], LANG_LEN)
        batch = tower_batch(torch, np, name, tokenizer)
        params = dict(model.named_parameters())
        tower = sum(p.numel() for k, p in params.items()
                    if k.startswith("narr_pooling_layer.encoder.")) / 1e6
        torch.cuda.reset_peak_memory_stats()
        eval_step = make_eval_step(model, cfg.detector)
        eval_step(batch)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        eval_s = []
        for _ in range(REQUESTS_FO):
            t0 = time.perf_counter()
            dets = eval_step(batch)
            torch.cuda.synchronize()
            eval_s.append(time.perf_counter() - t0)
        per_forward = {k: v / REQUESTS_FO for k, v in LAUNCHES.items()}
        if not all(torch.isfinite(dets[k]).all() for k in ("boxes", "scores", "ttcs")):
            raise AssertionError(f"[{name}] non-finite detections")
        if cfg.ttc_hand is not None:
            first = dets["valid"][:, :TTC_BOXES]
            if not first.any() or not (dets["ttcs"][:, :TTC_BOXES][first] >= cfg.detector.roi.min_ttc).all():
                raise AssertionError(f"[{name}] the TTC head's pass left no clamped TTC: {dets['ttcs'][:, :TTC_BOXES]}")

        nn_, nv = cfg.detector.roi.num_nouns, cfg.detector.roi.num_verbs
        tx, _ = make_optimizer({"name": "radam", "lr": 1e-4, "weight_decay": 1e-5}, None, 100)
        state = TrainState(step=0, opt_state=tx.init(params))
        mult = unfreeze_multipliers(model.named_parameters(), 0, run_cfg["model"], -1, 1, tower_depth(cfg),
                                    text_encoder=cfg.text_encoder)
        step = make_train_step(model, tx, LossConfig(ttc_on=cfg.detector.roi.ttc_on,
                                                     rpn_batch_size_per_image=256, last_noun_idx=nn_ - 1),
                               torch.ones(nn_), torch.ones(nv))
        lw = criterion_weights(run_cfg["run"]["criterion"], 0)
        step(state, batch, lw, mult)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        step_s, metrics = [], []
        for _ in range(TRAIN_STEPS_FO):
            t0 = time.perf_counter()
            m = step(state, batch, lw, mult)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
        per_step = {k: v / TRAIN_STEPS_FO for k, v in LAUNCHES.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for m in metrics:
            if not all(math.isfinite(v) for v in m.values()) or m["nonfinite_skipped"] != 0.0:
                raise AssertionError(f"[{name}] a train step went non-finite or was skipped: {m}")
            if cfg.ttc_hand is not None and not m["ttc_loss"] > 0.0:
                raise AssertionError(f"[{name}] ttc loss {m['ttc_loss']}")
        watched = ["cross_fusion_encoders.0.t_encoder.layers.0.self_attn.in_proj_weight",
                   "backbone.fpn.layer_blocks.0.weight"]
        watched += (["ttc_hand_head.layers.0.self_attn.in_proj_weight", "ttc_hand_head.ttc_out.weight"]
                    if cfg.ttc_hand is not None else ["narr_pooling_layer.out_mlp.weight"])
        grads = {n: float(params[n].grad.float().norm()) for n in watched}
        if not all(v > 0.0 for v in grads.values()):
            raise AssertionError(f"[{name}] zero gradient: {grads}")
        only_head = None
        if cfg.ttc_hand is not None:
            # The TTC loss alone: its gradient reaches the head and no
            # parameter upstream of the detached box features.
            m = step(state, batch, np.array([0, 0, 0, 0, 1, 0], np.float32), mult)
            leaked = [n for n, p in params.items() if not n.startswith("ttc_hand_head.")
                      and p.grad is not None and bool(p.grad.any())]
            head = [n for n, p in params.items() if n.startswith("ttc_hand_head.")
                    and p.grad is not None and bool(p.grad.any())]
            if leaked or not head or not float(m["ttc_loss"]) > 0.0:
                raise AssertionError(f"[{name}] the TTC loss reached {leaked[:5]}, or no head parameter "
                                     f"({len(head)})")
            only_head = {"head_tensors_with_grad": len(head), "ttc_loss": float(m["ttc_loss"])}
        want_fwd = _launches(*EXPECTED_TOWERS[name], step=False)
        want_step = _launches(*EXPECTED_TOWERS[name], step=True)
        got_fwd = {k: per_forward.get(k, 0) for k in want_fwd}
        got_step = {k: per_step.get(k, 0) for k in want_step}
        log(f"[towers: {name}] built in {build_s:.1f} s ({sum(p.numel() for p in params.values()) / 1e6:.1f} M "
            f"params, tower {tower:.1f} M); launches a forward {got_fwd}, a step {got_step}")
        log(f"  eval s {[round(t, 4) for t in eval_s]}, step s {[round(t, 4) for t in step_s]}, "
            f"peak {peak:.2f} GiB ({held:.2f} GiB held before the build; {smi}); losses "
            f"{[round(m['loss'], 4) for m in metrics]}, ttc {[round(m['ttc_loss'], 4) for m in metrics]}; "
            f"|grad| {json.dumps(grads)}" + ("" if only_head is None else f"; TTC loss alone {only_head}"))
        if got_fwd != want_fwd or got_step != want_step:
            raise AssertionError(f"[{name}] launches differ from the prediction: forward {want_fwd}, "
                                 f"step {want_step}")
        records[name] = {"eval_s": eval_s, "step_s": step_s, "peak_gib": peak, "held_gib": held,
                         "build_s": build_s, "tower_mparams": tower, "launches_forward": per_forward,
                         "launches_step": per_step, "metrics": metrics, "grad_norms": grads,
                         "ttc_loss_alone": only_head, "card": smi}
        if profile:
            records[name]["profile"] = {
                "stage_ms": tower_stages(torch, model, cfg, batch),
                "request": _trace(torch, f"{name} request", lambda: eval_step(batch)),
                "step": _trace(torch, f"{name} train step", lambda: step(state, batch, lw, mult))}
        del model, state, step, params, m, metrics, eval_step, dets, batch
        torch.cuda.empty_cache()
    records["wall_s"] = time.perf_counter() - t_phase
    log(f"[towers] phase wall time {records['wall_s']:.1f} s")
    return records


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
                feats[str(lvl)], lang, lang_mask, model.patches_to_token[i], model.tokens_to_features[i])[0])
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
    # Host operators by their own CPU time (the launch and dispatch work).
    host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    log("  host, self CPU ms: " + ", ".join(f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.2f} (x{e.count})"
                                           for e in host))
    return {f"profiled_{what.replace(' ', '_')}_ms": wall_ms, "device_busy_ms": busy_ms,
            "top_kernels_ms": {e.key: e.self_device_time_total / 1e3 for e in top},
            "top_host_ms": {e.key: e.self_cpu_time_total / 1e3 for e in host}}


# ------------------------------------------ phase 9: data parallel, trainable BN
# flagship_run_config() with trainable BatchNorm (momentum 0.1) and the whole
# trunk training from epoch 0 (train_ep 0, trainable_layers 5: no tape cut,
# so every BatchNorm's backward runs), on DP_TRAIN / DP_VAL in-memory
# examples: 2 train steps and 1 validation batch of B 8 global.
DP_TRAIN, DP_VAL = 16, 8
PATH_KERNELS = ("layer_norm", "residual_layer_norm", "attention_fwd", "attention_fwd_dropout",
                "attention_bwd_dq", "attention_bwd_dkv", "roi_align_fwd", "roi_align_bwd")
# A run against the one-rank run (a) from the same initial parameters, in
# bf16: the training loss within 2e-2 relative, the median running average
# within 1e-2 and the median tensor's update within 2.5e-1 in relative L2
# norm; each loss term, the largest tensor's error and the mAP are
# recorded, not held. At B 4 a bf16 product may round otherwise than at
# B 8 (cuDNN picks by shape), which moves RPN proposals of near-tied
# random-weight scores across the sampler and with them a few positive
# RoIs: the box loss term then differs by 6-25 % and its gradient reaches
# every tensor (two card runs read medians of 0.108 and 0.152; the total
# loss 2.7e-4 and 7.8e-4, the running averages 2.7e-4). The f32 CPU tests
# hold the same runs to 1e-4 (tests/test_torch_parallel.py).
DP_TOL = {"loss": 2e-2, "update": 2.5e-1, "stats": 1e-2}
# (c) once more in f32 (TF32 off) at B 2 global, flagship width: one rank of
# B 2 against two ranks of B 1, 1 step and 1 validation batch. Held to
# DP_TOL as (c) is; beside it the f32 CPU tests' 1e-4 and the noise floor:
# one rank against itself with the stem convolution scaled by 1 + PERTURB, a
# few ulps (perturb_). At random weights the training trunk turns a change
# of that size into the same gap as two ranks (flax's variance E[x^2] -
# mean^2 of unnormalised activations, then near-tied objectness reordering
# the proposals), so the two-rank run is read against the floor and not
# against the tiny CPU model's 1e-4. Phase 10 reads its f32 run the same
# way, perturbing the fusion, where the model axis splits the arithmetic.
DP_F32_B, DP_F32_TRAIN, DP_F32_VAL = 2, 2, 2
F32_TOL = 1e-4
PERTURB = 1e-6


def perturb_(torch, model, eps: float, where: str) -> list:
    """Scale the weights where a run's split enters by 1 + eps in place (the
    noise-floor runs): the stem convolution for the data axis (its sums
    reach every BatchNorm of the training trunk), the fusion layers' MLP
    up-projections (``linear1``) for the model axis. Returns their names,
    which the floor's statistics leave out."""
    stem = where == "stem"
    names = [k for k in dict(model.named_parameters())
             if (k == "backbone.body.conv1.weight" if stem
                 else ".t_encoder.layers." in k and k.endswith("linear1.weight"))] if eps else []
    with torch.no_grad():
        for k, p in model.named_parameters():
            if k in names:
                p.mul_(1 + eps)
    return names


def dp_run_config(fsdp: bool = False, precision: int = 16, batch: int | None = None) -> dict:
    cfg = flagship_run_config()
    cfg["model"].update(train_ep=0, trainable_layers=5, batch_norm={"use": True, "momentum": 0.1})
    cfg["run"].update(fsdp=fsdp, precision=precision)
    if batch:
        cfg["run"].update(train_bs=batch, val_bs=batch)
    return cfg


class f32_exact:
    """f32 products in f32: TF32 off for cuDNN and cuBLAS inside the block;
    with ``deterministic`` also cuDNN's deterministic algorithms."""

    def __init__(self, torch, deterministic: bool = False):
        self.torch, self.deterministic = torch, deterministic

    def __enter__(self):
        b = self.torch.backends
        self.saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic)
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
        b.cudnn.deterministic = self.deterministic or b.cudnn.deterministic

    def __exit__(self, *exc):
        b = self.torch.backends
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic = self.saved


def dp_fit(torch, np, run_dir: str, fsdp: bool = False, bn_calls: list | None = None,
           precision: int = 16, batch: int | None = None, n_train: int | None = None,
           n_val: int | None = None, perturb: float = 0.0) -> dict:
    """fit(1) of dp_run_config() with its launches, step times and peak
    memory; ``bn_calls`` collects the trainable BatchNorms' input shapes of
    the first train step."""
    import shutil

    from transfusion_torch.kernels import LAUNCHES
    from transfusion_torch.ops.batch_norm import BatchNorm
    from transfusion_torch.runner.trainer import EgoNaoTrainer

    shutil.rmtree(run_dir, ignore_errors=True)
    trainer = EgoNaoTrainer(dp_run_config(fsdp, precision, batch), run_dir,
                            data=trainer_data(np, n_train=n_train or DP_TRAIN, n_val=n_val or DP_VAL))
    trainer.ensure_state()
    perturbed = perturb_(torch, trainer.model, perturb, "stem")
    init = {k: v.detach().to("cpu", copy=True) for k, v in trainer.model.named_parameters()}
    hooks = []
    if bn_calls is not None:
        norms = [m for m in trainer.model.modules() if isinstance(m, BatchNorm)]

        def grab(mod, args):
            if mod.training and len(bn_calls) < len(norms):  # the first train step's
                bn_calls.append((tuple(args[0].shape), args[0].dtype))
        hooks = [m.register_forward_pre_hook(grab) for m in norms]
    counts: dict = {}
    train_s: list = []
    val_s: list = []
    trainer.train_step = _counted(torch, trainer.train_step, "train", counts, train_s)
    trainer.eval_loss_step = _counted(torch, trainer.eval_loss_step, "val", counts, val_s)
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    rec = trainer.fit(1)[0]
    launches = dict(LAUNCHES)
    for h in hooks:
        h.remove()
    missing = [k for k in PATH_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"the data-parallel path launched no {missing}")
    if rec["train_nonfinite_skipped"] != 0.0 or not all(
            math.isfinite(v) for k, v in rec.items() if k.endswith("loss")):
        raise AssertionError(f"non-finite loss or a skipped step: {rec}")
    path = os.path.join(run_dir, "results", "val_epoch0.json")
    results = json.load(open(path))["results"] if os.path.isfile(path) else None
    return {"trainer": trainer, "history": rec, "init": init, "launches": launches,
            "perturbed": perturbed,
            "per_step": {k: v / len(train_s) for k, v in counts["train"].items()},
            "train_s": train_s, "val_s": val_s, "results": results,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def dp_state(trainer) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in trainer.model.state_dict().items()}


def dp_compare(np, ref: dict, got: dict, init: dict, tag: str, trained_only: bool = False,
               skip=()) -> dict:
    """One run (``got``: history, state) against the one-rank run ``ref``
    from the same initial parameters ``init``, held to DP_TOL;
    ``trained_only`` leaves the tensors ``ref`` did not move (frozen), and
    ``skip`` names, out of the update statistics."""
    hist, want = got["history"], ref["history"]
    terms = {k: abs(hist[k] - v) / max(abs(v), 1e-12) for k, v in want.items()
             if k.startswith("train_") and k.endswith("loss")}

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))

    named = sorted((rel(got["state"][k] - init[k], ref["state"][k] - init[k]), k) for k in init
                   if k not in skip
                   and (not trained_only or not bool((ref["state"][k] == init[k]).all())))
    upd = [e for e, _ in named]
    stats = sorted(rel(got["state"][k], v) for k, v in ref["state"].items()
                   if k.endswith(("running_mean", "running_var")))
    out = {"loss_rel": terms["train_loss"], "loss_terms_rel": terms,
           "update_rel_l2_median": float(np.median(upd)), "update_rel_l2_max": upd[-1],
           "stats_rel_l2_median": float(np.median(stats)), "stats_rel_l2_max": stats[-1],
           "map_abs": max(abs(hist[k] - v) for k, v in want.items() if k.endswith("_val")),
           "update_worst": [(k, e) for e, k in named[-5:]]}
    log(f"  [{tag}] against one rank: {json.dumps(out)}")
    return out


def dp_hold(out: dict, tag: str) -> None:
    """A comparison of dp_compare held to DP_TOL."""
    check(f"[{tag}] training loss", out["loss_rel"], DP_TOL["loss"], "relative error")
    check(f"[{tag}] parameter updates", out["update_rel_l2_median"], DP_TOL["update"],
          "median relative L2 error")
    check(f"[{tag}] running averages", out["stats_rel_l2_median"], DP_TOL["stats"],
          "median relative L2 error")


def check_batch_norm(torch, calls: list) -> dict:
    """The trainable BatchNorm (batch_norm.BatchNormFunction and the running
    average update) against autograd through its plain formula at each
    distinct shape the train step gives it, in its dtype: outputs and dx
    within two ulps of the dtype at the largest magnitude, the statistics,
    dscale and dbias within 1e-4 relative (f32 sums in another order); then
    every call of a step timed, forward and backward, against the plain
    version."""
    from transfusion_torch.ops.batch_norm import BatchNorm, batch_norm_plain

    g = torch.Generator(device="cuda").manual_seed(9)
    errs: dict = {}
    for shape, dtype in sorted(set(calls), key=str):
        c = shape[1]
        x = (torch.randn(shape, device="cuda", generator=g) * 1.5 + 0.3).to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        cot = torch.randn(shape, device="cuda", generator=g).to(dtype)
        bn = BatchNorm(c, 0.1).to("cuda")
        with torch.no_grad():
            bn.weight.copy_(1 + 0.1 * torch.randn(c, device="cuda", generator=g))
            bn.bias.copy_(0.1 * torch.randn(c, device="cuda", generator=g))
        w, b = (t.detach().clone().requires_grad_() for t in (bn.weight, bn.bias))
        xa, xb = (x.detach().clone().requires_grad_() for _ in range(2))
        y = bn(xa, train=True)
        y.backward(cot)
        want, mean, var = batch_norm_plain(xb, w, b)
        want.backward(cot)
        ulp = 2 ** -7 if dtype == torch.bfloat16 else 2 ** -23
        label = f"batch_norm {list(shape)} {str(dtype).split('.')[-1]}"
        pairs = [("output", y, want, 2 * ulp), ("dx", xa.grad, xb.grad, 2 * ulp),
                 ("running mean", bn.running_mean, 0.1 * mean, 1e-4),
                 ("running var", bn.running_var, 0.9 + 0.1 * var, 1e-4),
                 ("dscale", bn.weight.grad, w.grad, 1e-4), ("dbias", bn.bias.grad, b.grad, 1e-4)]
        for name, a, ref, tol in pairs:
            a, ref = a.detach(), ref.detach()
            err = max_err(a, ref) / max(float(ref.float().abs().max()), 1e-12)
            errs[name] = max(errs.get(name, 0.0), err)
            check(f"{label} {name}", err, tol, "max|function - plain| / max|plain|")
        del x, xa, xb, y, want, cot
    torch.cuda.empty_cache()

    def fwd_bwd(plain: bool) -> float:
        total = 0.0
        for shape, dtype in calls:
            x = torch.randn(shape, device="cuda", generator=g).to(dtype).contiguous(
                memory_format=torch.channels_last).requires_grad_()
            cot = torch.randn(shape, device="cuda", generator=g).to(dtype)
            bn = BatchNorm(shape[1], 0.1).to("cuda")
            if plain:
                total += cuda_ms(lambda: batch_norm_plain(x, bn.weight, bn.bias)[0].backward(cot), 3,
                                 warmup=1)
            else:
                total += cuda_ms(lambda: bn(x, train=True).backward(cot), 3, warmup=1)
        return total

    bn_ms, plain_ms = fwd_bwd(False), fwd_bwd(True)
    torch.cuda.empty_cache()
    log(f"  BatchNorm forward + backward over the step's {len(calls)} calls: {bn_ms:.3f} ms "
        f"(plain autograd {plain_ms:.3f} ms)")
    return {"max_rel_err": errs, "step_ms": bn_ms, "plain_step_ms": plain_ms, "calls": len(calls)}


def dp_rank(rank: int, world: int, port: int, out_dir: str, ckpt: str) -> None:
    """Phase 9(c): one of two ranks on the card over gloo with CUDA tensors."""
    import numpy as np
    import torch

    from transfusion_torch.parallel import mesh
    from transfusion_torch.runner.trainer import EgoNaoTrainer

    os.environ["LOCAL_RANK"] = str(rank)
    sys.path.insert(0, HERE)
    mesh.init_process_group(rank, world, f"tcp://localhost:{port}", backend="gloo")
    rec: dict = {"refused": {}}
    try:
        torch.cuda.set_device(0)
        # The collectives of the path, each tried once on CUDA tensors.
        t = torch.ones(4 * world, device="cuda")
        probes = {"all_reduce": lambda: torch.distributed.all_reduce(t.clone()),
                  "all_gather_into_tensor": lambda: torch.distributed.all_gather_into_tensor(
                      torch.empty(4 * world * world, device="cuda"), t),
                  "reduce_scatter_tensor": lambda: torch.distributed.reduce_scatter_tensor(
                      torch.empty(4, device="cuda"), t)}
        for name, fn in probes.items():
            try:
                fn()
                torch.cuda.synchronize()
            except (RuntimeError, ValueError) as e:
                rec["refused"][name] = str(e).splitlines()[0][:300]
        modes = ["dp"] + ([] if rec["refused"] else ["fsdp"])
        for mode in modes:
            run = dp_fit(torch, np, os.path.join(out_dir, f"c_{mode}"), fsdp=mode == "fsdp")
            trainer = run.pop("trainer")
            grads = [p for p in trainer.model.parameters()]
            flat = [torch.randn_like(p) for p in grads]
            torch.distributed.barrier()
            t0 = time.perf_counter()
            mesh.all_reduce_sum_(flat)
            torch.cuda.synchronize()
            allreduce_s = time.perf_counter() - t0
            state = dp_state(trainer)
            digest = torch.stack([v.double().sum() for v in state.values()])
            rec[mode] = {**{k: v for k, v in run.items() if k != "init"}, "allreduce_s": allreduce_s,
                         "state": state if rank == 0 else None, "digest": digest,
                         "sharded": len(trainer.sharding.sharded)}
            del trainer, flat, grads
            torch.cuda.empty_cache()
        evaluator = EgoNaoTrainer(dp_run_config(), os.path.join(out_dir, "c_eval"),
                                  data=trainer_data(np, n_train=DP_TRAIN, n_val=DP_VAL))
        evaluator.ensure_state(resume_from=ckpt)
        rec["eval"] = evaluator.evaluate(0).metrics
        path = os.path.join(out_dir, "c_eval", "results", "val_epoch0.json")
        rec["eval_results"] = json.load(open(path))["results"] if rank == 0 else None
        del evaluator
        torch.cuda.empty_cache()
        with f32_exact(torch):
            run = dp_fit(torch, np, os.path.join(out_dir, "c_f32"), precision=32, batch=DP_F32_B,
                         n_train=DP_F32_TRAIN, n_val=DP_F32_VAL)
        trainer = run.pop("trainer")
        state = dp_state(trainer)
        rec["f32"] = {**{k: v for k, v in run.items() if k != "init"},
                      "state": state if rank == 0 else None,
                      "digest": torch.stack([v.double().sum() for v in state.values()])}
        torch.save(rec, os.path.join(out_dir, f"c_rank{rank}.pt"))
    finally:
        mesh.destroy_process_group()


def phase_data_parallel(torch, np, smi: str):
    """Phase 9: trainable BatchNorm and data parallelism at flagship width
    (dp_run_config: bf16, B 8 global, 768x1024, the trunk training).
    (a) one rank, no process group: fit(1) (2 train steps, an evaluation
        with losses), K1-K6 launched, the BatchNorm against its plain
        version at every shape of the step, and its share of the step;
    (b) a world of 1 over NCCL: fit(1) replicated and fully sharded, each
        against (a); a fresh trainer resumed from (b)'s checkpoint holds its
        state bit for bit and evaluates to the same detections bit for bit;
    (c) two ranks on the one card over gloo with CUDA tensors, B 4 each:
        fit(1) replicated (and fully sharded where gloo takes the
        collectives) against (a), both ranks holding the same parameters;
        a sharded evaluation of (a)'s checkpoint against (a)'s mAP and
        result keys."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    # The runs' checkpoints take gigabytes: they stay out of chiprun_out/.
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        rec = _data_parallel(torch, np, smi, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"  data-parallel phase wall time {rec['phase_s']:.1f} s")
    return rec


def check_global_draws(torch) -> None:
    """On the card, a rank's dropout keep masks (bf16 and f32, one and 56
    rows an image) and sampler keys are the one-rank run's for its images,
    bit for bit."""
    from transfusion_torch.models.text_encoder import DropoutRNG
    from transfusion_torch.ops.matcher import uniform_draws

    g = torch.Generator(device="cuda").manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((B, N0, 896), (B * 56, 1280)):
            x = torch.randn(shape, device="cuda", generator=g).to(dtype)
            per = shape[0] // B
            whole = DropoutRNG("cuda", 42, 3, (0, B, B)).keep(x, DROPOUT)
            for start in (0, B // 2):
                rows = (start, start + B // 2, B)
                part = DropoutRNG("cuda", 42, 3, rows).keep(x[start * per:(start + B // 2) * per],
                                                             DROPOUT)
                check(f"dropout keep, images {start}-{start + B // 2 - 1} of {B}, {list(shape)} "
                      f"{str(dtype).split('.')[-1]}",
                      float((part != whole[start * per:(start + B // 2) * per]).sum()), 0.0,
                      "elements differing from the one-rank draw")
    gen = lambda: torch.Generator(device="cuda").manual_seed(5)  # noqa: E731
    whole = uniform_draws((B, 2000), gen())
    part = uniform_draws((B // 2, 2000), gen(), rows=(B // 2, B, B))
    check("sampler keys, the last half", float(sum(int((p != w[B // 2:]).sum())
                                                    for p, w in zip(part, whole))), 0.0,
          "keys differing from the one-rank draw")


def _data_parallel(torch, np, smi: str, out_dir: str) -> dict:
    import torch.multiprocessing as mp

    from transfusion_torch.parallel import mesh
    from transfusion_torch.runner.trainer import EgoNaoTrainer

    rec: dict = {"card": smi}
    check_global_draws(torch)

    log(f"[data parallel] (a) one rank, trainable BN, {DP_TRAIN} train / {DP_VAL} val at {H}x{W}")
    calls: list = []
    a = dp_fit(torch, np, os.path.join(out_dir, "a"), bn_calls=calls)
    trainer = a.pop("trainer")
    a["state"] = dp_state(trainer)
    # What a rank sends a step: the gradients of the parameters that train
    # (f32), and the BatchNorms' sums (forward: x and x^2 and the count;
    # backward: two gradient sums; f32).
    from transfusion_torch.runner.trainer import tower_depth, unfreeze_multipliers

    mult = unfreeze_multipliers(trainer.model.named_parameters(), 0, dp_run_config()["model"], -1, 1,
                                tower_depth(trainer.model_cfg))
    a["grad_numel"] = sum(p.numel() for k, p in trainer.model.named_parameters() if mult[k])
    a["bn_sync_bytes"] = sum(4 * (4 * shape[1] + 1) for shape, _ in calls)
    log(f"  a rank sends {a['grad_numel'] * 4 / 2 ** 20:.1f} MiB of f32 gradients and "
        f"{a['bn_sync_bytes'] / 2 ** 10:.1f} KiB of BatchNorm sums a step")
    ckpt = trainer.ckpt.epoch_path(0)
    del trainer
    torch.cuda.empty_cache()
    step_s = a["train_s"][-1]  # the first step also tunes cuDNN
    log(f"  train step s {[round(t, 4) for t in a['train_s']]}, val batch s "
        f"{[round(t, 4) for t in a['val_s']]}, peak {a['peak_gib']:.2f} GiB, launches a step "
        f"{json.dumps(a['per_step'])}")
    bn = check_batch_norm(torch, calls)
    bn["share_of_step"] = bn["step_ms"] / (step_s * 1e3)
    log(f"  BatchNorm share of the {step_s * 1e3:.1f} ms step: {bn['share_of_step']:.3f}")
    rec["a"] = {k: v for k, v in a.items() if k not in ("state", "init")}
    rec["batch_norm"] = bn

    log("[data parallel] (b) a world of 1 over NCCL, replicated and fully sharded")
    mesh.init_process_group(0, 1, f"tcp://localhost:{mesh.free_port()}", backend="nccl")
    try:
        for mode in ("dp", "fsdp"):
            b = dp_fit(torch, np, os.path.join(out_dir, f"b_{mode}"), fsdp=mode == "fsdp")
            trainer = b.pop("trainer")
            b["state"] = dp_state(trainer)
            rec[f"b_{mode}"] = {**{k: v for k, v in b.items() if k not in ("state", "init")},
                                "against_a": dp_compare(np, a, b, a["init"], f"b {mode}")}
            dp_hold(rec[f"b_{mode}"]["against_a"], f"b {mode}")
            if mode == "fsdp":
                resumed = EgoNaoTrainer(dp_run_config(True), os.path.join(out_dir, "b_resume"),
                                        data=trainer_data(np, n_train=DP_TRAIN, n_val=DP_VAL))
                resumed.ensure_state(resume_from=trainer.ckpt.epoch_path(0))
                got = resumed.model.state_dict()
                if not all(torch.equal(got[k].cpu(), v) for k, v in b["state"].items()):
                    raise AssertionError("(b) the resumed trainer's state differs")
                dets: list = []
                first: list = []
                trainer.eval_loss_step = _counted(torch, trainer.eval_loss_step, "x", {}, [], first)
                resumed.eval_loss_step = _counted(torch, resumed.eval_loss_step, "x", {}, [], dets)
                trainer.evaluate(0)
                resumed.evaluate(0)
                for d0, d1 in zip(first, dets):
                    bad = [k for k in d0 if not _bits_equal(np, d0[k], d1[k])]
                    if bad:
                        raise AssertionError(f"(b) resumed detections differ in {bad}")
                log("  (b) resumed: state bit for bit, detections bit for bit")
                del resumed
            os.remove(os.path.join(trainer.ckpt.epoch_path(0), "state.pt"))
            del trainer
            torch.cuda.empty_cache()
    finally:
        mesh.destroy_process_group()

    log(f"[data parallel] (a) in f32, one rank of B {DP_F32_B}, {DP_F32_TRAIN} train / "
        f"{DP_F32_VAL} val")
    f32_runs = {}
    for tag, eps in (("a_f32", 0.0), ("a_f32_perturbed", PERTURB)):
        with f32_exact(torch):
            run = dp_fit(torch, np, os.path.join(out_dir, tag), precision=32, batch=DP_F32_B,
                         n_train=DP_F32_TRAIN, n_val=DP_F32_VAL, perturb=eps)
        trainer = run.pop("trainer")
        run["state"] = dp_state(trainer)
        f32_runs[tag] = run
        del trainer
        torch.cuda.empty_cache()
    a32 = f32_runs["a_f32"]
    floor = dp_compare(np, a32, f32_runs["a_f32_perturbed"], a32["init"], "f32 noise floor",
                       trained_only=True, skip=f32_runs["a_f32_perturbed"]["perturbed"])

    log("[data parallel] (c) two ranks on the one card over gloo, CUDA tensors, B 4 each "
        f"(then in f32, B {DP_F32_B // 2} each)")
    t0 = time.perf_counter()
    mp.spawn(dp_rank, args=(2, mesh.free_port(), out_dir, ckpt), nprocs=2, join=True)
    log(f"  two ranks ran in {time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(os.path.join(out_dir, f"c_rank{r}.pt"), weights_only=False) for r in range(2)]
    refused = ranks[0]["refused"]
    if refused:
        log(f"  gloo refused on CUDA tensors: {json.dumps(refused)}; the fully-sharded two-rank "
            "check stays with the CPU tests (tests/test_torch_parallel.py)")
    rec["c_refused"] = refused
    for mode in ("dp", "fsdp"):
        if mode not in ranks[0]:
            continue
        r0, r1 = ranks[0][mode], ranks[1][mode]
        if not torch.equal(r0["digest"], r1["digest"]):
            raise AssertionError(f"(c) {mode}: the two ranks' parameters differ")
        timed = ("train_time", "train_s_per", "train_decode")
        if ({k: v for k, v in r0["history"].items() if not k.startswith(timed)}
                != {k: v for k, v in r1["history"].items() if not k.startswith(timed)}):
            raise AssertionError(f"(c) {mode}: the two ranks logged different metrics")
        for r in (r0, r1):
            missing = [k for k in PATH_KERNELS if not r["launches"].get(k)]
            if missing:
                raise AssertionError(f"(c) {mode}: a rank launched no {missing}")
        cmp = dp_compare(np, a, {"history": r0["history"], "state": r0["state"]}, a["init"],
                         f"c {mode}")
        rec[f"c_{mode}"] = {**{k: r0[k] for k in ("history", "per_step", "train_s", "val_s",
                                                   "peak_gib", "allreduce_s", "sharded")},
                            "peak_gib_rank1": r1["peak_gib"], "allreduce_s_rank1": r1["allreduce_s"],
                            "against_a": cmp}
        log(f"  (c) {mode}: train step s {[round(t, 3) for t in r0['train_s']]} / "
            f"{[round(t, 3) for t in r1['train_s']]}, peak {r0['peak_gib']:.2f} / "
            f"{r1['peak_gib']:.2f} GiB, a gradient all-reduce {r0['allreduce_s'] * 1e3:.1f} ms")
    # The sharded evaluation of (a)'s checkpoint against one rank evaluating
    # it at the ranks' own batch (val_bs 4): the same result JSON and mAP
    # bit for bit; against (a)'s evaluation at B 8 the same result keys, the
    # mAP recorded (bf16 rounding at B 4 and B 8 differs, and 8 images give
    # about 12 ground-truth boxes: one detection moves the mAP by points).
    cfg4 = dp_run_config()
    cfg4["run"]["val_bs"] = B // 2
    one = EgoNaoTrainer(cfg4, os.path.join(out_dir, "a_eval4"),
                        data=trainer_data(np, n_train=DP_TRAIN, n_val=DP_VAL))
    one.ensure_state(resume_from=ckpt)
    want = one.evaluate(0)
    want_results = json.load(open(want.result_json_path))["results"]
    del one
    ev = ranks[0]["eval"]
    maps = {k: abs(ev[k] - v) for k, v in want.metrics.items() if k.endswith("_val")}
    check("(c) sharded evaluation mAP, one rank at B 4", max(maps.values()), 0.0,
          "max |two ranks - one rank| (points)")
    check("(c) sharded evaluation result JSON, one rank at B 4",
          float(ranks[0]["eval_results"] != want_results), 0.0, "differs")
    if sorted(ranks[0]["eval_results"]) != sorted(a["results"]):
        raise AssertionError("(c) the sharded evaluation's result keys differ from one rank's")
    map_b8 = max(abs(ev[k] - v) for k, v in a["history"].items() if k.endswith("_val"))
    log(f"  (c) sharded evaluation against one rank at B 8: mAP within {map_b8:.3f} points")
    rec["c_eval"] = {"metrics": ev, "map_abs_b4": max(maps.values()), "map_abs_b8": map_b8}
    r0, r1 = ranks[0]["f32"], ranks[1]["f32"]
    if not torch.equal(r0["digest"], r1["digest"]):
        raise AssertionError("(c) f32: the two ranks' parameters differ")
    cmp = dp_compare(np, a32, {"history": r0["history"], "state": r0["state"]}, a32["init"], "c f32",
                     trained_only=True)
    rec["c_f32"] = {**{k: r0[k] for k in ("history", "train_s", "peak_gib")}, "against_a": cmp,
                    "noise_floor": floor,
                    "within_cpu_tol": bool(cmp["loss_rel"] <= F32_TOL
                                           and cmp["update_rel_l2_median"] <= F32_TOL),
                    "within_floor": bool(cmp["loss_rel"] <= max(F32_TOL, floor["loss_rel"])
                                         and cmp["update_rel_l2_median"]
                                         <= max(F32_TOL, 2 * floor["update_rel_l2_median"]))}
    log(f"  (c) f32 at B {DP_F32_B}: loss {cmp['loss_rel']:.3g}, median update "
        f"{cmp['update_rel_l2_median']:.3g} relative (the floor: {floor['loss_rel']:.3g}, "
        f"{floor['update_rel_l2_median']:.3g}); within the CPU's {F32_TOL}: "
        f"{rec['c_f32']['within_cpu_tol']}; within the floor: {rec['c_f32']['within_floor']}")
    dp_hold(cmp, "c f32")
    for mode in ("dp", "fsdp"):
        if f"c_{mode}" in rec:
            dp_hold(rec[f"c_{mode}"]["against_a"], f"c {mode}")
    return rec



# ------------------------------------- phase 10: the model axis (tensor parallelism)
# flagship_run_config() with flash attention off (the model axis takes the
# plain attention, as JAX's does under a model axis, so (a) does too) on
# 2 x B train and TP_VAL val in-memory examples: 2 train steps and 1 validation batch
# of B 8; then the same in f32 (TF32 off) at B 2.
TP_VAL, TP_F32_B = 8, 2
# The model-group collectives (parallel.tensor_parallel.COLLECTIVES): a
# forward reduces once a Megatron pair (16 fusion layers x 2, 4
# back-projections, 12 MiniLM layers x 2, fc7); a train step's backward
# all-reduces once a column-parallel input (the same pairs less the
# back-projections, whose input gradient is an all-gather), and the step
# reduces the guard's verdict and broadcasts model rank 0's gradients of the
# whole tensors that train (about 21 M f32 at epoch 0: one bucket); a
# validation batch runs the box head twice (fc7 twice).
TP_FORWARD = 2 * 16 + 4 + 2 * 12 + 1
TP_EXPECTED_STEP = {"all_reduce": 2 * TP_FORWARD - 4, "all_gather": 4, "step": 2}
TP_EXPECTED_VAL = {"all_reduce": TP_FORWARD + 1, "all_gather": 0, "step": 0}
TP_EXPECTED_LAUNCHES = {"layer_norm": 5, "residual_layer_norm": 56, "roi_align_fwd": 1,
                        "roi_align_bwd": 1, "attention_fwd": 0, "attention_fwd_dropout": 0,
                        "attention_bwd_dq": 0, "attention_bwd_dkv": 0}


def check_split_draws(torch) -> None:
    """On the card, a model rank's dropout keep masks of its heads (the
    attention probabilities [B, 4, L, L]) and of its hidden columns (the MLP
    [B, L, 1792]), bf16 and f32, are its part of the one-rank mask, bit for
    bit, and so is the output."""
    from transfusion_torch.models.text_encoder import DropoutRNG

    g = torch.Generator(device="cuda").manual_seed(3)
    for dtype in (torch.bfloat16, torch.float32):
        for shape, dim in (((2, HEADS, 3200, 3200), 1), ((B, 3200, 1792), -1)):
            x = torch.rand(shape, device="cuda", generator=g).to(dtype) + 0.5
            whole = DropoutRNG("cuda", 42, 3).keep(x, DROPOUT)
            n = x.shape[dim] // 2
            for r in range(2):
                part = DropoutRNG("cuda", 42, 3).keep(x.narrow(dim, r * n, n).contiguous(), DROPOUT,
                                                        (dim, r, 2))
                check(f"dropout keep, model rank {r} of 2, {list(shape)} split on {dim} "
                      f"{str(dtype).split('.')[-1]}",
                      float((part != whole.narrow(dim, r * n, n)).sum()), 0.0,
                      "elements differing from the one-rank draw")
            del x, whole
    torch.cuda.empty_cache()


def tp_run_config(precision: int = 16, batch: int | None = None) -> dict:
    cfg = flagship_run_config()
    cfg["run"]["narr_fusion"]["args"]["use_flash_attention"] = False
    cfg["run"].update(precision=precision, train_bs=batch or B, val_bs=batch or B)
    return cfg


def _tp_counted(torch, fn, per_call: list, timed: list | None = None):
    """``fn`` with each call's model-group collectives (and, for the call
    ``timed`` names by index, their host seconds) appended to
    ``per_call``."""
    from transfusion_torch.parallel import tensor_parallel as tp

    def wrapped(*args, **kwargs):
        before = dict(tp.COLLECTIVES)
        if timed is not None and len(per_call) == timed[0]:
            with tp.timing() as times:
                out = fn(*args, **kwargs)
            timed.append(sum(times))
        else:
            out = fn(*args, **kwargs)
        per_call.append({k: v - before[k] for k, v in tp.COLLECTIVES.items()})
        return out

    return wrapped


def tp_fit(torch, np, run_dir: str, mesh_=None, precision: int = 16, batch: int | None = None,
           steps: int = 2, perturb: float = 0.0) -> dict:
    """fit(1) of tp_run_config() on ``mesh_`` (one rank without one): the
    history, the whole state (on rank 0), launches and collectives a call,
    step and validation times, the last step's collective seconds, peak
    memory and the parameters a rank holds; ``perturb`` scales the deepest
    backbone convolution after init (perturb_). ``run_dir`` is new."""
    from transfusion_torch.kernels import LAUNCHES
    from transfusion_torch.parallel.mesh import rank
    from transfusion_torch.runner.trainer import EgoNaoTrainer

    batch = batch or B
    n_train, n_val = steps * batch, TP_VAL if batch == B else batch
    trainer = EgoNaoTrainer(tp_run_config(precision, batch), run_dir, mesh=mesh_,
                            data=trainer_data(np, n_train=n_train, n_val=n_val))
    trainer.ensure_state()
    init = None if trainer.model.tensor_parallel is not None else {
        k: v.detach().to("cpu", copy=True) for k, v in trainer.model.named_parameters()}
    perturbed = perturb_(torch, trainer.model, perturb, "fusion")
    counts: dict = {}
    train_s: list = []
    val_s: list = []
    step_calls: list = []
    vals: list = []
    timed = [steps - 1]  # the last step's collectives are timed
    step_losses: list = []
    step = _tp_counted(torch, trainer.train_step, step_calls, timed)

    def logged(*args, **kwargs):
        metrics = step(*args, **kwargs)
        step_losses.append({k: float(v) for k, v in metrics.items() if k.endswith("loss")})
        return metrics

    trainer.train_step = _counted(torch, logged, "train", counts, train_s)
    trainer.eval_loss_step = _counted(torch, _tp_counted(torch, trainer.eval_loss_step, vals),
                                      "val", counts, val_s)
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    rec = trainer.fit(1)[0]
    if rec["train_nonfinite_skipped"] != 0.0 or not all(
            math.isfinite(v) for k, v in rec.items() if k.endswith("loss")):
        raise AssertionError(f"non-finite loss or a skipped step: {rec}")
    whole = trainer.sharding.full_model_state(trainer.model)
    state = {k: v.detach().to("cpu", copy=True) for k, v in whole.items()} if rank() == 0 else None
    path = os.path.join(run_dir, "results", "val_epoch0.json")
    out = {"history": rec, "state": state, "init": init, "step_losses": step_losses,
           "perturbed": perturbed,
           "digest": torch.stack([v.double().sum().cpu() for v in whole.values()]),
           "per_step": {k: v / len(train_s) for k, v in counts["train"].items()},
           "per_val": {k: v / len(val_s) for k, v in counts["val"].items()},
           "collectives_step": step_calls, "collectives_val": vals, "collective_s": timed[1:],
           "train_s": train_s, "val_s": val_s, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "param_bytes": sum(p.numel() * p.element_size() for p in trainer.model.parameters()),
           "results": json.load(open(path))["results"] if os.path.isfile(path) else None,
           "ckpt": trainer.ckpt.epoch_path(0)}
    del trainer
    torch.cuda.empty_cache()
    return out


def tp_remat(torch, np, run_dir: str, mesh_) -> dict:
    """Phase 10 (e): on each model rank, one train step of tp_run_config()
    at B 8 with the fusion levels rematerialised against the plain step
    (remat_runs: a warm-up, then plain / remat / remat / plain from the same
    parameters, batch and (seed, step), after a remat warm-up; epoch 0's
    freeze and multipliers): the gaps and their floors (remat_gaps), step s,
    peak GiB and the model-group collectives a step of each setting."""
    from transfusion_torch.data.loader import DataLoader
    from transfusion_torch.parallel.mesh import data_rank, data_size
    from transfusion_torch.runner.trainer import (EgoNaoTrainer, backbone_stop_grad_stages, tower_depth,
                                                  unfreeze_multipliers)
    from transfusion_torch.train.step import criterion_weights

    trainer = EgoNaoTrainer(tp_run_config(), run_dir, mesh=mesh_, data=trainer_data(np, n_train=B, n_val=B))
    trainer.ensure_state()
    # Epoch 0's batch, freeze and multipliers, as EgoNaoTrainer.train_epoch sets them.
    run, model_cfg = trainer.run, trainer.config["model"]
    trainer._set_stop_grad_stages(backbone_stop_grad_stages(0, model_cfg,
                                                            run.get("freeze_backbone_at_epoch", -1)))
    narr = run["narration_embeds"]["args"]
    mult = unfreeze_multipliers(trainer.model.named_parameters(), 0, model_cfg, narr.get("train_ep", -1),
                                narr.get("finetune_layers", 1), tower_depth(trainer.model_cfg),
                                run.get("freeze_backbone_at_epoch", -1),
                                text_encoder=trainer.model_cfg.text_encoder)
    loader = DataLoader(trainer.train_ds, trainer.train_bs, tokenizer=trainer.tokenizer, training=True,
                        seed=trainer.seed, lang_max_length=trainer.tokenizer.max_length,
                        rank_slice=(data_rank(), data_size()))
    batch = trainer._device_batch(next(iter(loader)))
    runs = remat_runs(torch, trainer.model, trainer.train_step,
                      lambda: trainer.tx.init(trainer.sharding.views()), batch,
                      criterion_weights(trainer.criterion, 0), mult)
    out = {"gaps": remat_gaps(torch, runs), "warmup_s": runs[0]["s"]}
    for setting in ("plain", "remat"):
        rs = [r for r in runs[1:] if r["setting"] == setting]
        out[setting] = {"step_s": [r["s"] for r in rs], "peak_gib": max(r["peak_gib"] for r in rs),
                        "collectives": [r["collectives"] for r in rs],
                        "launches": rs[0]["launches"]}
    del trainer, runs
    torch.cuda.empty_cache()
    return out


def tp_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """Phase 10 (b), (c): one of two model ranks on the card over gloo with
    CUDA tensors, mesh (1, 2): fit(1) in bf16 at B 8, then in f32 at B 2."""
    import numpy as np
    import torch

    from transfusion_torch.parallel import mesh

    os.environ["LOCAL_RANK"] = str(rank)
    sys.path.insert(0, HERE)
    mesh.init_process_group(rank, world, f"tcp://localhost:{port}", backend="gloo")
    try:
        torch.cuda.set_device(0)
        m = mesh.make_mesh(model=world)
        rec = {"b": tp_fit(torch, np, os.path.join(out_dir, "b"), m)}
        with f32_exact(torch):
            rec["c"] = tp_fit(torch, np, os.path.join(out_dir, "c"), m, precision=32, batch=TP_F32_B,
                              steps=1)
        rec["e"] = tp_remat(torch, np, os.path.join(out_dir, "e"), m)
        torch.save(rec, os.path.join(out_dir, f"tp_rank{rank}.pt"))
    finally:
        mesh.destroy_process_group()


def phase_tensor_parallel(torch, np, smi: str):
    """Phase 10: the model axis at flagship width (tp_run_config: bf16,
    B 8, 768x1024, flash attention off).
    (a) one rank, no process group: fit(1), then in f32 at B 2;
    (b) two model ranks on the one card over gloo with CUDA tensors, mesh
        (1, 2), each holding B 8: fit(1) against (a) (DP_TOL), the same
        result keys; K1, K5 and K6 launched and K2-K4 not, as predicted; the
        model-group collectives a step and a validation batch as predicted;
        step s, the last step's collective seconds, peak GiB and the
        parameter bytes a rank holds;
    (c) the same in f32 at B 2, one step, against (a)'s f32 run: the loss
        within 1e-4 relative, the median update within twice the noise
        floor's (one rank against itself with the fusion's linear1 weights
        scaled by 1 + PERTURB) or 1e-4;
    (d) (b)'s checkpoint resumed at one rank holds (b)'s gathered state bit
        for bit, and its evaluation at one rank against (b)'s at model 2."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from transfusion_torch.parallel import mesh
    from transfusion_torch.runner.trainer import EgoNaoTrainer

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    rec: dict = {"card": smi}
    try:
        check_split_draws(torch)
        log(f"[model axis] (a) one rank, flash attention off, {2 * B} train / {TP_VAL} val "
            f"at {H}x{W}; then f32 at B {TP_F32_B}, one step, and its noise floor")
        a = tp_fit(torch, np, os.path.join(work, "a"))
        with f32_exact(torch):
            a32, a32p = (tp_fit(torch, np, os.path.join(work, tag), precision=32, batch=TP_F32_B,
                                steps=1, perturb=eps)
                         for tag, eps in (("a_f32", 0.0), ("a_f32_perturbed", PERTURB)))
        init = a.pop("init")  # the seeded weights, the same at every precision and mesh
        log("[model axis] (b) two model ranks on the one card over gloo, CUDA tensors, B 8 each; "
            f"(c) the same in f32 at B {TP_F32_B}")
        t0 = time.perf_counter()
        mp.spawn(tp_rank, args=(2, mesh.free_port(), work), nprocs=2, join=True)
        log(f"  two ranks ran in {time.perf_counter() - t0:.1f} s")
        ranks = [torch.load(os.path.join(work, f"tp_rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        for tag, one in (("b", a), ("c", a32)):
            r0, r1 = ranks[0][tag], ranks[1][tag]
            if not torch.equal(r0["digest"], r1["digest"]):
                raise AssertionError(f"({tag}) the two model ranks' gathered parameters differ")
            for r in (r0, r1):
                steps = r["collectives_step"]
                if any(c != TP_EXPECTED_STEP for c in steps) or any(
                        c != TP_EXPECTED_VAL for c in r["collectives_val"]):
                    raise AssertionError(f"({tag}) model-group collectives {steps} a step, "
                                         f"{r['collectives_val']} a validation batch; predicted "
                                         f"{TP_EXPECTED_STEP} and {TP_EXPECTED_VAL}")
                got = {k: r["per_step"].get(k, 0) for k in TP_EXPECTED_LAUNCHES}
                if got != TP_EXPECTED_LAUNCHES:
                    raise AssertionError(f"({tag}) launches a step {got}, predicted "
                                         f"{TP_EXPECTED_LAUNCHES}")
            if sorted(r0["results"]) != sorted(one["results"]):
                raise AssertionError(f"({tag}) the result JSON's keys differ from one rank's")
            cmp = dp_compare(np, one, {"history": r0["history"], "state": r0["state"]}, init,
                             f"model axis {tag}", trained_only=True)
            rec[tag] = {**{k: r0[k] for k in ("history", "per_step", "per_val", "train_s", "val_s",
                                              "peak_gib", "param_bytes", "collective_s")},
                        "collectives_step": r0["collectives_step"][0],
                        "collectives_val": r0["collectives_val"][0],
                        "peak_gib_rank1": r1["peak_gib"], "collective_s_rank1": r1["collective_s"],
                        "one_rank": {k: one[k] for k in ("train_s", "val_s", "peak_gib", "param_bytes",
                                                         "per_step")},
                        "against_one_rank": cmp, "step_losses": r0["step_losses"],
                        "one_rank_step_losses": one["step_losses"]}
            log(f"  ({tag}) train step s {[round(t, 3) for t in r0['train_s']]} / "
                f"{[round(t, 3) for t in r1['train_s']]} (one rank {[round(t, 3) for t in one['train_s']]}), "
                f"last step's collectives {r0['collective_s'][0]:.3f} s, peak {r0['peak_gib']:.2f} / "
                f"{r1['peak_gib']:.2f} GiB (one rank {one['peak_gib']:.2f}), parameters a rank "
                f"{r0['param_bytes'] / 2 ** 20:.1f} MiB (one rank {one['param_bytes'] / 2 ** 20:.1f}), "
                f"collectives a step {json.dumps(r0['collectives_step'][0])}")
        dp_hold(rec["b"]["against_one_rank"], "model axis b")
        c = rec["c"]["against_one_rank"]
        floor = dp_compare(np, a32, a32p, init, "f32 noise floor", trained_only=True,
                           skip=a32p["perturbed"])
        rec["c"]["noise_floor"] = floor
        check("(c) f32 training loss, model 2 against one rank", c["loss_rel"], F32_TOL,
              "relative error")
        check("(c) f32 parameter updates, model 2 against one rank (twice the noise floor)",
              c["update_rel_l2_median"], max(F32_TOL, 2 * floor["update_rel_l2_median"]),
              "median relative L2 error")

        # (e) the remat step at model 2 against the plain one, rank by rank.
        want_remat = dict(TP_EXPECTED_STEP, all_reduce=TP_EXPECTED_STEP["all_reduce"] + TP_REMAT_EXTRA)
        rec["e"] = []
        for r, e in enumerate(x["e"] for x in ranks):
            for setting, want in (("plain", TP_EXPECTED_STEP), ("remat", want_remat)):
                if any(c != want for c in e[setting]["collectives"]):
                    raise AssertionError(f"(e) rank {r}: model-group collectives of a {setting} step "
                                         f"{e[setting]['collectives']}, predicted {want}")
            got = {k: e["remat"]["launches"].get(k, 0) for k in TP_EXPECTED_LAUNCHES}
            if got != dict(TP_EXPECTED_LAUNCHES, layer_norm=5 + 4, residual_layer_norm=56 + 32):
                raise AssertionError(f"(e) rank {r}: a remat step launched {got}")
            g = e["gaps"]
            log(f"  (e) rank {r}: remat against plain at model 2, loss {g['loss_plain']!r} / "
                f"{g['loss_remat']!r} (|diff| {g['loss_abs']:.3g}, floor {g['loss_floor']:.3g}), max "
                f"|update diff| {g['update_max_abs']:.3g} (floor {g['update_floor']:.3g}); step s plain "
                f"{[round(t, 3) for t in e['plain']['step_s']]}, remat "
                f"{[round(t, 3) for t in e['remat']['step_s']]}; peak GiB plain "
                f"{e['plain']['peak_gib']:.2f}, remat {e['remat']['peak_gib']:.2f}")
            rec["e"].append(e)

        log("[model axis] (d) (b)'s checkpoint resumed at one rank")
        back = EgoNaoTrainer(tp_run_config(), os.path.join(work, "d"),
                             data=trainer_data(np, n_train=2 * B, n_val=TP_VAL))
        back.ensure_state(resume_from=ranks[0]["b"]["ckpt"])
        got = back.model.state_dict()
        if not all(torch.equal(got[k].cpu(), v) for k, v in ranks[0]["b"]["state"].items()):
            raise AssertionError("(d) the resumed state differs from the model ranks' gathered state")
        ev = back.evaluate(0)
        want = ranks[0]["b"]["history"]
        results = json.load(open(ev.result_json_path))["results"]
        if sorted(results) != sorted(ranks[0]["b"]["results"]):
            raise AssertionError(f"(d) the one-rank evaluation's result keys {sorted(results)} differ "
                                 f"from model 2's {sorted(ranks[0]['b']['results'])}")
        rec["d"] = {"map_abs": max(abs(ev.metrics[k] - v) for k, v in want.items()
                                   if k.endswith("_val") and not k.startswith("val_")),
                    "metrics": ev.metrics}
        log(f"  (d) resumed bit for bit; its evaluation at one rank within {rec['d']['map_abs']:.3f} "
            "mAP points of model 2's")
        del back
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"  model-axis phase wall time {rec['phase_s']:.1f} s")
    return rec



# ------------------------------------------- phase 11: the other backbones
# (a) MobileNetV3-Large under the fusion and MiniLM: the trunk trains from
# epoch 0 with trainable_layers 3 (blocks 6-12, backbone.body.7-13), the
# stem and blocks 0-5 frozen by the multipliers alone (no tape cut). Level 0
# at stride 4 is 3,072 patches + 64 tokens, past K2's gate, so the request
# and the step launch what the flagship's do.
MOBILENET_MODEL = {"type": "mobilenet", "train_ep": 0, "trainable_layers": 3}
EXPECTED_MOBILENET = (5, 56, True)
# (b) the s2d flagship launches what the plain flagship launches.
EXPECTED_S2D = (5, 56, True)
S2D_F32_TOL = 1e-5  # backbone maps, max|s2d - plain| / max|plain|, f32 with TF32 off
# The golden test's tolerance (tests/test_golden_detections.py): float
# fields rtol 1e-4 / atol 1e-3, integers exact.
GOLDEN_RTOL, GOLDEN_ATOL = 1e-4, 1e-3
# (c) the dual-stream detector: no fusion, no MiniLM; K5 once a forward, K6
# once a backward.
EXPECTED_DUAL_FORWARD = {"roi_align_fwd": 1}
EXPECTED_DUAL_BACKWARD = {"roi_align_fwd": 1, "roi_align_bwd": 1}
FLOW_SHAPE = (B, H, W, 2)


def backbone_run_config(**model) -> dict:
    cfg = flagship_run_config()
    cfg["model"].update(model)
    return cfg


def f32_body(torch, body, cls=None, **kw):
    """An f32 copy on the card of a ResNet-family body (``cls``, default
    the body's own class, built with ``kw``; a ResNet over a dual-stream
    body's RGB weights)."""
    sizes = tuple(len(getattr(body, f"layer{i + 1}")) for i in range(4))
    out = (cls or type(body))(sizes, dtype=torch.float32, **kw).cuda()
    keys = set(out.state_dict())
    out.load_state_dict({k: v for k, v in body.state_dict().items() if k in keys}, strict=True)
    return out.eval()


def compare_detections(torch, a: dict, b: dict) -> dict:
    """Slot-by-slot agreement of two detection dicts at the golden
    tolerance: the number of images whose every field agrees, the kept
    counts, and the largest score gap over all slots."""
    same = torch.ones(a["valid"].shape[0], dtype=torch.bool, device=a["valid"].device)
    for k in a:
        if a[k].dtype.is_floating_point:
            ok = torch.isclose(a[k].float(), b[k].float(), rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)
        else:
            ok = a[k] == b[k]
        same &= ok.reshape(ok.shape[0], -1).all(1)
    return {"images_within_golden": int(same.sum()), "images": int(same.numel()),
            "kept": [int(a["valid"].sum()), int(b["valid"].sum())],
            "max_score_gap": float((a["scores"].float() - b["scores"].float()).abs().max())}


def phase_backbones(torch, np, smi: str) -> dict:
    """Phase 11: (a) MobileNet, (b) the s2d stem, (c) the dual-stream
    detector, each at flagship width (B 8, 768x1024, bf16 compute, f32
    params, seeded weights)."""
    t_phase = time.perf_counter()
    rec = {"mobilenet": backbones_mobilenet(torch, np, smi)}
    gc.collect()
    torch.cuda.empty_cache()
    rec["s2d"] = backbones_s2d(torch, np, smi)
    gc.collect()
    torch.cuda.empty_cache()
    rec["dual_stream"] = backbones_dual_stream(torch, np, smi)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"  backbones phase wall time {rec['phase_s']:.1f} s ({smi})")
    return rec


def backbones_mobilenet(torch, np, smi: str) -> dict:
    """(a) ``model.type: mobilenet`` through build_transfusion_config: two
    eval requests and two train steps after a warm-up; finite losses,
    non-zero gradients on the unfrozen blocks, frozen blocks unmoved,
    launches as EXPECTED_MOBILENET predicts."""
    from transfusion_torch.models.transfusion import TransFusion, build_transfusion_config
    from transfusion_torch.runner.trainer import backbone_stop_grad_stages
    from transfusion_torch.weights import init_random_

    held = torch.cuda.memory_allocated() / 2 ** 30
    run_cfg = backbone_run_config(**MOBILENET_MODEL)
    if backbone_stop_grad_stages(0, run_cfg["model"]) != 0:
        raise AssertionError("a MobileNet trunk takes no tape cut")
    t0 = time.perf_counter()
    cfg = build_transfusion_config(run_cfg, 88, 75, dtype=torch.bfloat16)
    model = init_random_(TransFusion(cfg, device="cuda"), seed=0)
    build_s = time.perf_counter() - t0
    names = [n for n, _ in model.named_parameters() if n.startswith("backbone.body.")]
    unit = {n: int(n.split(".")[2]) for n in names}
    frozen = [n for n in names if unit[n] < 7]
    # The first conv of each unfrozen block and the last block's squeeze-excite.
    watched = [f"backbone.body.{i}.block.0.0.weight" for i in range(7, 14)] + [
        "backbone.body.13.block.2.fc1.weight",
        "cross_fusion_encoders.0.t_encoder.layers.0.self_attn.in_proj_weight"]
    out = drive_config(torch, np, "backbones: mobilenet", model, cfg, run_cfg,
                       fusion_option_batch(torch, np), EXPECTED_MOBILENET, watched, smi, build_s,
                       held, frozen)
    out["trunk_params_m"] = sum(p.numel() for n, p in model.named_parameters() if n in unit) / 1e6
    return out


def backbones_s2d(torch, np, smi: str) -> dict:
    """(b) The flagship with ``model.s2d_stem: true``, its stem folded from
    the plain flagship's (``weights.fold_plain_stem``): f32 backbone maps
    (TF32 off) against the plain stem's within S2D_F32_TOL; bf16 maps, and
    bf16 detections against the plain flagship's at the golden tolerance,
    recorded; both stems timed (conv, norm, ReLU and max pool; the conv and
    the rearrangement alone beside them); then the s2d flagship's request
    and step with launches as the plain flagship's and the body, s2d stem
    included, unmoved by the flagship's freeze."""
    import dataclasses

    import torch.nn.functional as F

    from transfusion_torch.kernels import LAUNCHES
    from transfusion_torch.models.detector import detections_from_outputs
    from transfusion_torch.models.resnet import space_to_depth
    from transfusion_torch.models.transfusion import (TransFusion, build_transfusion_config,
                                                      flagship_config)
    from transfusion_torch.runner.trainer import backbone_stop_grad_stages
    from transfusion_torch.weights import fold_plain_stem, init_random_

    run_cfg = backbone_run_config(s2d_stem=True)
    cfg = build_transfusion_config(run_cfg, 88, 75, dtype=torch.bfloat16)
    cfg = dataclasses.replace(cfg, detector=dataclasses.replace(
        cfg.detector, stop_grad_stages=backbone_stop_grad_stages(0, run_cfg["model"])))
    if cfg != flagship_config(s2d_stem=True):
        raise AssertionError("model.s2d_stem: true does not map onto flagship_config(s2d_stem=True)")
    held = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    plain = init_random_(TransFusion(flagship_config(), device="cuda"), seed=0)
    s2d = TransFusion(cfg, device="cuda")
    s2d.load_state_dict(fold_plain_stem(plain.state_dict()), strict=True)
    build_s = time.perf_counter() - t0
    batch = fusion_option_batch(torch, np)
    x = batch["image"].permute(0, 3, 1, 2)

    def rel_gaps(a, b):
        return {k: float((b[k].float() - a[k].float()).abs().max() / a[k].float().abs().max()) for k in a}

    with f32_exact(torch), torch.inference_mode():
        fp = f32_body(torch, plain.backbone.body)
        fs = f32_body(torch, s2d.backbone.body, s2d_stem=True)
        rel = rel_gaps(fp(x), fs(x))
        del fp, fs
    for k, v in rel.items():
        check(f"[backbones: s2d] f32 level {k} maps, s2d stem vs plain stem", v, S2D_F32_TOL,
              "max|s2d - plain| / max|plain|")
    with torch.inference_mode():  # recorded, not held: bf16 rounds each stem's own sums
        rel_bf16 = rel_gaps(plain.backbone.body(x), s2d.backbone.body(x))

    def stem(body):
        return lambda: F.max_pool2d(F.relu(body.bn1(body.stem_conv(x))), 3, stride=2, padding=1)

    with torch.inference_mode():
        stem_ms = {"plain": cuda_ms(stem(plain.backbone.body), 20),
                   "s2d": cuda_ms(stem(s2d.backbone.body), 20),
                   "plain_conv": cuda_ms(lambda: plain.backbone.body.stem_conv(x), 20),
                   "s2d_conv": cuda_ms(lambda: s2d.backbone.body.stem_conv(x), 20),
                   "s2d_rearrange": cuda_ms(lambda: space_to_depth(x.to(torch.bfloat16)), 20)}
        dets = [detections_from_outputs(m(batch), m.cfg) for m in (plain, s2d)]
    torch.cuda.synchronize()
    det_cmp = compare_detections(torch, *dets)
    log(f"[backbones: s2d] f32 maps {json.dumps(rel)}; bf16 maps {json.dumps(rel_bf16)}; stem ms "
        f"{json.dumps(stem_ms)} ({smi}); bf16 detections against the plain flagship's at the golden "
        f"tolerance: {json.dumps(det_cmp)}")
    del dets, plain
    gc.collect()
    torch.cuda.empty_cache()
    LAUNCHES.clear()
    # The flagship's schedule freezes the whole body, the s2d stem with it.
    frozen = [n for n, _ in s2d.named_parameters() if n.startswith("backbone.body.")]
    out = drive_config(torch, np, "backbones: s2d", s2d, cfg, run_cfg, batch, EXPECTED_S2D,
                       ["cross_fusion_encoders.0.t_encoder.layers.0.self_attn.in_proj_weight",
                        "backbone.fpn.layer_blocks.0.weight"], smi, build_s, held, frozen)
    return {**out, "f32_rel": rel, "bf16_rel": rel_bf16, "stem_ms": stem_ms, "bf16_detections": det_cmp}


def backbones_dual_stream(torch, np, smi: str) -> dict:
    """(c) ``FasterRCNN(DetectorConfig(dual_stream=True))`` with a seeded
    flow [B, H, W, 2]: a forward with detections, then a training forward
    and a backward through the detector's losses (K5 once a forward, K6
    once a backward); then the zero-fusion oracle: with every fuse/proj
    weight zero under sum fusion the f32 RGB maps equal the plain ResNet's
    with the same weights bit for bit."""
    from transfusion_torch.kernels import LAUNCHES
    from transfusion_torch.models.detector import (DetectorConfig, FasterRCNN,
                                                   detections_from_outputs)
    from transfusion_torch.models.resnet import ResNet
    from transfusion_torch.models.roi_heads import RoIConfig
    from transfusion_torch.models.rpn import RPNConfig
    from transfusion_torch.ops.matcher import uniform_draws
    from transfusion_torch.train.step import LossConfig, compute_losses, step_generator
    from transfusion_torch.weights import init_random_

    dcfg = DetectorConfig(roi=RoIConfig(num_nouns=88, num_verbs=75, representation_size=1280,
                                        score_thresh=0.01, additional_postprocessing=True),
                          rpn=RPNConfig(score_thresh=0.01), dual_stream=True, dtype=torch.bfloat16)
    held = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    det = init_random_(FasterRCNN(dcfg, device="cuda"), seed=0)
    build_s = time.perf_counter() - t0
    batch = fusion_option_batch(torch, np)
    flow = torch.from_numpy(np.random.default_rng(2).normal(0, 2, FLOW_SHAPE).astype(np.float32)).cuda()
    hw = (H, W)
    torch.cuda.reset_peak_memory_stats()

    def request():
        with torch.inference_mode():
            return detections_from_outputs(det(batch["image"], hw, flow=flow), dcfg)

    request()
    torch.cuda.synchronize()
    LAUNCHES.clear()
    eval_s = []
    for _ in range(REQUESTS_FO):
        t0 = time.perf_counter()
        dets = request()
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t0)
    per_forward = {k: v / REQUESTS_FO for k, v in LAUNCHES.items()}
    if not all(torch.isfinite(dets[k]).all() for k in ("boxes", "scores", "ttcs")):
        raise AssertionError("[backbones: dual stream] non-finite detections")
    del dets

    loss_cfg = LossConfig(rpn_batch_size_per_image=256, last_noun_idx=87)
    ones_n, ones_v = torch.ones(88, device="cuda"), torch.ones(75, device="cuda")
    params = dict(det.named_parameters())

    def train(step: int):
        det.train()
        for p in params.values():
            p.grad = None
        gen = step_generator("cuda", 0, step)
        out = det(batch["image"], hw, batch["targets"], train=True, generator=gen, flow=flow)
        draws = uniform_draws(out["proposals"]["objectness"].shape, gen)
        stacked, _ = compute_losses(out, batch, loss_cfg, ones_n, ones_v, draws)
        stacked[:4].sum().backward()
        det.eval()
        return stacked.detach()

    train(0)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    step_s, losses = [], []
    for i in range(TRAIN_STEPS_FO):
        t0 = time.perf_counter()
        stacked = train(i + 1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append([float(v) for v in stacked[:4]])
    per_backward = {k: v / TRAIN_STEPS_FO for k, v in LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(math.isfinite(v) for row in losses for v in row):
        raise AssertionError(f"[backbones: dual stream] non-finite losses {losses}")
    watched = ["backbone.body.conv1.weight", "backbone.body.flow_conv1.weight",
               "backbone.body.layer1.0.fuse.proj.weight", "backbone.body.layer4.2.fuse.proj.weight",
               "backbone.body.flow_layer4.conv3.weight"]
    grads = {n: float(params[n].grad.float().norm()) for n in watched}
    if not all(v > 0.0 for v in grads.values()):
        raise AssertionError(f"[backbones: dual stream] zero gradient: {grads}")
    got_fwd = {k: per_forward.get(k, 0) for k in EXPECTED_DUAL_FORWARD}
    got_bwd = {k: per_backward.get(k, 0) for k in EXPECTED_DUAL_BACKWARD}
    log(f"[backbones: dual stream] built in {build_s:.1f} s ({sum(p.numel() for p in params.values()) / 1e6:.1f}"
        f" M params); launches a forward {got_fwd}, a forward + backward {got_bwd}")
    log(f"  eval s {[round(t, 4) for t in eval_s]}, forward + backward s {[round(t, 4) for t in step_s]}, "
        f"peak {peak:.2f} GiB ({held:.2f} GiB held before the build; {smi}); losses "
        f"[bbox, rpn, noun, verb] {losses}; |grad| {json.dumps(grads)}")
    if got_fwd != EXPECTED_DUAL_FORWARD or got_bwd != EXPECTED_DUAL_BACKWARD:
        raise AssertionError(f"[backbones: dual stream] launches differ from the prediction: forward "
                             f"{EXPECTED_DUAL_FORWARD}, forward + backward {EXPECTED_DUAL_BACKWARD}")
    for p in params.values():
        p.grad = None

    x, fl = batch["image"].permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
    with f32_exact(torch, deterministic=True), torch.inference_mode():
        dual = f32_body(torch, det.backbone.body)
        for name, p in dual.named_parameters():
            if ".fuse.proj." in name:
                p.zero_()
        plain = f32_body(torch, det.backbone.body, ResNet)
        got, want = dual(x, fl), plain(x)
        equal = {k: bool(torch.equal(got[k], want[k])) for k in want}
        del dual, plain, got, want
    log(f"  zero fuse/proj, sum fusion: RGB maps bit for bit the plain ResNet's (f32): {equal}")
    if not all(equal.values()):
        raise AssertionError(f"[backbones: dual stream] zero-fusion trunk differs from the plain ResNet: {equal}")
    return {"eval_s": eval_s, "fwd_bwd_s": step_s, "peak_gib": peak, "held_gib": held,
            "build_s": build_s, "launches_forward": per_forward, "launches_fwd_bwd": per_backward,
            "losses": losses, "grad_norms": grads, "zero_fusion_bit_equal": equal, "card": smi}


# Phase 12: the legacy heatmap family at B 8, 768x1024, f32 (each config's
# default dtype), seeded weights, the flagship's class counts (phase 7's
# build_transfusion_config(run_cfg, 88, 75): 87 nouns and 74 verbs, each
# with its background class) and its optimizer (flagship_run_config():
# RAdam lr 1e-4, wd 1e-5).
HM_NOUNS, HM_VERBS = 88, 75
HM_FEAT = (B, 48, 64, 1024)  # ResNet-50's stage-3 map at 768x1024: 24 x 32 = 768 patches of 2 x 2
HM_TOKEN_DIM, HM_LANG = 300, 64
HM_REQUESTS, HM_STEPS = 2, 2  # each model, after a warm-up
# Predicted K1 launches a forward (a train step's forward launches the same;
# the backward is layer_norm's closed form): (d1) 3 visual + 2 language QKV
# layers x 2 residual norms, and class_post_ln; (d2) 2 encoder layers x 2,
# and class_post_ln; ResnetNao and ScnnNao run no kernel.
HM_EXPECTED = {"resnet_nao": {}, "resnet_nao_multivar": {}, "scnn_nao": {},
               "fusion_asymmetric": {"residual_layer_norm": 10, "layer_norm": 1},
               "fusion_cross_transformer": {"residual_layer_norm": 4, "layer_norm": 1}}
# K1 at the shapes the phase adds, f32 (the models' dtype) and bf16: the
# asymmetric visual stream (8 x 769 rows of 300), the cross-transformer's
# joint sequence (8 x 834: 770 visual + 64 language tokens), the language
# stream (8 rows, residual) and class_post_ln (8 rows, plain), the patch
# tokens as the view x[:, 1:769] reads them (x[:, :768] of [8, 769, 300]),
# and an odd width (301, scalar loads) in both forms.
HM_LN_SHAPES = tuple(
    {**shape, "dtype": dt, "label": f"{shape['label']} {dt}"}
    for shape in ({"label": "heatmap fusion visual norms", "n": 769, "d": 300, "residual": True},
                  {"label": "heatmap fusion joint norms", "n": 834, "d": 300, "residual": True},
                  {"label": "heatmap fusion language norms", "n": 1, "d": 300, "residual": True},
                  {"label": "heatmap fusion class_post_ln", "n": 1, "d": 300, "residual": False},
                  {"label": "patch tokens, view", "n": 768, "view": 769, "d": 300, "residual": False},
                  {"label": "odd width residual", "n": 769, "d": 301, "residual": True},
                  {"label": "odd width plain", "n": 769, "d": 301, "residual": False})
    for dt in ("f32", "bf16"))
# The JSON line's rows for the new width: the f32 forms the family runs.
HM_ROWS = {"residual_layer_norm_d300": "heatmap fusion visual norms f32",
           "layer_norm_d300": "heatmap fusion class_post_ln f32"}
REPLACES |= {"residual_layer_norm_d300": REPLACES["residual_layer_norm"],
             "layer_norm_d300": REPLACES["layer_norm"]}
SOURCES |= {"residual_layer_norm_d300": SOURCES["residual_layer_norm"],
            "layer_norm_d300": SOURCES["layer_norm"]}
HM_TINY_TOL = 1e-4


def heatmap_models(torch):
    """(name, model, watched parameter names) of phase 12, seeded weights
    on the card: (a) ResnetNao (ResNet-50, heatmap_blocks 3), (b) the same
    with multivar_n, (c) ScnnNao at the factory widths with kl_div, (d1)
    HeatmapCrossFusion's defaults (asymmetric, embedding, regroup_gated,
    extra), (d2) cross_transformer, token_embeddings, regroup; each with
    noun, verb and TTC heads."""
    from transfusion_torch.models.heatmap_fusion import HeatmapCrossFusion, HeatmapFusionConfig
    from transfusion_torch.models.resnet_nao import ResnetNao, ResnetNaoConfig
    from transfusion_torch.models.scnn import ScnnNao, ScnnNaoConfig
    from transfusion_torch.weights import init_random_

    heads = dict(noun_classes=HM_NOUNS, verb_classes=HM_VERBS, ttc_pred=True)
    res = dict(stage_sizes=(3, 4, 6, 3), heatmap_blocks=3, resize_spec=(H, W), **heads)
    fus = dict(token_dim=HM_TOKEN_DIM, feature_channels=HM_FEAT[3], feature_hw=HM_FEAT[1:3], **heads)
    trunk = ["conv1.weight", "layer1.0.conv1.weight", "layer3.5.conv3.weight", "heatmap_head.conv1.weight"]

    def upstream(prefix, n, first):
        return [f"{prefix}.{i}.{p}" for i in range(n) for p in (first, "linear1.weight")]

    specs = [
        ("resnet_nao", lambda: ResnetNao(ResnetNaoConfig(**res)), trunk + ["noun_classifier.weight"]),
        ("resnet_nao_multivar", lambda: ResnetNao(ResnetNaoConfig(multivar_n=True, **res)),
         trunk + ["dist_mlp.weight", "offset_stds"]),
        ("scnn_nao", lambda: ScnnNao(ScnnNaoConfig(kl_div=True, resize_spec=(H, W), **heads)),
         ["trunk.ltd_conv.0.weight", "trunk.ppm.project.0.weight", "heatmap_head.conv1.weight",
          "bottleneck_2.0.block.0.0.weight"]),
        ("fusion_asymmetric", lambda: HeatmapCrossFusion(HeatmapFusionConfig(**fus)),
         ["patch_to_token.weight", "hmap_head.linear_2.weight", "class_post_linear.weight"]
         + upstream("vis_layers", 3, "q_proj.weight") + upstream("lang_layers", 2, "q_proj.weight")),
        ("fusion_cross_transformer", lambda: HeatmapCrossFusion(HeatmapFusionConfig(
            fusion_type="cross_transformer", narr_out_mode="token_embeddings", back_to_img_fn="regroup", **fus)),
         ["patch_to_token.weight", "hmap_head.linear_2.weight", "class_post_linear.weight"]
         + upstream("layers", 2, "self_attn.in_proj_weight")),
    ]
    for name, build, watched in specs:
        yield name, (lambda build=build: init_random_(build(), seed=0).cuda()), watched


def heatmap_inputs(torch, np):
    """Seeded inputs of phase 12 on the card: images [B, H, W, 3], one box
    an image with its gaussian and gaussian_dist targets
    (data/heatmaps.py), noun / verb / TTC targets, trunk features HM_FEAT,
    a narration vector [B, 1, 300] and narration tokens [B, 64, 300] with
    half of image 0's padded."""
    from transfusion_torch.data.heatmaps import get_img_heatmap

    rng = np.random.default_rng(12)
    x1, y1 = rng.uniform(0, W * 0.6, B), rng.uniform(0, H * 0.6, B)
    boxes = np.stack([x1, y1, x1 + rng.uniform(W * 0.08, W * 0.4, B), y1 + rng.uniform(H * 0.08, H * 0.4, B)], -1)
    on = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to("cuda", dt)  # noqa: E731
    mask = np.ones((B, HM_LANG), np.int32)
    mask[0, HM_LANG // 2:] = 0
    return {
        "image": on(rng.normal(0, 1, (B, H, W, 3)).astype(np.float32)),
        "gaussian": on(np.stack([get_img_heatmap("gaussian")(b[None], H, W) for b in boxes])),
        "gaussian_dist": on(np.stack([get_img_heatmap("gaussian_dist")(b[None], H, W) for b in boxes])),
        "noun": on(rng.integers(1, HM_NOUNS, B), torch.long),
        "verb": on(rng.integers(0, HM_VERBS, B), torch.long),
        "ttc": on(rng.uniform(0.2, 2.0, B).astype(np.float32)),
        "feat": on(rng.normal(0, 1, HM_FEAT).astype(np.float32)),
        "narration": on(rng.normal(0, 1, (B, 1, HM_TOKEN_DIM)).astype(np.float32)),
        "tokens": on(rng.normal(0, 1, (B, HM_LANG, HM_TOKEN_DIM)).astype(np.float32)),
        "mask": on(mask, torch.int32),
    }


def heatmap_loss(torch, name: str, out: dict, inp: dict, gen):
    """Each model's criterion: (a), (d1), (d2) hmap_criterion mse / mean on
    the gaussian targets; (b) multivar_n_loss (16 samples, drawn from
    ``gen`` on the card) on the gaussian_dist targets; (c) kl_div with the
    criterion's agg sum (config/derive.py:114-117) on the gaussian_dist
    targets; plus cross entropy on the noun and verb logits and smooth-L1
    on the TTC."""
    import torch.nn.functional as F

    from transfusion_torch.train.losses import hmap_criterion, multivar_n_loss, smooth_l1

    if name == "resnet_nao_multivar":
        hm = multivar_n_loss({"multivar_n": 1, "no_samples": 16})(out["heatmap"], inp["gaussian_dist"], gen)
    elif name == "scnn_nao":
        hm = hmap_criterion({"kl_div": 1, "agg": "sum"}, 1)(out["heatmap"], inp["gaussian_dist"])
    else:
        hm = hmap_criterion({"mse": 1, "agg": "mean"}, 1)(out["heatmap"], inp["gaussian"])
    cls = (F.cross_entropy(out["noun_logits"].float(), inp["noun"])
           + F.cross_entropy(out["verb_logits"].float(), inp["verb"])
           + smooth_l1(out["ttc"].float() - inp["ttc"], 1.0).mean())
    return hm + cls, {"heatmap_loss": float(hm.detach()), "class_loss": float(cls.detach())}


def phase_heatmap(torch, np, smi: str):
    """Phase 12: K1 at HM_LN_SHAPES against its plain version (and its
    backward at the family's two residual shapes), timed beside
    F.layer_norm and its bound, the flagship's level-0 shapes re-timed;
    the tiny f32 fusion on the card against the CPU; then each of
    heatmap_models at B 8, 768x1024: two eval forwards and two train steps
    (forward, criterion, backward, one RAdam update through
    train/optim.py::make_optimizer) after a warm-up, launches as
    HM_EXPECTED predicts, finite outputs and losses, non-zero gradients on
    the heatmap head and upstream of every K1 norm; eval s, step s, peak
    GiB. Returns (record, JSON rows of K1 at width 300)."""
    from transfusion_torch.kernels import LAUNCHES
    from transfusion_torch.models.text_encoder import DropoutRNG
    from transfusion_torch.train.optim import make_optimizer

    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(12)
    check_ln_shapes(torch, g, [s for s in HM_LN_SHAPES if s["n"] in (769, 834) and s["d"] == 300],
                    "heatmap shapes")
    ln_times = [time_ln_shape(torch, shape, g) for shape in HM_LN_SHAPES]
    flagship = [time_ln_shape(torch, {**LN_SHAPES[i], "label": LN_SHAPES[i]["label"] + " (re-read)"}, g)
                for i in (0, 2)]
    torch.cuda.empty_cache()
    rec = {"layer_norm_shapes": ln_times, "flagship_layer_norm": flagship,
           "tiny_f32": heatmap_tiny_reference(torch, np)}
    inp = heatmap_inputs(torch, np)
    opt_cfg = flagship_run_config()["run"]["optimizer"]
    path_launches: dict = {}
    for name, build, watched in heatmap_models(torch):
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        model = build()
        build_s = time.perf_counter() - t0
        fusion = name.startswith("fusion")
        lang = (inp["tokens"], inp["mask"]) if name == "fusion_cross_transformer" else (inp["narration"], None)

        def forward(rng=None):
            if fusion:
                return model(inp["feat"], *lang, im_size=(H, W), rng=rng)
            return model(inp["image"], rng=rng)

        torch.cuda.reset_peak_memory_stats()
        model.eval()
        with torch.no_grad():
            forward()
            torch.cuda.synchronize()
            LAUNCHES.clear()
            eval_s = []
            for _ in range(HM_REQUESTS):
                t0 = time.perf_counter()
                out = forward()
                torch.cuda.synchronize()
                eval_s.append(time.perf_counter() - t0)
        per_forward = {k: v / HM_REQUESTS for k, v in LAUNCHES.items() if v}
        for k, v in LAUNCHES.items():
            path_launches[k] = path_launches.get(k, 0) + v
        flat = [v for v in out.values() if torch.is_tensor(v)] + (
            list(out["heatmap"].values()) if isinstance(out["heatmap"], dict) else [])
        if not all(torch.isfinite(t).all() for t in flat):
            raise AssertionError(f"[heatmap {name}] non-finite outputs")
        hm = out["heatmap"]
        shape = tuple(hm["loc"].shape) if isinstance(hm, dict) else tuple(hm.shape)
        if shape != ((B, 2) if isinstance(hm, dict) else (B, H, W)):
            raise AssertionError(f"[heatmap {name}] heatmap shape {shape}")
        del out

        model.train()
        params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        tx, _ = make_optimizer(opt_cfg, None, steps_per_epoch=1)
        opt_state = tx.init(params)
        gen = torch.Generator(device="cuda").manual_seed(13)

        def train_step(step: int):
            nonlocal opt_state
            model.zero_grad(set_to_none=True)
            loss, parts = heatmap_loss(torch, name, forward(DropoutRNG("cuda", 42, step)), inp, gen)
            loss.backward()
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in params.items()}
            norms = {n: float(grads[n].float().norm()) for n in watched}
            upd, opt_state = tx.update(grads, opt_state, params)
            with torch.no_grad():
                torch._foreach_add_(list(params.values()), [upd[n].to(p.dtype) for n, p in params.items()])
            return float(loss), parts, norms

        train_step(0)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        step_s, losses, norms = [], [], {}
        for k in range(HM_STEPS):
            t0 = time.perf_counter()
            loss, parts, norms = train_step(k + 1)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append({"loss": loss, **parts})
        per_step = {k: v / HM_STEPS for k, v in LAUNCHES.items() if v}
        for k, v in LAUNCHES.items():
            path_launches[k] = path_launches.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_params = sum(p.numel() for p in params.values()) / 1e6
        log(f"[heatmap {name}] {n_params:.1f} M params, built in {build_s:.1f} s; launches a forward "
            f"{per_forward}, a train step {per_step}")
        log(f"  eval s {[round(t, 4) for t in eval_s]}, step s {[round(t, 4) for t in step_s]}, peak "
            f"{peak:.2f} GiB ({held:.2f} held before the build; {smi}); losses "
            f"{[{k: round(v, 4) for k, v in m.items()} for m in losses]}; |grad| {json.dumps(norms)}")
        if not all(math.isfinite(v) for m in losses for v in m.values()):
            raise AssertionError(f"[heatmap {name}] non-finite loss {losses}")
        if not all(v > 0.0 for v in norms.values()):
            raise AssertionError(f"[heatmap {name}] zero gradient: {norms}")
        if per_forward != HM_EXPECTED[name] or per_step != HM_EXPECTED[name]:
            raise AssertionError(f"[heatmap {name}] launches a forward {per_forward} and a step {per_step}, "
                                 f"predicted {HM_EXPECTED[name]}")
        rec[name] = {"eval_s": eval_s, "step_s": step_s, "peak_gib": peak, "held_gib": held,
                     "build_s": build_s, "params_m": n_params, "launches_forward": per_forward,
                     "launches_step": per_step, "losses": losses, "grad_norms": norms, "card": smi}
        del model, params, opt_state, tx
    rec["launches"] = path_launches
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"  heatmap phase wall time {rec['phase_s']:.1f} s ({smi})")
    rows = []
    for row, label in HM_ROWS.items():
        s0 = next(s for s in ln_times if s["label"] == label)
        err = max(s["max_abs_err"] for s in ln_times if s["name"] == s0["name"] and s["d"] == 300)
        rows.append({k: s0[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
                    | {"name": row, "kernel": s0["name"], "max_abs_err": err,
                       "shapes": [s for s in ln_times if s["name"] == s0["name"]]})
    return rec, rows


def heatmap_tiny_reference(torch, np) -> dict:
    """A tiny f32 HeatmapCrossFusion (token dim 300 so K1 takes its 300-wide
    rows; a [2, 8, 12, 64] map, 2 visual and 1 language layers) of each
    fusion family on the card (TF32 off) against the same weights on the
    CPU (plain versions), every output within HM_TINY_TOL of its largest
    magnitude (at least 1); K1 launched on the card."""
    from transfusion_torch.kernels import LAUNCHES
    from transfusion_torch.models.heatmap_fusion import HeatmapCrossFusion, HeatmapFusionConfig
    from transfusion_torch.weights import init_random_

    rng = np.random.default_rng(14)
    feat = torch.from_numpy(rng.normal(0, 1, (2, 8, 12, 64)).astype(np.float32))
    toks = torch.from_numpy(rng.normal(0, 1, (2, 5, HM_TOKEN_DIM)).astype(np.float32))
    mask = torch.tensor([[1, 1, 1, 1, 1], [1, 1, 0, 0, 0]], dtype=torch.int32)
    errs = {}
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for fusion in ("asymmetric", "cross_transformer"):
            cfg = HeatmapFusionConfig(fusion_type=fusion, token_dim=HM_TOKEN_DIM, vis_layers=2, lang_layers=1,
                                      num_layers=2, feature_channels=64, feature_hw=(8, 12),
                                      narr_out_mode="embedding" if fusion == "asymmetric" else "token_embeddings",
                                      noun_classes=7, verb_classes=5, ttc_pred=True)
            cpu = init_random_(HeatmapCrossFusion(cfg), seed=3).eval()
            card = HeatmapCrossFusion(cfg).cuda().eval()
            card.load_state_dict(cpu.state_dict())
            lang = (toks[:, :1], None) if fusion == "asymmetric" else (toks, mask)
            with torch.no_grad():
                want = cpu(feat, *lang, im_size=(32, 48))
                before = LAUNCHES["residual_layer_norm"]
                got = card(feat.cuda(), *(None if t is None else t.cuda() for t in lang), im_size=(32, 48))
                torch.cuda.synchronize()
            if LAUNCHES["residual_layer_norm"] == before:
                raise AssertionError(f"[heatmap tiny {fusion}] K1 did not launch")
            for k, w in want.items():
                errs[f"{fusion} {k}"] = max_err(got[k].cpu(), w) / max(float(w.abs().max()), 1.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    for k, e in errs.items():
        check(f"[heatmap tiny f32] {k}", e, HM_TINY_TOL, "max|card - CPU| / max(max|CPU|, 1)")
    return errs


# ------------------------------------------------- phase 13: the offline tools
# The label-extraction tool (``python -m transfusion_torch.tools.label_extraction``)
# at flagship width: ``extract`` builds the detector from flagship_run_config()
# written as its three YAML tiers (EgoNaoTrainer over an annotations-only Ego4D
# v2 tree: 87 nouns, 74 verbs, no frames; seeded weights) and sweeps
# TOOL_FRAMES seeded JPEG frames at TOOL_HW in batches of B through
# make_detect_fn on the card; ``label`` matches the detections against a
# seeded annotations pickle. Each extract batch runs the eval forward once.
TOOL_FRAMES, TOOL_HW, TOOL_VIDEO = 16, (1080, 1440), "toolvid-0000"
TOOL_THRESHOLDS = (0.0, None)  # one run keeping every valid detection, one at the default 0.4
TOOL_EXPECTED = {k: v * (TOOL_FRAMES // B) for k, v in EXPECTED_PER_FORWARD.items()}  # an extract run
TOOL_TRACE = ("attn_fwd_sm90", "roi_align_fwd", "extract_batch")  # K2's and K5's symbols, the region
NATIVE_TOL = 1e-12


def tool_inputs(np, root: str) -> dict:
    """The tool's inputs under ``root``: seeded frames, the label file (the
    class names of the trainer's generated noun ids), the YAML tiers, the
    annotations tree ($DATA), the narration annotations pickle and the
    soft matches."""
    import pandas as pd
    import yaml
    from PIL import Image

    from transfusion_torch.data.annotations import V2_NOUN_OVERRIDES

    rng = np.random.default_rng(13)
    h, w = TOOL_HW
    frames = os.path.join(root, "frames")
    os.makedirs(frames)
    ids = [30 * (k + 1) for k in range(TOOL_FRAMES)]
    for f in ids:
        # Smooth colour fields with a few solid boxes: a camera frame's JPEG size, not noise's.
        img = np.asarray(Image.fromarray(rng.integers(0, 256, (9, 12, 3), dtype=np.uint8)).resize(
            (w, h), Image.BILINEAR)).copy()
        for _ in range(4):
            bh, bw = int(rng.integers(h // 18, h // 4)), int(rng.integers(w // 24, w // 5))
            y, x = int(rng.integers(0, h - bh)), int(rng.integers(0, w - bw))
            img[y:y + bh, x:x + bw] = rng.integers(0, 256, 3)
        Image.fromarray(img).save(os.path.join(frames, f"{TOOL_VIDEO}_{f:07d}.jpg"), quality=90)

    names = [f"obj{i:02d}" for i in range(87)]
    verbs = [f"act{i:02d}" for i in range(74)]
    vids = ["toolclip-0", "toolclip-1"]
    ann_dir = os.path.join(root, "data", "Ego4d", "v2", "annotations")
    os.makedirs(ann_dir)
    for subset, n, start in (("train", 87, 1000), ("val", B, 9000)):
        anns = []
        for k in range(n):
            x, y = float(rng.uniform(0, 0.6) * w), float(rng.uniform(0, 0.6) * h)
            anns.append({"uid": f"{vids[k % 2]}_{start + 30 * k:07d}", "video_uid": vids[k % 2],
                         "frame": start + 30 * k, "clip_id": k % 2,
                         "objects": [{"box": [x, y, x + 0.2 * w, y + 0.2 * h], "noun_category_id": k % 87,
                                      "verb_category_id": k % 74, "time_to_contact": 0.5}]})
        with open(os.path.join(ann_dir, f"fho_sta_{subset}.json"), "w") as f:
            json.dump({"noun_categories": [{"id": i, "name": s} for i, s in enumerate(names)],
                       "verb_categories": [{"id": i, "name": s} for i, s in enumerate(verbs)],
                       "info": {"video_metadata": {v: {"fps": 30.0, "frame_height": h, "frame_width": w}
                                                   for v in vids}},
                       "annotations": anns}, f)
    # Generated noun ids are 1-based over the sorted names (0: background).
    class_names = ["background"] + sorted(V2_NOUN_OVERRIDES.get(i, s) for i, s in enumerate(names))
    label_file = os.path.join(root, "labels.json")
    with open(label_file, "w") as f:
        json.dump({"categories": [{"name": s} for s in class_names]}, f)

    cfg = flagship_run_config()
    tiers = {"model": dict(cfg["model"], verb_classifier={"type": False, "representation_size": 512}),
             "fusion": cfg["run"]["narr_fusion"]}
    paths = {k: os.path.join(root, f"{k}.yml") for k in ("model", "fusion", "run")}
    run = dict(cfg, model=paths["model"], run=dict(cfg["run"], narr_fusion={"config": paths["fusion"]}))
    for k, v in (*tiers.items(), ("run", run)):
        with open(paths[k], "w") as f:
            yaml.safe_dump(v, f)

    annots = pd.DataFrame([{"start_frame": s, "narration_id": f"{TOOL_VIDEO}_{i}", "narration": f"take {n}",
                            "starting_ms": s / 0.03, "fps": 30.0, "verb": "take", "all_nouns": [n]}
                           for i, (s, n) in enumerate(((0, "cup"), (200, "cup"), (500, "plate")))])
    annots_pkl = os.path.join(root, "annots.pkl")
    annots.to_pickle(annots_pkl)
    soft = {"no_matches": [], "actions": {"obj_only": [], "take_closest_to_hand": [], "take_all_instances": []},
            "cup": {"default": class_names[1:]}, "plate": {"default": class_names[::-1][:-1]}}
    soft_path = os.path.join(root, "soft.json")
    with open(soft_path, "w") as f:
        json.dump({"ego4d": soft}, f)
    return {"frames": frames, "ids": ids, "data": os.path.join(root, "data"), "label_file": label_file,
            "class_names": class_names, "config": paths["run"], "annots": annots, "annots_pkl": annots_pkl,
            "soft": soft, "soft_path": soft_path}


def tool_reference(torch, np, trainer, inp: dict, thresh: float) -> list:
    """The detections the tool's detector should give: each batch read and
    transformed as make_detect_fn does, through the port's make_eval_step on
    the tool's trainer, thresholded and scaled back to the frame."""
    from transfusion_torch.data.readers import Ego4dJpgReader
    from transfusion_torch.data.transforms import transform_example
    from transfusion_torch.train.step import make_eval_step

    step = make_eval_step(trainer.model, trainer.model_cfg.detector,
                          noun_verb_frequencies=trainer.noun_verb_freqs)
    reader = Ego4dJpgReader(inp["frames"], TOOL_VIDEO)
    bucket = tuple(trainer.aug.eval_bucket())
    out = []
    for lo in range(0, TOOL_FRAMES, B):
        imgs = [reader.get_frame(f) for f in inp["ids"][lo:lo + B]]
        ims = [transform_example(np.random.default_rng(0), img, np.zeros((0, 4), np.float32), trainer.aug,
                                 bucket, training=False)[0] for img in imgs]
        ids, mask = trainer.tokenizer.encode_batch([""] * len(imgs))
        db = trainer._device_batch({"image": np.stack(ims), "input_ids": ids, "attention_mask": mask,
                                    "image_hw": bucket}, with_targets=False)
        dets = {k: v.cpu().numpy() for k, v in step(db).items()}
        for i, img in enumerate(imgs):
            v = dets["valid"][i] & (dets["scores"][i] >= thresh)
            sx, sy = img.shape[1] / bucket[1], img.shape[0] / bucket[0]
            out.append((dets["nouns"][i][v], dets["scores"][i][v],
                        dets["boxes"][i][v] * np.array([sx, sy, sx, sy], np.float32)))
    return out


def phase_tools(torch, np, smi: str) -> dict:
    """extract (twice) and label through the tool's CLI, held against the
    eval step; one extract batch traced; the native STA matcher against the
    numpy one on phase 6's result JSON; phase 6's plot."""
    import importlib.util
    import shutil
    from dataclasses import replace

    import pandas as pd
    from torch.autograd import DeviceType

    from transfusion_torch.kernels import LAUNCHES
    from transfusion_torch.metrics import STAMeanAveragePrecision, native
    from transfusion_torch.models.transfusion import flagship_config
    from transfusion_torch.runner.trainer import EgoNaoTrainer
    from transfusion_torch.tools import label_extraction as le
    from transfusion_torch.utils import profiling

    t_phase = time.perf_counter()
    root = os.path.join(HERE, "chiprun_out", "tools_run")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    inp = tool_inputs(np, root)
    log(f"[tools] inputs written in {time.perf_counter() - t0:.1f} s: {TOOL_FRAMES} frames "
        f"{TOOL_HW[0]}x{TOOL_HW[1]} ({sum(os.path.getsize(os.path.join(inp['frames'], f)) for f in os.listdir(inp['frames'])) / 2 ** 20:.1f} MiB of JPEG)")
    made = []  # (trainer, detect, its outputs) of each extract run
    make_detect_fn = EgoNaoTrainer.make_detect_fn

    def spy(self, *args, **kwargs):
        fn = make_detect_fn(self, *args, **kwargs)
        outs = []

        def detect(images):
            outs.append(fn(images))
            return outs[-1]

        detect.timer = fn.timer
        made.append((self, detect, outs))
        return detect

    want_cfg = flagship_config()
    want_cfg = replace(want_cfg, detector=replace(want_cfg.detector, stop_grad_stages=0))
    rec: dict = {"runs": []}
    data_env = os.environ.get("DATA")
    os.environ["DATA"] = inp["data"]
    EgoNaoTrainer.make_detect_fn = spy
    try:
        for thresh in TOOL_THRESHOLDS:
            out_dir = os.path.join(root, f"extract_{thresh}")
            argv = ["extract", "--frames-dir", inp["frames"], "--video", TOOL_VIDEO, "--out-dir", out_dir,
                    "--config", inp["config"], "--label-file", inp["label_file"], "--batch-size", str(B)]
            argv += [] if thresh is None else ["--score-thresh", str(thresh)]
            torch.cuda.synchronize()
            LAUNCHES.clear()
            t0 = time.perf_counter()
            summary = le.main(argv)  # no --device: the tool's default, the card
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            trainer, detect, outs = made[-1]
            if trainer.device.type != "cuda" or trainer.model_cfg != want_cfg:
                raise AssertionError(f"[tools] the tool's detector: {trainer.device}, "
                                     f"{trainer.model_cfg} vs the flagship's {want_cfg}")
            got = {k: launches.get(k, 0) for k in set(launches) | set(TOOL_EXPECTED)}
            want = {k: TOOL_EXPECTED.get(k, 0) for k in got}
            log(f"  extract at threshold {thresh if thresh is not None else 'default 0.4'}: "
                f"{summary['rows']} rows of {summary['frames']} frames in {wall:.2f} s (trainer built "
                f"inside); ms a batch {summary['stage_ms']}; launches {got} (expected {want})")
            if got != want:
                raise AssertionError("[tools] extract did not launch the kernels as predicted")
            ref = tool_reference(torch, np, trainer, inp, 0.4 if thresh is None else thresh)
            flat = [d for batch in outs for d in batch]
            if len(flat) != len(ref) or not all(
                    _bits_equal(np, a, b) for x, y in zip(flat, ref) for a, b in zip(x, y)):
                raise AssertionError("[tools] the detector's outputs differ from make_eval_step's")
            check_csv = os.path.join(root, f"reference_{thresh}.csv")
            le.write_detections_csv(pd.DataFrame(le.detections_to_rows(inp["ids"], ref, inp["class_names"]),
                                                 columns=["Frame_no", "Classes", "Scores", "Bboxes"]), check_csv)
            with open(summary["out"], "rb") as a, open(check_csv, "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"[tools] {summary['out']} differs from the eval step's rows")
            kept = sum(len(d[0]) for d in flat)
            log(f"  every row equals make_eval_step's detections slot by slot, bit for bit ({kept} detections)")
            rec["runs"].append({"threshold": thresh, "rows": summary["rows"], "detections": kept,
                                "wall_s": wall, "stage_ms": summary["stage_ms"], "launches": got})
        if rec["runs"][0]["rows"] == 0:
            raise AssertionError("[tools] the low threshold kept no detection")

        # label, on the low-threshold detections; the same call in this process.
        csv = os.path.join(root, f"extract_{TOOL_THRESHOLDS[0]}", f"{TOOL_VIDEO}_detections.csv")
        out = le.main(["label", "--detections-csv", csv, "--annotations-pkl", inp["annots_pkl"],
                       "--video", TOOL_VIDEO, "--soft-matches", inp["soft_path"], "--out-dir",
                       os.path.join(root, "label"), "--dataset", "ego4d"])
        want = le.label_video(le.read_detections_csv(csv), inp["annots"], inp["soft"], 1)
        pd.testing.assert_frame_equal(pd.read_pickle(out["out"][:-len("csv")] + "pkl"), want)
        if len(want) == 0:
            raise AssertionError("[tools] label matched nothing")
        log(f"  label: {out['rows']} NAO rows, equal to label_video on the same CSV")
        rec["label_rows"] = out["rows"]

        # One extract batch under the profiler.
        trainer, detect, _ = made[-1]
        from transfusion_torch.data.readers import Ego4dJpgReader

        reader = Ego4dJpgReader(inp["frames"], TOOL_VIDEO)
        imgs = [reader.get_frame(f) for f in inp["ids"][:B]]
        trace_dir = os.path.join(root, "trace")
        t0 = time.perf_counter()
        with profiling.trace(trace_dir) as prof:
            with profiling.annotate("extract_batch"):
                detect(imgs)
        wall_ms = (time.perf_counter() - t0) * 1e3
        path = os.path.join(trace_dir, profiling.TRACE_FILE)
        with open(path) as f:
            text = f.read()
        missing = [k for k in TOOL_TRACE if k not in text]
        # The annotated region has a device-side range of its own: not a kernel.
        on_card = sorted((e for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA and e.key != "extract_batch"),
                         key=lambda e: e.self_device_time_total, reverse=True)
        busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
        top = {e.key[:60]: e.self_device_time_total / 1e3 for e in on_card[:8]}
        log(f"  traced extract batch: {wall_ms:.1f} ms under the profiler, device busy {busy_ms:.2f} ms; "
            f"trace {os.path.getsize(path) / 2 ** 20:.1f} MiB names {[k for k in TOOL_TRACE if k in text]}; "
            f"top device ms {json.dumps({k: round(v, 3) for k, v in top.items()})}")
        os.remove(path)
        if missing:
            raise AssertionError(f"[tools] the trace names none of {missing}")
        rec["trace"] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "top_device_ms": top}
        del trainer, detect, prof
    finally:
        EgoNaoTrainer.make_detect_fn = make_detect_fn
        if data_env is None:
            os.environ.pop("DATA", None)
        else:
            os.environ["DATA"] = data_env
        made.clear()
        gc.collect()
        torch.cuda.empty_cache()

    # The native STA matcher on phase 6's exported detections.
    if not native.native_available():
        raise AssertionError("[tools] the native STA matcher did not build")
    with open(os.path.join(HERE, "chiprun_out", "trainer_run", "results", "val_epoch0.json")) as f:
        results = json.load(f)["results"]
    val = trainer_data(np).val_ds.examples  # phase 6's examples (same seed)
    class NumpyMatcher(STAMeanAveragePrecision):
        def _try_native(self, *args):
            return None

    maps = {}
    for use_native in (True, False):
        metric = (STAMeanAveragePrecision if use_native else NumpyMatcher)(top_k=5)
        t0 = time.perf_counter()
        for ex in val:
            e = results[ex["id"]]
            metric.add({"boxes": np.asarray([d["box"] for d in e], np.float64).reshape(-1, 4),
                        "scores": np.asarray([d["score"] for d in e], np.float64),
                        "nouns": np.asarray([d["noun_category_id"] for d in e]),
                        "verbs": np.asarray([d["verb_category_id"] for d in e]),
                        "ttcs": np.asarray([d["time_to_contact"] for d in e], np.float64)},
                       {k: ex[k] for k in ("boxes", "nouns", "verbs", "ttcs")})
        maps[use_native] = (np.asarray(metric.evaluate()), time.perf_counter() - t0, np.concatenate(metric._tp))
    gap = float(np.nanmax(np.abs(maps[True][0] - maps[False][0]))) if np.isfinite(maps[True][0]).any() else 0.0
    same_nan = np.array_equal(np.isnan(maps[True][0]), np.isnan(maps[False][0]))
    same_tp = np.array_equal(maps[True][2], maps[False][2], equal_nan=True)
    log(f"  STA mAP of phase 6's JSON, native {maps[True][0].round(4).tolist()} ({maps[True][1] * 1e3:.1f} ms) "
        f"vs numpy ({maps[False][1] * 1e3:.1f} ms): max gap {gap:.3g} (tolerance {NATIVE_TOL}); tp arrays "
        f"{'equal' if same_tp else 'DIFFER'}, {int(np.nansum(maps[True][2]))} true positives over 8 measures")
    if gap > NATIVE_TOL or not same_nan or not same_tp:
        raise AssertionError("[tools] the native matcher's mAP differs from the numpy matcher's")
    rec["native"] = {"gap": gap, "native_ms": maps[True][1] * 1e3, "numpy_ms": maps[False][1] * 1e3,
                     "map": maps[True][0].tolist(), "true_positives": int(np.nansum(maps[True][2]))}

    plot = os.path.join(HERE, "chiprun_out", "trainer_run", "plots", "val", "epoch_000.jpg")
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    rec["plot"] = os.path.isfile(plot)
    log(f"  phase 6's fit {'wrote its plot ' + plot if rec['plot'] else 'ran without a plot'} "
        f"(matplotlib {'present' if has_mpl else 'absent'})")
    if has_mpl and not rec["plot"]:
        raise AssertionError("[tools] matplotlib is present but phase 6 wrote no plot")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"  tools phase wall time {rec['phase_s']:.1f} s ({smi})")
    return rec


# ------------------------------------------- phase 14: the fusion levels rematerialised
# flagship_config(remat_fusion=True) against False on the train slice's
# input (B 8, then B 32), seeded weights, token dropout 0.15, the same
# parameters, batch and (seed, step) for every run.
REMAT_BATCHES = (B, 32)
REMAT_SEED, REMAT_STEP = 3, 5
# A warm-up, then plain / remat / remat / plain: two runs of each setting
# give each its run-to-run gap, the floor the remat-vs-plain gap is held to.
# The warm-up is a remat step: it warms the shapes of both settings, and a
# process's first checkpoint imports torch._dynamo (seconds, once).
REMAT_ORDER = ("remat", "plain", "remat", "remat", "plain")
# A remat step launches the train slice's kernels and, in its backward, each
# fusion level's forward again up to its back-projection: K1's 4 final and
# 32 residual norms and K2 once a level; K3-K6 as before.
EXPECTED_REMAT_STEP = dict(EXPECTED_PER_STEP, layer_norm=5 + 4, residual_layer_norm=56 + 32,
                           attention_fwd_dropout=4 + 4)
# Single-level roi_align on K5: a stride-16 bf16 map of an 800 x 1088 image
# [50, 68, 256] and 512 RoIs.
ROI_SINGLE = (50, 68, 256, 512)
# Phase 10 (e): the model-axis remat step reissues each fusion layer's two
# forward all-reduces in the recompute; the recompute stops at the
# back-projection's product, before that product's all-reduce.
TP_REMAT_EXTRA = 2 * 16


def remat_runs(torch, model, step, opt_init, batch, lw, mult, order=REMAT_ORDER) -> list:
    """One train step for each setting of ``order`` ("plain" or "remat": the
    model's ``remat_fusion``), each from the same parameters, a fresh
    optimizer state (``opt_init()``) and the same (seed, step): the loss,
    every parameter after the step (on the CPU), step s, peak GiB from fresh
    peak statistics, kernel launches and model-group collectives. The
    parameters are put back after the last run."""
    import dataclasses

    from transfusion_torch.kernels import LAUNCHES
    from transfusion_torch.parallel import tensor_parallel as tp
    from transfusion_torch.train.step import TrainState

    cuda = model.device.type == "cuda"
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    cfgs = {on: dataclasses.replace(model.tcfg, remat_fusion=on == "remat") for on in ("plain", "remat")}
    runs = []
    for setting in order:
        model.tcfg = cfgs[setting]
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(start[k])
        state = TrainState(step=REMAT_STEP, opt_state=opt_init(), seed=REMAT_SEED)
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        before = dict(tp.COLLECTIVES)
        t0 = time.perf_counter()
        m = step(state, batch, lw, mult)
        if cuda:
            torch.cuda.synchronize()
        s = time.perf_counter() - t0
        if m["nonfinite_skipped"] != 0.0 or not math.isfinite(float(m["loss"])):
            raise AssertionError(f"[remat] a {setting} step went non-finite or was skipped: {m}")
        runs.append({"setting": setting, "loss": float(m["loss"]), "s": s,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0,
                     "launches": dict(LAUNCHES),
                     "collectives": {k: v - before[k] for k, v in tp.COLLECTIVES.items()},
                     "params": {k: p.detach().to("cpu", copy=True) for k, p in params.items()}})
    model.tcfg = cfgs["plain"]
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(start[k])
    del start
    return runs


def remat_gaps(torch, runs: list) -> dict:
    """Of the last four runs (plain / remat / remat / plain): the largest |difference|
    of any parameter after the step and of the loss, remat against plain,
    and the floor each is held to, twice the larger run-to-run gap of a
    setting (0 where both settings repeat bit for bit)."""
    def gap(a, b):
        worst = 0.0
        for k, v in a["params"].items():
            if not torch.equal(v, b["params"][k]):
                worst = max(worst, float((v.double() - b["params"][k].double()).abs().max()))
        return worst, abs(a["loss"] - b["loss"])

    p1, r1, r2, p2 = runs[-4:]
    update, loss = gap(p1, r1)
    floors = [gap(p1, p2), gap(r1, r2)]
    out = {"update_max_abs": update, "loss_abs": loss,
           "update_floor": 2 * max(f[0] for f in floors), "loss_floor": 2 * max(f[1] for f in floors),
           "loss_plain": p1["loss"], "loss_remat": r1["loss"]}
    if out["update_max_abs"] > out["update_floor"] or out["loss_abs"] > out["loss_floor"]:
        raise AssertionError(f"[remat] the remat step differs from the plain step beyond the "
                             f"run-to-run floor: {out}")
    return out


def check_single_level_roi_align(torch) -> dict:
    """Single-level ``roi_align`` on the card: K5 launched once a call on a
    one-level bf16 map (ROI_SINGLE), at sampling ratios 0 and 2, against
    ``roi_align_plain`` on the same one-level pyramid; a map whose pixel
    does not fill whole 16-byte vectors raises rather than falling back."""
    from transfusion_torch.kernels import LAUNCHES
    from transfusion_torch.ops import roi_align as ra

    h, w, c, n = ROI_SINGLE
    g = torch.Generator(device="cuda").manual_seed(11)
    feat = torch.randn(h, w, c, device="cuda", generator=g).to(torch.bfloat16)
    xy = torch.rand(n, 2, device="cuda", generator=g) * torch.tensor([w * 16.0, h * 16.0], device="cuda")
    rois = torch.cat([xy, xy + 8 + 600 * torch.rand(n, 2, device="cuda", generator=g)], 1)
    rec = {"shape": [h, w, c], "rois": n}
    for ratio in (0, 2):
        before = LAUNCHES["roi_align_fwd"]
        got = ra.roi_align(feat, rois, 1 / 16, 7, ratio)
        launched = LAUNCHES["roi_align_fwd"] - before
        params = ra.roi_sample_params(rois[None], [(h, w)], [0], (h * 16, w * 16), 7, ratio)
        want = ra.roi_align_plain(feat[None], params)[0]
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(f"roi_align single level bf16 [{h}, {w}, {c}], {n} RoIs, sampling ratio {ratio}", err,
              3.2e-2)  # bf16 output, f32 sums in both, as the multiscale check
        if launched != 1 or tuple(got.shape) != (n, 7, 7, c):
            raise AssertionError(f"single-level roi_align launched K5 {launched} times, shape "
                                 f"{tuple(got.shape)}")
        rec[f"ratio_{ratio}"] = {"max_abs_err": err, "launches": launched,
                                 "ms": cuda_ms(lambda: ra.roi_align(feat, rois, 1 / 16, 7, ratio), 10)}
    try:
        ra.roi_align(feat[..., :4].contiguous(), rois, 1 / 16)
    except ValueError as e:
        rec["refused"] = str(e)
    else:
        raise AssertionError("roi_align ran K5 on a map of 8-byte pixels")
    log(f"  single-level roi_align: K5 {rec['ratio_0']['ms']:.4f} / {rec['ratio_2']['ms']:.4f} ms "
        f"(ratio 0 / 2); 4 bf16 channels refused: {rec['refused']}")
    return rec


def remat_batch(torch, np, bsz: int) -> dict:
    """The train slice's input at ``bsz`` images: seeded images, LANG_LEN
    tokens, one GT box an image."""
    rng = np.random.default_rng(bsz)
    dev = "cuda"
    return {
        "image": torch.from_numpy(rng.normal(0, 0.7, (bsz, H, W, 3)).astype(np.float32)).to(dev),
        "input_ids": torch.from_numpy(rng.integers(0, 30000, (bsz, LANG_LEN))).to(dev),
        "attention_mask": torch.ones(bsz, LANG_LEN, dtype=torch.int64, device=dev), "image_hw": (H, W),
        "targets": {
            "boxes": torch.tensor([[[100.0, 100.0, 400.0, 400.0]]], device=dev).repeat(bsz, 1, 1),
            "nouns": torch.full((bsz, 1), 2, device=dev), "verbs": torch.full((bsz, 1), 1, device=dev),
            "ttcs": torch.full((bsz, 1), 0.9, device=dev),
            "valid": torch.ones(bsz, 1, dtype=torch.bool, device=dev)}}


def phase_remat(torch, np, smi: str) -> dict:
    """Phase 14: the flagship train step with the fusion levels
    rematerialised (``flagship_config(remat_fusion=True)``) against the
    plain step, at B 8 and at B 32 (768x1024, seeded weights, token dropout
    0.15, the train slice's optimizer and freeze rules): a warm-up, then
    plain / remat / remat / plain from the same parameters, batch and
    (seed, step); the loss and every parameter's update within the
    run-to-run floor (remat_gaps; predicted equal), launches a step as
    EXPECTED_PER_STEP and EXPECTED_REMAT_STEP predict, step s and peak GiB
    of each, and remat's peak below plain's at each B. First, single-level
    ``roi_align`` on K5 (check_single_level_roi_align)."""
    from transfusion_torch.models.transfusion import TransFusion, flagship_config
    from transfusion_torch.runner.trainer import unfreeze_multipliers
    from transfusion_torch.train.optim import make_optimizer
    from transfusion_torch.train.step import LossConfig, criterion_weights, make_train_step
    from transfusion_torch.weights import init_random_

    t_phase = time.perf_counter()
    log(f"[remat] single-level roi_align; then the flagship train step with remat_fusion at B "
        f"{REMAT_BATCHES}, {H}x{W}, runs {REMAT_ORDER} ({smi})")
    rec: dict = {"card": smi, "roi_align_single": check_single_level_roi_align(torch)}
    cfg = flagship_config(remat_fusion=True)
    model = init_random_(TransFusion(cfg, device="cuda"), seed=0)
    nn_, nv = cfg.detector.roi.num_nouns, cfg.detector.roi.num_verbs
    tx, _ = make_optimizer({"name": "radam", "lr": 1e-4, "weight_decay": 1e-5}, None, 100)
    mult = unfreeze_multipliers(model.named_parameters(), 0,
                                {"type": "res50", "train_ep": -1, "trainable_layers": 2}, -1, 1,
                                cfg.bert.num_layers)
    step = make_train_step(model, tx, LossConfig(rpn_batch_size_per_image=256, last_noun_idx=nn_ - 1),
                           torch.ones(nn_), torch.ones(nv))
    lw = criterion_weights({"bbox": 1, "obj_prop": 1, "noun": 1, "verb": 1})
    for bsz in REMAT_BATCHES:
        runs = remat_runs(torch, model, step, lambda: tx.init(dict(model.named_parameters())),
                          remat_batch(torch, np, bsz), lw, mult)
        gaps = remat_gaps(torch, runs)
        for r in runs[1:]:
            want = EXPECTED_REMAT_STEP if r["setting"] == "remat" else EXPECTED_PER_STEP
            got = {k: r["launches"].get(k, 0) for k in want}
            if got != want:
                raise AssertionError(f"[remat] B {bsz}: a {r['setting']} step launched {got}, "
                                     f"predicted {want}")
        by = {s: [r for r in runs[1:] if r["setting"] == s] for s in ("plain", "remat")}
        out = {s: {"step_s": [r["s"] for r in rs], "peak_gib": max(r["peak_gib"] for r in rs),
                   "launches": rs[0]["launches"]} for s, rs in by.items()}
        out.update(gaps, warmup_s=runs[0]["s"])
        rec[f"b{bsz}"] = out
        log(f"  B {bsz}: step s plain {[round(t, 4) for t in out['plain']['step_s']]}, remat "
            f"{[round(t, 4) for t in out['remat']['step_s']]}; peak GiB plain "
            f"{out['plain']['peak_gib']:.2f}, remat {out['remat']['peak_gib']:.2f}; loss "
            f"{gaps['loss_plain']!r} / {gaps['loss_remat']!r} (|diff| {gaps['loss_abs']:.3g}, floor "
            f"{gaps['loss_floor']:.3g}); max |update diff| {gaps['update_max_abs']:.3g} (floor "
            f"{gaps['update_floor']:.3g}); launches a remat step "
            f"{ {k: out['remat']['launches'].get(k, 0) for k in EXPECTED_REMAT_STEP} }")
        if not out["remat"]["peak_gib"] < out["plain"]["peak_gib"]:
            raise AssertionError(f"[remat] B {bsz}: remat's peak {out['remat']['peak_gib']:.2f} GiB is "
                                 f"not below plain's {out['plain']['peak_gib']:.2f} GiB")
        del runs
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"  remat phase wall time {rec['phase_s']:.1f} s ({smi})")
    return rec


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
    torch.cuda.empty_cache()
    fusion_rec = phase_fusion_options(torch, np, smi)
    torch.cuda.empty_cache()
    towers_rec = phase_towers(torch, np, smi, "--profile" in sys.argv[1:])
    torch.cuda.empty_cache()
    dp_rec = phase_data_parallel(torch, np, smi)
    torch.cuda.empty_cache()
    tp_rec = phase_tensor_parallel(torch, np, smi)
    gc.collect()
    torch.cuda.empty_cache()
    backbones_rec = phase_backbones(torch, np, smi)
    gc.collect()
    torch.cuda.empty_cache()
    heatmap_rec, heatmap_rows = phase_heatmap(torch, np, smi)
    gc.collect()
    torch.cuda.empty_cache()
    tools_rec = phase_tools(torch, np, smi)
    gc.collect()
    torch.cuda.empty_cache()
    remat_rec = phase_remat(torch, np, smi)

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
                        "data_parallel_launches": dp_rec["a"]["launches"].get(r["name"], 0),
                        "remat_step_launches": remat_rec[f"b{B}"]["remat"]["launches"].get(r["name"], 0),
                        **({"tflop_s": r["flops"] / (r["ms"] * 1e-3) / 1e12} if "flops" in r else {}),
                        **{k: r[k] for k in ("ms_bhnd", "ms_kernel", "pack_ms", "pack_bwd_ms", "shapes") if k in r}})
        log(f"[{r['name']}] kernel {r['ms']:.4f} ms ({records[-1]['pct_of_bound']:.1f} % of bound), plain "
            f"{r['plain_ms']:.4f} ms, library "
            f"{'n/a' if r['library_ms'] is None else format(r['library_ms'], '.4f') + ' ms'}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    for r in heatmap_rows:
        rows.append({
            "name": r["name"], "route": "cuda", "source": SOURCES[r["name"]], "replaces": REPLACES[r["name"]],
            "launches": heatmap_rec["launches"].get(r["kernel"], 0), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
        records.append({**rows[-1], "pct_of_bound": 100.0 * r["bound_ms"] / r["ms"], "shapes": r["shapes"]})
        log(f"[{r['name']}] kernel {r['ms']:.4f} ms ({records[-1]['pct_of_bound']:.1f} % of bound), plain "
            f"{r['plain_ms']:.4f} ms, library "
            f"{'n/a' if r['library_ms'] is None else format(r['library_ms'], '.4f') + ' ms'}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), {rows[-1]['launches']} launches in phase 12")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "torch": torch.__version__, "kernels": records, "slice": slice_rec,
                   "train": train_rec, "trainer": trainer_rec, "fusion_options": fusion_rec, "towers": towers_rec,
                   "data_parallel": dp_rec, "tensor_parallel": tp_rec, "backbones": backbones_rec,
                   "heatmap": heatmap_rec, "tools": tools_rec, "remat": remat_rec,
                   "ptxas": ptxas,
                   "build": {k: v for k, v in kernels.BUILD_LOG.items() if k != "ptxas"}}, f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
