#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``transfusion_torch``).

    python3 chip_smoke.py [--profile]

Needs one CUDA card (an H100 is what the numbers are read against) and the
CUDA toolkit; exits non-zero at once without a card. Phases:

1. build the hand-written kernels (``transfusion_torch/csrc/*.cu``) for
   sm_90a and print the build time;
2. for each kernel entry (LayerNorm, residual LayerNorm, attention forward,
   RoIAlign forward), at the flagship eval path's shapes in bf16 plus one
   f32 case: the kernel against its plain PyTorch version (max |diff|
   against a stated tolerance), kernel / plain / library-call times from
   CUDA events, and the least time the card could take (bound_ms, from the
   H100 SXM data-sheet rates 3.35 TB/s, 989 TFLOP/s bf16 tensor, 67 TFLOP/s
   f32);
3. a small-input reference check: the tiny f32 model's trunk on the card
   (kernels) against the same weights on the CPU (plain versions);
4. the slice: the flagship eval forward + ``detections_from_outputs`` at
   B 8, 768x1024, 64 language tokens, seeded random weights, for a few
   requests; frames/s, mean kept detections, and the kernel launch counts
   of that run, which must be LN 36 / attention 4 / RoIAlign 1 a forward.

With ``--profile`` a fifth phase times each stage of the forward and
traces one request with ``torch.profiler`` (device-busy share, top kernels).

The last three lines of stdout are the ``kernels`` JSON line, the card's
name and power limit (nvidia-smi), and ``{"ok": true, "device": ...}``.
Any failed phase exits non-zero without the ``ok`` line. A full record goes
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
B, H, W, LANG_LEN = 8, 768, 1024, 64
REQUESTS = 10  # the request is host-bound and varies; ten give a steadier mean
HBM_BPS = 3.35e12          # H100 SXM HBM3
BF16_TC_FLOPS = 989e12     # dense bf16 tensor cores
F32_FLOPS = 67e12          # f32 outside the tensor cores
EXPECTED_PER_FORWARD = {"layer_norm": 4, "residual_layer_norm": 32, "attention_fwd": 4,
                        "roi_align_fwd": 1}
REPLACES = {
    "layer_norm": "transfusion_tpu/ops/layer_norm.py:55",
    "residual_layer_norm": "transfusion_tpu/ops/layer_norm.py:59",
    "attention_fwd": "transfusion_tpu/ops/attention.py:226",
    "roi_align_fwd": "transfusion_tpu/ops/roi_align_pallas.py:267",
}
SOURCES = {
    "layer_norm": "transfusion_torch/csrc/layer_norm.cu",
    "residual_layer_norm": "transfusion_torch/csrc/layer_norm.cu",
    "attention_fwd": "transfusion_torch/csrc/attention.cu",
    "roi_align_fwd": "transfusion_torch/csrc/roi_align.cu",
}


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


def check(name: str, err: float, tol: float, measure: str = "max|kernel - plain|") -> None:
    log(f"  {name}: {measure} = {err:.3e} (tolerance {tol:.1e})")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain version ({err} > {tol})")


# ------------------------------------------------------------------ phases
def phase_layer_norm(torch, residual: bool):
    from transfusion_torch.ops import layer_norm as ln

    g = torch.Generator(device="cuda").manual_seed(1)
    d = 896
    # Level 0 of the flagship fusion: norm1/norm2 see B*3136 rows, final_norm B*3072.
    rows = B * (3136 if residual else 3072)
    x = torch.randn(rows, d, device="cuda", generator=g).mul_(3).add_(1).to(torch.bfloat16)
    r = torch.randn(rows, d, device="cuda", generator=g).to(torch.bfloat16) if residual else None
    w = torch.randn(d, device="cuda", generator=g).mul_(0.2).add_(1)
    b = torch.randn(d, device="cuda", generator=g).mul_(0.2)
    name = "residual_layer_norm" if residual else "layer_norm"
    log(f"[{name}] rows {rows} x {d} bf16")
    got = ln.fused_layer_norm(x, w, b, residual=r)
    want = ln.layer_norm_plain(x, w, b, residual=r)
    torch.cuda.synchronize()
    err = max_err(got, want)
    check(f"{name} bf16", err, 3.2e-2)  # one bf16 ulp for |y| < 8
    xf = torch.randn(999, d, device="cuda", generator=g) * 3
    rf = torch.randn(999, d, device="cuda", generator=g) if residual else None
    check(f"{name} f32", max_err(ln.fused_layer_norm(xf, w, b, residual=rf),
                                 ln.layer_norm_plain(xf, w, b, residual=rf)), 1e-4)
    ms = cuda_ms(lambda: ln.fused_layer_norm(x, w, b, residual=r), 50)
    plain = cuda_ms(lambda: ln.layer_norm_plain(x, w, b, residual=r), 10)
    lib = None if residual else cuda_ms(lambda: torch.nn.functional.layer_norm(x, (d,), w.to(x.dtype), b.to(x.dtype), 1e-6), 50)
    nbytes = rows * d * 2 * (3 if residual else 2) + 2 * d * 4
    bms, by = bound_ms(nbytes, rows * d * (9 if residual else 8), F32_FLOPS)
    return {"name": name, "max_abs_err": err, "ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bms, "bound_by": by}


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
            "library_ms": lib, "bound_ms": bms, "bound_by": by}


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


def _roi_touched_bytes(torch, params, shapes, h_tot, w_max, c, elt):
    """Bytes of pyramid cells inside the union of the RoIs' sample
    footprints (each read once): rectangles marked with a 2-D difference
    array."""
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
    diff = torch.zeros(bsz, h_tot + 1, w_max + 1, device="cuda")
    bi = torch.arange(bsz, device="cuda")[:, None].expand(bsz, n)
    one = torch.where(empty, 0.0, 1.0)
    ya, yb = (y0.long() + off), (y1.long() + off + 1)
    xa, xb = x0.long(), x1.long() + 1
    for yy, xx, s in ((ya, xa, 1.0), (ya, xb, -1.0), (yb, xa, -1.0), (yb, xb, 1.0)):
        diff.index_put_((bi, yy, xx), one * s, accumulate=True)
    cover = diff.cumsum(1).cumsum(2)[:, :h_tot, :w_max] > 0.5
    return int(cover.sum()) * c * elt


def phase_roi_align(torch):
    from transfusion_torch.ops import roi_align as ra

    g = torch.Generator(device="cuda").manual_seed(3)
    c, n = 256, 1000
    sizes = [(H // 4, W // 4), (H // 8, W // 8), (H // 16, W // 16), (H // 32, W // 32)]
    log(f"[roi_align_fwd] pyramid {sizes} x {c} bf16, rois [{B}, {n}, 4]")
    feats = {str(i): torch.randn(B, h, w, c, device="cuda", generator=g).to(torch.bfloat16)
             for i, (h, w) in enumerate(sizes)}
    rois = _synthetic_rois(torch, g, B, n, (H, W))
    packed, shapes, offsets = ra.pack_pyramid(feats)
    params = ra.roi_sample_params(rois, shapes, offsets, (H, W), 7, 0)
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
    plain = cuda_ms(lambda: ra.roi_align_plain(packed, params), 1, warmup=1)
    samples = float((params["ry"] * params["rx"]).sum()) * 49
    touched = _roi_touched_bytes(torch, params, shapes, packed.shape[1], packed.shape[2], c, 2)
    bms, by = bound_ms(touched + got.numel() * 2 + rois.numel() * 4, samples * c * 8, F32_FLOPS)
    log(f"  {samples:.0f} bilinear samples, {touched / 1e6:.1f} MB of pyramid touched")
    return {"name": "roi_align_fwd", "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "library_ms": None, "bound_ms": bms, "bound_by": by}


def _tiny_cfg():
    from transfusion_torch.models.detector import DetectorConfig
    from transfusion_torch.models.roi_heads import RoIConfig
    from transfusion_torch.models.rpn import RPNConfig
    from transfusion_torch.models.text_encoder import BertConfig
    from transfusion_torch.models.transfusion import FusionConfig, TransFusionConfig

    return TransFusionConfig(
        detector=DetectorConfig(
            roi=RoIConfig(num_nouns=7, num_verbs=5, representation_size=64, detections_per_img=10,
                          score_thresh=0.01, ttc_on=True, additional_postprocessing=True),
            rpn=RPNConfig(pre_nms_top_n_test=64, post_nms_top_n_test=32, score_thresh=0.01),
            stage_sizes=(1, 1, 1, 1)),
        fusion=FusionConfig(fpn_features=(0, 3), patch_h=(1, 1), patch_w=(1, 1), num_layers=(1, 1),
                            token_dim=64, num_heads=2, use_flash_attention=True),
        bert=BertConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                        intermediate_size=32, max_position_embeddings=16),
        out_mlp=64)


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
    if LAUNCHES["attention_fwd"] != 1 or LAUNCHES["residual_layer_norm"] != 4:
        raise AssertionError(f"small reference did not take the kernels: {dict(LAUNCHES)}")
    worst = 0.0
    for key in ref:
        scale = float(ref[key].abs().max())
        worst = max(worst, max_err(got[key].cpu(), ref[key]) / scale)
    check("tiny f32 trunk on the card vs the CPU", worst, 1e-4, "max|card - cpu| / max|cpu|")
    if not torch.isfinite(out["roi_outputs"]["class_logits"]).all():
        raise AssertionError("non-finite RoI outputs in the small reference run")
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


def phase_profile(torch, model, cfg, batch, freqs):
    """Where a request's time goes: each stage of the forward timed on the
    host clock between synchronisations (so stages do not overlap), then one
    request under torch.profiler for the device-busy share and the top
    kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            detections_from_outputs(model(batch), cfg.detector, noun_verb_frequencies=freqs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels only: an operator's own entry repeats the time of the kernels it launched.
    kernels_run = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels_run) / 1e3
    top = sorted(kernels_run, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    log(f"[profile] profiled request {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"(idle share {1 - busy_ms / wall_ms:.3f})")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return {"stage_ms": stage_ms, "profiled_request_ms": wall_ms, "device_busy_ms": busy_ms,
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
    for src, text in kernels.BUILD_LOG.get("ptxas", {}).items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    results = [phase_layer_norm(torch, False), phase_layer_norm(torch, True),
               phase_attention(torch), phase_roi_align(torch)]
    phase_small_reference(torch)
    slice_rec, slice_state = phase_slice(torch, np)
    if "--profile" in sys.argv[1:]:
        slice_rec["profile"] = phase_profile(torch, *slice_state)

    rows = []
    for r in results:
        rows.append({
            "name": r["name"], "route": "cuda", "source": SOURCES[r["name"]],
            "replaces": REPLACES[r["name"]], "launches": slice_rec["launches"].get(r["name"], 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
        log(f"[{r['name']}] kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{'n/a' if r['library_ms'] is None else format(r['library_ms'], '.4f') + ' ms'}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "torch": torch.__version__, "kernels": rows, "slice": slice_rec,
                   "build": {k: v for k, v in kernels.BUILD_LOG.items() if k != "ptxas"}}, f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
