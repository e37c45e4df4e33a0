"""Multiscale RoIAlign (aligned=True, adaptive sampling) over a packed FPN
pyramid: kernel K5 and its plain version.

Port of ``transfusion_tpu/ops/roi_align.py`` (the XLA path ``_pooled_xla``
and the dispatch in ``multiscale_roi_align``) and of the Pallas forward
``ops/roi_align_pallas.py::_fwd_kernel``. Each RoI is pooled at its
canonical FPN level (torchvision LevelMapper: k0 4, canonical size 224) with
``ceil(bin)`` samples per bin per axis, torchvision's border rules, and a
divide by ``max(ry * rx, 1)``.

Layouts follow the JAX package: levels are channels-last ``[B, H, W, C]``,
the packed pyramid ``[B, H_tot, W_max, C]``, the output ``[B, R, P, P, C]``.
On a CUDA pyramid :func:`multiscale_roi_align` launches
``csrc/roi_align.cu``; on a CPU pyramid it runs :func:`roi_align_plain`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from transfusion_torch import kernels


def fpn_levels(rois, num_levels: int = 4):
    """Canonical FPN level index in [0, num_levels) per RoI (LevelMapper)."""
    area = torch.clamp(rois[:, 2] - rois[:, 0], min=0) * torch.clamp(rois[:, 3] - rois[:, 1], min=0)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224.0 + 1e-6))
    return (torch.clamp(lvl, 2, 2 + num_levels - 1) - 2).to(torch.int64)


def pack_pyramid(feats: dict):
    """Stack levels "0".."3" vertically at a common width.

    Returns (packed [B, sum(H_l), max W, C], level shapes, row offsets). The
    padding columns of narrower levels are never addressed: samples are
    clamped into their own level.
    """
    keys = sorted([k for k in feats if k.isdigit()], key=int)
    shapes = [tuple(feats[k].shape[1:3]) for k in keys]
    max_w = max(w for _, w in shapes)
    offsets = [0]
    for h, _ in shapes:
        offsets.append(offsets[-1] + h)
    packed = torch.cat(
        [F.pad(feats[k], (0, 0, 0, max_w - feats[k].shape[2])) for k in keys], dim=1
    ).contiguous()
    return packed, shapes, offsets[:-1]


def roi_sample_params(rois, shapes, offsets, image_hw, output_size: int, sampling_ratio: int):
    """Per-RoI level assignment and adaptive sampling parameters, each [B, R]:
    level-relative start (y1, x1), bin sizes (bh, bw), sample counts (ry, rx,
    0 allowed), 1 / max(ry * rx, 1), level extent (hl, wl) and packed row
    offset (off)."""
    bsz, n = rois.shape[:2]
    dev = rois.device
    heights = torch.tensor([h for h, _ in shapes], dtype=torch.float32, device=dev)
    widths = torch.tensor([w for _, w in shapes], dtype=torch.float32, device=dev)
    offs = torch.tensor(offsets, dtype=torch.int32, device=dev)
    lvl = fpn_levels(rois.reshape(-1, 4), len(shapes)).reshape(bsz, n)
    scale = heights[lvl] / float(image_hw[0])
    x1 = rois[..., 0] * scale - 0.5
    y1 = rois[..., 1] * scale - 0.5
    x2 = rois[..., 2] * scale - 0.5
    y2 = rois[..., 3] * scale - 0.5
    bh = (y2 - y1) / output_size
    bw = (x2 - x1) / output_size
    if sampling_ratio > 0:
        ry = torch.full((bsz, n), sampling_ratio, dtype=torch.int32, device=dev)
        rx = ry
    else:
        ry = torch.ceil(bh).to(torch.int32)
        rx = torch.ceil(bw).to(torch.int32)
    count_inv = 1.0 / torch.clamp(ry * rx, min=1).to(torch.float32)
    return {
        "lvl": lvl, "y1": y1, "x1": x1, "bh": bh, "bw": bw, "ry": ry, "rx": rx,
        "count_inv": count_inv, "hl": heights[lvl], "wl": widths[lvl], "off": offs[lvl],
    }


def roi_align_plain(packed, params, output_size: int = 7):
    """Plain PyTorch statement of the kernel: loops over the sample grid up
    to this batch's largest (ry, rx), gathering the four bilinear corners of
    every bin's sample at once; sums in f32."""
    p = output_size
    bsz, h_tot, w_max, c = packed.shape
    dev = packed.device
    n = params["bh"].shape[1]
    flat = packed.reshape(bsz, h_tot * w_max, c).float()
    ry, rx = params["ry"], params["rx"]
    ryf = torch.clamp(ry.float(), min=1.0)[..., None, None]
    rxf = torch.clamp(rx.float(), min=1.0)[..., None, None]
    hl = params["hl"][..., None, None]
    wl = params["wl"][..., None, None]
    off = params["off"].to(torch.int64)[..., None, None]
    pr = torch.arange(p, dtype=torch.float32, device=dev)
    bidx = torch.arange(bsz, device=dev)[:, None]
    acc = torch.zeros((bsz, n, p, p, c), dtype=torch.float32, device=dev)
    max_ry = max(int(ry.max()), 0) if ry.numel() else 0
    max_rx = max(int(rx.max()), 0) if rx.numel() else 0
    # Sample offsets as tensors: a true division by ry, as the kernel and the
    # JAX package divide (a Python float over a tensor would multiply by the
    # reciprocal instead).
    half = torch.arange(max(max_ry, max_rx), dtype=torch.float32, device=dev) + 0.5
    for iy in range(max_ry):
        y = params["y1"][..., None, None] + params["bh"][..., None, None] * (
            pr[:, None] + half[iy] / ryf)                                 # [B, R, P, 1]
        ok_y = (iy < ry)[..., None, None] & (y >= -1.0) & (y <= hl)
        yc = torch.minimum(torch.clamp(y, min=0.0), hl - 1)
        y0 = torch.floor(yc)
        y1i = torch.minimum(y0 + 1, hl - 1)
        ly = yc - y0
        for ix in range(max_rx):
            x = params["x1"][..., None, None] + params["bw"][..., None, None] * (
                pr[None, :] + half[ix] / rxf)                             # [B, R, 1, P]
            ok = ok_y & (ix < rx)[..., None, None] & (x >= -1.0) & (x <= wl)
            xc = torch.minimum(torch.clamp(x, min=0.0), wl - 1)
            x0 = torch.floor(xc)
            x1i = torch.minimum(x0 + 1, wl - 1)
            lx = xc - x0
            val = 0.0
            for yy, wy in ((y0, 1 - ly), (y1i, ly)):
                for xx, wx in ((x0, 1 - lx), (x1i, lx)):
                    cell = ((yy.to(torch.int64) + off) * w_max + xx.to(torch.int64))
                    cell = cell.expand(bsz, n, p, p).reshape(bsz, -1)
                    g = flat[bidx, cell].reshape(bsz, n, p, p, c)
                    val = val + (wy * wx * ok)[..., None] * g
            acc += val
    out = acc * params["count_inv"][..., None, None, None]
    return out.to(packed.dtype)


def _roi_align_cuda(packed, params, output_size: int):
    bsz, h_tot, w_max, c = packed.shape
    n = params["bh"].shape[1]
    kernels.require(packed.dtype in (torch.bfloat16, torch.float32), f"roi_align: dtype {packed.dtype}")
    kernels.require(packed.is_contiguous(), "roi_align: packed pyramid must be contiguous")
    kernels.require(c * packed.element_size() % 16 == 0 and packed.data_ptr() % 16 == 0,
                    "roi_align: a pixel's channels must fill whole 16-byte vectors, 16-byte aligned")
    kernels.require(output_size <= 32, "roi_align: output size must be <= 32")
    fparams = torch.stack(
        [params["y1"], params["x1"], params["bh"], params["bw"], params["hl"], params["wl"],
         params["count_inv"], torch.zeros_like(params["y1"])], dim=-1,
    ).to(device=packed.device, dtype=torch.float32).contiguous()
    iparams = torch.stack(
        [params["ry"], params["rx"], params["off"], torch.zeros_like(params["ry"])], dim=-1,
    ).to(device=packed.device, dtype=torch.int32).contiguous()
    out = torch.empty((bsz, n, output_size, output_size, c), dtype=packed.dtype, device=packed.device)
    if n == 0:
        return out
    code = kernels.library().tf_roi_align_fwd(
        packed.data_ptr(), fparams.data_ptr(), iparams.data_ptr(), out.data_ptr(),
        bsz, n, h_tot, w_max, c, output_size, int(packed.dtype == torch.bfloat16),
        kernels.stream_handle(packed.device),
    )
    kernels.check(code, "tf_roi_align_fwd")
    kernels.LAUNCHES["roi_align_fwd"] += 1
    return out


def pooled_from_packed(packed, params, output_size: int = 7):
    """Pool every RoI from a packed pyramid: the kernel on CUDA, else plain."""
    if packed.device.type == "cpu":
        return roi_align_plain(packed, params, output_size)
    return _roi_align_cuda(packed, params, output_size)


def multiscale_roi_align(feats: dict, rois, image_hw, output_size: int = 7,
                         sampling_ratio: int = 0):
    """feats {"0".."3": [B, H_l, W_l, C]}, rois [B, R, 4] in image
    coordinates -> [B, R, P, P, C] in the pyramid's dtype."""
    packed, shapes, offsets = pack_pyramid(feats)
    params = roi_sample_params(rois.float(), shapes, offsets, image_hw, output_size, sampling_ratio)
    return pooled_from_packed(packed, params, output_size)
