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
``csrc/roi_align.cu`` (K5) forward and ``csrc/roi_align_bwd.cu`` (K6,
port of ``roi_align_pallas.py::_bwd_kernel``) backward; on a CPU pyramid it
runs :func:`roi_align_plain` and :func:`roi_align_bwd_plain`.
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
    offset (off); and, as the kernels read them, "fparams" [B, R, 8] f32
    (y1, x1, bh, bw, hl, wl, count_inv, 0) and "iparams" [B, R, 4] int32
    (ry, rx, off, 0), stacked here once for a forward and its backward."""
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
    hl, wl, off = heights[lvl], widths[lvl], offs[lvl]
    return {
        "lvl": lvl, "y1": y1, "x1": x1, "bh": bh, "bw": bw, "ry": ry, "rx": rx,
        "count_inv": count_inv, "hl": hl, "wl": wl, "off": off,
        # The same, stacked once as the kernels read them.
        "fparams": torch.stack([y1, x1, bh, bw, hl, wl, count_inv, torch.zeros_like(y1)], dim=-1),
        "iparams": torch.stack([ry, rx, off, torch.zeros_like(ry)], dim=-1),
    }


def _bilinear_corners(params, output_size: int, w_max: int):
    """The forward's sample grid, one sample (iy, ix) at a time up to this
    batch's largest (ry, rx): for each sample the four bilinear corners as
    (packed cell index [B, R, P, P], weight [B, R, P, P] f32), the weight 0
    for samples outside the level or beyond the RoI's own (ry, rx)."""
    p = output_size
    dev = params["y1"].device
    ry, rx = params["ry"], params["rx"]
    ryf = torch.clamp(ry.float(), min=1.0)[..., None, None]
    rxf = torch.clamp(rx.float(), min=1.0)[..., None, None]
    hl = params["hl"][..., None, None]
    wl = params["wl"][..., None, None]
    off = params["off"].to(torch.int64)[..., None, None]
    pr = torch.arange(p, dtype=torch.float32, device=dev)
    max_ry = max(int(ry.max()), 0) if ry.numel() else 0
    max_rx = max(int(rx.max()), 0) if rx.numel() else 0
    # Sample offsets as tensors: a true division by ry, as the kernels and the
    # JAX package divide (a Python float over a tensor would multiply by the
    # reciprocal instead).
    half = torch.arange(max(max_ry, max_rx), dtype=torch.float32, device=dev) + 0.5
    shape = params["y1"].shape + (p, p)
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
            corners = []
            for yy, wy in ((y0, 1 - ly), (y1i, ly)):
                for xx, wx in ((x0, 1 - lx), (x1i, lx)):
                    cell = (yy.to(torch.int64) + off) * w_max + xx.to(torch.int64)
                    corners.append((cell.expand(shape), (wy * wx * ok).expand(shape)))
            yield corners


def roi_align_plain(packed, params, output_size: int = 7):
    """Plain PyTorch statement of K5: gathers the four bilinear corners of
    every bin's sample at once, one sample of the grid at a time; sums in
    f32."""
    bsz, h_tot, w_max, c = packed.shape
    n = params["bh"].shape[1]
    p = output_size
    flat = packed.reshape(bsz, h_tot * w_max, c).float()
    bidx = torch.arange(bsz, device=packed.device)[:, None]
    acc = torch.zeros((bsz, n, p, p, c), dtype=torch.float32, device=packed.device)
    for corners in _bilinear_corners(params, p, w_max):
        val = 0.0
        for cell, w in corners:
            g = flat[bidx, cell.reshape(bsz, -1)].reshape(bsz, n, p, p, c)
            val = val + w[..., None] * g
        acc += val
    out = acc * params["count_inv"][..., None, None, None]
    return out.to(packed.dtype)


def roi_align_bwd_plain(grad_out, params, packed_shape, dtype, output_size: int = 7):
    """Plain PyTorch statement of K6: the gradient with respect to the packed
    pyramid, every sample's bilinear weights x grad_out x count_inv
    scatter-added (f32) into the cells the forward read, then cast once to
    the pyramid's dtype."""
    bsz, h_tot, w_max, c = packed_shape
    g = grad_out.float() * params["count_inv"][..., None, None, None]
    acc = torch.zeros((bsz * h_tot * w_max, c), dtype=torch.float32, device=grad_out.device)
    base = (torch.arange(bsz, device=grad_out.device) * (h_tot * w_max))[:, None, None, None]
    for corners in _bilinear_corners(params, output_size, w_max):
        for cell, w in corners:
            acc.index_add_(0, (cell + base).reshape(-1), (w[..., None] * g).reshape(-1, c))
    return acc.reshape(packed_shape).to(dtype)


def _axis_span(start, size, count, extent, output_size: int):
    """Cells [lo, hi] along one axis that a RoI's samples can reach: the
    clamped first and last sample, placed as the forward places them, and
    the `+ 1` corner of the last, clamped into [0, extent - 1]. The sample
    coordinate is monotone along the axis, so the ends bound every sample."""
    countf = torch.clamp(count.float(), min=1.0)
    ends = []
    # Tensor over tensor: a true division, as in _bilinear_corners.
    for bin_, half in ((0.0, torch.full_like(countf, 0.5)), (float(output_size - 1), countf - 0.5)):
        pos = start + size * (bin_ + half / countf)
        ends.append(torch.floor(torch.minimum(torch.clamp(pos, min=0.0), extent - 1)))
    lo = torch.minimum(ends[0], ends[1])
    hi = torch.minimum(torch.maximum(ends[0], ends[1]) + 1, extent - 1)
    return lo.to(torch.int32), hi.to(torch.int32)


def roi_footprints(params, output_size: int = 7):
    """Per-RoI rectangle of packed pyramid cells the RoI's bilinear samples
    can read (forward) or write (backward), [B, R, 4] int32: first row,
    last row (packed rows, the level's offset added), first column, last
    column, all inclusive. A RoI with no samples (ry or rx 0) gets the empty
    rectangle rows [0, -1], columns [0, -1]. K5 and K6 compute the same
    rectangle on the card (``csrc/roi_align.cuh::footprint``): K5 reads its
    window, K6 tests it against each output tile."""
    ylo, yhi = _axis_span(params["y1"], params["bh"], params["ry"], params["hl"], output_size)
    xlo, xhi = _axis_span(params["x1"], params["bw"], params["rx"], params["wl"], output_size)
    off = params["off"].to(torch.int32)
    empty = (params["ry"] <= 0) | (params["rx"] <= 0)
    foot = torch.stack([ylo + off, yhi + off, xlo, xhi], dim=-1)
    return torch.where(empty[..., None], torch.tensor([0, -1, 0, -1], dtype=torch.int32,
                                                      device=foot.device), foot)


def _kernel_params(params, device):
    fparams, iparams = params["fparams"], params["iparams"]
    kernels.require(fparams.device == device and iparams.device == device
                    and fparams.dtype == torch.float32 and iparams.dtype == torch.int32
                    and fparams.is_contiguous() and iparams.is_contiguous(),
                    "roi_align: fparams / iparams as roi_sample_params stacks them, on the pyramid's device")
    return fparams, iparams


def _check_pyramid(name, t):
    kernels.require(t.dtype in (torch.bfloat16, torch.float32), f"{name}: dtype {t.dtype}")
    kernels.require(t.is_contiguous(), f"{name}: tensors must be contiguous")
    kernels.require(t.shape[-1] * t.element_size() % 16 == 0 and t.data_ptr() % 16 == 0,
                    f"{name}: a pixel's channels must fill whole 16-byte vectors, 16-byte aligned")


def _roi_align_cuda(packed, params, output_size: int):
    bsz, h_tot, w_max, c = packed.shape
    n = params["bh"].shape[1]
    _check_pyramid("roi_align", packed)
    kernels.require(output_size <= 32, "roi_align: output size must be <= 32")
    fparams, iparams = _kernel_params(params, packed.device)
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


def _roi_align_bwd_cuda(grad_out, params, packed_shape, dtype, output_size: int):
    bsz, h_tot, w_max, c = packed_shape
    n = params["bh"].shape[1]
    _check_pyramid("roi_align backward", grad_out)
    kernels.require(output_size <= 8, "roi_align backward: output size must be <= 8")
    kernels.require(grad_out.dtype == dtype and grad_out.shape == (bsz, n, output_size, output_size, c),
                    "roi_align backward: grad_out must be [B, R, P, P, C] in the pyramid's dtype")
    # K6 writes every cell of the gradient, zeros included: no zeroed
    # accumulator, no cast. With no RoI it still runs, writing zeros.
    grad = torch.empty(packed_shape, dtype=dtype, device=grad_out.device)
    fparams, iparams = _kernel_params(params, grad_out.device)
    code = kernels.library().tf_roi_align_bwd(
        grad_out.data_ptr(), fparams.data_ptr(), iparams.data_ptr(), grad.data_ptr(),
        bsz, n, h_tot, w_max, c, output_size, int(dtype == torch.bfloat16),
        kernels.stream_handle(grad_out.device),
    )
    kernels.check(code, "tf_roi_align_bwd")
    kernels.LAUNCHES["roi_align_bwd"] += 1
    return grad


def roi_align_bwd(grad_out, params, packed_shape, dtype, output_size: int = 7):
    """Gradient with respect to the packed pyramid: K6 on CUDA, else plain."""
    if grad_out.device.type == "cpu":
        return roi_align_bwd_plain(grad_out, params, packed_shape, dtype, output_size)
    return _roi_align_bwd_cuda(grad_out, params, packed_shape, dtype, output_size)


class _RoIAlign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, params, output_size):
        ctx.params, ctx.output_size = params, output_size
        ctx.packed_shape, ctx.dtype = tuple(packed.shape), packed.dtype
        if packed.device.type == "cpu":
            return roi_align_plain(packed, params, output_size)
        return _roi_align_cuda(packed, params, output_size)

    @staticmethod
    def backward(ctx, grad_out):
        grad = roi_align_bwd(grad_out.contiguous(), ctx.params, ctx.packed_shape, ctx.dtype,
                             ctx.output_size)
        return grad, None, None


def pooled_from_packed(packed, params, output_size: int = 7):
    """Pool every RoI from a packed pyramid, differentiably with respect to
    the pyramid: K5 forward and K6 backward on CUDA, else the plain
    versions."""
    return _RoIAlign.apply(packed, params, output_size)


def multiscale_roi_align(feats: dict, rois, image_hw, output_size: int = 7,
                         sampling_ratio: int = 0):
    """feats {"0".."3": [B, H_l, W_l, C]}, rois [B, R, 4] in image
    coordinates -> [B, R, P, P, C] in the pyramid's dtype. The gradient
    flows back through the packing to every level."""
    packed, shapes, offsets = pack_pyramid(feats)
    params = roi_sample_params(rois.detach().float(), shapes, offsets, image_hw, output_size,
                               sampling_ratio)
    return pooled_from_packed(packed, params, output_size)
