"""``paddle.vision.ops`` of the port: the detection operators.

Reference: ``paddle_tpu/vision/ops.py`` (XLA composites, no Pallas) and,
for ``psroi_pool`` and ``yolo_loss``, the host loops of
``paddle_tpu/fluid/layers.py:2365-2407`` and ``:2570-2636``. Here every
operator is a PyTorch composite on the device of its inputs (a numpy
input goes to ``set_device``'s place, else the card), in float32 or
float64, with autograd through every floating input; nothing moves to the
CPU. Where the reference's arithmetic depends on the order of a greedy
loop, the port computes the same answer in bulk:

- ``nms`` / ``multiclass_nms``: the greedy rule (keep box ``i`` when no
  kept box before it in score order overlaps it above the threshold) has
  one solution, the fixed point of ``keep[i] = ~any_j(keep[j] & by[i, j])``
  over the strictly-lower overlap mask ``by``. :func:`_sweep` iterates it from
  all-true: after pass ``t`` the first ``t`` entries are final, so it
  ends in at most ``k`` passes, with one host read every
  ``SWEEP_PASSES_PER_READ`` passes. The passes grow with the longest
  chain of boxes each of which frees the next by being suppressed; a
  line of ``k`` boxes, each overlapping only its neighbours, in score
  order, takes ``k``. ``chip_smoke.py`` phase 14 counts them on proposals
  clustered as a region-proposal network's are. Scores sort stably, as
  the reference's ``argsort(-s)``, so ties keep index order.
- ``roi_align`` / ``roi_pool`` gather the sampled points of each RoI from
  an NHWC copy of ``x`` (``[R, Sy, Sx, C]`` a corner) and never copy a
  whole feature map per RoI, as the reference's ``x[batch_idx]`` does.
- ``psroi_pool`` takes each bin's mean from a float64 summed-area table
  (channels last): four lookups a bin over the reference's bin edges.
- ``yolo_loss`` assigns targets for every ground truth at once; where two
  land on one cell, the last (in the reference's image-then-box order)
  writes ``obj_mask`` and the box targets, and the class targets are the
  union of their labels. Unlike the reference, whose loss is built from
  host arrays, its loss takes a gradient to ``x``.

Host reads: ``nms``'s kept list and :func:`_sweep`'s convergence checks,
``distribute_fpn_proposals``' one read of the RoIs (host metadata in the
reference too), and a ``boxes_num`` given as a device tensor is used on
the device without a read.
"""
from __future__ import annotations

import io as _io

import numpy as np
import torch

from ..core.tensor import as_port, as_tensor_arg, to_tensor
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer import Layer

__all__ = ["nms", "roi_align", "RoIAlign", "roi_pool", "RoIPool",
           "psroi_pool", "PSRoIPool", "yolo_box", "yolo_loss", "box_coder",
           "DeformConv2D", "deform_conv2d", "distribute_fpn_proposals",
           "generate_proposals", "iou_similarity", "box_clip", "prior_box",
           "anchor_generator", "bipartite_match", "multiclass_nms",
           "read_file", "decode_jpeg"]

#: passes of :func:`_sweep` between two reads of its convergence flag
SWEEP_PASSES_PER_READ = 4
#: fixed-point passes :func:`_sweep` has run in this process (read and
#: reset through the module)
sweep_passes = 0


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _to_device(values, dev, dtype=None):
    """Host values (numpy or a list) on ``dev`` without a blocking copy: a
    synchronous host-to-device copy would wait for the device."""
    t = torch.as_tensor(np.asarray(values))
    return t.to(dev, dtype, non_blocking=True)


def _rois_per_image(boxes_num, rois):
    """Each RoI's image index on ``rois``' device: ``boxes_num[i]`` RoIs
    of image ``i`` in order. A device tensor of counts is used where it
    lies (no host read); host counts must sum to the RoI count."""
    dev = rois.device
    if isinstance(boxes_num, torch.Tensor):
        counts = boxes_num.to(dev, torch.long)
    else:
        host = np.asarray(boxes_num).astype(np.int64).reshape(-1)
        if int(host.sum()) != rois.shape[0]:
            raise ValueError(f"boxes_num sums to {int(host.sum())}, not the "
                             f"{rois.shape[0]} RoIs given")
        counts = _to_device(host, dev)
    return torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), counts,
        output_size=rois.shape[0])


# ---------------------------------------------------------------------- iou
def _box_iou(a, b):
    """IoU matrix between boxes [N, 4] and [M, 4] (x1, y1, x2, y2)."""
    area_a = torch.clamp(a[:, 2] - a[:, 0], min=0) * torch.clamp(
        a[:, 3] - a[:, 1], min=0)
    area_b = torch.clamp(b[:, 2] - b[:, 0], min=0) * torch.clamp(
        b[:, 3] - b[:, 1], min=0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-10)


def _pixel_iou(a, b):
    """IoU in pixel coordinates: +1 on widths and heights."""
    def area(v):
        return (v[:, 2] - v[:, 0] + 1) * (v[:, 3] - v[:, 1] + 1)

    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt + 1, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def _overlaps(iou, threshold):
    """``iou > threshold`` as 0 / 1 in :func:`_sweep`'s product dtype:
    bfloat16 on the card (half float32's bytes), float32 elsewhere."""
    return (iou > threshold).to(torch.bfloat16 if iou.is_cuda
                                else torch.float32)


def _sweep(by):
    """The greedy keep mask of every row of ``by`` ``[..., k, k]`` (0 / 1,
    :func:`_overlaps`; ``by[..., i, j]`` is 1 where ``j < i`` and box ``j``
    suppresses box ``i`` if kept): the unique ``keep`` with ``keep[i] =
    ~any_j(keep[j] & by[i, j])``, iterated to its fixed point from
    all-true. A pass is one batched product: a row's count of kept
    suppressors, a sum of non-negative terms, is 0 exactly when it has
    none, whatever the product's precision."""
    global sweep_passes
    keep = torch.ones(by.shape[:-1], dtype=torch.bool, device=by.device)
    k = by.shape[-1]
    done = 0
    while done < k:
        for _ in range(SWEEP_PASSES_PER_READ):
            prev = keep
            hits = torch.matmul(by, prev.to(by.dtype).unsqueeze(-1))
            keep = hits.squeeze(-1) == 0
            done += 1
        sweep_passes += SWEEP_PASSES_PER_READ
        if torch.equal(keep, prev):
            break
    return keep


def _desc_order(s, dim=-1):
    """Indices sorting ``s`` by descending value, ties in index order (the
    reference's stable ``argsort(-s)``)."""
    return torch.sort(s, dim=dim, descending=True, stable=True).indices


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Hard NMS (reference: ``paddle_tpu/vision/ops.py:42``): the indices of
    the kept boxes in descending score order (scores default to the given
    order), int64, at most ``top_k``. With ``category_idxs`` a box is
    suppressed only by boxes of its own category; ``categories`` is
    accepted and unused, as in the reference."""
    b = as_tensor_arg(boxes)
    n = b.shape[0]
    s = (as_tensor_arg(scores, b) if scores is not None else
         torch.arange(n, 0, -1, dtype=torch.float32, device=b.device))
    with torch.no_grad():
        order = _desc_order(s)
        b_sorted = b[order]
        iou = _box_iou(b_sorted, b_sorted)
        if category_idxs is not None:  # suppressed only within a category
            c = as_tensor_arg(category_idxs, b)[order]
            iou = torch.where(c[:, None] == c[None, :], iou, 0.0)
        # IoU is symmetric: row i of the overlaps names i's suppressors
        kept = order[_sweep(_overlaps(iou, iou_threshold).tril_(-1))]
    if top_k is not None:
        kept = kept[:top_k]
    return as_port(kept.to(torch.int64))


# ----------------------------------------------------------------- roi align
def _gather_nhwc(x_nhwc, bidx, yi, xi):
    """``x_nhwc[bidx, yi, xi]`` over a sampling grid: ``bidx`` [R],
    ``yi`` [R, Sy], ``xi`` [R, Sx] -> [R, Sy, Sx, C]."""
    return x_nhwc[bidx[:, None, None], yi[:, :, None], xi[:, None, :]]


def _grid(start, extent, count, div):
    """Sample positions ``start + extent * (j + 0.5) / div`` for ``j`` in
    ``range(count)``: [R, count] in ``start``'s dtype. The fractions are
    formed in float64 and rounded once, as the reference's weakly typed
    ``(arange + 0.5) / div``."""
    frac = ((torch.arange(count, dtype=torch.float64, device=start.device)
             + 0.5) / div).to(start.dtype)
    return start[:, None] + extent[:, None] * frac[None, :]


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign (reference: ``paddle_tpu/vision/ops.py:82-136``). ``x``
    [N, C, H, W], ``boxes`` [R, 4] (x1, y1, x2, y2 in image coordinates),
    ``boxes_num`` RoIs per image -> [R, C, oh, ow]: the mean of ``ratio``
    x ``ratio`` bilinear samples a bin (``ratio`` 2 when
    ``sampling_ratio <= 0``), the corners clipped into the map."""
    xv = as_tensor_arg(x)
    bv = as_tensor_arg(boxes, xv)
    oh, ow = _pair(output_size)
    ratio = 2 if sampling_ratio <= 0 else sampling_ratio
    H, W = xv.shape[2], xv.shape[3]
    bidx = _rois_per_image(boxes_num, bv)
    off = 0.5 if aligned else 0.0
    b = bv * spatial_scale
    x1, y1, x2, y2 = (b[:, i] - off for i in range(4))
    least = 1e-3 if aligned else 1.0
    bin_w = torch.clamp(x2 - x1, min=least) / ow
    bin_h = torch.clamp(y2 - y1, min=least) / oh
    gy = _grid(y1, bin_h, oh * ratio, ratio)   # [R, Sy]
    gx = _grid(x1, bin_w, ow * ratio, ratio)   # [R, Sx]
    y0 = torch.clamp(torch.floor(gy), 0, H - 1)
    x0 = torch.clamp(torch.floor(gx), 0, W - 1)
    y1i = torch.clamp(y0 + 1, 0, H - 1).long()
    x1i = torch.clamp(x0 + 1, 0, W - 1).long()
    y0i, x0i = y0.long(), x0.long()
    wy1 = torch.clamp(gy - y0, 0, 1)
    wx1 = torch.clamp(gx - x0, 0, 1)
    wy0, wx0 = 1 - wy1, 1 - wx1
    x_nhwc = xv.permute(0, 2, 3, 1).contiguous()
    out = None  # corners one at a time, each added into ``out`` in place
    for yi, wy, xi, wx in ((y0i, wy0, x0i, wx0), (y0i, wy0, x1i, wx1),
                           (y1i, wy1, x0i, wx0), (y1i, wy1, x1i, wx1)):
        corner = _gather_nhwc(x_nhwc, bidx, yi, xi)  # [R, Sy, Sx, C]
        weight = (wy[:, :, None] * wx[:, None, :])[..., None]
        out = (corner * weight if out is None
               else out.addcmul_(corner, weight))
    R, C = out.shape[0], out.shape[-1]
    pooled = out.reshape(R, oh, ratio, ow, ratio, C).mean(dim=(2, 4))
    return as_port(pooled.permute(0, 3, 1, 2).contiguous())


class RoIAlign(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """RoI max pooling (reference: ``paddle_tpu/vision/ops.py:150-181``):
    the max of a 4 x 4 nearest-neighbour sampling of each bin. Its
    gradient (which the reference does not record) splits among equal
    maxima, as JAX's ``max`` does."""
    xv = as_tensor_arg(x)
    bv = as_tensor_arg(boxes, xv)
    oh, ow = _pair(output_size)
    ratio = 4
    H, W = xv.shape[2], xv.shape[3]
    bidx = _rois_per_image(boxes_num, bv)
    b = bv * spatial_scale
    x1, y1 = b[:, 0], b[:, 1]
    rw = torch.clamp(b[:, 2] - x1, min=1.0)
    rh = torch.clamp(b[:, 3] - y1, min=1.0)
    gy = _grid(y1, rh, oh * ratio, oh * ratio)
    gx = _grid(x1, rw, ow * ratio, ow * ratio)
    yi = torch.clamp(torch.round(gy - 0.5), 0, H - 1).long()
    xi = torch.clamp(torch.round(gx - 0.5), 0, W - 1).long()
    samples = _gather_nhwc(xv.permute(0, 2, 3, 1), bidx, yi, xi)
    R, C = samples.shape[0], samples.shape[-1]
    pooled = samples.reshape(R, oh, ratio, ow, ratio, C).amax(dim=(2, 4))
    return as_port(pooled.permute(0, 3, 1, 2).contiguous())


class RoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI average pooling (reference:
    ``paddle_tpu/vision/ops.py:662``, computed by
    ``paddle_tpu/fluid/layers.py:2365-2407``): output bin ``(i, j)`` of
    channel ``oc`` is the mean of input channel ``oc * oh * ow + i * ow +
    j`` over the bin's window, ``floor`` / ``ceil`` edges clipped into the
    map, at least one pixel before clipping, 0 where clipping empties it.
    Each mean is four lookups into a float64 summed-area table; the output
    has ``x``'s dtype."""
    xv = as_tensor_arg(x)
    rv = as_tensor_arg(boxes, xv)
    oh, ow = _pair(output_size)
    n, c, h, w = xv.shape
    if c % (oh * ow):
        raise ValueError(f"psroi_pool: input channels ({c}) must be a "
                         f"multiple of output_size^2 ({oh}*{ow})")
    oc = c // (oh * ow)
    bidx = (_rois_per_image(boxes_num, rv) if boxes_num is not None
            else torch.zeros(rv.shape[0], dtype=torch.long, device=rv.device))
    r = rv * spatial_scale
    x1, y1, x2, y2 = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    bh = torch.clamp(y2 - y1, min=0.1) / oh
    bw = torch.clamp(x2 - x1, min=0.1) / ow

    def edges(start, size, bins, limit):
        i = torch.arange(bins, device=rv.device, dtype=rv.dtype)[None, :]
        lo = torch.floor(start[:, None] + i * size[:, None])
        hi = torch.maximum(torch.ceil(start[:, None] + (i + 1) * size[:, None]),
                           lo + 1)
        return (torch.clamp(lo, 0, limit).long(),
                torch.clamp(hi, 0, limit).long())

    ys, ye = edges(y1, bh, oh, h)  # [R, oh]
    xs, xe = edges(x1, bw, ow, w)  # [R, ow]
    # channels last: both sums run over outer dimensions
    table = torch.zeros((n, h + 1, w + 1, c), dtype=torch.float64,
                        device=xv.device)
    table[:, 1:, 1:] = xv.permute(0, 2, 3, 1).to(
        torch.float64).contiguous().cumsum(1).cumsum(2)
    ch = (torch.arange(oc, device=xv.device)[:, None, None] * (oh * ow)
          + torch.arange(oh, device=xv.device)[None, :, None] * ow
          + torch.arange(ow, device=xv.device)[None, None, :])
    bi = bidx[:, None, None, None]
    chi = ch[None]
    y_lo, y_hi = ys[:, None, :, None], ye[:, None, :, None]
    x_lo, x_hi = xs[:, None, None, :], xe[:, None, None, :]
    total = (table[bi, y_hi, x_hi, chi] - table[bi, y_lo, x_hi, chi]
             - table[bi, y_hi, x_lo, chi] + table[bi, y_lo, x_lo, chi])
    area = (y_hi - y_lo) * (x_hi - x_lo)  # [R, 1, oh, ow]
    out = torch.where(area > 0, total / torch.clamp(area, min=1), 0.0)
    return as_port(out.to(xv.dtype))


class PSRoIPool(Layer):
    """reference: ``paddle_tpu/vision/ops.py:677`` ``PSRoIPool``."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


# ------------------------------------------------------------------ yolo box
def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5, name=None):
    """Decode a YOLOv3 head (reference: ``paddle_tpu/vision/ops.py:195``).
    ``x`` [N, A * (5 + C), H, W], ``img_size`` [N, 2] (h, w) -> (boxes
    [N, A * H * W, 4], scores [N, A * H * W, C]), both zero where the
    objectness is at most ``conf_thresh``. The anchors' extents are
    float32, as the reference's numpy constants."""
    xv = as_tensor_arg(x)
    imgv = as_tensor_arg(img_size, xv)
    anchors = np.asarray(anchors, np.float32).reshape(-1, 2)
    A = anchors.shape[0]
    N, _, H, W = xv.shape
    p = xv.reshape(N, A, 5 + class_num, H, W)
    tx, ty, tw, th = p[:, :, 0], p[:, :, 1], p[:, :, 2], p[:, :, 3]
    obj = torch.sigmoid(p[:, :, 4])
    cls = torch.sigmoid(p[:, :, 5:])
    dev = xv.device
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]
    gy = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    alpha, beta = scale_x_y, -0.5 * (scale_x_y - 1.0)
    cx = (torch.sigmoid(tx) * alpha + beta + gx) / W
    cy = (torch.sigmoid(ty) * alpha + beta + gy) / H
    aw = _to_device(anchors[:, 0] / (downsample_ratio * W), dev)
    ah = _to_device(anchors[:, 1] / (downsample_ratio * H), dev)
    bw = torch.exp(tw) * aw[None, :, None, None]
    bh = torch.exp(th) * ah[None, :, None, None]
    im_h = imgv[:, 0].to(torch.float32)[:, None, None, None]
    im_w = imgv[:, 1].to(torch.float32)[:, None, None, None]
    x1 = (cx - bw / 2) * im_w
    y1 = (cy - bh / 2) * im_h
    x2 = (cx + bw / 2) * im_w
    y2 = (cy + bh / 2) * im_h
    if clip_bbox:
        zero = torch.zeros((), dtype=x1.dtype, device=dev)
        x1 = torch.minimum(torch.maximum(x1, zero), im_w - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), im_h - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), im_w - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), im_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(N, -1, 4)
    score = (obj[..., None] * torch.movedim(cls, 2, -1)).reshape(
        N, -1, class_num)
    mask = obj.reshape(N, -1, 1) > conf_thresh
    return as_port(boxes * mask), as_port(score * mask)


# ----------------------------------------------------------------- box coder
def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """The center-size box codec of SSD-style heads (reference:
    ``paddle_tpu/vision/ops.py:244``): row ``i`` of ``target_box`` against
    row ``i`` of ``prior_box``, as the reference computes it; ``axis`` is
    accepted and unused there too."""
    pv = as_tensor_arg(prior_box)
    tv = as_tensor_arg(target_box, pv)
    norm = 0.0 if box_normalized else 1.0
    pw = pv[:, 2] - pv[:, 0] + norm
    ph = pv[:, 3] - pv[:, 1] + norm
    pcx = pv[:, 0] + pw / 2
    pcy = pv[:, 1] + ph / 2
    vv = (as_tensor_arg(prior_box_var, pv) if prior_box_var is not None
          else torch.ones_like(pv))
    if code_type == "encode_center_size":
        tw = tv[:, 2] - tv[:, 0] + norm
        th = tv[:, 3] - tv[:, 1] + norm
        tcx = tv[:, 0] + tw / 2
        tcy = tv[:, 1] + th / 2
        out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                           torch.log(tw / pw), torch.log(th / ph)], dim=1)
        return as_port(out / vv)
    d = tv * vv
    cx = d[:, 0] * pw + pcx
    cy = d[:, 1] * ph + pcy
    w = torch.exp(d[:, 2]) * pw
    h = torch.exp(d[:, 3]) * ph
    return as_port(torch.stack([cx - w / 2, cy - h / 2, cx + w / 2 - norm,
                                cy + h / 2 - norm], dim=1))


# --------------------------------------------------------------- deform conv
def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 / v2 (reference:
    ``paddle_tpu/vision/ops.py:284-366``): each output position samples
    ``x`` bilinearly (zero outside the map) at its kernel points moved by
    ``offset`` ([N, 2 * dg * kh * kw, oh, ow], (dy, dx) a point), times
    ``mask`` when given, then one grouped product with ``weight``. The
    columns are gathered channels-last, ``[N, oh, ow, K, C]``; a float64
    product stays float64 (the reference forms it in float32)."""
    xv = as_tensor_arg(x)
    ov = as_tensor_arg(offset, xv)
    wv = as_tensor_arg(weight, xv)
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    N, C, H, W = xv.shape
    Co, Cg, kh, kw = wv.shape
    oh = (H + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
    ow = (W + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
    K, dg = kh * kw, deformable_groups
    dev = xv.device
    base_y = ((torch.arange(oh, device=dev) * s[0] - p[0])[:, None, None]
              + (torch.arange(kh, device=dev) * d[0]).repeat_interleave(kw)
              [None, None, :])
    base_x = ((torch.arange(ow, device=dev) * s[1] - p[1])[None, :, None]
              + (torch.arange(kw, device=dev) * d[1]).repeat(kh)
              [None, None, :])
    off = ov.reshape(N, dg, K, 2, oh, ow)
    yy = base_y + torch.movedim(off[:, :, :, 0], 2, -1)  # [N, dg, oh, ow, K]
    xx = base_x + torch.movedim(off[:, :, :, 1], 2, -1)
    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy1, wx1 = (yy - y0)[..., None], (xx - x0)[..., None]
    wy0, wx0 = 1 - wy1, 1 - wx1
    y0i, x0i = y0.long(), x0.long()
    Cpg = C // dg
    xg = xv.reshape(N, dg, Cpg, H, W).permute(0, 1, 3, 4, 2)  # channels last
    ni = torch.arange(N, device=dev)[:, None, None, None, None]
    gi = torch.arange(dg, device=dev)[None, :, None, None, None]

    def corner(yi, xi):  # [N, dg, oh, ow, K, Cpg], 0 outside the map
        valid = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W))[..., None]
        v = xg[ni, gi, torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]
        return torch.where(valid, v, torch.zeros((), dtype=v.dtype,
                                                 device=dev))

    cols = (corner(y0i, x0i) * wy0 * wx0 + corner(y0i, x0i + 1) * wy0 * wx1
            + corner(y0i + 1, x0i) * wy1 * wx0
            + corner(y0i + 1, x0i + 1) * wy1 * wx1)
    if mask is not None:
        m = as_tensor_arg(mask, xv).reshape(N, 1, K, oh, ow)
        cols = cols * torch.movedim(m, 2, -1)[..., None]
    # [N, dg, oh, ow, K, Cpg] -> [N, oh * ow, K, groups, C / groups]
    cols = cols.permute(0, 2, 3, 4, 1, 5).reshape(N, oh * ow, K, groups,
                                                  C // groups)
    w_g = wv.reshape(groups, Co // groups, Cg, K)
    out = torch.einsum("npkgc,gock->ngop", cols, w_g)
    out = out.reshape(N, Co, oh, ow)
    if bias is not None:
        out = out + as_tensor_arg(bias, xv).reshape(1, -1, 1, 1)
    return as_port(out)


class DeformConv2D(Layer):
    """reference: ``paddle_tpu/vision/ops.py:369`` ``DeformConv2D``: weight
    ``[out, in / groups, kh, kw]`` (``XavierNormal``), bias ``[out]`` (0)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self._cfg = (stride, padding, dilation, deformable_groups, groups)
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups, kh, kw), attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = (None if bias_attr is False else self.create_parameter(
            (out_channels,), attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0)))

    def forward(self, x, offset, mask=None):
        s, p, d, dg, g = self._cfg
        return deform_conv2d(x, offset, self.weight, self.bias, s, p, d, dg,
                             g, mask)


# ------------------------------------------------- fpn distribute (metadata)
def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None):
    """Each RoI to the FPN level of its scale (reference:
    ``paddle_tpu/vision/ops.py:395-415``): (the RoIs of each level, their
    indices into ``fpn_rois``, and the order that restores the input
    order from the levels' concatenation). The levels are host metadata,
    as in the reference: one read of the RoIs, the levels computed in
    numpy in the reference's arithmetic; the outputs lie on the RoIs'
    device."""
    rv = as_tensor_arg(fpn_rois)
    rois = rv.detach().cpu().numpy()
    off = 1.0 if pixel_offset else 0.0
    w = rois[:, 2] - rois[:, 0] + off
    h = rois[:, 3] - rois[:, 1] + off
    scale = np.sqrt(np.maximum(w * h, 1e-6))
    lvl = np.floor(np.log2(scale / refer_scale + 1e-6)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    index = [np.nonzero(lvl == L)[0] for L in range(min_level, max_level + 1)]
    restore = (np.argsort(np.concatenate(index)) if index
               else np.zeros(0, np.int64))
    idx = [_to_device(i.astype(np.int64), rv.device) for i in index]
    return ([as_port(rv[i]) for i in idx], [as_port(i) for i in idx],
            as_port(_to_device(restore.astype(np.int64), rv.device)))


def generate_proposals(*args, **kwargs):
    """Not computed, as in the reference (``paddle_tpu/vision/ops.py:418``)."""
    raise NotImplementedError(
        "generate_proposals (RPN decode) lands with the detection model zoo; "
        "compose yolo_box/box_coder + nms for proposal generation meanwhile"
    )


# ------------------------------------------------- legacy detection op set
def iou_similarity(x, y, box_normalized=True, name=None):
    """Pairwise IoU [N, M] (reference: ``paddle_tpu/vision/ops.py:430``);
    ``box_normalized=False`` adds 1 to widths and heights."""
    a = as_tensor_arg(x)
    b = as_tensor_arg(y, a)
    return as_port(_box_iou(a, b) if box_normalized else _pixel_iou(a, b))


def box_clip(input, im_info, name=None):  # noqa: A002 — Paddle's name
    """Clip boxes to their image (reference: ``paddle_tpu/vision/ops.py:448``).
    ``im_info`` rows are (height, width, scale); boxes [B, M, 4] clip per
    image, flat [N, 4] boxes take a single ``im_info`` row."""
    boxes = as_tensor_arg(input)
    info = as_tensor_arg(im_info, boxes)
    if boxes.ndim == 2 and info.numel() > 3:
        raise ValueError(
            "flat [N,4] boxes with multi-image im_info are ambiguous without "
            "LoD; pass boxes as [B, M, 4] aligned with im_info rows")
    info2 = info.reshape(-1, 3)
    h = info2[:, 0] / info2[:, 2] - 1.0
    w = info2[:, 1] / info2[:, 2] - 1.0
    if boxes.ndim == 3:
        h, w = h[:, None], w[:, None]
    else:
        h, w = h[0], w[0]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi)

    return as_port(torch.stack([clip(boxes[..., 0], w), clip(boxes[..., 1], h),
                                clip(boxes[..., 2], w), clip(boxes[..., 3], h)],
                               dim=-1))


def _centres(fh, fw, offset, step_h, step_w, dev):
    """The cell centres (cx, cy), each [fh, fw] float32."""
    cy = (torch.arange(fh, dtype=torch.float32, device=dev) + offset) * step_h
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + offset) * step_w
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    return cxg, cyg


def prior_box(input, image, min_sizes, max_sizes=None,  # noqa: A002
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2), flip=False,
              clip=False, steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD prior boxes (reference: ``paddle_tpu/vision/ops.py:480``): (boxes
    [H, W, P, 4], normalized x1, y1, x2, y2, and their variances), float32,
    on ``input``'s device."""
    feat = as_tensor_arg(input)
    img = as_tensor_arg(image, feat)
    fh, fw = int(feat.shape[2]), int(feat.shape[3])
    ih, iw = int(img.shape[2]), int(img.shape[3])
    step_h = steps[1] if steps[1] > 0 else ih / fh
    step_w = steps[0] if steps[0] > 0 else iw / fw
    ars = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - a) > 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    whs = []  # (w, h) a prior in pixels; max_sizes pair by position
    for mi, ms in enumerate(min_sizes):
        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            if max_sizes:
                whs.append((float(np.sqrt(ms * max_sizes[mi])),) * 2)
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * float(np.sqrt(ar)), ms / float(np.sqrt(ar))))
        else:
            for ar in ars:
                whs.append((ms * float(np.sqrt(ar)), ms / float(np.sqrt(ar))))
            if max_sizes:
                whs.append((float(np.sqrt(ms * max_sizes[mi])),) * 2)
    cxg, cyg = _centres(fh, fw, offset, step_h, step_w, feat.device)
    wh = _to_device(whs, feat.device, torch.float32)
    half_w, half_h = wh[:, 0] / 2.0, wh[:, 1] / 2.0
    boxes = torch.stack([(cxg[..., None] - half_w) / iw,
                         (cyg[..., None] - half_h) / ih,
                         (cxg[..., None] + half_w) / iw,
                         (cyg[..., None] + half_h) / ih], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = _to_device(variance, feat.device, torch.float32).expand(
        boxes.shape).contiguous()
    return as_port(boxes), as_port(var)


def anchor_generator(input, anchor_sizes, aspect_ratios, variance,  # noqa: A002
                     stride, offset=0.5, name=None):
    """RPN anchors (reference: ``paddle_tpu/vision/ops.py:539``): (anchors
    [H, W, A, 4] in pixels, their variances), float32, on ``input``'s
    device; the ratios vary slowest."""
    feat = as_tensor_arg(input)
    fh, fw = int(feat.shape[2]), int(feat.shape[3])
    whs = [(s / float(np.sqrt(ar)), s * float(np.sqrt(ar)))
           for ar in aspect_ratios for s in anchor_sizes]
    cxg, cyg = _centres(fh, fw, offset, stride[1], stride[0], feat.device)
    wh = _to_device(whs, feat.device, torch.float32)
    anchors = torch.stack([cxg[..., None] - wh[:, 0] / 2,
                           cyg[..., None] - wh[:, 1] / 2,
                           cxg[..., None] + wh[:, 0] / 2,
                           cyg[..., None] + wh[:, 1] / 2], dim=-1)
    var = _to_device(variance, feat.device, torch.float32).expand(
        anchors.shape).contiguous()
    return as_port(anchors), as_port(var)


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    """Greedy bipartite matching (reference: ``paddle_tpu/vision/ops.py:570``):
    ``min(n, m)`` times, the largest remaining entry (the first in row-major
    order on a tie) matches its row and column, which leave. Returns
    (match_indices [m] int32, the row of each column or -1, and
    match_distance [m] in ``dist_matrix``'s dtype); ``per_prediction``
    with a threshold also matches each unmatched column whose best row
    reaches it. No host read: each step is a few launches on the
    device."""
    d = as_tensor_arg(dist_matrix)
    n, m = d.shape
    dev = d.device
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    row_idx = torch.full((m,), -1, dtype=torch.int32, device=dev)
    row_val = torch.zeros(m, dtype=d.dtype, device=dev)
    left = d.detach().clone()
    for _ in range(min(n, m)):
        flat = torch.argmax(left).reshape(1)  # a tensor index: no host read
        i, j = flat // m, flat % m
        v = left.reshape(-1)[flat]
        valid = v > -torch.inf
        hit = valid & (cols == j)
        row_idx = torch.where(hit, i.to(torch.int32), row_idx)
        row_val = torch.where(hit, v, row_val)
        gone = valid & ((rows == i)[:, None] | (cols == j)[None, :])
        left = torch.where(gone, -torch.inf, left)
    if match_type == "per_prediction" and dist_threshold is not None:
        best_val, best_row = torch.max(d.detach(), dim=0)
        extra = (row_idx < 0) & (best_val >= dist_threshold)
        row_idx = torch.where(extra, best_row.to(torch.int32), row_idx)
        row_val = torch.where(extra, best_val, row_val)
    return as_port(row_idx), as_port(row_val)


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None):
    """Per-class NMS and a global top-k (reference:
    ``paddle_tpu/vision/ops.py:608-659``). ``bboxes`` [N, 4], ``scores``
    [C, N] -> [keep_top_k, 6] rows (class, score, x1, y1, x2, y2) in
    descending score order; a row with score -1 is padding (suppressed,
    under ``score_threshold``, or of ``background_label``). Every class's
    greedy sweep runs at once, over ``[C, k, k]`` (:func:`_sweep`);
    ``nms_eta`` is accepted and unused, as in the reference."""
    boxes = as_tensor_arg(bboxes)
    sc = as_tensor_arg(scores, boxes)
    c, n = sc.shape
    k = n if nms_top_k < 0 else min(nms_top_k, n)
    dev = boxes.device
    with torch.no_grad():
        iou = _box_iou(boxes, boxes) if normalized else _pixel_iou(boxes,
                                                                   boxes)
        order = _desc_order(sc)[:, :k]                 # [C, k]
        s_k = torch.gather(sc, 1, order)
        by = _overlaps(iou, nms_threshold)[order[:, :, None],
                                            order[:, None, :]]
        keep = _sweep(by.tril_(-1))
        keep &= s_k > score_threshold
        keep &= (torch.arange(c, device=dev) != background_label)[:, None]
    dtype = torch.promote_types(torch.promote_types(sc.dtype, boxes.dtype),
                                torch.float32)
    cls = torch.arange(c, device=dev, dtype=dtype)[:, None].expand(c, k)
    rows = torch.cat([cls[..., None],
                      torch.where(keep, s_k, -1.0).to(dtype)[..., None],
                      boxes[order].to(dtype)], dim=-1).reshape(c * k, 6)
    top = min(keep_top_k, rows.shape[0]) if keep_top_k > 0 else rows.shape[0]
    return as_port(rows[_desc_order(rows[:, 1])[:top]])


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """The YOLOv3 loss (reference: ``paddle_tpu/vision/ops.py:690``, computed
    by ``paddle_tpu/fluid/layers.py:2570-2636``): a scalar, the sum of the
    xy BCE, the wh L1 and the class BCE at the assigned cells plus the
    objectness BCE everywhere. ``gt_box`` [N, B, 4] (cx, cy, w, h,
    normalized), ``gt_label`` [N, B]. A ground truth with ``w <= 0`` or
    ``h <= 0`` is skipped; the others go to the cell ``trunc(c * size)``
    (at most ``size - 1``; a negative one indexes as in Python, and its
    xy target keeps it unwrapped) of the first masked anchor of largest
    shape IoU, computed in float64.
    ``ignore_thresh``, ``gt_score`` and ``use_label_smooth`` are accepted
    and unused, as in the reference. The loss takes a gradient to ``x``
    (the reference's does not)."""
    xv = as_tensor_arg(x)
    gt = as_tensor_arg(gt_box, xv)
    labels = as_tensor_arg(gt_label, xv).long()
    n, _, h, w = xv.shape
    na = len(anchor_mask)
    dev = xv.device
    pred = xv.reshape(n, na, 5 + class_num, h, w)
    aw = np.asarray([anchors[2 * m] / (downsample_ratio * w)
                     for m in anchor_mask], np.float64)
    ah = np.asarray([anchors[2 * m + 1] / (downsample_ratio * h)
                     for m in anchor_mask], np.float64)
    with torch.no_grad():
        cx, cy, gw, gh = gt.unbind(-1)                      # [n, B]
        valid = (gw > 0) & (gh > 0)
        # the targets take the cell as computed; only the index wraps
        gi = torch.clamp(torch.trunc(cx * w).long(), max=w - 1)
        gj = torch.clamp(torch.trunc(cy * h).long(), max=h - 1)
        gw64, gh64 = gw.double()[..., None] * w, gh.double()[..., None] * h
        aw_t = _to_device(aw * w, dev)
        ah_t = _to_device(ah * h, dev)
        inter = torch.minimum(gw64, aw_t) * torch.minimum(gh64, ah_t)
        union = gw64 * gh64 + aw_t * ah_t - inter
        best = torch.argmax(inter / union, dim=-1)          # [n, B]
        bw = _to_device(aw, dev, gt.dtype)[best]
        bh = _to_device(ah, dev, gt.dtype)[best]
        t_box = torch.stack([cx * w - gi, cy * h - gj,
                             torch.log(torch.clamp(gw / bw, min=1e-9)),
                             torch.log(torch.clamp(gh / bh, min=1e-9))],
                            dim=-1).to(xv.dtype)            # [n, B, 4]
        img = torch.arange(n, device=dev)[:, None].expand_as(best)
        cells = n * na * h * w
        # a skipped ground truth writes to a spare last slot, dropped after
        cell = torch.where(valid,
                           ((img * na + best) * h + gj % h) * w + gi % w,
                           cells).reshape(-1)
        pos = torch.arange(cell.numel(), device=dev)
        # the last ground truth on a cell writes it (image-then-box order,
        # the reference's loop); a CUDA scatter with repeated indices
        # leaves the winner undefined, so the others go to the spare slot
        last = torch.full((cells + 1,), -1, dtype=torch.long, device=dev)
        last.scatter_reduce_(0, cell, pos, reduce="amax")
        won = torch.where(last[cell] == pos, cell, cells)
        obj = torch.zeros(cells + 1, dtype=xv.dtype, device=dev)
        obj.index_fill_(0, won, 1.0)
        t_xywh = torch.zeros((cells + 1, 4), dtype=xv.dtype, device=dev)
        t_xywh[won] = t_box.reshape(-1, 4)
        t_cls = torch.zeros((cells + 1, class_num), dtype=xv.dtype,
                            device=dev)
        t_cls.view(-1).index_fill_(
            0, cell * class_num + torch.where(valid, labels, 0).reshape(-1),
            1.0)
        om = obj[:cells].reshape(n, na, h, w)
        t_xywh = t_xywh[:cells].reshape(n, na, h, w, 4).permute(0, 1, 4, 2, 3)
        t_cls = t_cls[:cells].reshape(n, na, h, w, class_num).permute(
            0, 1, 4, 2, 3)
    om4 = om[:, :, None]
    bce = F.binary_cross_entropy_with_logits
    xy_l = (bce(pred[:, :, 0:2], t_xywh[:, :, :2], reduction="none")
            * om4).sum()
    wh_l = (torch.abs(pred[:, :, 2:4] - t_xywh[:, :, 2:]) * om4).sum()
    obj_l = bce(pred[:, :, 4], om, reduction="none").sum()
    cls_l = (bce(pred[:, :, 5:], t_cls, reduction="none") * om4).sum()
    return as_port((xy_l + wh_l) + (obj_l + cls_l))


def read_file(filename, name=None):
    """The file's bytes as a uint8 tensor (reference:
    ``paddle_tpu/vision/ops.py:701``)."""
    with open(filename, "rb") as f:
        data = f.read()
    return to_tensor(np.frombuffer(data, dtype=np.uint8).copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode JPEG bytes on the host through PIL into a uint8 CHW tensor
    (reference: ``paddle_tpu/vision/ops.py:708-728``); raises where PIL is
    absent, as the reference does."""
    try:
        from PIL import Image
    except ImportError as e:
        raise NotImplementedError(
            "decode_jpeg needs PIL for host-side decode in this build"
        ) from e
    raw = bytes(np.asarray(as_tensor_arg(x).detach().cpu().numpy(),
                           np.uint8))
    with Image.open(_io.BytesIO(raw)) as img:
        if mode == "gray":
            arr = np.asarray(img.convert("L"))[None]
        else:
            arr = np.asarray(img.convert("RGB")).transpose(2, 0, 1)
    return to_tensor(np.ascontiguousarray(arr))
