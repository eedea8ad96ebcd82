"""MCTF, motion-compensated temporal filtering of key frames and mini-GoP
anchors (PyTorch), ported from svtav1_tpu's ops/tf_jax.py.

The reference's ALT-REF temporal filter (temporal_filtering.c:2752
produce_temporally_filtered_pic; plane-wise weighted accumulation :1382):
each neighbour frame is motion-compensated toward the centre frame (16x16
full-pel ME with K8, the 49-point subpel search with K9, chroma MC at the
luma MV with K10), then every sample of the centre is replaced by an
exponentially weighted average of the centre and the compensated
neighbours, with weights from the local 5x5-windowed compensation error,
the frame's noise level and the encoding strength. Two kernels, each with a
plain PyTorch version beside it:

- K12 `tf_filter` (`csrc/tf.cu`): the weighting and normalisation of one
  plane over all K neighbours;
- K13 `tf_noise` (`csrc/tf.cu`): the noise estimate's exact sums.

The filter changes only the source handed to the encoder (nothing is
signalled), so conformance is untouched. Deliberate divergence: the window
sums and the noise sums are exact integers here, where the reference sums
float32 (a summed-area table, an order-dependent reduction); the two agree
wherever the reference's float32 sums are exact, and the port's exp is
correctly rounded (double, rounded once) where XLA's float32 exp is not.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from . import me_torch

TF_BLOCK = 16  # ME/MC granularity (the reference filters 32x32 with 16 subblocks)
_NOISE_SCALE = np.float32(np.sqrt(np.pi / 2) / 6.0)


def _flat_threshold(bd: int) -> int:
    """Edge-gradient threshold of the noise estimate, scaled with bit depth
    (the reference shifts its EDGE_THRESHOLD by bd - 8)."""
    return 40 << (bd - 8)


def noise_sums_plain(y, bd: int = 8):
    """Plain PyTorch version of K13: (sum of |Laplacian| over the flat
    interior samples, their count), both int64 tensors."""
    y = y.to(torch.int32)
    c = y[1:-1, 1:-1]
    lap = (4 * c - 2 * (y[1:-1, :-2] + y[1:-1, 2:] + y[:-2, 1:-1] + y[2:, 1:-1])
           + y[:-2, :-2] + y[:-2, 2:] + y[2:, :-2] + y[2:, 2:])
    grad = (y[1:-1, 2:] - y[1:-1, :-2]).abs() + (y[2:, 1:-1] - y[:-2, 1:-1]).abs()
    flat = grad < _flat_threshold(bd)
    return (lap.abs().to(torch.int64) * flat).sum(), flat.sum()


def noise_sums(y, bd: int = 8):
    """(|Laplacian| sum, flat count) of an (H, W) int32 plane (K13)."""
    if y.device.type == "cpu":
        return noise_sums_plain(y, bd)
    kernels.check(y, "y", torch.int32)
    if y.dim() != 2:
        raise ValueError("noise_sums: one (H, W) plane")
    out = torch.zeros(2, dtype=torch.int64, device=y.device)
    kernels.launch("tf_noise", y.data_ptr(), out.data_ptr(), y.shape[0], y.shape[1],
                   _flat_threshold(bd), kernels.stream_ptr(out))
    return out[0], out[1]


def estimate_noise(y, bd: int = 8) -> np.float32:
    """Frame noise sigma (estimate_noise_j): the mean |Laplacian| over the
    flat samples times sqrt(pi/2)/6, in float32 (mean in place of the
    reference encoder's median: the same scale on iid noise)."""
    s, cnt = noise_sums(y, bd)
    return np.float32(int(s)) / np.float32(max(int(cnt), 1)) * _NOISE_SCALE


def _box5_sum(sq):
    """5x5 window sums of an (H, W) int32 plane with edge replication."""
    H, W = sq.shape
    dev = sq.device
    iy = (torch.arange(H + 4, device=dev) - 2).clamp(0, H - 1)
    ix = (torch.arange(W + 4, device=dev) - 2).clamp(0, W - 1)
    p = sq[iy[:, None], ix[None, :]]
    rows = p[:, 0:W] + p[:, 1 : W + 1] + p[:, 2 : W + 2] + p[:, 3 : W + 3] + p[:, 4 : W + 4]
    return rows[0:H] + rows[1 : H + 1] + rows[2 : H + 2] + rows[3 : H + 3] + rows[4 : H + 4]


def tf_filter_plain(center, preds, h2: float, bd: int = 8):
    """Plain PyTorch version of K12; same arguments and result as tf_filter.
    Divisions take full tensors, so that no device turns a division by a
    scalar into a multiplication by its reciprocal."""
    c = center.to(torch.int32)
    a = c.to(torch.float32)
    ws = torch.ones_like(a)
    h2_t = torch.full_like(a, float(np.float32(h2)))
    n25 = torch.full_like(a, 25.0)
    for k in range(preds.shape[0]):
        p = preds[k].to(torch.int32)
        d = _box5_sum((p - c) * (p - c)).to(torch.float32) / n25
        w = torch.exp((-d / h2_t).to(torch.float64)).to(torch.float32)
        a = a + w * p.to(torch.float32)
        ws = ws + w
    return torch.round(a / ws).to(torch.int32).clamp(0, (1 << bd) - 1)


def tf_filter(center, preds, h2: float, bd: int = 8):
    """Temporal filter of one plane (K12): center (H, W) int32, preds
    (K, H, W) int32 neighbours compensated toward it, h2 the float32 decay.
    Returns the filtered (H, W) int32 plane."""
    if center.device.type == "cpu":
        return tf_filter_plain(center, preds, h2, bd)
    kernels.check(center, "center", torch.int32)
    if center.dim() != 2:
        raise ValueError("tf_filter: one (H, W) centre plane")
    H, W = center.shape
    kernels.check(preds, "preds", torch.int32, (preds.shape[0], H, W))
    out = torch.empty_like(center)
    kernels.launch("tf_filter", center.data_ptr(), preds.data_ptr(), out.data_ptr(),
                   preds.shape[0], H, W, float(np.float32(h2)), bd, kernels.stream_ptr(out))
    return out


def tf_strength(qindex: int, bd: int = 8) -> float:
    """q-derived filter strength (q_decay shape: stronger at high q), in
    sample units; scales with bit depth like sigma."""
    return (1.0 + qindex / 48.0) * (1 << (bd - 8))


def tf_decay(sigma: np.float32, strength: np.float32) -> np.float32:
    """The decay h2 = 2 (sigma^2 + strength^2) of the weights (n_decay *
    q_decay * sigma^2 shape: larger noise or stronger filtering flatten
    them), float32. XLA evaluates the reference's expression with the first
    product fused into the sum (one rounding instead of two), so it is
    computed here the same way: the exact float32 product sigma^2 in
    float64, plus the float32 strength^2, rounded once to float32."""
    fused = np.float32(np.float64(sigma) * np.float64(sigma) + np.float64(strength * strength))
    return np.float32(2.0) * fused


def _blocks_to_plane(b, R: int, C: int, n: int):
    return b.reshape(R, C, n, n).permute(0, 2, 1, 3).reshape(R * n, C * n)


def filter_planes(center, neighbors, qindex: int, bd: int = 8):
    """center: [y, u, v] (H, W) and (H/2, W/2) planes on one device (uint8
    at 8 bits, int16 at 10), H and W multiples of 64; neighbors: list of
    such triples. Returns the filtered [y, u, v] int32 planes on that
    device."""
    H, W = center[0].shape
    dev = center[0].device
    R, C = H // TF_BLOCK, W // TF_BLOCK
    B = R * C
    nc = TF_BLOCK // 2
    cy, cu, cv = (p.to(torch.int32).contiguous() for p in center)
    sigma = max(estimate_noise(cy, bd), np.float32(0.5 * (1 << (bd - 8))))
    h2 = tf_decay(sigma, np.float32(tf_strength(qindex, bd)))
    r_idx = torch.arange(R, device=dev, dtype=torch.int32).repeat_interleave(C)
    c_idx = torch.arange(C, device=dev, dtype=torch.int32).repeat(R)
    srcb = cy.reshape(R, TF_BLOCK, C, TF_BLOCK).permute(0, 2, 1, 3) \
        .reshape(B, TF_BLOCK, TF_BLOCK).contiguous()
    preds = [[], [], []]
    src_pyr = me_torch.me_pyramid(center[0], H // 64, W // 64, bd)  # shared by the neighbours
    for ny, nu, nv in neighbors:
        mvs_fp, _sb = me_torch.me_fullpel_frame(center[0], ny, H // 64, W // 64, src_pyr=src_pyr,
                                                bd=bd)
        fp = mvs_fp[TF_BLOCK][:R, :C].reshape(B, 2)
        mv8, pred = me_torch.subpel_pred_lanes(srcb, ny, r_idx * TF_BLOCK, c_idx * TF_BLOCK, fp,
                                               0, bd)
        preds[0].append(_blocks_to_plane(pred, R, C, TF_BLOCK))
        # chroma MC at the luma 1/8-pel MV (1/16 pel of the chroma plane)
        puv = me_torch.mc_lanes_planes([nu, nv], r_idx * nc, c_idx * nc, mv8[:, 0], mv8[:, 1],
                                       nc, nc, 0, bd)
        for pi in (1, 2):
            preds[pi].append(_blocks_to_plane(puv[pi - 1], R, C, nc))
    return [tf_filter(c, torch.stack(p), h2, bd) for c, p in zip((cy, cu, cv), preds)]


def filter_frame(center, neighbors, qindex: int, bd: int = 8, device=None):
    """center: [y, u, v] aligned numpy planes (64-multiples); neighbors:
    list of same-shape plane triples. Returns the filtered [y, u, v] int32
    numpy planes (tf_jax.filter_frame), computed on `device` (None means
    CUDA; "cpu" runs the kernels' plain versions)."""
    device = kernels.resolve_device(device)
    if not neighbors:
        return center
    dt = me_torch.plane_np_dtype(bd)

    def put(planes):
        return [torch.from_numpy(np.ascontiguousarray(p, dt)).to(device) for p in planes]

    out = filter_planes(put(center), [put(f) for f in neighbors], qindex, bd)
    return [p.cpu().numpy() for p in out]
