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

- K12 `tf_filter` (`csrc/tf.cu`): the weighting and normalisation of the
  three planes over all K neighbours, in one launch on the neighbours'
  block-layout predictions (`tf_filter_planes`);
- K13 `tf_noise` (`csrc/tf.cu`): the noise estimate's exact sums and, from
  them, the filter's decay h2 on the card (`noise_decay`), which K12 reads
  there: one MCTF call synchronises with the host only for its download.

The filter changes only the source handed to the encoder (nothing is
signalled), so conformance is untouched. Deliberate divergence: the window
sums and the noise sums are exact integers here, where the reference sums
float32 (a summed-area table, an order-dependent reduction); the two agree
wherever the reference's float32 sums are exact, and the port's exp is
correctly rounded (double, rounded once) where XLA's float32 exp is not.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels
from . import me_torch

TF_BLOCK = 16  # ME/MC granularity (the reference filters 32x32 with 16 subblocks)
_NOISE_SCALE = np.float32(np.sqrt(np.pi / 2) / 6.0)
TF_KMAX = 8  # neighbours a K12 launch takes (csrc/tf.cu)
TF_TABLE = 1 << 16  # K12's table of weights w(s): window sums s below it


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


@functools.lru_cache(maxsize=None)
def _scratch(device: str) -> dict:
    """The kernels' scratch on a device, zeroed once (each launch leaves it
    zeroed): K13's sums and CTA count, K12's table claims and CTA count;
    and K12's weight table, filled by each launch. One stream at a time
    uses them."""
    return dict(noise=torch.zeros(3, dtype=torch.int64, device=device),
                filter=torch.zeros(3, dtype=torch.int32, device=device),
                table=torch.empty(TF_TABLE, dtype=torch.float32, device=device))


def _noise(y, bd: int, qindex: int):
    """One K13 launch on the (H, W) luma y (plane_dtype(bd)): ((2,) int64
    sums, 0-dim float32 h2 at qindex's strength), both on the card."""
    me_torch.check_plane(y, "y", bd)
    if y.dim() != 2:
        raise ValueError("tf_noise: one (H, W) plane")
    sums = torch.empty(2, dtype=torch.int64, device=y.device)
    h2 = torch.empty((), dtype=torch.float32, device=y.device)
    kernels.launch(me_torch._kname("tf_noise", bd), y.data_ptr(),
                   _scratch(str(y.device))["noise"].data_ptr(), sums.data_ptr(), h2.data_ptr(),
                   y.shape[0], y.shape[1], bd, float(_NOISE_SCALE),
                   float(np.float32(tf_strength(qindex, bd))), kernels.stream_ptr(h2))
    return sums, h2


def noise_sums(y, bd: int = 8):
    """(|Laplacian| sum, flat count) of an (H, W) plane (K13): int64
    tensors; on the card plane_dtype(bd)."""
    if y.device.type == "cpu":
        return noise_sums_plain(y, bd)
    sums, _h2 = _noise(y, bd, 0)
    return sums[0], sums[1]


def estimate_noise(y, bd: int = 8) -> np.float32:
    """Frame noise sigma (estimate_noise_j): the mean |Laplacian| over the
    flat samples times sqrt(pi/2)/6, in float32 (mean in place of the
    reference encoder's median: the same scale on iid noise)."""
    s, cnt = noise_sums(y, bd)
    return np.float32(int(s)) / np.float32(max(int(cnt), 1)) * _NOISE_SCALE


def noise_decay_plain(y, qindex: int, bd: int = 8):
    """Plain PyTorch version of noise_decay: K13's sums, then the decay in
    float32 tensor ops rounded as tf_decay(max(estimate_noise(y),
    0.5 * 2^(bd-8)), np.float32(tf_strength(qindex, bd)))."""
    f32 = torch.float32
    s, cnt = noise_sums_plain(y, bd)
    mean = s.to(f32) / cnt.clamp(min=1).to(f32)
    sigma = torch.maximum(mean * torch.tensor(_NOISE_SCALE),
                          torch.tensor(0.5 * (1 << (bd - 8)), dtype=f32))
    st = torch.tensor(np.float32(tf_strength(qindex, bd)))
    fused = (sigma.double() * sigma.double() + (st * st).double()).to(f32)
    return torch.tensor(2.0, dtype=f32) * fused


def noise_decay(y, qindex: int, bd: int = 8):
    """The filter's decay h2 for the (H, W) luma y at qindex (K13): a 0-dim
    float32 tensor on y's device, computed there (no host round trip)."""
    if y.device.type == "cpu":
        me_torch.check_plane(y, "y", bd)
        return noise_decay_plain(y, qindex, bd)
    return _noise(y, bd, qindex)[1]


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
    """K12's arithmetic on one plane, the core of its plain version: center
    (H, W), preds (K, H, W) neighbours compensated toward it, h2 the float32
    decay; returns the filtered (H, W) int32 plane. Divisions take full
    tensors, so that no device turns a division by a scalar into a
    multiplication by its reciprocal."""
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


def tf_filter_planes_plain(center, preds_y, preds_uv, h2, bd: int = 8):
    """Plain PyTorch version of K12; same arguments and result as
    tf_filter_planes: the planes rebuilt from the blocks, tf_filter_plain on
    each."""
    H, W = center[0].shape
    R, C = H // TF_BLOCK, W // TF_BLOCK
    h2 = float(np.float32(float(h2)))
    stacks = ([_blocks_to_plane(p, R, C, TF_BLOCK) for p in preds_y],
              [_blocks_to_plane(p[0], R, C, TF_BLOCK // 2) for p in preds_uv],
              [_blocks_to_plane(p[1], R, C, TF_BLOCK // 2) for p in preds_uv])
    return [tf_filter_plain(c, torch.stack(ps), h2, bd) for c, ps in zip(center, stacks)]


def tf_filter_planes(center, preds_y, preds_uv, h2, bd: int = 8):
    """Temporal filter of a frame's three planes (K12). center: [y, u, v]
    (H, W) and (H/2, W/2) planes, H and W multiples of 64 (plane_dtype(bd)
    on the card); preds_y: K (B, 16, 16) int32 luma predictions of the
    neighbours, B = (H/16)(W/16) blocks in raster order (subpel_pred_lanes);
    preds_uv: K (2, B, 8, 8) int32 U and V predictions (mc_lanes_planes);
    h2: the float32 decay, a 0-dim tensor on the card (noise_decay).
    Returns the filtered [y, u, v] int32 planes. One launch on the card."""
    H, W = center[0].shape
    K = len(preds_y)
    if H % 64 or W % 64 or any(p.shape != (H // 2, W // 2) for p in center[1:]):
        raise ValueError(f"tf_filter_planes: planes of {H}x{W} and its halves, multiples of 64")
    if len(preds_uv) != K or not 1 <= K <= TF_KMAX:
        raise ValueError(f"tf_filter_planes: 1 to {TF_KMAX} neighbours, each with U and V")
    for p in center:
        me_torch.check_plane(p, "center", bd)
    if center[0].device.type == "cpu":
        return tf_filter_planes_plain(center, preds_y, preds_uv, h2, bd)
    R, C = H // TF_BLOCK, W // TF_BLOCK
    B = R * C
    for p in preds_y:
        kernels.check(p, "preds_y", torch.int32, (B, TF_BLOCK, TF_BLOCK))
    for p in preds_uv:
        kernels.check(p, "preds_uv", torch.int32, (2, B, TF_BLOCK // 2, TF_BLOCK // 2))
    if any(p.data_ptr() % 16 for p in preds_y + preds_uv):
        raise ValueError("tf_filter_planes: predictions must start on 16 bytes")
    kernels.check(h2, "h2", torch.float32, ())
    dev = str(center[0].device)
    work = _scratch(dev)
    out = torch.empty(H * W * 3 // 2, dtype=torch.int32, device=center[0].device)
    ptrs = [p.data_ptr() for p in preds_y] + [p.data_ptr() for p in preds_uv]
    kernels.launch(me_torch._kname("tf_filter", bd), *(p.data_ptr() for p in center),
                   (ctypes.c_longlong * len(ptrs))(*ptrs), out.data_ptr(), h2.data_ptr(),
                   work["table"].data_ptr(), work["filter"].data_ptr(), K, R, C, bd, TF_TABLE,
                   kernels.stream_ptr(out))
    n = H * W
    return [out[:n].view(H, W), out[n : n + n // 4].view(H // 2, W // 2),
            out[n + n // 4 :].view(H // 2, W // 2)]


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
    device. On the card: K13, then per neighbour K8's two launches, K9 and
    K10 (U and V), then K12, with no host synchronisation."""
    H, W = center[0].shape
    dev = center[0].device
    R, C = H // TF_BLOCK, W // TF_BLOCK
    B = R * C
    nc = TF_BLOCK // 2
    h2 = noise_decay(center[0], qindex, bd)
    blk = torch.arange(B, device=dev, dtype=torch.int32)
    r_idx, c_idx = blk // C, blk % C
    srcb = center[0].reshape(R, TF_BLOCK, C, TF_BLOCK).transpose(1, 2) \
        .reshape(B, TF_BLOCK, TF_BLOCK).to(torch.int32)
    preds_y, preds_uv = [], []
    src_pyr = me_torch.me_pyramid(center[0], H // 64, W // 64, bd)  # shared by the neighbours
    for ny, nu, nv in neighbors:
        mvs_fp, _sb = me_torch.me_fullpel_frame(center[0], ny, H // 64, W // 64, src_pyr=src_pyr,
                                                bd=bd)
        fp = mvs_fp[TF_BLOCK][:R, :C].reshape(B, 2)
        mv8, pred = me_torch.subpel_pred_lanes(srcb, ny, r_idx * TF_BLOCK, c_idx * TF_BLOCK, fp,
                                               0, bd)
        preds_y.append(pred)
        # chroma MC at the luma 1/8-pel MV (1/16 pel of the chroma plane)
        preds_uv.append(me_torch.mc_lanes_planes([nu, nv], r_idx * nc, c_idx * nc, mv8[:, 0],
                                                 mv8[:, 1], nc, nc, 0, bd))
    return tf_filter_planes(center, preds_y, preds_uv, h2, bd)


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
