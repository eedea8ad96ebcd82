"""Top-level encoder of the PyTorch port: key frames, low-delay P frames
and hierarchical-B mini-GoPs, with CQP, CRF or rate control, on a CUDA
device, ported from svtav1_tpu's pipeline/encoder.py.

API shape mirrors the reference's library API (EbSvtAv1Enc.h:966-1076
svt_av1_enc_send_picture / _get_packet): `send_frame` returns the packets
that become ready (coding order), `flush` drains the tail, `encode_frame` is
the synchronous helper of low-delay configurations. Key frames are coded by
`device_commit.encode_intra_frames`; with `keyint > 1` the frames between
keys are inter frames coded through the three phases of `inter_device`
with the DPB planes kept on `device`: the next frame's decide is dispatched
before the previous frame's host walk runs. With `minigop=1` they are P
frames referencing the previous frame (LAST) and the last key (GOLDEN);
with `minigop` 2, 4 or 8 they form dyadic mini-GoPs (pipeline/gop.py): the
anchor is coded first and hidden, then the middles, which also reference
the anchor as ALTREF and add the compound NEW_NEWMV candidate; a hidden
frame is shown later by a show-existing TU. With `enable_tf`, key frames
and mini-GoP anchors are temporally filtered first (ops/tf_torch.py) with
up to TF_PAST past and TF_FUT future source frames.

Rate control (`rc_mode`): "cqp" codes every frame at `qindex` plus its
layer offset. "crf" buffers `lookahead` frames and runs TPL
(pipeline/tpl.py) over each window in coding order; each frame's qindex
follows from its propagated r0, and inter frames stay on the pipelined
path. "cbr" and "vbr" (one pass, or two passes with `stats_in` from
pipeline/firstpass.py) are host controllers (pipeline/rc.py) that need
every TU's size before the next frame's qindex, so each inter frame is
finished (its TU written) before the next one starts. `scene_cut`
codes a key frame where the source changes abruptly.

All-intra streams (`keyint=1`, CQP, no scene cut, no restoration) with
`intra_batch > 1` queue that many frames and code them as one batch: one
decide, one K16 commit launch and one filter pass over the batch
(`device_commit.encode_intra_frames`), then each frame's header and TU in
display order; elsewhere `intra_batch` is ignored, as in the reference.

`enable_restoration` takes the reference's synchronous route: the decide,
the commit, deblocking and CDEF run on the device (CDEF's strengths from
the reference's host search, device_commit.restoration_filters), the
deblocked and CDEF-filtered planes come to the host, and the host runs the
loop-restoration search per plane (filters/restoration.py), the plan walk
with the restoration units, and the restoration filter; the result enters
the device DPB. Compound prediction is off there, as in the reference.

`film_grain` (a strength, the grain estimated once from the first source
frame) or `film_grain_table` (an aomenc "filmgrn1" table) signal film grain
parameters in every frame header (filters/film_grain.py); the recon does
not change, a decoder adds the grain to its output.

`mode_decision` picks the route: "jax" (the default) is the device route
above; "numpy" is the reference's host route, its default: every frame is
decided and reconstructed on the host (pipeline/intra_md.py,
pipeline/inter_md.py; filter-intra, `enable_filter_intra`, exists only
there), frame by frame without pipelining, then DLF at the by-q levels and
CDEF at the host search's strengths run on the device over the host plan
(device_commit.plan_filters: K4, K6, K7), then the plan walk (or, under
restoration, _restore). The host route has no intra batching, global
motion, compound prediction or tiles, as in the reference; MCTF and CRF's
TPL still run on the device.

This slice supports every preset ("fast", "medium", "slow"), 8- and 10-bit
(`bd`, on every path: CRF's TPL and the tile encoders too), DLF
and CDEF each on or off, translation global motion, CDF inheritance, the
HDR metadata OBUs of key frames, and uniform tiles (`tile_cols_log2`,
`tile_rows_log2`) in all-intra streams (`keyint=1`) of the device route:
each tile is decided, committed and walked on its own, the filters run
over the whole frame. Inter frames are single-tile, as in the reference
(ValueError).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..codec.tile_codec import FrameParams, TileCodec
from ..constants.av1 import RefFrame
from ..constants.cdf import FrameContext
from ..entropy.bitstream import (FrameConfig, SequenceConfig, frame_obu, sequence_header_obu,
                                 show_existing_frame_obu, temporal_delimiter_obu)
from ..kernels import resolve_device
from ..ops.me_torch import plane_np_dtype
from ..utils import profiler
from . import gop


@dataclass
class EncoderConfig:
    width: int
    height: int
    qindex: int = 120  # base_q_idx (CQP)
    bd: int = 8
    # "jax": the device route; "numpy": the host mode decision (the
    # reference's default, which the port keeps as an option)
    mode_decision: str = "jax"
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    keyint: int = 1  # key frame every N frames (1 = all-intra)
    minigop: int = 1  # 1 = low-delay; 2/4/8 = hierarchical-B mini-GoPs
    enable_dlf: bool = True  # in-loop deblocking (by-q levels)
    enable_cdef: bool = True  # CDEF (frame-wide searched strength set)
    enable_filter_intra: bool = False  # recursive filter-intra (host route only)
    rc_mode: str = "cqp"  # "cqp" | "cbr" | "vbr" | "crf" (TPL r0-based q assignment)
    enable_restoration: bool = False  # loop restoration (Wiener + self-guided)
    scene_cut: bool = False  # adaptive key frames on scene changes
    intra_batch: int = 1  # all-intra frame batching through the device pipeline
    # MCTF: temporal filtering of key frames and mini-GoP anchors with their
    # neighbours (the ALT-REF filter, temporal_filtering.c:2752); keyint > 1
    # or minigop > 1
    enable_tf: bool = False
    preset: str = "medium"  # "fast" | "medium" | "slow"
    enable_rdoq: bool = True  # RDOQ in the commit (where the preset has it)
    target_kbps: float = 0.0  # rate-control target (kbit/s)
    fps: float = 30.0
    lookahead: int = 16  # CRF: TPL sliding-window size (frames buffered)
    # two-pass VBR: the first pass's stats records (pipeline/firstpass.read_stats)
    stats_in: list | None = None
    film_grain: int = 0  # film grain synthesis strength (0 = off)
    film_grain_table: str | None = None  # explicit aomenc "filmgrn1" table
    # CDF lifecycle: seed each inter frame's symbol CDFs from the primary
    # ref's saved frame context, and store the adapted end-of-frame CDFs
    # with every refreshed DPB slot
    cdf_inheritance: bool = True
    # max reference frames per inter frame: 3 = LAST + GOLDEN (the last key)
    # + ALTREF (the mini-GoP anchor; hierarchical-B middles only)
    n_refs: int = 3
    # compound (average) prediction in hierarchical-B middles: the
    # reference_select syntax and the NEW_NEWMV candidate on (LAST, ALTREF)
    enable_compound: bool = True
    # translation global motion: host estimation against the LAST ref's
    # source, a GLOBALMV lane at the global MV in the decide, and the spec's
    # global_motion_params in the header (codec/gm.py); inter frames only
    enable_gm: bool = True
    # HDR metadata OBUs in key-frame TUs: content_light = (max_cll,
    # max_fall); mastering_display = (((rx, ry), (gx, gy), (bx, by)),
    # (wx, wy), max_lum, min_lum); itut_t35 = payload bytes
    content_light: tuple | None = None
    mastering_display: tuple | None = None
    itut_t35: bytes | None = None


# preset -> speed features of the reference's ladder (svtav1_tpu's
# pipeline/encoder.py PRESETS); key frames read sf_nmodes_key, sf_tx_ntypes,
# sf_cdef_fast and sf_dlf_search, so "slow" codes them like "medium"
PRESETS = {
    "fast": dict(sf_nmodes_inter=4, sf_nmodes_key=7, sf_tx_ntypes=1,
                 sf_fast_subpel=1, sf_cdef_fast=1, sf_dlf_search=0),
    "medium": dict(sf_nmodes_inter=7, sf_nmodes_key=13, sf_tx_ntypes=4,
                   sf_fast_subpel=1, sf_cdef_fast=0, sf_dlf_search=1),
    "slow": dict(sf_nmodes_inter=13, sf_nmodes_key=13, sf_tx_ntypes=4,
                 sf_fast_subpel=0, sf_cdef_fast=0, sf_dlf_search=1),
}
# preset -> batched RDOQ in the commit (the reference's PRESETS "rdoq")
PRESET_RDOQ = {"fast": False, "medium": True, "slow": True}

@dataclass
class Packet:
    """One temporal unit out of the encoder (coding order)."""

    tu: bytes
    disp_idx: int | None = None  # display idx of the frame coded in this TU
    recon: list | None = None  # encoder recon (aligned planes; None for SE)
    shown_disp_idx: int | None = None  # display idx output by this TU


def replicate_display_edges(planes: list, width: int, height: int) -> None:
    """Overwrite each plane's mi-alignment padding with replicated display-edge
    pixels, in place. Run after in-loop filters, before a frame enters the DPB.

    Spec 7.11.3.4 clamps MC reference coordinates at the *display* dims
    (RefUpscaledWidth-1 / FrameHeight-1); the reference achieves the same by
    re-padding the recon from the display edge before it is used as a
    reference (pic_analysis_process.c
    svt_aom_pad_picture_to_multiple_of_min_blk_size_dimensions). Without this
    MC would read decoded alignment padding for non-multiple-of-8 dims."""
    dims = [(height, width), (height >> 1, width >> 1), (height >> 1, width >> 1)]
    for plane, (h, w) in zip(planes, dims):
        if w < plane.shape[1]:
            plane[:, w:] = plane[:, w - 1 : w]
        if h < plane.shape[0]:
            plane[h:, :] = plane[h - 1 : h, :]


def pad_to_aligned(plane: np.ndarray, aw: int, ah: int) -> np.ndarray:
    """Replicate-pad a plane to aligned dims (reference
    pic_analysis_process.c pad_picture_to_multiple_of_min_blk_size)."""
    h, w = plane.shape
    out = np.zeros((ah, aw), np.int32)
    out[:h, :w] = plane
    if w < aw:
        out[:h, w:] = plane[:, -1:]
    if h < ah:
        out[h:, :] = out[h - 1 : h, :]
    return out


class Encoder:
    def __init__(self, cfg: EncoderConfig, device=None):
        # 4:2:0 needs even dims; sources are padded to the mi-aligned size
        # (always a multiple of 8) and cropped at display per the spec
        if cfg.width % 2 or cfg.height % 2:
            raise ValueError("4:2:0 requires even dims")
        if cfg.minigop not in (1, 2, 4, 8):
            raise ValueError(f"minigop {cfg.minigop}: dyadic mini-GoPs of 1, 2, 4 or 8 frames")
        if cfg.preset not in PRESETS:
            raise ValueError(f"unknown preset {cfg.preset!r}: one of {sorted(PRESETS)}")
        if cfg.rc_mode not in ("cqp", "cbr", "vbr", "crf"):
            raise ValueError(f"unknown rc_mode {cfg.rc_mode!r}: cqp, cbr, vbr or crf")
        if cfg.bd not in (8, 10):
            raise ValueError(f"bd {cfg.bd}: the sequence header codes 8 or 10 bits (main profile)")
        if cfg.rc_mode in ("cbr", "vbr") and cfg.target_kbps <= 0:
            raise ValueError(f"{cfg.rc_mode} needs target_kbps")
        if cfg.mode_decision not in ("jax", "numpy"):
            raise ValueError(f"unknown mode_decision {cfg.mode_decision!r}: jax or numpy")
        if cfg.enable_filter_intra and cfg.mode_decision == "jax":
            raise ValueError("filter-intra uses the numpy mode-decision path")
        if (cfg.tile_cols_log2 or cfg.tile_rows_log2) and cfg.mode_decision != "jax":
            raise ValueError("multi-tile encoding requires the jax mode-decision backend")
        if (cfg.tile_cols_log2 or cfg.tile_rows_log2) and cfg.keyint != 1:
            raise ValueError("round-1 profile: inter frames are single-tile")
        self._host_md = cfg.mode_decision == "numpy"
        self.device = resolve_device(device)
        self.cfg = cfg
        self._sf = PRESETS[cfg.preset]
        self._rdoq = PRESET_RDOQ[cfg.preset] and cfg.enable_rdoq
        self._grain_table = None
        if cfg.film_grain_table:
            from ..filters.film_grain import load_fgs_table

            self._grain_table = load_fgs_table(cfg.film_grain_table)
        self._grain_est = None  # the noise model's parameters (estimated once)
        self._grain_src0 = None  # the first source frame, held for the estimate
        self.seq = SequenceConfig(width=cfg.width, height=cfg.height, bd=cfg.bd,
                                  enable_cdef=cfg.enable_cdef,
                                  enable_restoration=cfg.enable_restoration,
                                  enable_filter_intra=cfg.enable_filter_intra,
                                  film_grain_params_present=bool(
                                      cfg.film_grain or cfg.film_grain_table))
        # all-intra batches: frames wait in _ibatch until intra_batch are queued
        self._ibatch: list = []
        self._batching = (cfg.intra_batch > 1 and cfg.keyint <= 1 and not self._host_md
                          and cfg.rc_mode == "cqp" and not cfg.scene_cut
                          and not cfg.enable_restoration)
        self.next_disp = 0  # next display index expected from the caller
        self.anchor = -1  # display idx of the last coded anchor
        self.pending: list = []  # buffered (disp_idx, src_planes)
        # display idx -> {planes (device [y, u, v], uint8 or int16 by bd), order_hint, slot}
        self.dpb: dict = {}
        self._cdf_slots: list = [None] * 8  # per-slot saved frame contexts
        # global motion: per-slot saved gm params (PrevGmParams source) and
        # the source lumas a later frame can still name as its LAST ref
        self._gm_slots: list = [((0, 0),) * 8] * 8
        self._gm_src: dict = {}
        self._use_gm = bool(cfg.enable_gm and not self._host_md
                            and not (cfg.tile_cols_log2 or cfg.tile_rows_log2)
                            and cfg.keyint != 1)
        self._golden_disp = None  # last key's display idx (GOLDEN ref)
        self._slot_occupant: dict = {}  # DPB slot -> display idx
        # frame pipeline: FIFO of in-flight work, at most one frame's device
        # work outstanding; the host walk of frame N runs while the device
        # executes frame N+1's decide
        self._pipe: list = []
        self._wrote_seq = False
        # MCTF lookahead: source frames wait in _tf_q until a scheduled key
        # frame or anchor has its future neighbours; _tf_hist holds the past
        self._tf = cfg.enable_tf and (cfg.keyint > 1 or cfg.minigop > 1)
        self._tf_q: list = []
        self._tf_hist: list = []
        self._tf_emitted = 0
        from . import rc

        self.rc = None
        if cfg.rc_mode == "cbr":
            self.rc = rc.CbrController(cfg.target_kbps * 1000.0, cfg.fps, cfg.qindex)
        elif cfg.rc_mode == "vbr":
            if cfg.stats_in:
                from .firstpass import TwoPassVbrController

                self.rc = TwoPassVbrController(cfg.stats_in, cfg.target_kbps * 1000.0, cfg.fps,
                                               cfg.qindex, keyint=cfg.keyint,
                                               minigop=cfg.minigop, bd=cfg.bd)
            else:
                self.rc = rc.VbrController(cfg.target_kbps * 1000.0, cfg.fps, cfg.qindex,
                                           keyint=cfg.keyint, minigop=cfg.minigop, bd=cfg.bd)
            self.rc.set_frame_geometry(cfg.width, cfg.height)
        self.scene = rc.SceneDetector() if cfg.scene_cut else None
        # CRF: TPL lookahead queue of (disp, src, is_key), and the source of
        # the last anchor, frame 0 of the next window
        self._crf = cfg.rc_mode == "crf"
        self._crf_pending: list = []
        self._anchor_src = None

    # ------------------------------------------------------------------- API

    TF_PAST, TF_FUT = 2, 3  # MCTF window (the reference's derive_tf_window_params)

    def _grain_for(self, disp_idx: int):
        """Film grain parameters of one display frame (None when grain is
        off). A table's segments select by display index; otherwise the
        flat-block noise model runs once on the first source frame, with
        the synthetic table of the strength as the clean-source fallback.
        The seed advances per frame, so the grain pattern changes from frame
        to frame."""
        cfg = self.cfg
        if not (cfg.film_grain or self._grain_table):
            return None
        from dataclasses import replace

        from ..filters import film_grain as fg

        if self._grain_table is not None:
            p = fg.select_params(self._grain_table, disp_idx)
            if p is None or not p.apply_grain:
                return None
            return replace(p, update_grain=1,
                           grain_seed=(p.grain_seed + disp_idx * 3083) & 0xFFFF)
        if self._grain_est is None:
            est = None
            if self._grain_src0 is not None:
                est = fg.estimate_params(self._grain_src0, bd=cfg.bd,
                                         strength_scale=cfg.film_grain / 8.0)
            self._grain_est = est or fg.synthetic_params(cfg.film_grain)
            self._grain_src0 = None
        return replace(self._grain_est, grain_seed=(7391 + disp_idx * 3083) & 0xFFFF)

    def send_frame(self, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> list:
        """Feed one display-order frame; returns the ready packets (coding
        order). An inter frame's packet is returned by a later call (or by
        flush); with MCTF, frames first wait in a short lookahead queue so
        that key frames and anchors are filtered with future neighbours;
        with intra batching, frames wait until a batch is full."""
        if (self.cfg.film_grain and self._grain_table is None
                and self._grain_est is None and self._grain_src0 is None):
            # the grain is estimated on the source as it comes in, before MCTF
            self._grain_src0 = (np.asarray(y), np.asarray(u), np.asarray(v))
        if not self._tf:
            return self._send_frame_inner(y, u, v)
        self._tf_q.append(tuple(np.asarray(p, np.int32) for p in (y, u, v)))
        return self._tf_drain(final=False)

    def _tf_drain(self, final: bool) -> list:
        from ..ops import tf_torch

        cfg = self.cfg
        packets = []
        while self._tf_q:
            d = self._tf_emitted
            # key frames and mini-GoP anchors (base pictures) are filtered,
            # as the reference filters every base picture
            scheduled = d % cfg.keyint == 0 or (cfg.minigop > 1 and d % cfg.minigop == 0)
            head = self._tf_q[0]
            if scheduled:
                if not final and len(self._tf_q) < 1 + self.TF_FUT:
                    break
                neigh = self._tf_hist + self._tf_q[1 : 1 + self.TF_FUT]
                if neigh:
                    h, w = head[0].shape
                    H64, W64 = -(-h // 64) * 64, -(-w // 64) * 64

                    def pad64(fr):
                        return [pad_to_aligned(fr[0], W64, H64),
                                pad_to_aligned(fr[1], W64 // 2, H64 // 2),
                                pad_to_aligned(fr[2], W64 // 2, H64 // 2)]

                    with profiler.stage("tf"):
                        f = tf_torch.filter_frame(pad64(head), [pad64(x) for x in neigh],
                                                  cfg.qindex, cfg.bd, self.device)
                    head = (f[0][:h, :w], f[1][: h // 2, : w // 2], f[2][: h // 2, : w // 2])
            self._tf_hist = (self._tf_hist + [self._tf_q.pop(0)])[-self.TF_PAST:]
            self._tf_emitted += 1
            packets += self._send_frame_inner(*head)
        return packets

    def _send_frame_inner(self, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> list:
        cfg = self.cfg
        d = self.next_disp
        self.next_disp += 1
        src = self._pad(y, u, v)
        is_key = cfg.keyint <= 1 or d % cfg.keyint == 0
        if self.scene is not None and self.scene.is_cut(src[0]) and d > 0:
            is_key = True
        if self._batching:
            self._ibatch.append((d, src))
            if len(self._ibatch) >= cfg.intra_batch:
                return self._encode_intra_batch()
            return []
        if self._crf:
            self._crf_pending.append((d, src, is_key))
            if len(self._crf_pending) >= max(cfg.lookahead, cfg.minigop + 1):
                return self._drain_crf(final=False)
            return []
        if is_key:
            packets = self._drain_pending() + self._pipe_drain()
            packets.append(self._encode_key(d, src))
            self.anchor = d
            return packets
        self.pending.append((d, src))
        packets = []
        if len(self.pending) == cfg.minigop:
            packets += self._code_minigop(self.pending)
            self.pending = []
        return packets

    def flush(self) -> list:
        packets = self._tf_drain(final=True) if self._tf else []
        if self._ibatch:  # a partial last batch
            packets += self._encode_intra_batch()
        if self._crf:
            return packets + self._drain_crf(final=True) + self._pipe_drain()
        return packets + self._drain_pending() + self._pipe_drain()

    def encode_frame(self, y, u, v):
        """Synchronous helper of low-delay configurations (minigop == 1, no
        MCTF, no CRF): returns (tu_bytes, recon_planes) of this display frame."""
        if self.cfg.minigop != 1 or self._tf or self._crf or self._batching:
            raise ValueError("encode_frame codes low-delay frames one at a time (minigop=1, "
                             "no MCTF, no CRF lookahead, no intra batching); use send_frame "
                             "and flush")
        pkts = self.send_frame(y, u, v) + self._pipe_drain()
        if len(pkts) != 1:
            raise RuntimeError(f"encode_frame expected one packet, got {len(pkts)}")
        return pkts[0].tu, pkts[0].recon

    # ------------------------------------------------------------- scheduling

    def _tpl_r0(self, window_lumas: list) -> np.ndarray:
        """TPL dispenser and synthesizer over a window of source lumas in the
        coded prediction structure (dyadic mini-GoPs when minigop > 1),
        padded to 64-multiples for the SB-granular ME pyramid."""
        from . import tpl

        h, w = window_lumas[0].shape
        H, W = -(-h // 64) * 64, -(-w // 64) * 64
        with profiler.stage("tpl"):
            stats = tpl.tpl_window([pad_to_aligned(y, W, H) for y in window_lumas],
                                   self.cfg.qindex, self.cfg.bd, minigop=self.cfg.minigop,
                                   device=self.device)
            return tpl.synthesize(stats)

    def _drain_crf(self, final: bool) -> list:
        """Code buffered frames with TPL-derived per-frame qindex (the
        reference's TPL group and crf_qindex_calc flow: src_ops_process.c
        tpl_mc_flow, rc_process.c:782). A key frame's window starts at the
        key; a mini-GoP's window starts at its anchor's source."""
        from . import tpl

        cfg = self.cfg
        la = max(cfg.lookahead, cfg.minigop + 1)
        hl = int(np.log2(max(cfg.minigop, 1)))
        packets = []
        while self._crf_pending and (final or len(self._crf_pending) >= la):
            pend = self._crf_pending
            if pend[0][2]:  # key frame: the window starts at the key itself
                packets += self._pipe_drain()
                r0s = self._tpl_r0([s[0] for (_d, s, _k) in pend[:la]])
                d, src, _ = pend.pop(0)
                q = tpl.crf_qindex(cfg.qindex, float(r0s[0]), True, 0, hl, cfg.bd)
                packets.append(self._encode_key(d, src, qindex_override=q))
                self.anchor = d
                self._anchor_src = src
                continue
            # frames until the next key bound this mini-GoP
            upto = next((i for i, e in enumerate(pend) if e[2]), len(pend))
            size = 1
            while size * 2 <= upto and size * 2 <= cfg.minigop:
                size *= 2
            if not final and upto >= len(pend) and upto < cfg.minigop:
                break  # wait for a full mini-GoP
            mg = pend[:size]
            wlen = min(la - 1, upto)
            r0s = self._tpl_r0([self._anchor_src[0]] + [s[0] for (_d, s, _k) in pend[:wlen]])
            r0_by_disp = {pend[i][0]: float(r0s[i + 1]) for i in range(wlen)}
            packets += self._code_minigop([(d, s) for (d, s, _k) in mg], r0_by_disp=r0_by_disp)
            self._anchor_src = mg[-1][1]
            del self._crf_pending[:size]
        return packets

    def _drain_pending(self) -> list:
        packets = []
        while self.pending:
            size = 1
            while size * 2 <= len(self.pending) and size * 2 <= self.cfg.minigop:
                size *= 2
            packets += self._code_minigop(self.pending[:size])
            self.pending = self.pending[size:]
        return packets

    def _code_minigop(self, frames: list, r0_by_disp: dict | None = None) -> list:
        from . import tpl

        srcs = {d: s for d, s in frames}
        sched = gop.schedule_minigop(self.anchor, len(frames))
        hl = int(np.log2(max(self.cfg.minigop, 1)))
        # liveness-based DPB slot assignment over slots 0..6 (slot 7 is the
        # GOLDEN key): a slot is reusable when its occupant is neither a ref
        # of a not-yet-coded frame, nor awaiting show_existing, nor the
        # mini-GoP's outgoing anchor
        needed_after = [set() for _ in sched]
        need: set = {frames[-1][0]}
        for i in range(len(sched) - 1, -1, -1):
            needed_after[i] = set(need)
            f = sched[i]
            need.update(x for x in (f.past_idx, f.future_idx) if x is not None)
            need.update(f.show_existing)
            if f.show is False:
                need.add(f.disp_idx)  # hidden frame awaits its display
        packets = []
        for i, f in enumerate(sched):
            if f.disp_idx not in needed_after[i] and f.show:
                slot = None  # shown now, referenced never: skip the refresh
            else:
                # the GOLDEN key always has slot 7, so its copies in 0..6 are
                # reusable; every other live ref is in needed_after
                keep = needed_after[i] - {self._golden_disp}
                slot = next((s for s in range(7)
                             if self._slot_occupant.get(s) is None
                             or self._slot_occupant[s] not in keep), None)
                if slot is None:
                    raise RuntimeError(f"live reference set {sorted(keep)} exceeds the 7 "
                                       "rotating DPB slots")
                self._slot_occupant[slot] = f.disp_idx
            q = None
            if r0_by_disp is not None:
                q = tpl.crf_qindex(self.cfg.qindex, r0_by_disp.get(f.disp_idx, 1.0), False,
                                   f.layer, hl, self.cfg.bd)
            packets += self._encode_push(f.disp_idx, srcs[f.disp_idx], f.show, f.layer,
                                         f.past_idx, f.future_idx, qindex_override=q,
                                         dpb_slot=slot)
            for se in f.show_existing:
                packets += self._push_done(self._show_existing(se))
        self.anchor = frames[-1][0]
        # drop DPB entries older than the new anchor (refs no longer
        # needed), except the GOLDEN key the sequence still references
        for k in [k for k in self.dpb if k < self.anchor and k != self._golden_disp]:
            del self.dpb[k]
        return packets

    # --------------------------------------------------------------- encoding

    def _pad(self, y, u, v):
        p = FrameParams(width=self.cfg.width, height=self.cfg.height, qindex=self.cfg.qindex,
                        bd=self.cfg.bd)
        aw, ah = p.aligned_width, p.aligned_height
        return [pad_to_aligned(np.asarray(y, np.int32), aw, ah),
                pad_to_aligned(np.asarray(u, np.int32), aw >> 1, ah >> 1),
                pad_to_aligned(np.asarray(v, np.int32), aw >> 1, ah >> 1)]

    def _frame_qindex(self, is_key: bool, layer: int, disp: int | None = None) -> int:
        if self.rc is not None:
            return self.rc.frame_qindex(is_key, layer, disp)
        q = self.cfg.qindex
        if self.cfg.minigop > 1 or self.cfg.keyint > 1:
            q += gop.KEY_Q_OFFSET if is_key else gop.LAYER_Q_OFFSET[min(layer, 2)]
        return max(1, min(255, q))

    def _metadata_obus(self) -> bytes:
        """HDR metadata OBUs of key-frame TUs (CLL, MDCV, ITU-T T.35; the
        reference's metadata_handle.c svt_aom_copy_metadata_buffer)."""
        from ..entropy import bitstream as bs

        cfg = self.cfg
        out = b""
        if cfg.content_light is not None:
            out += bs.content_light_obu(*cfg.content_light)
        if cfg.mastering_display is not None:
            prim, wp, mx, mn = cfg.mastering_display
            out += bs.mastering_display_obu(prim, wp, mx, mn)
        if cfg.itut_t35 is not None:
            out += bs.itut_t35_obu(0xB5, cfg.itut_t35)
        return out

    def _show_existing(self, disp_idx: int) -> Packet:
        slot = self.dpb[disp_idx]["slot"]
        tu = temporal_delimiter_obu() + show_existing_frame_obu(slot)
        return Packet(tu=tu, shown_disp_idx=disp_idx)

    def _gm_estimate(self, p, disp_idx: int, is_key: bool, past_idx, src) -> None:
        """Translation global-motion estimation against the LAST ref's
        source luma (codec/gm.py; global_me.c:126 analog), on the host. Also
        keeps the source lumas for later estimates: only this frame's and
        those of live DPB entries, the frames a later frame can name as
        past_idx (the reference keeps up to 32)."""
        if not self._use_gm:
            return
        cur = np.asarray(src[0])
        if not is_key and past_idx is not None:
            from ..codec import gm as gm_mod

            ref = self._gm_src.get(past_idx)
            if ref is not None and ref.shape == cur.shape:
                with profiler.stage("gm"):
                    mv = gm_mod.estimate_translation(cur, ref)
                if mv != (0, 0):
                    g = [(0, 0)] * 8
                    g[int(RefFrame.LAST_FRAME)] = mv
                    p.gm_mvs = tuple(g)
        self._gm_src[disp_idx] = cur
        for k in [k for k in self._gm_src if k != disp_idx and k not in self.dpb]:
            del self._gm_src[k]

    def _frame_setup(self, disp_idx: int, is_key: bool, layer: int, past_idx,
                     future_idx, qindex_override=None) -> dict:
        """Per-frame header/reference setup: qindex, ref map (id -> DPB
        planes), ref slots/hints, loop-filter levels, FrameParams."""
        cfg = self.cfg
        order_hint = disp_idx & 0x7F
        qindex = (qindex_override if qindex_override is not None
                  else self._frame_qindex(is_key, layer, disp_idx))
        ref_hints = [0] * 8
        refs = None
        ref_slot = [0] * 7
        if not is_key:
            past = self.dpb[past_idx]
            fut = self.dpb[future_idx] if future_idx is not None else None
            refs = {int(RefFrame.LAST_FRAME): past["planes"]}
            entries = {int(RefFrame.LAST_FRAME): past}
            if fut is not None:
                refs[int(RefFrame.ALTREF_FRAME)] = fut["planes"]
                entries[int(RefFrame.ALTREF_FRAME)] = fut
            # GOLDEN = the sequence's last key, kept even when it is also
            # LAST so the reference count stays constant across the GOP
            g = self._golden_disp
            if cfg.n_refs >= 3 and g is not None and g in self.dpb and g != future_idx:
                refs[int(RefFrame.GOLDEN_FRAME)] = self.dpb[g]["planes"]
                entries[int(RefFrame.GOLDEN_FRAME)] = self.dpb[g]
            for ref in range(1, 8):
                if ref in entries:
                    ent = entries[ref]
                elif ref >= int(RefFrame.BWDREF_FRAME) and fut is not None:
                    ent = fut
                else:
                    ent = past
                ref_hints[ref] = ent["order_hint"]
                ref_slot[ref - 1] = ent["slot"]
        lf_levels = (0, 0, 0, 0)
        if cfg.enable_dlf:
            from ..filters import dlf

            lf_levels = dlf.pick_filter_levels(qindex, cfg.bd, is_key, cfg.height)
        ref_select = int(cfg.enable_compound and not is_key and future_idx is not None
                         and not self._host_md and not cfg.enable_restoration)
        p = FrameParams(width=cfg.width, height=cfg.height, qindex=qindex, bd=cfg.bd,
                        tile_cols_log2=cfg.tile_cols_log2, tile_rows_log2=cfg.tile_rows_log2,
                        frame_is_intra=is_key, order_hint=order_hint,
                        ref_hints=tuple(ref_hints), lf_levels=lf_levels,
                        reference_select=ref_select,
                        enable_filter_intra=cfg.enable_filter_intra,
                        enable_rdoq=self._rdoq, enable_gm=int(self._use_gm), **self._sf)
        return dict(p=p, refs=refs, ref_slot=ref_slot, order_hint=order_hint)

    def _dpb_assign(self, disp_idx: int, is_key: bool, dpb_slot):
        """DPB slot + refresh flag; GOLDEN bookkeeping for keys."""
        refresh = True
        if dpb_slot == "auto":
            slot = 7 if is_key else disp_idx % 7
        elif dpb_slot is None:
            slot, refresh = 0, False
        else:
            slot = dpb_slot
        if is_key:
            self._golden_disp = disp_idx
            self._slot_occupant = {s: disp_idx for s in range(7)}
        return slot, refresh

    def _stack_refs(self, refs: dict):
        """(NREF, H, W) device stacks per plane from DPB entries (uint8, int16
        at 10 bits), in RefFrame id order (LAST first)."""
        ref_ids = sorted(refs.keys())
        return tuple(torch.stack([refs[r][pl] for r in ref_ids]) for pl in range(3)), ref_ids

    def _write_tu(self, fr: FrameConfig, payload, metadata: bytes = b"") -> bytes:
        """The TU of a coded frame; its size goes to the rate controller."""
        tu = temporal_delimiter_obu()
        if not self._wrote_seq:
            tu += sequence_header_obu(self.seq)
            self._wrote_seq = True
        tu += metadata + frame_obu(self.seq, fr, payload)
        if self.rc is not None:
            self.rc.update(len(tu) * 8.0)
        return tu

    def _save_contexts(self, walk_fc, p, slot: int, is_key: bool) -> None:
        """Store the frame context (tile 0's adapted end state, its update
        counters restarted) and the gm params with the refreshed slot(s)."""
        saved_ctx = walk_fc if self.cfg.cdf_inheritance else None
        if saved_ctx is not None:
            saved_ctx.reset_counters()
        if is_key:
            self._cdf_slots = [saved_ctx] * 8
            self._gm_slots = [tuple(p.gm_mvs)] * 8
        else:
            self._cdf_slots[slot] = saved_ctx
            self._gm_slots[slot] = tuple(p.gm_mvs)

    def _walk(self, p, plan, walk_fc) -> list:
        """The entropy payloads of a plan, one per tile: tile 0 adapts
        walk_fc in place (its end state is the stored frame context), later
        tiles restart from the frame-initial state."""
        with profiler.stage("entropy_walk"):
            fc_init = walk_fc.clone()
            return [TileCodec(p, walk_fc if i == 0 else fc_init.clone(), tile=t).encode(plan)
                    for i, t in enumerate(p.tiles())]

    def _payloads(self, p, plan, recon: list, filt: dict, src: list, walk_fc) -> list:
        """The payloads of a plan whose recon has been through DLF and CDEF:
        _restore under restoration, else the plan walk."""
        if self.cfg.enable_restoration:
            return self._restore(p, plan, recon, filt, src, walk_fc)
        return self._walk(p, plan, walk_fc)

    def _host_plan(self, src: list, p, refs: dict | None) -> tuple:
        """The host route's frame (the reference's _encode_one under
        mode_decision="numpy"): the host mode decision (intra_md for a key
        frame, inter_md on the references downloaded as host int32 planes),
        then the plan's DLF and CDEF on the device
        (device_commit.plan_filters). Returns (plan, recon, filt) as the
        restoration route's commit does."""
        from . import device_commit, inter_md, intra_md

        with profiler.stage("host_md"):
            if refs is None:
                plan, recon = intra_md.encode_intra_frame(src, p)
            else:
                host_refs = {r: [pl.cpu().numpy().astype(np.int32) for pl in planes]
                             for r, planes in refs.items()}
                plan, recon = inter_md.encode_inter_frame(src, p, host_refs)
        recon, filt = device_commit.plan_filters(plan, recon, src[0], p, self.device,
                                                 self.cfg.enable_cdef,
                                                 deblocked=self.cfg.enable_restoration)
        return plan, recon, filt

    def _restore(self, p, plan, recon: list, filt: dict, src: list, walk_fc) -> list:
        """The host half of the restoration route (the reference's
        _encode_one under enable_restoration), after the device filters
        (device_commit.restoration_filters, or plan_filters on the host
        route): the loop-restoration search of each plane on the CDEF output
        `recon` against the deblocked planes, the plan walk with the
        restoration units, then the restoration filter. recon is filtered
        in place; returns the payloads."""
        from ..filters import restoration as lr_mod
        from .intra_md import rd_lambda

        cfg = self.cfg
        deblocked = filt["deblocked"]

        def plane_args(plane):
            sub = 1 if plane else 0
            return (p.lr_unit_size(plane), (cfg.width + sub) >> sub, (cfg.height + sub) >> sub,
                    sub, p.bd, plane > 0)

        with profiler.stage("lr_search"):
            lam = float(rd_lambda(p.qindex, p.bd))
            found = [lr_mod.search_plane(src[pl], recon[pl], deblocked[pl], *plane_args(pl), lam)
                     for pl in range(3)]
            p.lr_types = tuple(ftype for ftype, _ in found)
            plan.lr_units = [units for _, units in found]
        payloads = self._walk(p, plan, walk_fc)
        with profiler.stage("lr_apply"):
            for pl in range(3):
                if p.lr_types[pl] != lr_mod.RESTORE_NONE:
                    recon[pl] = lr_mod.apply_lr_plane(recon[pl], deblocked[pl], plan.lr_units[pl],
                                                      *plane_args(pl))
        return payloads

    def _encode_key(self, disp_idx: int, src: list, qindex_override=None) -> Packet:
        """Decide, commit and filter one key frame, then _finish_key. Under
        restoration the restoration route's filters run and _restore
        follows; the host route decides on the host (_host_plan)."""
        from . import device_commit

        cfg = self.cfg
        setup = self._frame_setup(disp_idx, True, 0, None, None, qindex_override)
        p = setup["p"]
        self._gm_estimate(p, disp_idx, True, None, src)
        walk_fc = FrameContext(p.qindex)
        if self._host_md:
            plan, recon, filt = self._host_plan(src, p, None)
            payloads = self._payloads(p, plan, recon, filt, src, walk_fc)
        elif cfg.enable_restoration:
            plan, recon, filt, _ = device_commit.encode_intra_frames(
                [src], p, self.device, enable_cdef=cfg.enable_cdef, walk_fcs=[walk_fc],
                restoration=True)[0]
            payloads = self._restore(p, plan, recon, filt, src, walk_fc)
        else:
            plan, recon, filt, payloads = device_commit.encode_intra_frames(
                [src], p, self.device, apply_filters=cfg.enable_dlf or cfg.enable_cdef,
                enable_dlf=cfg.enable_dlf, enable_cdef=cfg.enable_cdef, walk_fcs=[walk_fc])[0]
        return self._finish_key(disp_idx, setup, plan, recon, filt, payloads, walk_fc)

    def _encode_intra_batch(self) -> list:
        """Code the queued all-intra frames as one batch: one qindex, one
        device_commit.encode_intra_frames call (the decide, one K16 launch
        and one filter pass over the batch), then each frame's _finish_key
        in display order."""
        from . import device_commit

        cfg = self.cfg
        batch, self._ibatch = self._ibatch, []
        q = self._frame_qindex(True, 0)
        setups = [self._frame_setup(d, True, 0, None, None, q) for d, _ in batch]
        walk_fcs = [FrameContext(q) for _ in batch]
        outs = device_commit.encode_intra_frames(
            [src for _, src in batch], setups[0]["p"], self.device,
            apply_filters=cfg.enable_dlf or cfg.enable_cdef, enable_dlf=cfg.enable_dlf,
            enable_cdef=cfg.enable_cdef, walk_fcs=walk_fcs)
        packets = []
        for (d, _), setup, out, walk_fc in zip(batch, setups, outs, walk_fcs):
            packets.append(self._finish_key(d, setup, *out, walk_fc))
            self.anchor = d
        return packets

    def _finish_key(self, disp_idx: int, setup: dict, plan, recon: list, filt, payloads,
                    walk_fc) -> Packet:
        """A committed key frame's header, TU, DPB entry and saved contexts.
        filt: the filter levels and CDEF strengths the frame was filtered
        with (None: unfiltered); payloads None: walk the plan here."""
        cfg = self.cfg
        p = setup["p"]
        if payloads is None:
            payloads = self._walk(p, plan, walk_fc)
        cdef_y, cdef_uv, cdef_damping = ((0, 0),), ((0, 0),), 3
        hdr_lf = p.lf_levels
        if filt is not None:
            hdr_lf = tuple(filt["lf_levels"])
            ypri, ysec, upri, usec, cdef_damping = filt["cdef"]
            cdef_y, cdef_uv = ((ypri, ysec),), ((upri, usec),)
        replicate_display_edges(recon, cfg.width, cfg.height)
        fr = FrameConfig(qindex=p.qindex, disable_cdf_update=p.disable_cdf_update,
                         show_frame=True,
                         tile_cols_log2=p.tile_cols_log2, tile_rows_log2=p.tile_rows_log2,
                         frame_type=0, order_hint=setup["order_hint"], refresh_frame_flags=0xFF,
                         ref_frame_idx=tuple(setup["ref_slot"]),
                         lf_levels=hdr_lf, lf_sharpness=p.lf_sharpness,
                         cdef_damping=cdef_damping, cdef_y=cdef_y, cdef_uv=cdef_uv,
                         primary_ref_frame=7,  # PRIMARY_REF_NONE
                         frame_end_update_cdf=cfg.cdf_inheritance,
                         lr_types=p.lr_types, lr_unit_shift=p.lr_unit_shift,
                         lr_uv_shift=p.lr_uv_shift,
                         reference_select=p.reference_select, skip_mode_allowed=False,
                         gm_mvs=p.gm_mvs, prev_gm_mvs=None,
                         film_grain=self._grain_for(disp_idx))
        tu = self._write_tu(fr, payloads, self._metadata_obus())
        # keys park in slot 7 (they refresh all slots) so the GOLDEN
        # reference survives the rotating non-key slots 0..6; nothing coded
        # before a key can be referenced after it
        slot, _ = self._dpb_assign(disp_idx, True, "auto")
        if cfg.keyint > 1:
            self.dpb = {disp_idx: {"planes": self._upload(recon),
                                   "order_hint": setup["order_hint"], "slot": slot}}
        self._save_contexts(walk_fc, p, slot, True)
        return Packet(tu=tu, disp_idx=disp_idx, recon=recon, shown_disp_idx=disp_idx)

    def _upload(self, recon: list) -> list:
        """Host recon planes as device DPB planes (uint8, int16 at 10 bits)."""
        dt = plane_np_dtype(self.cfg.bd)
        return [torch.from_numpy(pl.astype(dt)).to(self.device) for pl in recon]

    # --------------------------------------------------- pipelined inter path

    def _pipe_drain(self) -> list:
        """Finish every queued pipeline item in order."""
        items, self._pipe = self._pipe, []
        return [payload if kind == "done" else self._pipe_finish(payload)
                for kind, payload in items]

    def _push_done(self, pkt: Packet) -> list:
        """Order an already-built packet behind any in-flight frame."""
        if self._pipe:
            self._pipe.append(("done", pkt))
            return []
        return [pkt]

    def _encode_push(self, disp_idx: int, src: list, show: bool, layer: int, past_idx,
                     future_idx, qindex_override=None, dpb_slot="auto") -> list:
        """Pipelined inter encode: dispatch this frame's decide, finish older
        frames on the host (overlapping the device), then dispatch commit and
        filters and queue the host finish. Under rate control the next
        frame's qindex needs this frame's size, so the frame is finished at
        once. Under restoration, and on the host route, the frame is coded
        synchronously (_encode_sync)."""
        from . import inter_device

        cfg = self.cfg
        setup = self._frame_setup(disp_idx, False, layer, past_idx, future_idx, qindex_override)
        p = setup["p"]
        self._gm_estimate(p, disp_idx, False, past_idx, src)
        st = dict(setup=setup, show=show, disp_idx=disp_idx)
        if self._host_md:  # nothing is in flight on this route
            return [self._encode_sync(st, None, src, dpb_slot)]
        refs_dev, ref_ids = self._stack_refs(setup["refs"])
        pend = inter_device.inter_start_decide(src, p, refs_dev, p.interp_filter, ref_ids)
        out = self._pipe_drain()  # host walks of older frames overlap the decide
        if cfg.enable_restoration:
            return out + [self._encode_sync(st, pend, src, dpb_slot)]
        pend = inter_device.inter_start_commit(pend, enable_dlf=cfg.enable_dlf,
                                               enable_cdef=cfg.enable_cdef)
        self._dpb_enter(st, dpb_slot, pend.dpb_planes)
        self._pipe.append(("frame", dict(st, pend=pend)))
        if self.rc is not None:
            out += self._pipe_drain()
        return out

    def _encode_sync(self, st: dict, pend, src: list, dpb_slot) -> Packet:
        """An inter frame coded synchronously: on the host route (pend None)
        _host_plan, else the restoration route's commit and filters on the
        device (inter_device.inter_commit_restoration); then _payloads, the
        DPB entry uploaded to the device, and _finish_inter."""
        from . import inter_device

        p = st["setup"]["p"]
        walk_fc, primary_ref = self._inter_context(p, st["setup"]["ref_slot"])
        if pend is None:
            plan, recon, filt = self._host_plan(src, p, st["setup"]["refs"])
        else:
            plan, recon, filt = inter_device.inter_commit_restoration(
                pend, enable_cdef=self.cfg.enable_cdef)
        payloads = self._payloads(p, plan, recon, filt, src, walk_fc)
        replicate_display_edges(recon, self.cfg.width, self.cfg.height)
        self._dpb_enter(st, dpb_slot, self._upload(recon))
        return self._finish_inter(st, walk_fc, primary_ref, recon, filt, payloads)

    def _dpb_enter(self, st: dict, dpb_slot, planes: list) -> None:
        """An inter frame's DPB slot, refresh flag (into st) and DPB entry of
        its device planes."""
        st["slot"], st["refresh"] = self._dpb_assign(st["disp_idx"], False, dpb_slot)
        self.dpb[st["disp_idx"]] = {"planes": planes, "order_hint": st["setup"]["order_hint"],
                                    "slot": st["slot"]}

    def _inter_context(self, p, ref_slot) -> tuple:
        """(frame-initial CDFs, primary_ref_frame) of an inter frame: the
        LAST reference's saved context under CDF inheritance, else the
        defaults and PRIMARY_REF_NONE."""
        if self.cfg.cdf_inheritance:
            saved = self._cdf_slots[ref_slot[0]]
            if saved is not None:
                return saved.clone(), 0  # LAST
        return FrameContext(p.qindex), 7

    def _pipe_finish(self, st: dict) -> Packet:
        from . import inter_device

        setup = st["setup"]
        walk_fc, primary_ref = self._inter_context(setup["p"], setup["ref_slot"])
        _, recon, filt, payloads = inter_device.inter_finish(st["pend"], walk_fc)
        return self._finish_inter(st, walk_fc, primary_ref, recon, filt, payloads)

    def _finish_inter(self, st: dict, walk_fc, primary_ref: int, recon: list, filt: dict,
                      payloads: list) -> Packet:
        """An inter frame's header, TU and saved contexts."""
        from ..entropy.bitstream import skip_mode_allowed

        cfg = self.cfg
        setup = st["setup"]
        p, ref_slot = setup["p"], setup["ref_slot"]
        slot, refresh = st["slot"], st["refresh"]
        disp_idx, show = st["disp_idx"], st["show"]
        ypri, ysec, upri, usec, cdef_damping = filt["cdef"]
        fr = FrameConfig(qindex=p.qindex, disable_cdf_update=p.disable_cdf_update,
                         show_frame=show,
                         tile_cols_log2=p.tile_cols_log2, tile_rows_log2=p.tile_rows_log2,
                         frame_type=1, order_hint=setup["order_hint"],
                         refresh_frame_flags=(1 << slot) if refresh else 0,
                         ref_frame_idx=tuple(ref_slot),
                         lf_levels=filt["lf_levels"], lf_sharpness=p.lf_sharpness,
                         cdef_damping=cdef_damping, cdef_y=((ypri, ysec),),
                         cdef_uv=((upri, usec),),
                         primary_ref_frame=primary_ref,
                         frame_end_update_cdf=cfg.cdf_inheritance,
                         lr_types=p.lr_types, lr_unit_shift=p.lr_unit_shift,
                         lr_uv_shift=p.lr_uv_shift,
                         reference_select=p.reference_select,
                         skip_mode_allowed=bool(p.reference_select) and skip_mode_allowed(
                             p.order_hint, p.order_hint_bits, list(p.ref_hints[1:])),
                         gm_mvs=p.gm_mvs,
                         prev_gm_mvs=(self._gm_slots[ref_slot[primary_ref]]
                                      if primary_ref != 7 else None),
                         film_grain=self._grain_for(disp_idx))
        tu = self._write_tu(fr, payloads[0])
        if refresh:
            self._save_contexts(walk_fc, p, slot, False)
        return Packet(tu=tu, disp_idx=disp_idx, recon=recon,
                      shown_disp_idx=disp_idx if show else None)
