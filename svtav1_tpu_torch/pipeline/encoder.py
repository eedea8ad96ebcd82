"""Top-level encoder of the PyTorch port: all-intra (key-frame) CQP encoding
on a CUDA device, ported from svtav1_tpu's pipeline/encoder.py.

API shape mirrors the reference's library API (EbSvtAv1Enc.h:966-1076
svt_av1_enc_send_picture / _get_packet): `send_frame` returns the packets
that become ready, `flush` drains the tail, `encode_frame` is the
synchronous helper. Every frame is a key frame coded by
`device_commit.encode_intra_frames` on `device`.

This slice supports `keyint=1` with every preset ("fast", "medium", "slow"),
8-bit, CQP, one tile, DLF and CDEF each on or off. Every other setting
raises NotImplementedError naming the ROADMAP item that brings it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..codec.tile_codec import FrameParams, TileCodec
from ..constants.cdf import FrameContext
from ..entropy.bitstream import (FrameConfig, SequenceConfig, frame_obu, sequence_header_obu,
                                 temporal_delimiter_obu)
from ..utils import profiler


@dataclass
class EncoderConfig:
    width: int
    height: int
    qindex: int = 120  # base_q_idx (CQP)
    bd: int = 8
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    keyint: int = 1  # key frame every N frames (1 = all-intra)
    minigop: int = 1  # 1 = low-delay; 2/4/8 = hierarchical-B mini-GoPs
    enable_dlf: bool = True  # in-loop deblocking (by-q levels)
    enable_cdef: bool = True  # CDEF (frame-wide searched strength set)
    enable_filter_intra: bool = False  # recursive filter-intra
    rc_mode: str = "cqp"  # "cqp" | "cbr" | "vbr" | "crf"
    enable_restoration: bool = False  # loop restoration (Wiener + self-guided)
    scene_cut: bool = False  # adaptive key frames on scene changes
    intra_batch: int = 1  # all-intra frame batching through the device pipeline
    enable_tf: bool = False  # MCTF of key frames
    preset: str = "medium"  # "fast" | "medium" | "slow"
    film_grain: int = 0  # film grain synthesis strength (0 = off)
    film_grain_table: str | None = None  # explicit aomenc "filmgrn1" table


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

# setting -> (is it outside this slice?, the ROADMAP queue 1 item that brings it)
_UNSUPPORTED = (
    (lambda c: c.keyint != 1, "keyint != 1 (inter frames)", "the inter path"),
    (lambda c: c.minigop != 1, "minigop != 1", "hierarchical-B/compound"),
    (lambda c: c.enable_restoration, "enable_restoration", "restoration"),
    (lambda c: c.enable_tf, "enable_tf", "MCTF"),
    (lambda c: c.scene_cut, "scene_cut", "the inter path"),
    (lambda c: bool(c.film_grain or c.film_grain_table), "film_grain", "film grain"),
    (lambda c: c.tile_cols_log2 > 0 or c.tile_rows_log2 > 0, "tiles", "tiles"),
    (lambda c: c.intra_batch > 1, "intra_batch > 1", "intra batching"),
    (lambda c: c.rc_mode != "cqp", "rc_mode != 'cqp'", "TPL/CRF and rate control"),
    (lambda c: c.bd != 8, "bd != 8", "10-bit at the encoder level"),
    (lambda c: c.enable_filter_intra, "enable_filter_intra", "filter-intra"),
)


@dataclass
class Packet:
    """One temporal unit out of the encoder (coding order)."""

    tu: bytes
    disp_idx: int | None = None  # display idx of the frame coded in this TU
    recon: list | None = None  # encoder recon (aligned planes)
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


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA. Without CUDA only an explicit CPU device is taken."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("svtav1_tpu_torch runs on a CUDA device and none is available; "
                           "pass device='cpu' to run the plain PyTorch versions of the kernels")
    return dev


class Encoder:
    def __init__(self, cfg: EncoderConfig, device=None):
        # 4:2:0 needs even dims; sources are padded to the mi-aligned size
        # (always a multiple of 8) and cropped at display per the spec
        if cfg.width % 2 or cfg.height % 2:
            raise ValueError("4:2:0 requires even dims")
        if cfg.preset not in PRESETS:
            raise ValueError(f"unknown preset {cfg.preset!r}: one of {sorted(PRESETS)}")
        for outside, what, item in _UNSUPPORTED:
            if outside(cfg):
                raise NotImplementedError(
                    f"{what} is not in this slice of svtav1_tpu_torch; it comes with "
                    f"ROADMAP queue 1 '{item}'")
        self.device = resolve_device(device)
        self.cfg = cfg
        self._sf = PRESETS[cfg.preset]
        self._rdoq = PRESET_RDOQ[cfg.preset]
        self.seq = SequenceConfig(width=cfg.width, height=cfg.height, bd=cfg.bd,
                                  enable_cdef=cfg.enable_cdef,
                                  enable_restoration=cfg.enable_restoration,
                                  enable_filter_intra=cfg.enable_filter_intra,
                                  film_grain_params_present=False)
        self.next_disp = 0  # next display index expected from the caller
        self._wrote_seq = False

    # ------------------------------------------------------------------- API

    def send_frame(self, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> list:
        """Feed one display-order frame; returns the ready packets (every
        frame is a key frame, so each call returns its own packet)."""
        d = self.next_disp
        self.next_disp += 1
        return [self._encode_one(d, self._pad(y, u, v))]

    def flush(self) -> list:
        return []

    def encode_frame(self, y, u, v):
        """Synchronous helper: returns (tu_bytes, recon_planes)."""
        pkts = self.send_frame(y, u, v)
        return pkts[0].tu, pkts[0].recon

    # --------------------------------------------------------------- encoding

    def _pad(self, y, u, v):
        p = FrameParams(width=self.cfg.width, height=self.cfg.height, qindex=self.cfg.qindex,
                        bd=self.cfg.bd)
        aw, ah = p.aligned_width, p.aligned_height
        return [pad_to_aligned(np.asarray(y, np.int32), aw, ah),
                pad_to_aligned(np.asarray(u, np.int32), aw >> 1, ah >> 1),
                pad_to_aligned(np.asarray(v, np.int32), aw >> 1, ah >> 1)]

    def _encode_one(self, disp_idx: int, src: list) -> Packet:
        from . import device_commit

        cfg = self.cfg
        order_hint = disp_idx & 0x7F
        qindex = max(1, min(255, cfg.qindex))
        lf_levels = (0, 0, 0, 0)
        if cfg.enable_dlf:
            from ..filters import dlf

            lf_levels = dlf.pick_filter_levels(qindex, cfg.bd, True, cfg.height)
        p = FrameParams(width=cfg.width, height=cfg.height, qindex=qindex, bd=cfg.bd,
                        frame_is_intra=True, order_hint=order_hint, ref_hints=(0,) * 8,
                        lf_levels=lf_levels, enable_rdoq=self._rdoq, **self._sf)
        walk_fc = FrameContext(p.qindex)
        plan, recon, filt, payloads = device_commit.encode_intra_frames(
            [src], p, self.device, apply_filters=cfg.enable_dlf or cfg.enable_cdef,
            enable_dlf=cfg.enable_dlf, enable_cdef=cfg.enable_cdef, walk_fcs=[walk_fc])[0]
        if payloads is None:
            with profiler.stage("entropy_walk"):
                payloads = [TileCodec(p, walk_fc, tile=p.tiles()[0]).encode(plan)]

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
                         frame_type=0, order_hint=order_hint, refresh_frame_flags=0xFF,
                         ref_frame_idx=(0,) * 7,
                         lf_levels=hdr_lf, lf_sharpness=p.lf_sharpness,
                         cdef_damping=cdef_damping, cdef_y=cdef_y, cdef_uv=cdef_uv,
                         primary_ref_frame=7,  # PRIMARY_REF_NONE
                         # the reference's default cdf_inheritance: adapted
                         # end-of-frame CDFs are stored with every frame
                         frame_end_update_cdf=True,
                         lr_types=p.lr_types, lr_unit_shift=p.lr_unit_shift,
                         lr_uv_shift=p.lr_uv_shift,
                         reference_select=p.reference_select, skip_mode_allowed=False,
                         gm_mvs=p.gm_mvs, prev_gm_mvs=None, film_grain=None)
        tu = temporal_delimiter_obu()
        if not self._wrote_seq:
            tu += sequence_header_obu(self.seq)
            self._wrote_seq = True
        tu += frame_obu(self.seq, fr, payloads[0])
        return Packet(tu=tu, disp_idx=disp_idx, recon=recon, shown_disp_idx=disp_idx)
