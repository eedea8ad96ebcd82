"""Shared check of the port's encodes against the JAX package's device path
(svtav1_tpu's Encoder(mode_decision="jax")) on the CPU, and of the port's
streams against libaom.

Two deliberate divergences (ROADMAP queue 3) shape the comparison:
- the compound-mode context map: the port codes inter_compound_mode with
  the spec's Compound_Mode_Ctx_Map, the reference with a wrong one, so the
  bytes of a TU that codes a compound block may differ (its recon may not);
- deblocking at a display edge that is not a multiple of 8: the port, like
  the spec and libaom, leaves the edge segments outside the displayed frame
  unfiltered; the reference filters them, and CDEF and later frames read
  those samples. The reference runs here with the spec's rule, written
  in this module apart from the port (`reference_with_display_edge_rule`),
  which changes nothing where the frame is a multiple of 8.
Every port TU must also decode in libaom to the port's recon (where the
host has libaom)."""
import contextlib
import inspect
from unittest import mock

import jax.numpy as jnp
import numpy as np
import torch

from svtav1_tpu.filters import dlf_jax
from svtav1_tpu.pipeline import device_commit as ref_commit
from svtav1_tpu.pipeline import device_decide as ref_decide
from svtav1_tpu.pipeline import encoder as ref_enc
from svtav1_tpu.pipeline import intra_device as ref_intra
from svtav1_tpu_torch.codec.tile_codec import TileCodec
from svtav1_tpu_torch.decode.decoder import Decoder
from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.utils import aomdec
from svtav1_tpu_torch.utils.testclip import make_frames
from tools.make_test_video import make_frames as ref_make_frames

# The suite runs in several worker processes on a few cores, and every
# worker imports this module while it collects the tests. PyTorch's
# intra-op thread pool (one thread per core in every process) would
# oversubscribe the cores and spin; the port's plain versions run at test
# sizes, where one thread per process is faster.
torch.set_num_threads(1)


def spec_offscreen(n_rows: int, n_edges: int, plane: int, transpose: bool, w: int,
                   h: int) -> np.ndarray:
    """(n_rows, n_edges) bool: the segments of a vertical-edge map (edge k
    at plane column 4(k+1), segment j at plane row 4j; rows and columns
    swapped for the horizontal pass) that the spec's edge loop (7.14.2)
    finds off screen: its luma position x >= FrameWidth or y >= FrameHeight.
    A chroma sample at plane position p lies at luma position 2p."""
    ss = 1 if plane else 0
    edge = (4 * np.arange(1, n_edges + 1)) << ss
    row = (4 * np.arange(n_rows)) << ss
    if transpose:  # edges lie along rows, segments along columns
        return (edge[None, :] >= h) | (row[:, None] >= w)
    return (edge[None, :] >= w) | (row[:, None] >= h)


@contextlib.contextmanager
def reference_with_display_edge_rule(w: int, h: int):
    """Within the block, the JAX package's deblocking leaves the edge
    segments outside the displayed w x h frame unfiltered, as the spec
    (7.14.2 onScreen), libaom and the port do: its filter-length maps are
    masked with `spec_offscreen`. The package itself stays as it is."""
    real = dlf_jax.flen_maps_from_sizes

    def masked(size_map, plane, transpose):
        flen = np.array(real(size_map, plane, transpose))
        flen[:, spec_offscreen(flen.shape[1], flen.shape[2], plane, transpose, w, h)] = 0
        return flen

    with mock.patch.object(dlf_jax, "flen_maps_from_sizes", masked):
        yield


@contextlib.contextmanager
def reference_with_spec_rules(bd: int):
    """Within the block, the JAX package follows the two spec rules the port
    keeps (ROADMAP queue 3): its _predict_modes (as its decide, its commit
    and its TPL probe call it) predicts DC with neither neighbour as
    1 << (bd - 1), and its _filter_device, when a frame's luma levels come
    out 0, returns the frame filtered with no deblocking at all (the decoder
    filters no plane then) and the searched level's index. Yields the
    number of frames that took the second rule. The package itself stays
    as it is. Its jitted programs keep the rules they were traced with, so
    a worker must trace every program it compares here inside the block."""
    real_pm = ref_decide._predict_modes
    real_fd = ref_commit._filter_device
    sig = inspect.signature(real_fd)
    level0 = [0]

    def predict_modes(above, left, topleft, have_above, have_left, n, *a, **kw):
        out = real_pm(above, left, topleft, have_above, have_left, n, *a, **kw)
        none = ~(jnp.asarray(have_above).astype(bool) | jnp.asarray(have_left).astype(bool))
        return out.at[:, 0].set(jnp.where(none[:, None, None], 1 << (bd - 1), out[:, 0]))

    def filter_device(*args, **kw):
        a = sig.bind(*args, **kw)
        a.apply_defaults()
        a = dict(a.arguments)
        out = real_fd(**a)
        levels, lf_search = a["levels"], a["lf_search"]
        if not (levels[2] or levels[3]):
            return out
        picks = np.asarray(out[1])[:, 4]
        off = [lf_search[k] == 0 if lf_search else levels[0] == levels[1] == 0 for k in picks]
        if not any(off):
            return out
        assert all(off), "a batch mixing level-0 and filtered frames"
        level0[0] += len(off)
        packed, stats, planes = real_fd(**dict(a, levels=(0, 0, 0, 0), lf_search=()))
        return packed, stats.at[:, 4].set(out[1][:, 4]), planes

    with mock.patch.object(ref_decide, "_predict_modes", predict_modes), \
            mock.patch.object(ref_commit, "_predict_modes", predict_modes), \
            mock.patch.object(ref_intra, "_predict_modes", predict_modes), \
            mock.patch.object(ref_commit, "_filter_device", filter_device):
        yield level0


def decode_counting_compound(dec: Decoder, tu: bytes):
    """dec.decode_tu(tu) and the number of compound blocks it parsed."""
    count = [0]
    real = TileCodec._code_comp_mode_mv

    def spy(self, *args, **kw):
        count[0] += 1
        return real(self, *args, **kw)

    with mock.patch.object(TileCodec, "_code_comp_mode_mv", spy):
        out = dec.decode_tu(tu)
    return out, count[0]


def noisy_frames(w: int, h: int, n: int, seed: int = 9, bd: int = 8) -> list:
    """The noisy clip of the reference's tests/test_restoration.py (a ramp
    plus Gaussian noise, flat chroma), on which the loop-restoration search
    picks a filter where the synthetic clip picks none; at 10 bits the
    samples are shifted left by 2."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    out = []
    for i in range(n):
        y = np.clip((xx + yy * 2 + i * 3) % 256 + rng.normal(0, 6, (h, w)), 0, 255)
        planes = (y.astype(np.int32), np.full((h // 2, w // 2), 120, np.int32),
                  np.full((h // 2, w // 2), 130, np.int32))
        out.append(tuple(p << (bd - 8) for p in planes))
    return out


def displayed(planes, w: int, h: int) -> list:
    """The displayed w x h part of 4:2:0 recon planes."""
    return [planes[0][:h, :w], planes[1][: (h + 1) >> 1, : (w + 1) >> 1],
            planes[2][: (h + 1) >> 1, : (w + 1) >> 1]]


def matches_jax_and_decodes(w: int, h: int, cfg: dict) -> None:
    """Two frames of the synthetic clip through both encoders in `cfg`:
    identical TUs and recon, the port's decoder reproduces the recon, and
    libaom decodes the port's TUs to it."""
    frames = make_frames(w, h, 2)
    for a, b in zip(frames, ref_make_frames(w, h, 2)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    ref = ref_enc.Encoder(ref_enc.EncoderConfig(w, h, mode_decision="jax", **cfg))
    port = port_enc.Encoder(port_enc.EncoderConfig(w, h, **cfg), device="cpu")
    dec = Decoder()
    tus, shown = [], []
    for f, (y, u, v) in enumerate(frames):
        with reference_with_display_edge_rule(w, h):
            want_tu, want_rec = ref.encode_frame(y, u, v)
        tu, rec = port.encode_frame(y, u, v)
        for i in range(3):
            np.testing.assert_array_equal(rec[i], want_rec[i], err_msg=f"frame {f} plane {i}")
        assert tu == want_tu, f"frame {f}: {len(tu)} vs {len(want_tu)} bytes"
        dy, du, dv, drec = dec.decode_tu(tu)
        for i in range(3):
            np.testing.assert_array_equal(drec[i], rec[i], err_msg=f"decode frame {f} plane {i}")
        assert dy.shape == (h, w)
        tus.append(tu)
        shown.append(displayed(rec, w, h))
    check_libaom(tus, shown)


def gop_matches_jax_and_decodes(w: int, h: int, cfg: dict, frames: int, clip=None) -> list:
    """`frames` frames of the synthetic clip, or of `clip` when given (a key
    frame, then P frames when cfg["keyint"] > 1, or hierarchical-B
    mini-GoPs when cfg["minigop"] > 1) through both encoders with
    send_frame + flush: identical TUs and recon in coding order,
    show-existing TUs included, every frame shown once in display order;
    and the port's decoder, fed the TUs in order, reproduces every recon
    and displays each frame's recon (with film grain: the recon plus the
    grain, which must change it); libaom decodes the port's TUs to the
    shown frames. A TU that codes a compound block may differ in its bytes
    (the compound-mode context map, see the module note). Returns the
    port's packets. cfg may name the route (`mode_decision`, the device
    route "jax" by default); both encoders take it."""
    if clip is None:
        clip = make_frames(w, h, frames)
    ref = ref_enc.Encoder(ref_enc.EncoderConfig(w, h, **{"mode_decision": "jax", **cfg}))
    port = port_enc.Encoder(port_enc.EncoderConfig(w, h, **cfg), device="cpu")
    want, got = [], []
    with reference_with_display_edge_rule(w, h):
        for y, u, v in clip:
            want += ref.send_frame(y, u, v)
            got += port.send_frame(y, u, v)
        want += ref.flush()
    got += port.flush()
    order = [(p.disp_idx, p.shown_disp_idx) for p in got]
    assert order == [(p.disp_idx, p.shown_disp_idx) for p in want]
    assert sorted(d for d, _ in order if d is not None) == list(range(frames))
    assert [s for _, s in order if s is not None] == list(range(frames))
    dec = Decoder()
    recon_of = {}
    shown = Shown(w, h, grain=bool(cfg.get("film_grain") or cfg.get("film_grain_table")))
    for f, (a, b) in enumerate(zip(got, want)):
        (dy, du, dv, drec), compound = decode_counting_compound(dec, a.tu)
        if not compound:
            assert a.tu == b.tu, f"TU {f}: {len(a.tu)} vs {len(b.tu)} bytes"
        if b.recon is None:
            assert a.recon is None and drec is None, f"TU {f}"
        else:
            for i in range(3):
                np.testing.assert_array_equal(a.recon[i], b.recon[i], err_msg=f"TU {f} plane {i}")
                np.testing.assert_array_equal(drec[i], a.recon[i], err_msg=f"decode TU {f} plane {i}")
            recon_of[a.disp_idx] = a.recon
        if a.shown_disp_idx is not None:
            shown.add(f, (dy, du, dv), recon_of[a.shown_disp_idx])
    shown.check([p.tu for p in got])
    return got


class Shown:
    """The frames a stream shows, in display order, checked as they come:
    the decoder's output equals the shown frame's recon, or, with film
    grain, is that recon plus the grain; `check` then holds libaom's
    output to them and, with grain, requires the grain to have changed
    some frame."""

    def __init__(self, w: int, h: int, grain: bool = False):
        self.w, self.h, self.grain = w, h, grain
        self.planes, self.grained = [], 0

    def add(self, f: int, out, recon) -> None:
        want = displayed(recon, self.w, self.h)
        if self.grain:
            self.grained += any(not np.array_equal(a, b) for a, b in zip(out, want))
            self.planes.append(out)
        else:
            np.testing.assert_array_equal(out[0], want[0], err_msg=f"TU {f} shows another frame")
            self.planes.append(want)

    def check(self, tus) -> None:
        check_libaom(tus, self.planes)
        assert not self.grain or self.grained, "film grain changed no shown frame"


def check_libaom(tus, shown) -> None:
    """libaom decodes the TUs to the shown planes (in display order) bit for
    bit, where the host has it (it checks nothing otherwise): the count of
    frames it checked is printed."""
    checked = aomdec.verify_tus(tus, shown)
    print(f"libaom checked {checked} frames of {len(tus)} TUs"
          + ("" if aomdec.available() else " (libaom is not on this host)"))
    assert checked in (0, len(shown))


def encode_all(enc, frames) -> list:
    """The packets of `frames` through enc.send_frame + flush."""
    pkts = []
    for y, u, v in frames:
        pkts += enc.send_frame(y, u, v)
    return pkts + enc.flush()


def gop_decodes(pkts, w: int, h: int, grain: bool = False) -> None:
    """The port's decoder reproduces every coded frame's recon of a GOP's
    packets (show-existing TUs included) and shows every frame once in
    display order (with film grain, its recon plus the grain); libaom
    decodes the TUs to the shown frames."""
    dec = Decoder()
    recon_of, shown = {}, Shown(w, h, grain)
    for f, p in enumerate(pkts):
        dy, du, dv, drec = dec.decode_tu(p.tu)
        if p.recon is not None:
            for i in range(3):
                np.testing.assert_array_equal(drec[i], p.recon[i], err_msg=f"TU {f} plane {i}")
            recon_of[p.disp_idx] = p.recon
        if p.shown_disp_idx is not None:
            assert p.shown_disp_idx == len(shown.planes)
            shown.add(f, (dy, du, dv), recon_of[p.shown_disp_idx])
    shown.check([p.tu for p in pkts])


def lr_types_of(tus) -> list:
    """The lr_types (Y, U, V) of each frame header of a stream, in coding
    order."""
    from svtav1_tpu_torch.decode.decoder import frame_headers

    return [tuple(fi.lr_types) for fi in frame_headers(tus)]


def mi_from_plan(plan, params):
    """The frame-wide mi grid of a plan's decisions (the reference's
    pipeline/encoder.mi_from_plan), which its host DLF and CDEF read."""
    from svtav1_tpu_torch.codec.mvp import MiState

    plan.materialize()
    mi = MiState(params.mi_rows, params.mi_cols)
    for (r, c, bsize), d in plan.blocks.items():
        mi.set_block(r, c, bsize, d.y_mode, d.ref_frame, int(d.ref_frame1),
                     (int(d.mv[0]), int(d.mv[1])),
                     mv1=(int(d.mv1[0]), int(d.mv1[1])), skip=d.skip)
    return mi


def packets_decode(pkts, frames) -> None:
    """The port's decoder, and libaom where the host has it, reproduce
    every packet's recon; the shown planes have the frames' dims."""
    dec = Decoder()
    shown = []
    for f, pkt in enumerate(pkts):
        dy, du, dv, drec = dec.decode_tu(pkt.tu)
        for i in range(3):
            np.testing.assert_array_equal(drec[i], pkt.recon[i], err_msg=f"frame {f} plane {i}")
        assert dy.shape == frames[f][0].shape
        shown.append((dy, du, dv))
    check_libaom([p.tu for p in pkts], shown)
