"""The port's tiles against the JAX package's on the CPU: the tile
encoders (svtav1_tpu_torch.parallel.tiles) against svtav1_tpu's
mesh-sharded ones on a jax.sharding.Mesh of 2 of the 8 virtual devices of
tests/conftest.py, the port batching the same 2 tiles with the plain
versions of its kernels, at 8 bits and at 10 (the reference under the
port's DC rule, torch_encode_parity.reference_with_spec_rules: every
tile's top-left block has no neighbour); the Encoder's 2x2-tile key frame
against svtav1_tpu's Encoder (it follows the intra mesh case, whose
per-tile commit programs the reference then reuses); and K8 with a
reference wider than the source. Everything is compared exactly (payloads, recon, MVs,
frame_mi), except the decide's float32 costs, summed in another order
(rtol 1e-5), and the blocks of ROADMAP queue 3's deliberate penalty-grid
divergence (_assert_decides_agree). Every stream is also decoded by the
port's decoder and, where the host has it, by libaom."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from svtav1_tpu.codec.tile_codec import FrameParams as RefParams
from svtav1_tpu.filters import cdef as ref_cdef
from svtav1_tpu.ops import me_jax
from svtav1_tpu.parallel import tiles as ref_tiles
from svtav1_tpu.pipeline import encoder as ref_enc
from svtav1_tpu_torch.codec.tile_codec import FrameParams
from svtav1_tpu_torch.constants.av1 import RefFrame
from svtav1_tpu_torch.decode.decoder import Decoder
from svtav1_tpu_torch.entropy.bitstream import (FrameConfig, SequenceConfig, frame_obu,
                                                sequence_header_obu, temporal_delimiter_obu)
from svtav1_tpu_torch.filters import cdef as port_cdef
from svtav1_tpu_torch.ops import me_torch
from svtav1_tpu_torch.parallel import tiles as port_tiles
from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.utils.testclip import make_frames
from torch_encode_parity import (check_libaom, encode_all, packets_decode,
                                 reference_with_spec_rules)

W, H, QINDEX = 256, 64, 110  # two 128x64 tile columns (tests/test_multichip.py's recipe)


@functools.lru_cache(maxsize=1)
def _mesh():
    """One mesh per worker: the reference keys its compiled programs on it."""
    devs = jax.devices("cpu")
    assert len(devs) >= 2, "tests/conftest.py provides 8 virtual devices"
    return Mesh(np.array(devs[:2]), ("tile",))


def _clip(seed: int = 4):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    y = (110 + 60 * np.sin(xx / 9.0) + 35 * np.cos(yy / 7.0)
         + rng.normal(0, 6, (H, W))).clip(0, 255).astype(np.int32)
    u = rng.integers(70, 180, (H // 2, W // 2)).astype(np.int32)
    v = rng.integers(70, 180, (H // 2, W // 2)).astype(np.int32)
    return y, u, v


def _record_runs(mp, module, name: str) -> list:
    """Wrap module.name (a decide builder returning (run, layout, ...)) with
    the MonkeyPatch `mp` so that every run's packed per-tile grids, summed
    cost and layout are appended to the returned list."""
    runs = []
    build = getattr(module, name)

    def wrapped(*args):
        run, layout, *rest = build(*args)

        def run_and_record(*a):
            packed, total = run(*a)
            runs.append((np.asarray(packed.cpu() if isinstance(packed, torch.Tensor) else packed),
                         float(total), layout))
            return packed, total

        return (run_and_record, layout, *rest)

    mp.setattr(module, name, wrapped)
    return runs


def _assert_decides_agree(ref_runs, port_runs, fields, is_key: bool, bd: int = 8) -> None:
    """The decide grids of every tile agree: equal modes, tx types and MVs,
    costs within rtol 1e-5 (float32 sums in another order). The one
    deliberate divergence (ROADMAP queue 3, the directional-mode penalty
    grid): where the reference picks D45, D67 or D203 on a block whose
    neighbours the decoder would read from real pixels, the port's grid
    forbids the mode and the block takes another; each such block must be
    one that the port's grid forbids. The frames' summed costs then agree
    within rtol 1e-5 once those blocks count the port's cost."""
    from svtav1_tpu_torch.constants.cdf import get_q_ctx

    assert len(ref_runs) == len(port_runs) > 0
    p = FrameParams(width=W, height=H, qindex=QINDEX, bd=bd, frame_is_intra=is_key,
                    tile_cols_log2=1)
    pens = port_tiles._tile_consts(p, get_q_ctx(QINDEX), p.tiles())[1]
    for (rp, r_total, layout), (pp, p_total, p_layout) in zip(ref_runs, port_runs):
        assert layout == p_layout
        off, moved = 0, 0.0
        for n, R, C in layout:
            g_r, g_p = ({f: a[:, off + i * R * C : off + (i + 1) * R * C].reshape(-1, R, C)
                         for i, f in enumerate(fields)} for a in (rp, pp))
            off += len(fields) * R * C
            div = g_r["mode"] != g_p["mode"]
            t, r, c = np.nonzero(div)
            assert (pens[n][t, r, c, g_r["mode"][div].astype(int)] > 0).all(), \
                f"n={n}: a block diverges where the port's penalty grid allows the mode"
            for f in fields:
                if f == "cost":
                    np.testing.assert_allclose(g_p[f][~div], g_r[f][~div], rtol=1e-5)
                else:
                    np.testing.assert_array_equal(g_p[f][~div], g_r[f][~div], err_msg=f"{n} {f}")
            moved += float(g_p["cost"][div].astype(np.float64).sum()
                           - g_r["cost"][div].astype(np.float64).sum())
        np.testing.assert_allclose(p_total, r_total + moved, rtol=1e-5)


def _intra_run(planes, bd: int) -> dict:
    """A 256x64 key frame in two 128x64 tiles through both packages' intra
    tile encoders, with each decide's grids recorded."""
    with pytest.MonkeyPatch.context() as mp, reference_with_spec_rules(bd):
        ref_runs = _record_runs(mp, ref_tiles, "_mesh_decide_fn")
        port_runs = _record_runs(mp, port_tiles, "_mesh_decide_fn")
        kw = dict(width=W, height=H, qindex=QINDEX, bd=bd, frame_is_intra=True, tile_cols_log2=1)
        want = ref_tiles.encode_intra_frame_mesh(list(planes), RefParams(**kw), _mesh())
        got = port_tiles.encode_intra_frame_mesh(list(planes), FrameParams(**kw), 2, device="cpu")
    return dict(want=want, got=got, ref_runs=ref_runs, port_runs=port_runs, bd=bd)


@pytest.fixture(scope="module")
def intra_run():
    return _intra_run(_clip(), 8)


@pytest.fixture(scope="module")
def intra_run10():
    """The key frame at 10 bits: the synthetic clip's first frame."""
    return _intra_run([np.asarray(pl, np.int32) for pl in make_frames(W, H, 1, bd=10)[0]], 10)


def _check_intra_mesh(run) -> None:
    """Payloads, recon and the decide grids equal the reference's mesh
    encode."""
    want_pl, want_rec, want_p = run["want"]
    got_pl, got_rec, got_p = run["got"]
    assert len(got_pl) == 2 and got_pl == want_pl
    for i in range(3):
        np.testing.assert_array_equal(got_rec[i], want_rec[i], err_msg=f"plane {i}")
    _assert_decides_agree(run["ref_runs"], run["port_runs"], ("cost", "mode", "tx"), True,
                          run["bd"])
    assert got_p.tile_cols_log2 == want_p.tile_cols_log2 == 1


def test_intra_mesh_matches_jax(intra_run):
    _check_intra_mesh(intra_run)


def test_intra_mesh_10bit_matches_jax(intra_run10):
    _check_intra_mesh(intra_run10)
    assert int(intra_run10["got"][1][0].max()) > 255


def test_four_tile_key_frame_matches_jax():
    """A 256x128 key frame at medium through the Encoder in 2x2 tiles of
    128x64 (tile_cols_log2=1, tile_rows_log2=1): TU bytes and recon equal
    svtav1_tpu's Encoder(mode_decision="jax"); both decoders reproduce the
    recon."""
    frames = make_frames(256, 128, 1)
    cfg = dict(qindex=120, keyint=1, preset="medium", tile_cols_log2=1, tile_rows_log2=1)
    want = encode_all(ref_enc.Encoder(ref_enc.EncoderConfig(256, 128, mode_decision="jax",
                                                            **cfg)), frames)
    got = encode_all(port_enc.Encoder(port_enc.EncoderConfig(256, 128, **cfg), device="cpu"),
                     frames)
    assert len(got) == len(want) == 1
    assert got[0].tu == want[0].tu, f"{len(got[0].tu)} vs {len(want[0].tu)} bytes"
    for i in range(3):
        np.testing.assert_array_equal(got[0].recon[i], want[0].recon[i], err_msg=f"plane {i}")
    packets_decode(got, frames)


def _gop_clip(bd: int = 8):
    """Three frames of the synthetic moving clip at 256x64, the two later
    ones with a patch of new content in the right tile: the P frames code
    inter blocks of several sizes and intra blocks among them."""
    frames = [[np.asarray(pl, np.int32) for pl in f] for f in make_frames(W, H, 3, bd=bd)]
    yy, xx = np.mgrid[0:40, 0:40]
    for d in (1, 2):
        patch = 128 + 60 * np.sin((xx + yy * d) / 3.0)
        frames[d][0][12:52, 150 + 8 * d : 190 + 8 * d] = patch * (1 << (bd - 8))
    return frames


def _p_params(disp: int, bd: int = 8) -> dict:
    hints = [0] * 8
    hints[int(RefFrame.LAST_FRAME)] = disp - 1
    return dict(width=W, height=H, qindex=QINDEX, bd=bd, frame_is_intra=False, order_hint=disp,
                ref_hints=tuple(hints), tile_cols_log2=1)


def _cdef(mod, recon, src, mi, bd: int = 8):
    """The caller's frame-wide CDEF of a mesh frame (search and apply, in
    place); returns its strengths and damping."""
    ypri, ysec, upri, usec, damping = mod.search_strengths(recon, src, mi, QINDEX, bd)
    if ypri or ysec or upri or usec:
        mod.cdef_frame(recon, mi, ypri, ysec, upri, usec, damping, bd=bd)
    return ypri, ysec, upri, usec, damping


def _inter_run(bd: int) -> dict:
    """A key frame and two P frames at 256x64 in two tiles, coded as the
    reference's own multi-chip dry run codes its GOP (each P frame decided
    against the previous frame's CDEF'd recon, CDEF by the caller), through
    both packages' tile encoders; the port's TUs and recon and the
    packages' per-frame results."""
    with pytest.MonkeyPatch.context() as mp, reference_with_spec_rules(bd):
        ref_runs = _record_runs(mp, ref_tiles, "_mesh_inter_fn")
        port_runs = _record_runs(mp, port_tiles, "_mesh_inter_fn")
        mesh = _mesh()
        frames = _gop_clip(bd)
        kw = dict(width=W, height=H, qindex=QINDEX, bd=bd, frame_is_intra=True, tile_cols_log2=1)
        key = port_tiles.encode_intra_frame_mesh(frames[0], FrameParams(**kw), 2, device="cpu")
        want_key = ref_tiles.encode_intra_frame_mesh(frames[0], RefParams(**kw), mesh)
        seq = SequenceConfig(width=W, height=H, bd=bd, enable_cdef=True)
        fr = FrameConfig(qindex=QINDEX, disable_cdf_update=False, show_frame=True,
                         tile_cols_log2=1, frame_type=0, order_hint=0)
        tus = [temporal_delimiter_obu() + sequence_header_obu(seq) + frame_obu(seq, fr, key[0])]
        recons = [key[1]]
        ref_dpb = [pl.copy() for pl in want_key[1]]
        port_dpb = [pl.copy() for pl in key[1]]
        last = int(RefFrame.LAST_FRAME)
        frames_out = []
        for disp in (1, 2):
            src, kw = frames[disp], _p_params(disp, bd)
            want = ref_tiles.encode_inter_frame_mesh(src, RefParams(**kw), {last: ref_dpb}, mesh)
            got = port_tiles.encode_inter_frame_mesh(src, FrameParams(**kw), {last: port_dpb}, 2,
                                                     device="cpu")
            unfiltered = ([pl.copy() for pl in want[1]], [pl.copy() for pl in got[1]])
            strengths = (_cdef(ref_cdef, want[1], src, want[3], bd),
                         _cdef(port_cdef, got[1], src, got[3], bd))
            ypri, ysec, upri, usec, damping = strengths[1]
            fri = FrameConfig(qindex=QINDEX, disable_cdf_update=False, show_frame=True,
                              tile_cols_log2=got[2].tile_cols_log2, frame_type=1,
                              order_hint=disp, refresh_frame_flags=1, ref_frame_idx=(0,) * 7,
                              cdef_damping=damping, cdef_y=((ypri, ysec),),
                              cdef_uv=((upri, usec),))
            tus.append(temporal_delimiter_obu() + frame_obu(seq, fri, got[0]))
            recons.append(got[1])
            frames_out.append(dict(want=want, got=got, unfiltered=unfiltered,
                                   strengths=strengths))
            ref_dpb = [pl.copy() for pl in want[1]]
            port_dpb = [pl.copy() for pl in got[1]]
    return dict(key=(key, want_key), frames=frames_out, tus=tus, recons=recons,
                ref_runs=ref_runs, port_runs=port_runs, bd=bd)


@pytest.fixture(scope="module")
def inter_run():
    return _inter_run(8)


@pytest.fixture(scope="module")
def inter_run10():
    return _inter_run(10)


def _check_inter_mesh(inter_run) -> None:
    """On a clip whose P frames hold inter and intra blocks of several
    sizes, the key frame's payloads and the P frames' payloads, recon (as
    the tile encoder returns it, and after the caller's CDEF), frame_mi and
    decide grids equal the reference mesh's."""
    key, want_key = inter_run["key"]
    assert key[0] == want_key[0]
    last = int(RefFrame.LAST_FRAME)
    for disp, fr in enumerate(inter_run["frames"], start=1):
        want_pl, want_rec, _wp, want_mi = fr["want"]
        got_pl, got_rec, _gp, got_mi = fr["got"]
        assert got_pl == want_pl, f"frame {disp}"
        for i in range(3):
            np.testing.assert_array_equal(fr["unfiltered"][1][i], fr["unfiltered"][0][i],
                                          err_msg=f"frame {disp} plane {i}")
            np.testing.assert_array_equal(got_rec[i], want_rec[i], err_msg=f"CDEF {disp} {i}")
        for name, arr in vars(want_mi).items():
            np.testing.assert_array_equal(np.asarray(getattr(got_mi, name)), np.asarray(arr),
                                          err_msg=f"frame {disp} frame_mi.{name}")
        assert 0 < (got_mi.ref0 == last).mean() < 1, "inter and intra blocks"
        assert fr["strengths"][0] == fr["strengths"][1]
    assert len(inter_run["port_runs"]) == 2
    _assert_decides_agree(inter_run["ref_runs"], inter_run["port_runs"],
                          port_tiles._INTER_FIELDS, False, inter_run["bd"])


def test_inter_mesh_matches_jax(inter_run):
    _check_inter_mesh(inter_run)


def test_inter_mesh_10bit_matches_jax(inter_run10):
    _check_inter_mesh(inter_run10)


def test_me_fullpel_with_ref_offset_matches_jax():
    """K8's plain version with ref_off_x=128 on the inter mesh's own tile
    shape: a 64x128 tile source against its 64x384 halo-cropped reference.
    Every size's full-pel MVs and the SB MVs equal me_jax's."""
    rng = np.random.default_rng(11)
    noise = rng.integers(0, 256, (66, 386))
    # a 3x3 box-filtered noise texture: no period for the pyramid to alias
    ref = sum(noise[a : a + 64, b : b + 384] for a in range(3) for b in range(3)) // 9
    ref = ref.astype(np.int32)
    # the tile's content moved by (2, -9) pels against the reference
    src = np.roll(ref, (2, -9), axis=(0, 1))[:, 128:256].copy()
    src[:, 96:] = rng.integers(0, 256, (64, 32))  # and an area the search cannot match
    me_ref = jax.jit(me_jax.me_fullpel_frame, static_argnums=(2, 3),
                     static_argnames="ref_off_x")  # one compile, not one per op
    want, want_sb = me_ref(jnp.asarray(src), jnp.asarray(ref), 1, 2, ref_off_x=128)
    got, got_sb = me_torch.me_fullpel_frame(torch.from_numpy(src), torch.from_numpy(ref), 1, 2,
                                            ref_off_x=128)
    np.testing.assert_array_equal(got_sb.numpy(), np.asarray(want_sb))
    for n in me_torch.SIZES:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]), err_msg=f"n={n}")
    assert (got[8].numpy() == (-2, 9)).all(axis=-1).mean() > 0.5  # the motion was found
    with pytest.raises(ValueError, match="multiple of 4"):
        me_torch.me_fullpel_frame(torch.from_numpy(src), torch.from_numpy(ref), 1, 2,
                                  ref_off_x=130)


def _check_inter_stream(inter_run) -> None:
    """The port's key frame and P frames decode bit-exactly in the port's
    decoder and, where the host has it, in libaom."""
    dec = Decoder()
    shown = []
    for i, (tu, rec) in enumerate(zip(inter_run["tus"], inter_run["recons"])):
        dy, du, dv, drec = dec.decode_tu(tu)
        for pl in range(3):
            np.testing.assert_array_equal(drec[pl], rec[pl], err_msg=f"decode frame {i} {pl}")
        shown.append((dy, du, dv))
    check_libaom(inter_run["tus"], shown)


def test_inter_mesh_stream_decodes(inter_run):
    _check_inter_stream(inter_run)


def test_inter_mesh_10bit_stream_decodes(inter_run10):
    _check_inter_stream(inter_run10)


def _check_intra_stream(intra_run) -> None:
    """The port's payloads in one two-tile frame OBU decode to its recon in
    the port's decoder and, where the host has it, in libaom."""
    got_pl, got_rec, _p = intra_run["got"]
    seq = SequenceConfig(width=W, height=H, bd=intra_run["bd"], enable_cdef=False)
    fr = FrameConfig(qindex=QINDEX, disable_cdf_update=False, show_frame=True, tile_cols_log2=1,
                     frame_type=0)
    tu = temporal_delimiter_obu() + sequence_header_obu(seq) + frame_obu(seq, fr, got_pl)
    dy, du, dv, drec = Decoder().decode_tu(tu)
    for i in range(3):
        np.testing.assert_array_equal(drec[i], got_rec[i], err_msg=f"decode plane {i}")
    check_libaom([tu], [(dy, du, dv)])


def test_intra_mesh_stream_decodes(intra_run):
    _check_intra_stream(intra_run)


def test_intra_mesh_10bit_stream_decodes(intra_run10):
    _check_intra_stream(intra_run10)
