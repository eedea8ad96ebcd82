"""svtav1_tpu_torch stands alone: no module of it imports jax or svtav1_tpu,
and its entry points (the Encoder, the CLI, the tile encoders) default to
the card and refuse to fall back quietly."""
import os
import subprocess
import sys

import pytest
import torch

from svtav1_tpu_torch.pipeline import encoder as port_enc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
only = sys.argv[1:]

class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "svtav1_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

for k in [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "svtav1_tpu")]:
    del sys.modules[k]
sys.meta_path.insert(0, Block())
import svtav1_tpu_torch
# Python modules only (the entropy package's built .so is not a module)
names = only or [m.name for m in pkgutil.walk_packages(svtav1_tpu_torch.__path__,
                                                       "svtav1_tpu_torch.")
                 if not m.name.rsplit(".", 1)[-1].startswith("lib")]
for name in names:
    importlib.import_module(name)
assert not any(k.split(".")[0] in ("jax", "jaxlib", "svtav1_tpu") for k in sys.modules)
print(len(names))
"""


def test_every_module_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 30  # the whole package was walked


def test_random_access_modules_import_without_jax_or_reference():
    """The modules of the random-access slice and the CLI, each imported
    alone with jax and svtav1_tpu blocked."""
    mods = ["svtav1_tpu_torch.app", "svtav1_tpu_torch.ops.tf_torch", "svtav1_tpu_torch.io.ivf",
            "svtav1_tpu_torch.io.y4m", "svtav1_tpu_torch.utils.metrics"]
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, *mods], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) == len(mods)


def test_rate_control_modules_import_without_jax_or_reference():
    """The modules of the TPL/CRF and rate-control slice, each imported
    alone with jax and svtav1_tpu blocked."""
    mods = ["svtav1_tpu_torch.pipeline.tpl", "svtav1_tpu_torch.pipeline.rc",
            "svtav1_tpu_torch.pipeline.firstpass"]
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, *mods], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) == len(mods)


def test_no_source_mentions_the_reference_package():
    pkg = os.path.join(REPO, "svtav1_tpu_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert "import jax" not in text and "from jax" not in text, f
                assert "from svtav1_tpu." not in text and "import svtav1_tpu\n" not in text, f


def test_encoder_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_enc.EncoderConfig(64, 64, keyint=1, preset="fast", enable_cdef=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_enc.Encoder(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_enc.Encoder(cfg, device="cuda")
    assert port_enc.Encoder(cfg, device="cpu").device.type == "cpu"


def test_gop_encoder_without_device_needs_cuda(monkeypatch):
    """The low-delay GOP (keyint > 1) defaults to the card as well."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_enc.EncoderConfig(64, 64, keyint=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_enc.Encoder(cfg)
    assert port_enc.Encoder(cfg, device="cpu").device.type == "cpu"


def test_crf_encoder_and_tpl_without_device_need_cuda(monkeypatch):
    """CRF's Encoder and the TPL window default to the card as well."""
    import numpy as np

    from svtav1_tpu_torch.pipeline import tpl

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_enc.EncoderConfig(64, 64, keyint=16, rc_mode="crf")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_enc.Encoder(cfg)
    assert port_enc.Encoder(cfg, device="cpu").device.type == "cpu"
    frames = [np.full((64, 64), 90 + 5 * i, np.int32) for i in range(2)]
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.tpl_window(frames, 120)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpl.tpl_window(frames, 120, device="cuda")
    assert len(tpl.tpl_window(frames, 120, device="cpu")) == 2


def test_cli_without_device_needs_cuda(monkeypatch, tmp_path, capsys):
    """The CLI defaults to the card too: without --device and without a card
    it stops with the "needs CUDA" error before reading its input."""
    from svtav1_tpu_torch import app

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = app.main(["-i", str(tmp_path / "in.y4m"), "-b", str(tmp_path / "out.ivf")])
    assert rc != 0
    assert "needs CUDA" in capsys.readouterr().err
    assert not (tmp_path / "out.ivf").exists()


def test_filter_frame_without_device_needs_cuda(monkeypatch):
    """MCTF's numpy entry point defaults to the card like the Encoder."""
    import numpy as np

    from svtav1_tpu_torch.ops import tf_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    planes = [np.zeros((64, 64), np.int32)] + [np.zeros((32, 32), np.int32)] * 2
    with pytest.raises(RuntimeError, match="CUDA"):
        tf_torch.filter_frame(planes, [planes], 120)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf_torch.filter_frame(planes, [planes], 120, device="cuda")
    out = tf_torch.filter_frame(planes, [planes], 120, device="cpu")
    assert [p.shape for p in out] == [p.shape for p in planes]


def test_kernel_argument_check_rejects_cpu_tensors():
    """The wrappers take the plain version only for CPU tensors; the kernel
    argument check rejects a CPU tensor outright."""
    from svtav1_tpu_torch import kernels

    with pytest.raises(ValueError, match="CUDA"):
        kernels.check(torch.zeros(4, dtype=torch.int32), "x", torch.int32)


def test_tile_modules_import_without_jax_or_reference():
    """The modules of the tile slice and the libaom oracle, each imported
    alone with jax and svtav1_tpu blocked."""
    mods = ["svtav1_tpu_torch.parallel", "svtav1_tpu_torch.parallel.tiles",
            "svtav1_tpu_torch.utils.aomdec"]
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, *mods], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) == len(mods)


def _mesh_frame(w: int, h: int):
    import numpy as np

    planes = [np.full((h, w), 100, np.int32)] + [np.full((h // 2, w // 2), 128, np.int32)] * 2
    return planes, {1: planes}


def test_tile_encoders_without_device_need_cuda(monkeypatch):
    """The tile encoders default to the card like the Encoder."""
    from svtav1_tpu_torch.codec.tile_codec import FrameParams
    from svtav1_tpu_torch.parallel import tiles

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    planes, refs = _mesh_frame(256, 64)
    key = FrameParams(width=256, height=64, qindex=110, frame_is_intra=True, tile_cols_log2=1)
    inter = FrameParams(width=256, height=64, qindex=110, frame_is_intra=False,
                        tile_cols_log2=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tiles.encode_intra_frame_mesh(planes, key, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tiles.encode_inter_frame_mesh(planes, inter, refs, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tiles.encode_inter_frame_mesh(planes, inter, refs, 2, device="cuda")


def test_inter_tiles_need_heights_of_whole_superblocks():
    """The inter tile decide runs its ME on the unpadded tile, as the
    reference's does: a tile height that is not a multiple of 64 (here 72)
    raises ValueError naming the limit, before any work. Tiles of unequal
    width (320 = 192 + 128 columns) are refused too."""
    from svtav1_tpu_torch.codec.tile_codec import FrameParams
    from svtav1_tpu_torch.parallel import tiles

    planes, refs = _mesh_frame(256, 72)
    p = FrameParams(width=256, height=72, qindex=110, frame_is_intra=False, tile_cols_log2=1)
    with pytest.raises(ValueError, match="multiples of 64"):
        tiles.encode_inter_frame_mesh(planes, p, refs, 2, device="cpu")
    planes, refs = _mesh_frame(320, 64)
    p = FrameParams(width=320, height=64, qindex=110, frame_is_intra=False, tile_cols_log2=1)
    with pytest.raises(ValueError, match="equal dims"):
        tiles.encode_inter_frame_mesh(planes, p, refs, 2, device="cpu")
