"""The port's string parameter API (svtav1_tpu_torch/params.py) on the CPU:
tests/test_params.py's three cases on the port, and the same key/value
strings giving the JAX package's EncoderConfig field by field."""
import dataclasses

import numpy as np
import pytest

from svtav1_tpu import params as ref_params
from svtav1_tpu.pipeline import encoder as ref_enc
from svtav1_tpu_torch import params
from svtav1_tpu_torch.params import ParamError, config_from_params, parse_parameter
from svtav1_tpu_torch.pipeline.encoder import EncoderConfig

# one value for every key, valid in both packages
EVERY_KEY = {
    "width": "352", "height": "288", "qp": "96", "crf": "100", "input-depth": "10",
    "keyint": "32", "hierarchical-levels": "3", "tile-columns": "1", "tile-rows": "2",
    "enable-dlf": "0", "enable-cdef": "off", "enable-restoration": "yes",
    "enable-rdoq": "false", "enable-tf": "on", "n-refs": "2", "rc": "vbr", "tbr": "750.5",
    "fps": "24", "scd": "1", "lookahead": "40", "intra-batch": "8", "mode-decision": "numpy",
    "preset": "slow", "film-grain": "12", "fgs-table": "grain.tbl",
}


def test_parse_basic():
    cfg = config_from_params({"qp": "96", "keyint": "16", "hierarchical-levels": "2",
                              "rc": "cbr", "tbr": "800", "enable-cdef": "0"},
                             width=64, height=64)
    assert cfg.qindex == 96 and cfg.keyint == 16 and cfg.minigop == 4
    assert cfg.rc_mode == "cbr" and cfg.target_kbps == 800.0
    assert cfg.enable_cdef is False


def test_range_and_unknown_rejected():
    cfg = EncoderConfig(width=64, height=64)
    with pytest.raises(ParamError):
        parse_parameter(cfg, "qp", "300")
    with pytest.raises(ParamError):
        parse_parameter(cfg, "no-such-key", "1")
    with pytest.raises(ParamError):
        parse_parameter(cfg, "enable-dlf", "maybe")
    with pytest.raises(ParamError):
        parse_parameter(cfg, "mode-decision", "cuda")


def test_config_encodes():
    from svtav1_tpu_torch.decode.decoder import Decoder
    from svtav1_tpu_torch.pipeline.encoder import Encoder

    cfg = config_from_params({"qp": "120", "keyint": "2"}, width=64, height=64)
    enc = Encoder(cfg, device="cpu")
    dec = Decoder()
    y = np.full((64, 64), 100, np.int32)
    u = v = np.full((32, 32), 120, np.int32)
    for _ in range(2):
        tu, recon = enc.encode_frame(y, u, v)
        _, _, _, drecon = dec.decode_tu(tu)
        for pl in range(3):
            assert np.array_equal(recon[pl], drecon[pl])


def test_every_key_matches_the_reference():
    """The two packages name the same keys, and one dict holding every key
    gives equal EncoderConfig fields, field by field."""
    assert params._PARAMS.keys() == ref_params._PARAMS.keys() == EVERY_KEY.keys()
    port = config_from_params(EVERY_KEY)
    ref = ref_params.config_from_params(EVERY_KEY)
    assert isinstance(ref, ref_enc.EncoderConfig)
    for f in dataclasses.fields(ref_enc.EncoderConfig):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.mode_decision == "numpy" and port.minigop == 8 and port.bd == 10
