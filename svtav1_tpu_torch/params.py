"""String parameter API of the PyTorch port, a copy of svtav1_tpu's
params.py (the analog of svt_av1_enc_parse_parameter,
Source/Lib/Globals/enc_settings.c): kebab-case key/value pairs mapped onto
the port's EncoderConfig with range validation, with the same keys,
ranges and ParamError. `mode-decision` takes "numpy" (the host route) and
"jax" (the device route); an EncoderConfig built here starts from the
port's default, "jax".
"""
from __future__ import annotations

from .pipeline.encoder import EncoderConfig


class ParamError(ValueError):
    pass


def _int_range(lo, hi):
    def parse(v):
        x = int(v)
        if not lo <= x <= hi:
            raise ParamError(f"value {x} out of range [{lo}, {hi}]")
        return x

    return parse


def _int_choice(*allowed):
    def parse(v):
        x = int(v)
        if x not in allowed:
            raise ParamError(f"value {x} not one of {allowed}")
        return x

    return parse


def _bool(v):
    if str(v).lower() in ("1", "true", "yes", "on"):
        return True
    if str(v).lower() in ("0", "false", "no", "off"):
        return False
    raise ParamError(f"not a boolean: {v}")


def _str_choice(*opts):
    def parse(v):
        if v not in opts:
            raise ParamError(f"expected one of {opts}, got {v}")
        return v

    return parse


# token -> (EncoderConfig field, parser); names follow Docs/Parameters.md
_PARAMS = {
    "width": ("width", _int_range(8, 16384)),
    "height": ("height", _int_range(8, 8704)),
    "qp": ("qindex", _int_range(1, 255)),  # 0 would be CodedLossless (unsupported syntax)
    "crf": ("qindex", _int_range(1, 255)),  # sets the CRF target qindex (use rc=crf)
    "input-depth": ("bd", _int_choice(8, 10)),
    "keyint": ("keyint", _int_range(1, 1 << 16)),
    "hierarchical-levels": ("minigop", lambda v: 1 << _int_range(0, 3)(v)),
    "tile-columns": ("tile_cols_log2", _int_range(0, 4)),
    "tile-rows": ("tile_rows_log2", _int_range(0, 4)),
    "enable-dlf": ("enable_dlf", _bool),
    "enable-cdef": ("enable_cdef", _bool),
    "enable-restoration": ("enable_restoration", _bool),
    "enable-rdoq": ("enable_rdoq", _bool),
    "enable-tf": ("enable_tf", _bool),
    "n-refs": ("n_refs", _int_range(1, 3)),
    "rc": ("rc_mode", _str_choice("cqp", "cbr", "crf", "vbr")),
    "tbr": ("target_kbps", lambda v: float(v)),
    "fps": ("fps", lambda v: float(v)),
    "scd": ("scene_cut", _bool),
    "lookahead": ("lookahead", _int_range(2, 120)),
    "intra-batch": ("intra_batch", _int_range(1, 64)),
    "mode-decision": ("mode_decision", _str_choice("numpy", "jax")),
    "preset": ("preset", _str_choice("fast", "medium", "slow")),
    "film-grain": ("film_grain", _int_range(0, 50)),
    "fgs-table": ("film_grain_table", str),
}


def parse_parameter(cfg: EncoderConfig, name: str, value: str) -> None:
    """Set one parameter by string name (raises ParamError on bad input)."""
    if name not in _PARAMS:
        raise ParamError(f"unknown parameter: {name}")
    field, parser = _PARAMS[name]
    setattr(cfg, field, parser(value))


def config_from_params(pairs: dict, width: int = 0, height: int = 0) -> EncoderConfig:
    """Build an EncoderConfig from {key: value} strings."""
    cfg = EncoderConfig(width=width or 64, height=height or 64)
    for k, v in pairs.items():
        parse_parameter(cfg, k, v)
    return cfg
