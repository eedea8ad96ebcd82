"""Default CDF tables (AV1 spec normative constants) + frame-context assembly.

Tables are loaded from constants/data/default_cdfs.npz (extracted spec
constants — see tools/extract_normative.py; reference behavior:
Source/Lib/Codec/cabac_context_model.c svt_aom_init_mode_probs /
svt_av1_default_coef_probs).

CDF layout: inverse-CDF Q15, length nsyms+1, trailing adaptation counter.
"""
from __future__ import annotations

import functools
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "data")


@functools.lru_cache(maxsize=None)
def load_default_cdfs() -> dict:
    with np.load(os.path.join(_DATA, "default_cdfs.npz")) as z:
        return {k: z[k].copy() for k in z.files}


def get_q_ctx(base_qindex: int) -> int:
    """Coefficient CDF set selection by qindex (spec / cabac_context_model.c:2264)."""
    if base_qindex <= 20:
        return 0
    if base_qindex <= 60:
        return 1
    if base_qindex <= 120:
        return 2
    return 3


class FrameContext:
    """Mutable per-frame CDF state (analog of the reference FRAME_CONTEXT).

    Holds one numpy array per symbol family; tables adapt during encoding
    unless disable_cdf_update. Construction mirrors svt_aom_init_mode_probs +
    svt_av1_default_coef_probs (cabac_context_model.c:738,2274).
    """

    # mode tables copied verbatim from defaults (name -> attr)
    _MODE_TABLES = {
        "kf_y_mode": "svt_aom_default_kf_y_mode_cdf",
        "angle_delta": "default_angle_delta_cdf",
        "y_mode": "default_if_y_mode_cdf",
        "uv_mode": "default_uv_mode_cdf",
        "partition": "default_partition_cdf",
        "skip": "default_skip_cdfs",
        "tx_size": "default_tx_size_cdf",
        "txfm_partition": "default_txfm_partition_cdf",
        "intra_ext_tx": "default_intra_ext_tx_cdf",
        "inter_ext_tx": "default_inter_ext_tx_cdf",
        "filter_intra_mode": "default_filter_intra_mode_cdf",
        "filter_intra": "default_filter_intra_cdfs",
        "cfl_sign": "default_cfl_sign_cdf",
        "cfl_alpha": "default_cfl_alpha_cdf",
        "delta_q": "default_delta_q_cdf",
        "delta_lf": "default_delta_lf_cdf",
        "segment_id": "default_seg_tree_cdf",
        "spatial_pred_seg": "default_spatial_pred_seg_tree_cdf",
        "skip_mode": "default_skip_mode_cdfs",
        "intrabc": "default_intrabc_cdf",
        "palette_y_size": "default_palette_y_size_cdf",
        "palette_uv_size": "default_palette_uv_size_cdf",
        "palette_y_color": "default_palette_y_color_index_cdf",
        "palette_uv_color": "default_palette_uv_color_index_cdf",
        "palette_y_mode": "default_palette_y_mode_cdf",
        "palette_uv_mode": "default_palette_uv_mode_cdf",
        # inter mode families
        "newmv": "default_newmv_cdf",
        "zeromv": "default_zeromv_cdf",
        "refmv": "default_refmv_cdf",
        "drl": "default_drl_cdf",
        "inter_compound_mode": "default_inter_compound_mode_cdf",
        "wedge_idx": "default_wedge_idx_cdf",
        "interintra": "default_interintra_cdf",
        "interintra_mode": "default_interintra_mode_cdf",
        "wedge_interintra": "default_wedge_interintra_cdf",
        "compound_type": "default_compound_type_cdf",
        "motion_mode": "default_motion_mode_cdf",
        "obmc": "default_obmc_cdf",
        "intra_inter": "default_intra_inter_cdf",
        "comp_inter": "default_comp_inter_cdf",
        "comp_ref_type": "default_comp_ref_type_cdf",
        "uni_comp_ref": "default_uni_comp_ref_cdf",
        "single_ref": "default_single_ref_cdf",
        "comp_ref": "default_comp_ref_cdf",
        "comp_bwdref": "default_comp_bwdref_cdf",
        "interp_filter": "default_switchable_interp_cdf",
        "comp_group_idx": "default_comp_group_idx_cdfs",
        "compound_idx": "default_compound_idx_cdfs",
        "delta_lf_multi": "default_delta_lf_multi_cdf",
        "segment_pred": "default_segment_pred_cdf",
        "wiener_restore": "default_wiener_restore_cdf",
        "sgrproj_restore": "default_sgrproj_restore_cdf",
        "switchable_restore": "default_switchable_restore_cdf",
        # MV coding (NmvContext); component tables indexed [comp 0=row 1=col]
        "nmv_joints": "default_nmv_joints",
        "nmv_classes": "default_nmv_classes",
        "nmv_class0_fp": "default_nmv_class0_fp",
        "nmv_fp": "default_nmv_fp",
        "nmv_sign": "default_nmv_sign",
        "nmv_class0_hp": "default_nmv_class0_hp",
        "nmv_hp": "default_nmv_hp",
        "nmv_class0": "default_nmv_class0",
        "nmv_bits": "default_nmv_bits",
    }

    # coeff tables selected by q_ctx (attr -> table name)
    _COEF_TABLES = {
        "txb_skip": "av1_default_txb_skip_cdfs",
        "eob_extra": "av1_default_eob_extra_cdfs",
        "dc_sign": "av1_default_dc_sign_cdfs",
        "coeff_br": "av1_default_coeff_lps_multi_cdfs",
        "coeff_base": "av1_default_coeff_base_multi_cdfs",
        "coeff_base_eob": "av1_default_coeff_base_eob_multi_cdfs",
        "eob_flag_16": "av1_default_eob_multi16_cdfs",
        "eob_flag_32": "av1_default_eob_multi32_cdfs",
        "eob_flag_64": "av1_default_eob_multi64_cdfs",
        "eob_flag_128": "av1_default_eob_multi128_cdfs",
        "eob_flag_256": "av1_default_eob_multi256_cdfs",
        "eob_flag_512": "av1_default_eob_multi512_cdfs",
        "eob_flag_1024": "av1_default_eob_multi1024_cdfs",
    }

    def __init__(self, base_qindex: int) -> None:
        d = load_default_cdfs()
        qctx = get_q_ctx(base_qindex)
        self.tables: dict[str, np.ndarray] = {}
        for attr, name in self._MODE_TABLES.items():
            if name in d:
                self.tables[attr] = d[name].astype(np.int32).copy()
        for attr, name in self._COEF_TABLES.items():
            self.tables[attr] = d[name][qctx].astype(np.int32).copy()

    def __getitem__(self, name: str) -> np.ndarray:
        return self.tables[name]

    def clone(self) -> "FrameContext":
        """Deep copy of the mutable CDF state (reference FRAME_CONTEXT
        assignment in svt_aom_update_rc_counts / frame-context save-restore,
        md_config_process.c:676-695)."""
        fc = object.__new__(FrameContext)
        fc.tables = {k: v.copy() for k, v in self.tables.items()}
        return fc

    def reset_counters(self) -> None:
        """Zero every cdf's update counter, keeping the probabilities
        (av1_reset_cdf_symbol_counters: the spec's frame-end context adoption
        resets counters, so inherited contexts restart at the fast
        adaptation rate). The counter sits right after the cdf's terminal
        zero (icdf[nsym-1] == 0, counter at [nsym])."""
        for v in self.tables.values():
            if v.ndim == 0 or v.shape[-1] < 2:
                continue
            rows = v.reshape(-1, v.shape[-1])
            has_zero = (rows == 0).any(axis=-1)
            first_zero = np.argmax(rows == 0, axis=-1)
            cnt_idx = np.minimum(first_zero + 1, rows.shape[-1] - 1)
            keep = np.take_along_axis(rows, cnt_idx[:, None], axis=-1)
            new = np.where(has_zero[:, None], 0, keep)
            np.put_along_axis(rows, cnt_idx[:, None], new, axis=-1)
