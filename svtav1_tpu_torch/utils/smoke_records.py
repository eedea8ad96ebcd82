"""Compare the deterministic records of two `chip_smoke.py` logs, a parent
commit's and a change's: what a change that only makes a kernel faster must
leave as it was. Those are the fields of DETERMINISTIC (bytes, Y-PSNR,
qindex and r0, achieved kbps, waves, K16's tasks and depth, decode and
CPU-equality flags, kernels' errors and differing counts, the batched
path's launches and equality with the unbatched one, the restoration types
and the bytes and Y-PSNR beside them, the grain parameters) on every
record the two logs share.
A record is a JSON line: `check` lines are matched by kernel and shape,
`phase` lines by phase, preset or path, bit depth and their order among
equal keys. Times, rates and records only one log has are not compared.

    python -m svtav1_tpu_torch.utils.smoke_records PARENT_LOG CHANGE_LOG

Prints one JSON line: the records and values compared and every value that
differs; exits 1 if any differs.
"""
from __future__ import annotations

import json
import sys

DETERMINISTIC = (
    "tus", "frames", "bytes", "bytes_per_frame", "bytes_key", "bytes_per_p_frame",
    "bytes_per_b_frame", "bytes_show_existing", "bytes_cuda", "bytes_cpu",
    "identical_tu_byte_share", "y_psnr", "qindex_by_frame", "qindex", "r0_by_window", "r0",
    "achieved_kbps", "waves", "waves_per_frame", "key_waves", "p_waves_per_frame", "tf_calls",
    "tpl_frames", "decode_bit_exact", "tus_equal_cpu", "tus_equal_library", "verify",
    "exit_code", "checked_tus", "max_abs_err", "differing_samples", "changed_samples",
    "differing_lanes", "changed_levels", "flat_samples", "h2", "cells_on",
    "lanes_without_neighbour",
    # the batched all-intra, restoration and film grain paths
    "tus_equal_unbatched", "waves_unbatched", "launches_per_batch", "lr_types",
    "bytes_no_restoration", "y_psnr_no_restoration", "bytes_no_grain",
    "recon_equal_without_grain", "output_recon_plus_grain", "grain", "tasks", "depth",
    # the host mode decision
    "filter_intra_blocks", "launches_per_frame",
)


def records(lines) -> dict:
    """{record key: record} of a log's JSON lines (other lines skipped)."""
    out, seen = {}, {}
    for line in lines:
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "check" in rec:
            key = ("check", rec["check"], json.dumps(rec.get("shape")))
        elif "phase" in rec:
            cfg = rec.get("config") if isinstance(rec.get("config"), dict) else {}
            key = ("phase", rec["phase"], str(rec.get("preset", rec.get("path"))),
                   rec.get("bd", cfg.get("bd", 8)))
        else:
            continue
        n = seen[key] = seen.get(key, 0) + 1
        out[key + (n,)] = rec
    return out


def compare(parent_lines, change_lines) -> dict:
    """The records and values the two logs share, and the values that differ."""
    a, b = records(parent_lines), records(change_lines)
    shared = [k for k in a if k in b]
    values, differ = 0, []
    for k in shared:
        for field in DETERMINISTIC:
            if field in a[k] and field in b[k]:
                values += 1
                if a[k][field] != b[k][field]:
                    differ.append(dict(record=list(k), field=field, parent=a[k][field],
                                       change=b[k][field]))
    return dict(records=len(shared), values=values, differ=differ,
                only_parent=len(a) - len(shared), only_change=len(b) - len(shared))


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    with open(sys.argv[1]) as pa, open(sys.argv[2]) as ch:
        res = compare(pa, ch)
    print(json.dumps(res))
    return 1 if res["differ"] else 0


if __name__ == "__main__":
    sys.exit(main())
