"""utils/smoke_records: the deterministic records of two chip_smoke.py logs
are matched by kernel and shape or by phase, preset and bit depth; a changed
byte count, flag or error is reported, a changed time is not."""
import json

from svtav1_tpu_torch.utils import smoke_records


def _log(*recs):
    return ["python 3.12 torch ..."] + [json.dumps(r) for r in recs] + ["NVIDIA H100, 700 W"]


GOP = dict(phase="path", preset="medium GOP", config=dict(qindex=120, keyint=16),
           bytes_per_frame=3936.8125, y_psnr=38.31, fps=6.7)
GOP10 = dict(GOP, config=dict(qindex=120, keyint=16, bd=10), bytes_per_frame=3560.625)
K6 = dict(check="cdef_dir", shape=[1, 135, 240], max_abs_err=0, ms=0.05, device_ms=0.006)
DECODE = dict(phase="decode", path="1080p GOP", tus=2, decode_bit_exact=True, seconds=21.0)


def test_equal_records_but_times():
    parent = _log(GOP, GOP10, K6, DECODE)
    change = _log(dict(GOP, fps=7.1), GOP10, dict(K6, ms=0.04, device_ms=0.0047),
                  dict(DECODE, seconds=20.0), dict(K6, shape=[2, 135, 240]))
    res = smoke_records.compare(parent, change)
    assert res["differ"] == [] and res["records"] == 4 and res["only_change"] == 1
    assert res["values"] == 2 + 2 + 1 + 2


def test_a_changed_value_is_reported_on_its_record():
    parent = _log(GOP, GOP10, K6, DECODE)
    change = _log(GOP, dict(GOP10, bytes_per_frame=3561.0), K6,
                  dict(DECODE, decode_bit_exact=False))
    res = smoke_records.compare(parent, change)
    assert [(d["record"][2], d["record"][3], d["field"]) for d in res["differ"]] == [
        ("medium GOP", 10, "bytes_per_frame"), ("1080p GOP", 8, "decode_bit_exact")]


def test_new_path_records_are_compared():
    """The batched all-intra, restoration and film grain records: their
    restoration types, launches per batch and grain parameters count as
    deterministic, their frames/s do not."""
    lr = dict(phase="path", preset="1080p restoration", config=dict(qindex=120, keyint=16),
              lr_types=[[1, 0, 0], [0, 0, 0]], bytes=[17000, 3900], seconds=90.0)
    batch = dict(phase="path", preset="1080p all-intra batched", config=dict(keyint=1),
                 launches_per_batch={"commit_wave": 1}, median_fps={"1": 12.0, "8": 15.0})
    grain = dict(phase="path", preset="1080p film grain", config=dict(keyint=16),
                 grain=dict(y_points=14, seeds=[7391]), fps=6.0)
    parent = _log(lr, batch, grain)
    same = smoke_records.compare(parent, _log(dict(lr, seconds=80.0),
                                              dict(batch, median_fps={"1": 11.0, "8": 16.0}),
                                              dict(grain, fps=7.0)))
    assert same["differ"] == [] and same["records"] == 3 and same["values"] == 2 + 1 + 1
    moved = smoke_records.compare(parent, _log(dict(lr, lr_types=[[0, 0, 0], [0, 0, 0]]),
                                               dict(batch, launches_per_batch={"commit_wave": 8}),
                                               dict(grain, grain=dict(y_points=13, seeds=[7391]))))
    assert [d["field"] for d in moved["differ"]] == ["lr_types", "launches_per_batch", "grain"]
