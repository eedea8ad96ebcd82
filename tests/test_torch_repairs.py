"""Two repairs of the port that no parity test reaches (ROADMAP queue 3).

- The decoder reads the global-motion flags before it checks them: under
  `python -O`, which drops every `assert`, a low-delay stream whose P frames
  code a translation global MV still decodes to the encoder's recon.
- The CDEF apply leaves out the decoder's "direction 0 when the primary
  strength is 0" forcing, which holds only while the strength ladder never
  gives a zero primary with a secondary one: the ladder is held to that,
  and a ladder that breaks it raises ValueError.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from svtav1_tpu_torch.decode.decoder import Decoder
from svtav1_tpu_torch.filters import cdef_torch
from svtav1_tpu_torch.filters.cdef import SEARCH_CANDIDATES
from svtav1_tpu_torch.pipeline import encoder as port_enc
from svtav1_tpu_torch.utils.testclip import make_frames
from torch_encode_parity import encode_all

REPO = Path(__file__).resolve().parents[1]

DECODE_O = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from svtav1_tpu_torch.decode.decoder import Decoder
assert False, "asserts are on"
"""

DECODE = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from svtav1_tpu_torch.decode.decoder import Decoder
data = np.load(sys.argv[2], allow_pickle=True)
dec = Decoder()
for i, tu in enumerate(data["tus"]):
    recon = dec.decode_tu(bytes(tu))[3]
    for p in range(3):
        if not np.array_equal(recon[p], data[f"rec{i}_{p}"]):
            sys.exit(f"frame {i} plane {p} differs")
print("decoded", len(data["tus"]))
"""


def test_global_motion_stream_decodes_under_python_O(tmp_path):
    w, h = 128, 128  # the smallest frame the estimate searches (codec/gm.py)
    frames = make_frames(w, h, 3, seed=2)
    pkts = encode_all(port_enc.Encoder(port_enc.EncoderConfig(w, h, keyint=8), device="cpu"),
                      frames)
    dec = Decoder()
    coded = []
    for p in pkts:
        dec.decode_tu(p.tu)
        coded += [mv for e in dec.dpb if e is not None for mv in e["gm"] if tuple(mv) != (0, 0)]
    assert coded, "the stream codes no global MV"
    arrays = {f"rec{i}_{pl}": p.recon[pl] for i, p in enumerate(pkts) for pl in range(3)}
    path = tmp_path / "gop.npz"
    np.savez(path, tus=np.array([np.frombuffer(p.tu, np.uint8) for p in pkts], dtype=object),
             **arrays)
    run = [sys.executable, "-O", "-c"]
    # the interpreter really drops asserts, then the stream decodes under it
    assert subprocess.run(run + [DECODE_O, str(REPO)], capture_output=True).returncode == 0
    res = subprocess.run(run + [DECODE, str(REPO), str(path)], capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr + res.stdout
    assert res.stdout.strip() == f"decoded {len(pkts)}"


def test_cdef_ladder_keeps_the_direction_invariant():
    cdef_torch.check_ladder(SEARCH_CANDIDATES)
    for bad in (((0, 1),), ((1, 2),), ((0, 0), (1, 3))):
        with pytest.raises(ValueError, match="zero primary strength"):
            cdef_torch.check_ladder(bad)
