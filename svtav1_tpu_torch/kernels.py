"""Build, load and count the hand-written CUDA kernels of the port.

The sources in `csrc/*.cu` have a plain C interface. At first use they are
compiled with `nvcc` for `sm_90a` (one `nvcc -c` per source, all started
together), linked into one shared library under `build/` at the repository
root and loaded with `ctypes`. Nothing is built when the package is imported:
the CPU paths never reach this module's loader.

Each kernel wrapper calls `launch(name, fn_name, *args)`, which calls the C
entry point, raises if it returns a CUDA error code, and adds one to the
kernel's launch count. `launches` is read by `chip_smoke.py` to show that the
main path ran through every kernel.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(os.path.dirname(_PKG), "build")
LIB = os.path.join(BUILD, "libsvtav1_torch_kernels.so")
PTXAS_LOG = os.path.join(BUILD, "ptxas.txt")  # ptxas -v of the last build
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# kernel name -> (source file, C entry point)
KERNELS = {
    "intra_pred": ("intra_pred.cu", "intra_pred_launch"),
    "txfm_quant_recon": ("txfm_quant_recon.cu", "txfm_quant_recon_launch"),
    "txb_rate": ("txb_rate.cu", "txb_rate_launch"),
    "dlf_edges": ("dlf_edges.cu", "dlf_edges_launch"),
    "rdoq": ("rdoq.cu", "rdoq_launch"),
    "cdef_dir": ("cdef.cu", "cdef_dir_launch"),
    "cdef_search": ("cdef.cu", "cdef_search_launch"),
    "cdef_apply": ("cdef.cu", "cdef_apply_launch"),
    "me_sad": ("me.cu", "me_sad_launch"),
    "subpel_pred": ("subpel.cu", "subpel_pred_launch"),
    "mc_lanes": ("mc.cu", "mc_lanes_launch"),
    "mc_compound": ("mc.cu", "mc_compound_launch"),
    # the 16-bit forms of K8-K11 and K14 (K12's and K13's below): the same kernels on
    # int16 planes (10-bit)
    "me_sad16": ("me.cu", "me_sad16_launch"),
    "subpel_pred16": ("subpel.cu", "subpel_pred16_launch"),
    "mc_lanes16": ("mc.cu", "mc_lanes16_launch"),
    "mc_compound16": ("mc.cu", "mc_compound16_launch"),
    "subpel_refine16": ("subpel.cu", "subpel_refine16_launch"),
    "tf_filter": ("tf.cu", "tf_filter_launch"),
    "tf_noise": ("tf.cu", "tf_noise_launch"),
    "tf_filter16": ("tf.cu", "tf_filter16_launch"),
    "tf_noise16": ("tf.cu", "tf_noise16_launch"),
    "subpel_refine": ("subpel.cu", "subpel_refine_launch"),
    "tpl_cost": ("txfm_quant_recon.cu", "tpl_cost_launch"),
    "commit_wave": ("commit.cu", "commit_wave_launch"),
}
# the kernels with a 16-bit form -> that form (`name` + "16")
FORM16 = {k: k + "16" for k in KERNELS if k + "16" in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
ARGTYPES = {
    # above, left, tl, have_above, have_left, mode|NULL, weights, dr, out, B, n, log2n,
    # nmodes, bd, stream
    "intra_pred_launch": [_P] * 9 + [_I] * 5 + [_P],
    # src|NULL, pred, v_adst, h_adst, levels, coeff|NULL, recon|NULL, sse|NULL, stage, L,
    # rep, n, b0, b1, b2, sh_row, sh_col, dq_dc, dq_ac, ls, bd, stream
    "txfm_quant_recon_launch": [_P] * 8 + [_I] * 13 + [_P],
    # levels, flut, ilut, out, B, h, w, log2w, tx_class, stream
    "txb_rate_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # the same with group_threads, the threads per transform block (16, 32 or 256;
    # chip_smoke.py times them against each other)
    "txb_rate_launch_group": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # ptrs (host: J x in, flen_v, flen_h, out), lv (host: J x 8 limits), J, F, H, W, bd, stream
    "dlf_edges_launch": [_P, _P] + [_I] * 5 + [_P],
    # levels, coeff, flut, ilut, scan, out, B, h, w, log2w, ls, dq_dc, dq_ac,
    # lam, dscale, skip_delta, stream
    "rdoq_launch": [_P] * 6 + [_I] * 7 + [_F] * 3 + [_P],
    # plane, dirs, var, F, H, W, coeff_shift, stream
    "cdef_dir_launch": [_P] * 3 + [_I] * 4 + [_P],
    # plane, dirs, var, mask, src, sse, pri (host), sec (host), K, F, H, W, damping,
    # coeff_shift, stream
    "cdef_search_launch": [_P] * 8 + [_I] * 6 + [_P],
    # y, u, v, out_y, out_u, out_v, dirs, var, mask, sse, strengths, pri (host), sec (host),
    # K, F, H, W, damping, coeff_shift, stream
    "cdef_apply_launch": [_P] * 13 + [_I] * 6 + [_P],
    # mode (0 pyramid, 1 frame search), src0|NULL, src1, src2, ref0, ref1, ref2, out|NULL, hs,
    # ws, Hs, Ws, hr, wr, Hr, Wr, ox, sb_rows, sb_cols, l2_radius, leaf_radius, stream
    "me_sad_launch": [_I] + [_P] * 7 + [_I] * 13 + [_P],
    "me_sad16_launch": [_I] + [_P] * 7 + [_I] * 13 + [_P],
    # src_b, ref, ys, xs, mv_fp, ftab, mv_out, pred_out, B, H, W, n, bd, fast, stream
    "subpel_pred_launch": [_P] * 8 + [_I] * 6 + [_P],
    "subpel_pred16_launch": [_P] * 8 + [_I] * 6 + [_P],
    # ref0, ref1|NULL, ref2|NULL, ys, xs, mvy, mvx, ref_idx|NULL, ftab_x, ftab_y, out, P, B,
    # nref, H, W, n_h, n_w, bd, stream
    "mc_lanes_launch": [_P] * 11 + [_I] * 8 + [_P],
    "mc_lanes16_launch": [_P] * 11 + [_I] * 8 + [_P],
    # ref0, ref1|NULL, ref2|NULL (stacks), ys, xs, mv0y, mv0x, mv1y, mv1x, ref0_idx,
    # ref1_idx, ftab_x, ftab_y, out, P, B, nref, H, W, n_h, n_w, bd, stream
    "mc_compound_launch": [_P] * 14 + [_I] * 8 + [_P],
    "mc_compound16_launch": [_P] * 14 + [_I] * 8 + [_P],
    # cy, cu, cv, ptrs (host: K luma, K U+V predictions), out, h2, table, scratch, K, R, C,
    # bd, cap, stream
    "tf_filter_launch": [_P] * 8 + [_I] * 5 + [_P],
    "tf_filter16_launch": [_P] * 8 + [_I] * 5 + [_P],
    # y, acc, sums, h2, H, W, bd, scale, strength, stream
    "tf_noise_launch": [_P] * 4 + [_I] * 3 + [_F, _F, _P],
    "tf_noise16_launch": [_P] * 4 + [_I] * 3 + [_F, _F, _P],
    # src_b, ref, ys, xs, mv_fp, ftab, mv_out, B, H, W, n, bd, stream
    "subpel_refine_launch": [_P] * 7 + [_I] * 5 + [_P],
    "subpel_refine16_launch": [_P] * 7 + [_I] * 5 + [_P],
    # src, pred, satd|NULL, err|NULL, recon|NULL, mode, L, rep, n, b0, b1, b2, sh_row, sh_col,
    # dq_dc, dq_ac, ls, bd, stream
    "tpl_cost_launch": [_P] * 5 + [_I] * 13 + [_P],
    # frame_desc, tasks, owner, sync, T, F, R8, C8, dq_dc, dq_ac, bd, rdoq, lam, max_n, grid,
    # stream
    "commit_wave_launch": [_P] * 4 + [_I] * 8 + [_F] + [_I] * 2 + [_P],
    # max_n, T -> K16's grid (negative: a CUDA error)
    "commit_wave_grid": [_I, _I],
    # flag, rounds, stream: one flag handed between two CTAs (K16's cost per dependency edge)
    "flag_pingpong_launch": [_P, _I, _P],
    # which (0 VABSDIFF4.ACC, 1 IDP.2A, 2 IDP.4A, 3 IMAD, 4 VABSDIFF2.ACC, 5 VABSDIFF.ACC),
    # blocks, iters,
    # out, stream: the instruction rates of K8's and K9's bounds (chip_smoke.py)
    "packed_rate_launch": [_I, _I, _I, _P, _P],
}

launches = {name: 0 for name in KERNELS}
build_seconds: float | None = None
_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of svtav1_tpu_torch are built "
                       "with the CUDA toolkit at first use on a GPU machine")


def build() -> str:
    """Compile every source of csrc/ in parallel and link one .so (rebuilt
    when a source is newer than the library). Returns the library path."""
    global build_seconds
    srcs = sorted({src for src, _ in KERNELS.values()})
    paths = [os.path.join(CSRC, s) for s in srcs]
    headers = [os.path.join(CSRC, h) for h in os.listdir(CSRC) if h.endswith(".cuh")]
    newest = max(os.path.getmtime(p) for p in paths + headers)
    if os.path.exists(LIB) and os.path.getmtime(LIB) >= newest:
        return LIB
    t0 = time.perf_counter()
    nvcc = _nvcc()
    os.makedirs(BUILD, exist_ok=True)
    tag = f"{os.getpid()}"
    objs = [os.path.join(BUILD, f"{os.path.splitext(s)[0]}.{tag}.o") for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", p, "-o", o],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for p, o in zip(paths, objs)]
    errors, logs = [], []
    for p, proc in zip(paths, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode:
            errors.append(f"{os.path.basename(p)}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = f"{LIB}.{tag}.tmp"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, LIB)
    with open(PTXAS_LOG, "w") as f:
        f.write("\n".join(logs))
    for o in objs:
        os.remove(o)
    build_seconds = time.perf_counter() - t0
    return LIB


def ptxas_report() -> dict:
    """{kernel entry: (registers, spill stores, spill loads, static shared
    bytes)} from the last build's `ptxas -v` output ({} when the library
    was not built by this checkout)."""
    import re

    if not os.path.exists(PTXAS_LOG):
        return {}
    out, entry = {}, None
    for line in open(PTXAS_LOG):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            kern = re.search(r"\d+([a-z_]+_kernel)((?:IL[bi]\d+E|L[bi]\d+E)*)", name)
            args = [("true" if v == "1" else "false") if t == "b" else v
                    for t, v in re.findall(r"L([bi])(\d+)E", kern.group(2))] if kern else []
            entry = name if not kern else kern.group(1) + (f"<{', '.join(args)}>" if args else "")
            out[entry] = [0, 0, 0, 0]
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[entry][1:3] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry][0] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[entry][3] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for fn, argtypes in ARGTYPES.items():
                f = getattr(handle, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _lib = handle
    return _lib


def launch(name: str, *args) -> None:
    """Call kernel `name`'s C entry point; raise on a CUDA error code."""
    fn = getattr(lib(), KERNELS[name][1])
    err = fn(*args)
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    launches[name] += 1


def resolve_device(device=None):
    """The torch device of an entry point: `None` means CUDA. Without CUDA
    only an explicit CPU device is taken."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("svtav1_tpu_torch runs on a CUDA device and none is available; "
                           "pass device='cpu' to run the plain PyTorch versions of the kernels")
    return dev


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(t, name: str, dtype, shape=None) -> None:
    """Validate a kernel argument: CUDA, dtype, contiguous, optional shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
