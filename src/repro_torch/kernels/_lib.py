"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled by its own ``nvcc`` process, all started together,
into an object file for ``sm_90a``; the objects are linked into one shared
library with a plain C interface, which ``ctypes`` loads. The build runs at
the first kernel launch (never at import: the CPU tests import every module)
into ``build/repro_torch/`` at the root of the checkout, keyed by a hash of
the sources, so a second process reuses it.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a nonzero code into an exception.
``flash_decode_workspace_elems``, ``int_matmul_workspace_elems`` and
``flash_attention_bwd_workspace_elems`` launch nothing: they size the
kernels' workspaces; nor does
``int_matmul_decode_max_m``, the most rows the int matmuls quantize A at.
There is no fallback: a failed build or launch raises.

``LAUNCHES`` counts kernel launches per kernel name. A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its path went
through the kernels. ``FUSED`` names work that runs inside another kernel's
launch and is counted beside it: ``act_quant_static_fused`` is one static
quantization done in the staging of a ``w8a8_matmul`` or ``w4a8_matmul``
launch (M <= 16), not a launch of its own.

A CUDA graph (``serving/graphs.py``) launches its kernels without running
the wrappers: ``record_launches`` takes back what the wrappers counted while
a graph was captured (the capture launched nothing), and ``replayed`` adds
those counts once per replay and counts the replay in
``COUNTERS["graph_replays"]``, so ``LAUNCHES`` after a replayed step equals
what the same step run eagerly gives.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

KERNELS = ("w8a8_matmul", "act_quant_static", "flash_attention",
           "flash_decode", "flash_decode_paged", "w4a8_matmul",
           "act_quant_ptoken", "flash_attention_bwd")
# counted beside the kernels: quantizations done inside an int matmul
# launch, and the launches of the tensor-parallel modes (the W4A8 kernel's
# f32 accumulator, the per-token quantizer's range-only and given-range
# modes), which count under these names instead of the kernel's
FUSED = ("act_quant_static_fused", "w4a8_matmul_acc", "act_quant_ptoken_range",
         "act_quant_ptoken_given")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS + FUSED}
COUNTERS: Dict[str, int] = {"graph_replays": 0}

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every entry point (all return cudaError_t as int, but
# those in _RESTYPES)
_SIGNATURES = {
    # x, x_kind, w, colsum, s_x, z_x, s_w, s_w_bf16, z_shift, out,
    # out_bf16, M, N, K, workspace, stream
    "w8a8_matmul_launch": [_VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _F, _VP, _I,
                           _I, _I, _I, _VP, _VP],
    # x, x_bf16, scale, zero, out, n, stream
    "act_quant_static_launch": [_VP, _I, _VP, _VP, _VP, ctypes.c_longlong,
                                _VP],
    # x, x_kind, w_packed, s_w, s_w_bf16, colsum, s_x, z_x, z_shift, out,
    # out_kind, M, N, K, group, workspace, stream
    "w4a8_matmul_launch": [_VP, _I, _VP, _VP, _I, _VP, _VP, _VP, _F, _VP, _I,
                           _I, _I, _I, _I, _VP, _VP],
    # M, N, K, group
    "int_matmul_workspace_elems": [_I, _I, _I, _I],
    # (no arguments)
    "int_matmul_decode_max_m": [],
    # x, x_bf16, out, scale, zero, lo, hi, mode, M, D, qmax, stream
    "act_quant_ptoken_launch": [_VP, _I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                                _F, _VP],
    # q, k, v, out, lse (null: not written), bf16, causal, B, H, Kh, S, T,
    # hd, prefix_len, prefix_live, q strides (b, h, s), k strides (b, h, t),
    # v strides (b, h, t), out strides (b, h, s), stream
    "flash_attention_launch": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I] + [ctypes.c_longlong] * 12
                              + [_VP],
    # q, k, v, o, dout, lse, workspace, dq, dk, dv, bf16, causal, B, H, Kh,
    # S, T, hd, prefix_len, prefix_live, the (b, head, row) strides of q, k,
    # v, o, dout, dq, dk, dv (24 int64), stream
    "flash_attention_bwd_launch": [_VP] * 10 + [_I] * 10
                                  + [ctypes.POINTER(ctypes.c_longlong), _VP],
    # bf16, B, H, Kh, S, T, hd
    "flash_attention_bwd_workspace_elems": [_I] * 7,
    # q, k, v, k_scale, v_scale, scale_per_row, kc, vc, pos, pos_per_row,
    # out, fp_bf16, cache_int8, B, H, K, Smax, hd, m, kv0, Kmem (the window
    # of K KV heads read, of Kmem in memory), workspace, tickets, stream
    "flash_decode_launch": [_VP, _VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _I,
                            _VP, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _VP, _VP, _VP],
    # q, k_pages, v_pages, page_table, k_scale, v_scale, scale_per_row, kc,
    # vc, pos, pos_per_row, out, fp_bf16, cache_int8, B, H, K, P, ps, hd, m,
    # kv0, Kmem, workspace, tickets, stream
    "flash_decode_paged_launch": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _VP, _VP,
                                  _VP, _I, _VP, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _VP, _VP, _VP],
    # B, H, K, Smax, hd
    "flash_decode_workspace_elems": [_I, _I, _I, _I, _I],
}
_RESTYPES = {"flash_decode_workspace_elems": ctypes.c_longlong,
             "int_matmul_workspace_elems": ctypes.c_longlong,
             "flash_attention_bwd_workspace_elems": ctypes.c_longlong}

_lib: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Optional[float] = None
BUILD_LOG: Dict[str, float] = {}


def _nvcc() -> str:
    cand = [shutil.which("nvcc"),
            os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the port's kernels build from "
                       "source and cannot launch without it")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link one shared library.
    Returns its path; reuses a library already built from the same
    sources."""
    global BUILD_SECONDS
    out = BUILD_DIR / f"libreprotorch_{_digest()}.so"
    if out.exists():
        BUILD_SECONDS = 0.0
        return out
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = BUILD_DIR / (src.stem + f".{os.getpid()}.o")
        log = obj.with_suffix(".log")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        with open(log, "wb") as fh:
            procs.append((src, obj, log, subprocess.Popen(
                cmd, stdout=fh, stderr=subprocess.STDOUT)))
    objs, errors = [str(obj) for _, obj, _, _ in procs], []
    pending = list(procs)
    while pending:
        for item in [x for x in pending if x[3].poll() is not None]:
            src, _, log, p = item
            # seconds from the start until this source was done
            BUILD_LOG[src.name] = time.perf_counter() - t0
            if p.returncode != 0:
                errors.append(f"{src.name}:\n"
                              f"{log.read_text(errors='replace')}")
            os.remove(log)
            pending.remove(item)
        time.sleep(0.05)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                           "-shared", "-o", str(tmp), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n"
                           + link.stdout.decode(errors="replace"))
    os.replace(tmp, out)
    for o in objs:
        os.remove(o)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(*tensors: torch.Tensor) -> None:
    """Every operand of a kernel launch lies on the same CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for d in (LAUNCHES, COUNTERS):
        for k in d:
            d[k] = 0


def record_launches(capture: Callable[[], None]) -> Dict[str, int]:
    """Runs ``capture`` (a graph capture: its wrappers count launches that
    are only recorded) and returns the counts it added, which it takes back
    out of ``LAUNCHES``."""
    before = dict(LAUNCHES)
    try:
        capture()
        return {k: LAUNCHES[k] - n for k, n in before.items()
                if LAUNCHES[k] != n}
    finally:
        LAUNCHES.update(before)


def replayed(counts: Dict[str, int]) -> None:
    """One replay of a graph whose capture recorded ``counts``."""
    for k, n in counts.items():
        LAUNCHES[k] += n
    COUNTERS["graph_replays"] += 1
