"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use, alone, into ``ops/build/lib<name>-<hash>.so`` (headers it
includes, ``csrc/*.cuh``, are compiled in with it)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so csrc/<name>.cu

The hash covers the source text, every ``csrc/*.cuh`` header and the
flags, so an edited source or header never loads a stale library. The
directory is listed in ``.gitignore``. Nothing here runs at import time:
the first wrapper call on a CUDA tensor builds and loads its library;
``build_all`` starts one ``nvcc`` per source at once (``chip_smoke.py``
builds every kernel in parallel that way).

A failed build raises ``KernelBuildError`` with nvcc's output. Every
launch goes through ``launch``, which runs the C entry on its tensors'
device and stream. A kernel entry point returns ``cudaGetLastError()``
after its launch, and ``check`` raises ``KernelLaunchError`` when that is
not 0 — there is no fallback to the plain PyTorch version on a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDED = (_c_void_p,) + (ctypes.c_longlong,) * 3
_FLASH_TAIL = (_c_int,) * 6 + (_c_float, _c_void_p)
_W_STRIDES = (ctypes.c_longlong,) * 2
_CONV_TAIL = (_c_int,) * 7 + (_c_void_p,)

#: C entry points per library: name -> (argtypes). Every entry returns
#: an int — the launchers a cudaError_t; pointers and the stream are
#: c_void_p so ctypes never truncates them to 32 bits.
SIGNATURES: dict[str, dict[str, tuple]] = {
    "paged_attention": {
        # q, k_pool, v_pool, table, q_pos, out, B, H, S, D, NB, bs, MB, the
        # plan's ranks, chunk keys and chunks a rank (paged_plan), scale,
        # stream
        **{fn: (_c_void_p,) * 6 + (_c_int,) * 10 + (_c_float, _c_void_p)
           for fn in ("paged_attention_f32", "paged_attention_bf16")},
    },
    "ln_matmul": {
        # x, gamma, beta, w, bias, y, M, d, n, w_stride_k, w_stride_n, the
        # plan's split (rows_plan), eps, stream
        **{fn: (_c_void_p,) * 6 + (_c_int,) * 6 + (_c_float, _c_void_p)
           for fn in ("ln_matmul_f32", "ln_matmul_bf16_f32", "ln_matmul_bf16")},
        # x, gamma, beta, w, bias, y, stats; M, d, n, sk, sn, eps, stream
        **{f"ln_matmul_tiled_{s}": (_c_void_p,) * 7 + (_c_int,) * 3 + _W_STRIDES
           + (_c_float, _c_void_p) for s in ("f32", "bf16", "bf16_f32")},
    },
    "ln_matmul_bwd": {
        # x, gamma, w, sk, sn, dy, dx, mean, rstd, ws, out; M, d, n, G, eps,
        # stream
        **{f"ln_bwd_dx_{s}": (_c_void_p,) * 3 + _W_STRIDES + (_c_void_p,) * 6
           + (_c_int,) * 4 + (_c_float, _c_void_p) for s in ("f32", "bf16")},
        # x, gamma, beta, dy, mean, rstd, ws, dw; M, d, n, G, stream
        **{f"ln_bwd_dw_{s}": (_c_void_p,) * 8 + (_c_int,) * 4 + (_c_void_p,)
           for s in ("f32", "bf16")},
    },
    # each [B,H,S,D] input as (pointer, stride_b, stride_h, stride_s);
    # then mask, outputs; B, H, Sq, Sk, D, causal, scale, stream
    "flash_attention": {
        # q, k, v, mask, out, lse
        **{f"flash_fwd_{s}": _STRIDED * 3 + (_c_void_p,) * 3 + _FLASH_TAIL
           for s in ("f32", "bf16")},
        # q, k, v, o, dout, mask, lse, dk, dv
        **{f"flash_bwd_dkv_{s}": _STRIDED * 5 + (_c_void_p,) * 4 + _FLASH_TAIL
           for s in ("f32", "bf16")},
        # q, k, v, o, dout, mask, lse, dq
        **{f"flash_bwd_dq_{s}": _STRIDED * 5 + (_c_void_p,) * 3 + _FLASH_TAIL
           for s in ("f32", "bf16")},
    },
    # w as (pointer, stride_k, stride_n); M, cin, cout, G (partial chunks),
    # prologue, relu, stats; stream
    "fused_conv_bn": {
        # x, w, sk, sn, scale, shift, y, ws, sum, ssq; M, cin, cout, G, the
        # tile's columns of cout, prologue, relu, stats; stream
        **{f"conv_bn_fwd_{s}": (_c_void_p,) * 2 + _W_STRIDES + (_c_void_p,) * 6 + (_c_int,)
           + _CONV_TAIL for s in ("f32", "bf16")},
        # 0, 1 -> the forward tile's rows of M, CTAs an SM
        "conv_bn_fwd_tile": (_c_int,),
        # x, y, dy, w, sk, sn, scale, shift, dsum, dssq, dx, ws, dscale, dshift
        **{f"conv_bn_bwd_dx_{s}": (_c_void_p,) * 4 + _W_STRIDES + (_c_void_p,) * 8
           + _CONV_TAIL for s in ("f32", "bf16")},
        # 0, 1, 2 -> the dx tile's rows, columns, CTAs an SM
        "conv_bn_dx_tile": (_c_int,),
        # x, y, dy, scale, shift, dsum, dssq, ws, dw; M, cin, cout, G, the
        # tile's columns of cout, prologue, relu, stats; stream
        **{f"conv_bn_bwd_dw_{s}": (_c_void_p,) * 9 + (_c_int,) + _CONV_TAIL
           for s in ("f32", "bf16")},
        # 0, 1, 2 -> the dw tile's rows of cin, rows of M a block, CTAs an SM
        "conv_bn_dw_tile": (_c_int,),
        # x, y, dy, w, sk, sn, scale, shift, dsum, dssq, dx, ws, dw, dscale, dshift
        **{f"conv_bn_bwd_single_{s}": (_c_void_p,) * 4 + _W_STRIDES + (_c_void_p,) * 9
           + _CONV_TAIL for s in ("f32", "bf16")},
        # 0, 1 -> the single-pass tile's rows, CTAs an SM
        "conv_bn_single_tile": (_c_int,),
    },
}


#: entries that report a constant of their source and launch nothing (no
#: stream argument); every other entry of ``SIGNATURES`` launches kernels
#: and is called through ``launch`` alone
QUERIES = frozenset({"conv_bn_fwd_tile", "conv_bn_dx_tile", "conv_bn_dw_tile",
                     "conv_bn_single_tile"})


class KernelBuildError(RuntimeError):
    """nvcc failed (or is missing) for one of the port's sources."""


class KernelLaunchError(RuntimeError):
    """A kernel entry point returned a CUDA error after its launch."""


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    the first ``nvcc`` on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the port's "
            "kernels are built from source on first use")
    return found


def _paths(name: str) -> tuple[str, str, str]:
    """(source, library, build log) of ``name``; the library's file name
    holds a hash of the source, every header in ``CSRC`` and the flags."""
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256()
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    return src, so, so[:-3] + ".log"


def constants(name: str) -> dict[str, int]:
    """The ``constexpr int NAME = value;`` lines of source ``name``: the
    constants a wrapper's launch plan shares with its kernel, stated once
    in the kernel's source."""
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        return {k: int(v) for k, v in re.findall(r"^constexpr int (\w+) = (\d+);", f.read(),
                                                  re.MULTILINE)}


def _start(name: str) -> tuple[subprocess.Popen, str, str] | None:
    """Start nvcc for ``name`` unless its library is already built."""
    src, so, log = _paths(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, log


def _finish(name: str, started) -> None:
    proc, tmp, log = started
    out, _ = proc.communicate()
    with open(log, "w") as f:
        f.write(out)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed for csrc/{name}.cu (rc {proc.returncode}):\n{out}")
    os.replace(tmp, _paths(name)[1])  # atomic: a torn .so never loads


def build_all(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Build every named library, one nvcc per source, all started
    together; returns name -> the ptxas report (registers, shared memory,
    spills) from the build log, empty when the library was cached."""
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish(n, s)
    reports = {}
    for n in names:
        log = _paths(n)[2]
        reports[n] = ""
        if os.path.exists(log):
            with open(log) as f:
                reports[n] = f.read()
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        build_all((name,))
        lib = ctypes.CDLL(_paths(name)[1])
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.dtf_error_string.argtypes = [ctypes.c_int]
        lib.dtf_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def on_cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (the wrapper launches its kernel), False for
    a CPU one (the wrapper computes its plain version); raises on any other
    device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, got {t.device}")
    return True


def refuse_grad(what: str, tensors, hint: str) -> None:
    """Raise when autograd would record a launch whose kernel has no
    backward: the ctypes launch returns a tensor with no ``grad_fn``, so
    a training step would silently give its inputs no gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward kernel and an input requires grad; "
            f"{hint} (or run it under torch.no_grad() / with frozen "
            f"parameters, as serving does)")


def launch(lib: ctypes.CDLL, entry: str, what: str, device: torch.device, *args) -> None:
    """Call the C entry ``entry`` of ``lib`` with ``args`` and the current
    stream of ``device`` (the device of the tensors whose pointers ``args``
    hold), then ``check`` its return code. A C entry launches on the
    current device, so when ``device`` is not the current one the call runs
    inside ``torch.cuda.device(device)``; the index is compared first, so
    the common call on the current device enters no guard."""
    fn = getattr(lib, entry)
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(lib, rc, what)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise ``KernelLaunchError`` unless the entry returned cudaSuccess."""
    if rc != 0:
        msg = lib.dtf_error_string(rc).decode(errors="replace")
        raise KernelLaunchError(f"{what}: CUDA error {rc} ({msg})")
