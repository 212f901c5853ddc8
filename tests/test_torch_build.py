"""The port's kernel build (ops/_build.py) on the CPU: no nvcc is needed to
name a library. A library's file name holds a hash of its source, of every
header in ``csrc/`` and of nvcc's flags, so an edited header never loads a
library built before the edit. And every source parses as C++ (g++ with a
shim of the CUDA built-ins), which finds an undefined name before a card
does."""

import ast
import ctypes
import glob
import importlib.util
import os
import re
import shutil
import subprocess

import pytest

from distributed_tensorflow_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "tile.cuh"\nint a() { return 1; }\n')
    (src / "b.cu").write_text("int b() { return 2; }\n")
    (src / "tile.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return src


def test_library_path_follows_every_header_and_the_source(csrc):
    before = _build._paths("a")
    assert _build._paths("a") == before  # a pure function of the bytes
    src, so, log = before
    assert src == os.path.join(str(csrc), "a.cu")
    assert os.path.basename(so).startswith("liba-") and so.endswith(".so")
    assert log == so[:-3] + ".log"
    (csrc / "tile.cuh").write_text("#pragma once\n// edited\n")
    after = _build._paths("a")
    assert after[1] != before[1]
    (csrc / "extra.cuh").write_text("// a new header\n")
    assert _build._paths("a")[1] != after[1]
    (csrc / "a.cu").write_text('#include "tile.cuh"\nint a() { return 3; }\n')
    assert _build._paths("a")[1] not in (before[1], after[1])


def test_library_path_follows_the_flags_and_differs_by_source(csrc, monkeypatch):
    a, b = _build._paths("a")[1], _build._paths("b")[1]
    assert a != b
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._paths("a")[1] != a


def test_the_port_sources_name_their_libraries():
    """Every library of ``SIGNATURES`` has its source in the real ``csrc``,
    and the LN+matmul sources, the conv+BN source and the flash source
    (its bf16 dK/dV kernel) share ``tile_mma.cuh``."""
    for name in _build.SIGNATURES:
        assert os.path.exists(_build._paths(name)[0]), name
    for name in ("ln_matmul", "ln_matmul_bwd", "fused_conv_bn", "flash_attention"):
        with open(_build._paths(name)[0]) as f:
            assert '#include "tile_mma.cuh"' in f.read()


def test_conv_bn_forward_entries_take_the_plan_width():
    """The conv+BN forward's C entries take the launch plan's tile width
    after G, as dw's do (the parse test below holds the source's
    definitions to these arities), and ``conv_bn_fwd_tile`` states the
    forward tile's rows of M and CTAs an SM for ``fwd_plan``."""
    sig = _build.SIGNATURES["fused_conv_bn"]
    assert sig["conv_bn_fwd_tile"] == (ctypes.c_int,)
    for s in ("f32", "bf16"):
        args = sig[f"conv_bn_fwd_{s}"]
        # x, w; sk, sn; scale, shift, y, ws, sum, ssq; M, cin, cout, G, bn,
        # prologue, relu, stats; stream
        assert len(args) == 19 and args[2:4] == (ctypes.c_longlong,) * 2
        assert args[10:18] == (ctypes.c_int,) * 8 and args[18] == ctypes.c_void_p
    with open(_build._paths("fused_conv_bn")[0]) as f:
        src = f.read()
    assert "int conv_bn_fwd_tile(int what)" in src
    assert re.search(r"int G, int bn, int prologue, int relu, int stats, void \*stream\n"
                     r"#define DTF_FWD_PASS", src)


#: Just enough of CUDA for g++ to parse the port's sources as C++: the
#: execution-space keywords vanish, built-ins are declarations, inline PTX
#: stays an asm statement g++ does not assemble under -fsyntax-only.
_SHIM = r"""
#pragma once
#include <cmath>
#include <cstddef>
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __align__(n)
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1)
    : x(a), y(b), z(c) {} };
struct uint3_ { unsigned x, y, z; };
extern uint3_ threadIdx, blockIdx, blockDim, gridDim;
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct __nv_bfloat16 { unsigned short v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
float __bfloat162float(__nv_bfloat16);
__nv_bfloat16 __float2bfloat16(float);
float2 __bfloat1622float2(__nv_bfloat162);
__nv_bfloat162 __floats2bfloat162_rn(float, float);
unsigned short __bfloat16_as_ushort(__nv_bfloat16);
float __fmul_rn(float, float);
float __fadd_rn(float, float);
float __shfl_xor_sync(unsigned, float, int);
float __shfl_sync(unsigned, float, int);
int __shfl_sync(unsigned, int, int);
float __shfl_down_sync(unsigned, float, int);
unsigned __ballot_sync(unsigned, int);
int __reduce_max_sync(unsigned, int);
void __syncthreads();
void __syncwarp(unsigned m = 0xffffffffu);
size_t __cvta_generic_to_shared(const void*);
float rsqrtf(float);
float __expf(float);
float exp2f(float);
float __fdividef(float, float);
float __int_as_float(int);
int __float_as_int(float);
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }
inline float min(float a, float b) { return a < b ? a : b; }
inline float max(float a, float b) { return a > b ? a : b; }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef struct CUstream_st* cudaStream_t;
cudaError_t cudaGetLastError();
const char* cudaGetErrorString(cudaError_t);
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int);
template <class T> cudaError_t cudaMemcpyFromSymbol(void*, const T&, size_t);
namespace cooperative_groups {
struct cluster_group {
  void sync() const;
  unsigned block_rank() const;
  unsigned num_blocks() const;
  template <class T> T* map_shared_rank(T* p, unsigned rank) const;
};
cluster_group this_cluster();
}
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim; size_t dynamicSmemBytes; cudaStream_t stream;
  cudaLaunchAttribute* attrs; unsigned numAttrs;
};
// as CUDA's template: the arguments convert to the kernel's parameters
template <class... E, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t*, void (*k)(E...), A&&... a) {
  k(static_cast<E>(a)...);
  return cudaSuccess;
}
"""


def _parse(name: str, src: str, tmp_path):
    """g++ -fsyntax-only on the source text ``src`` of library ``name``
    (its kernel launches ``<<<...>>>`` dropped) against the CUDA shim, with
    the headers of ``csrc`` beside it, each C entry point of
    ``SIGNATURES`` held to its arity: the finished process."""
    gxx = shutil.which("g++")
    assert gxx, "g++ parses the sources here"
    for h in ("cuda_bf16.h", "cuda_runtime.h", "cooperative_groups.h"):
        (tmp_path / h).write_text('#include "cuda_shim.h"\n')
    (tmp_path / "cuda_shim.h").write_text(_SHIM)
    for h in glob.glob(os.path.join(_build.CSRC, "*.cuh")):
        shutil.copy(h, tmp_path)
    src = re.sub(r"<<<.*?>>>", "", src, flags=re.S)
    src += "\ntemplate <class R, class... A> constexpr int dtf_arity(R (*)(A...)) " \
           "{ return sizeof...(A); }\n"
    src += "".join(f'static_assert(dtf_arity(&{fn}) == {len(args)}, "{fn}");\n'
                   for fn, args in _build.SIGNATURES[name].items())
    (tmp_path / f"{name}.cpp").write_text(src)
    return subprocess.run([gxx, "-std=c++17", "-fsyntax-only", "-Wno-unknown-pragmas",
                           "-I", str(tmp_path), "-x", "c++", str(tmp_path / f"{name}.cpp")],
                          capture_output=True, text=True)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_sources_parse_as_cpp_with_every_template_instantiated(name, tmp_path):
    """No nvcc runs here, so an undefined name or a type error in a kernel
    would first show on the card. g++ parses each source (its kernel
    launches ``<<<...>>>`` dropped, so the launchers instantiate every
    kernel template) against a shim of the CUDA built-ins, with the
    headers of ``csrc`` beside it; every C entry point of ``SIGNATURES``
    takes as many arguments as its ctypes signature lists."""
    with open(_build._paths(name)[0]) as f:
        out = _parse(name, f.read(), tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str, *parts: str):
    """A script of the repo (not a package module) loaded by its path."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_TURNS = _load("flash_dkv_turns", "tools", "flash_dkv_turns.py")


@pytest.mark.parametrize("name,subs", _TURNS.VARIANTS, ids=[n for n, _ in _TURNS.VARIANTS])
def test_flash_dkv_turns_substitutions_apply_to_the_source(name, subs):
    """``tools/flash_dkv_turns.py`` builds variants of the flash source by
    text substitution (the forward's and dK/dV's CTA shapes, K/V
    residency, ring depth, ablations); each text it replaces occurs
    exactly once in the source, so a variant changes the one kernel it
    names and the tool does not refuse it on the card."""
    with open(_build._paths("flash_attention")[0]) as f:
        src = f.read()
    for old, new in subs:
        assert src.count(old) == 1 and old != new, (name, old)
    assert _TURNS.substitute(src, name, subs) != src


def test_flash_dkv_turns_refuses_a_text_that_is_not_there_once():
    """A substitution whose text occurs twice (or not at all) would change
    both kernels (or none): the tool stops instead."""
    with pytest.raises(SystemExit, match="2 times"):
        _TURNS.substitute("a;\na;\n", "twice", [("a;", "b;")])
    with pytest.raises(SystemExit, match="0 times"):
        _TURNS.substitute("a;\n", "absent", [("c;", "b;")])
    assert _TURNS.substitute("a;\nc;\n", "once", [("a;", "b;")]) == "b;\nc;\n"


_CONV_TURNS = _load("conv_fwd_turns", "tools", "conv_fwd_turns.py")


@pytest.mark.parametrize("name,subs", _CONV_TURNS.VARIANTS,
                         ids=[n for n, _ in _CONV_TURNS.VARIANTS])
def test_conv_fwd_turns_substitutions_apply_to_the_source(name, subs):
    """``tools/conv_fwd_turns.py`` builds variants of the conv+BN source by
    text substitution (the forward's levers, ring depths and ablations);
    each text it replaces occurs exactly once in the source, so a variant
    changes the forward kernel alone and the tool does not refuse it on the
    card."""
    with open(_build._paths("fused_conv_bn")[0]) as f:
        src = f.read()
    for old, new in subs:
        assert src.count(old) == 1 and old != new, (name, old)
    assert _CONV_TURNS.substitute(src, name, subs) != src


_PTXAS = """ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelILi64EEEvNS_7StridedE
    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads
ptxas info    : Used 247 registers, used 1 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_fwd_f32_kernelILi64EEEvNS_7StridedE
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi64EEEvNS_7StridedE
    0 bytes stack frame, {dq_spill} bytes spill stores, {dq_spill} bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_123flash_bwd_dq_f32_kernelILi64EEEvNS_7StridedE
    0 bytes stack frame, {dq_f32_spill} bytes spill stores, {dq_f32_spill} bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""


@pytest.mark.parametrize("spill,dq_spill,dq_f32_spill,kernels,refused", [
    (0, 0, 0, ("flash_fwd_kernel",), None),
    (16, 0, 0, ("flash_fwd_kernel",), "spills"),
    (0, 0, 0, ("flash_fwd_kernel", "flash_bwd_dkv_kernel"), "no instantiation"),
    (0, 16, 0, ("flash_fwd_kernel", "flash_bwd_dq_kernel"), "flash_bwd_dq_kernel.*spills"),
    (0, 0, 24, ("flash_fwd_kernel", "flash_bwd_dq_kernel"), None),
], ids=["clean", "spills", "missing", "dq-spills", "dq-f32-spills-unmatched"])
def test_chip_smoke_refuses_a_spilling_or_missing_flash_kernel(spill, dq_spill, dq_f32_spill,
                                                               kernels, refused):
    """``chip_smoke.check_spills`` reads ptxas's report: a bf16 flash
    kernel that spills (the forward, or dQ), or one the report does not
    name, fails phase 1; the f32 kernels (``flash_fwd_f32_kernel``,
    ``flash_bwd_dq_f32_kernel``, spilling here) are not matched by the bf16
    kernels' names."""
    chip_smoke = _load("chip_smoke", "chip_smoke.py")
    report = _PTXAS.format(spill=spill, dq_spill=dq_spill, dq_f32_spill=dq_f32_spill)
    if refused is None:
        chip_smoke.check_spills(report, kernels)
    else:
        with pytest.raises(chip_smoke.SmokeFailure, match=refused):
            chip_smoke.check_spills(report, kernels)


_LN_TURNS = _load("ln_fwd_turns", "tools", "ln_fwd_turns.py")


@pytest.mark.parametrize("name,subs", _LN_TURNS.VARIANTS, ids=[n for n, _ in _LN_TURNS.VARIANTS])
def test_ln_fwd_turns_substitutions_apply_to_the_source(name, subs, tmp_path):
    """``tools/ln_fwd_turns.py`` builds variants of the LN+matmul forward
    source by text substitution (its ablations and levers); each text it
    replaces occurs exactly once in the source, so a variant changes the
    serving kernel alone and the tool does not refuse it on the card, and
    each variant still parses (its switched-off branches included)."""
    with open(_build._paths("ln_matmul")[0]) as f:
        src = f.read()
    for old, new in subs:
        assert src.count(old) == 1 and old != new, (name, old)
    text = _LN_TURNS.substitute(src, name, subs)
    assert text != src
    out = _parse("ln_matmul", text, tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]


_PAGED_TURNS = _load("paged_turns", "tools", "paged_turns.py")


@pytest.mark.parametrize("name,subs", _PAGED_TURNS.VARIANTS + [_PAGED_TURNS.TIMELINE],
                         ids=[n for n, _ in _PAGED_TURNS.VARIANTS + [_PAGED_TURNS.TIMELINE]])
def test_paged_turns_substitutions_apply_to_the_source(name, subs, tmp_path):
    """``tools/paged_turns.py`` builds variants of the paged attention
    source by text substitution (its ablations, levers and the timeline
    built on the source's phase marks); each text it
    replaces occurs exactly once in the source, and each variant still
    parses (its switched-off branches included)."""
    with open(_build._paths("paged_attention")[0]) as f:
        src = f.read()
    for old, new in subs:
        assert src.count(old) == 1 and old != new, (name, old)
    text = _PAGED_TURNS.substitute(src, name, subs)
    assert text != src
    out = _parse("paged_attention", text, tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]


def test_paged_smem_is_the_kernel_layout(tmp_path):
    """The wrapper's ``paged_smem`` (which ``paged_plan`` fits to the SM)
    and the kernel's ``layout`` (the launch's shared-memory size) state one
    sum twice: g++ evaluates ``layout<T, DK, WARPS>`` as a constant
    expression for every plan ``paged_plan`` makes over both dtypes, every
    head dim, S from decode to two 64-row tiles, 1 to 128 blocks of 8 to
    32 keys and 1 or 8 batch rows, and each must equal ``paged_smem``."""
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    cases = set()
    for esz, t in ((2, "__nv_bfloat16"), (4, "float")):
        for D in pa.HEAD_DIMS:
            for S in (1, 5, 32, 64, 128):
                for MB in (1, 3, 20, 64, 128):
                    for bs in (8, 16, 32):
                        for B in (1, 8):
                            plan = pa.paged_plan(B, 12, S, MB, bs, D, esz, 132)
                            warps = 4 if S <= 32 else 8
                            cases.add((t, max(D, 16), warps, S, D, plan.chunk, plan.ranks,
                                       plan.cpr, pa.paged_smem(plan, S, D, esz)))
    with open(_build._paths("paged_attention")[0]) as f:
        src = f.read()
    src += "".join(f"static_assert(layout<{t}, {dk}, {w}>({S}, {D}, {kc}, {r}, {c}).bytes == "
                   f'{n}, "S={S} D={D} chunk={kc} ranks={r} cpr={c} {t}");\n'
                   for t, dk, w, S, D, kc, r, c, n in sorted(cases))
    assert len(cases) > 100
    out = _parse("paged_attention", src, tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]


# ---------------------------------------------------------------------------
# the launch device
# ---------------------------------------------------------------------------

OPS = os.path.join(REPO, "distributed_tensorflow_tpu_torch", "ops")


def test_every_launch_goes_through_the_device_helper():
    """A C entry launches on the current device, so every launch of the
    port goes through ``_build.launch``, which enters the tensors' device:
    in ``ops/*.py`` no attribute names an entry of ``SIGNATURES`` that
    launches (``QUERIES`` report constants and launch nothing), no
    ``getattr`` result is called, and no stream is read
    (``.cuda_stream``) outside ``_build.launch`` itself."""
    launching = {fn for entries in _build.SIGNATURES.values() for fn in entries} - _build.QUERIES
    assert _build.QUERIES <= {fn for entries in _build.SIGNATURES.values() for fn in entries}
    found = []
    for path in sorted(glob.glob(os.path.join(OPS, "*.py"))):
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        helper = set()
        for node in ast.walk(tree):
            if (os.path.basename(path) == "_build.py" and isinstance(node, ast.FunctionDef)
                    and node.name == "launch"):
                helper = {id(n) for n in ast.walk(node)}
        for node in ast.walk(tree):
            where = f"{os.path.basename(path)}:{getattr(node, 'lineno', '?')}"
            if id(node) in helper:
                continue
            if isinstance(node, ast.Attribute) and node.attr in launching | {"cuda_stream"}:
                found.append(f"{where} .{node.attr}")
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Call)
                    and isinstance(node.func.func, ast.Name) and node.func.func.id == "getattr"):
                found.append(f"{where} getattr(...)(...)")
    assert found == []
    with open(os.path.join(OPS, "_build.py")) as f:
        assert "cuda_stream" in f.read()


class _Lib:
    """A stand-in library: ``entry`` records its arguments and the device
    that was current when it was called."""

    def __init__(self, current, rc=0):
        self.calls, self.current, self.rc = [], current, rc

    def entry(self, *args):
        self.calls.append((args, self.current[0]))
        return self.rc

    def dtf_error_string(self, rc):
        return b"invalid argument"


def test_launch_enters_the_tensors_device_only_when_it_is_not_current(monkeypatch):
    """``_build.launch`` calls the entry with its arguments and the current
    stream of the tensors' device last; when that device is the current
    one it enters no guard, else it calls the entry inside
    ``torch.cuda.device`` of that device (and leaves the current device as
    it was). A non-zero return raises ``KernelLaunchError``."""
    import contextlib

    import torch

    current = [0]
    entered = []

    @contextlib.contextmanager
    def device(dev):
        entered.append(dev.index)
        before, current[0] = current[0], dev.index
        try:
            yield
        finally:
            current[0] = before

    class _Stream:
        def __init__(self, dev):
            self.cuda_stream = 1000 + torch.device(dev).index

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    lib = _Lib(current)
    _build.launch(lib, "entry", "test", torch.device("cuda:0"), 1, 2)
    assert lib.calls == [((1, 2, 1000), 0)] and entered == []
    _build.launch(lib, "entry", "test", torch.device("cuda:1"), 3)
    assert lib.calls[1] == ((3, 1001), 1) and entered == [1] and current == [0]
    with pytest.raises(_build.KernelLaunchError, match="test: CUDA error 1"):
        _build.launch(_Lib(current, rc=1), "entry", "test", torch.device("cuda:0"))
