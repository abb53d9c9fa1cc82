"""Build the CUDA sources with nvcc and bind their C interface with ctypes.

Each source under `csrc/` compiles on first use into one shared library
per lane variant in ``ccka_tpu_torch/_build/`` (listed in .gitignore),
named by a hash of the source, its headers and the flags so an edit
rebuilds. A variant is a (faults, batch deadline D) pair of the packed
stream's lanes (:data:`VARIANTS`), passed to the source as the macros
``CCKA_FAULTS`` and ``CCKA_WL_D``: splitting the instantiations over
several translation units lets :func:`build_all` run one nvcc for each,
all at once. Nothing here runs at import time: the CPU tests import
every module of the package without nvcc.

The launch wrappers check device, dtype, shape and contiguity, launch on
PyTorch's current stream, and raise if the C function returns a CUDA
error. Every rollout launch takes ``b0``, the global index of its first
cluster (0 for a whole fleet): one shard of a fleet draws the fleet's
interruptions for its clusters. They allocate nothing: the caller passes the output tensor (or,
for a CARRY instantiation, the two state buffers of a :class:`BlockCarry`).
The rollout wrappers count their launches by instantiation in their
``launches`` Counter ("<FAULTS,CARRY>" and the like:
:func:`instantiation`); the others count in an integer ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("rollout_profiles.cu", "rollout_mlp.cu")
# (fault lanes, batch-deadline depth D; 0 = no workload lanes).
VARIANTS = ((False, 0), (True, 0), (False, 16), (True, 16))

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # Keep each multiply and add rounded on its own, as the plain
              # PyTorch version's separate operations are.
              "-fmad=false", "-Xptxas", "-v")

_VP, _I, _ULL = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
# The C interface of each source: function -> argument types.
_SIGNATURES = {
    "rollout_profiles.cu": {
        "ccka_rollout_profiles": (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                                  _I, _ULL, _I, _VP, _I, _I, _I, _I, _VP),
        "ccka_philox_uniforms": (_VP, _ULL, _I, _I, _I, _I, _VP),
        "ccka_rollout_plan": (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                              _I, _I, _ULL, _I, _I, _I, _I, _I, _VP),
        "ccka_rollout_profiles_carry": (_VP, _VP, _VP, _I, _VP, _VP, _I, _I,
                                        _I, _I, _I, _I, _I, _ULL, _I, _VP,
                                        _I, _I, _I, _I, _I, _VP),
        "ccka_rollout_plan_carry": (_VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _ULL, _I, _I, _I, _I,
                                    _I, _I, _VP),
    },
    "rollout_mlp.cu": {
        "ccka_rollout_mlp": (_VP,) * 11 + (_I,) * 10 + (_ULL, _I, _I, _I,
                                                         _I, _I, _VP),
        "ccka_rollout_mlp_carry": (_VP, _VP, _VP, _I) + (_VP,) * 9
                                  + (_I,) * 10 + (_ULL,) + (_I,) * 6
                                  + (_VP,),
        "ccka_mlp_forward": (_VP,) * 13 + (_I,) * 4 + (_VP,),
    },
}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, else PATH, else the toolkit's usual home."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _variant_flags(faults: bool, wl_depth: int) -> tuple[str, ...]:
    if (bool(faults), int(wl_depth)) not in VARIANTS:
        raise ValueError(f"no kernel build for faults={faults}, batch "
                         f"deadline D={wl_depth}; built: {VARIANTS}")
    return (f"-DCCKA_FAULTS={int(bool(faults))}",
            f"-DCCKA_WL_D={int(wl_depth)}")


def _lib_path(source: str, faults: bool = False, wl_depth: int = 0) -> Path:
    """The library of one variant of ``source``, named by a hash of it, of
    every header beside it and of the flags."""
    flags = NVCC_FLAGS + _variant_flags(faults, wl_depth)
    digest = hashlib.sha256(
        b"".join(f.read_bytes() for f in
                 (CSRC / source, *sorted(CSRC.glob("*.cuh"))))
        + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / (f"{Path(source).stem}-f{int(bool(faults))}"
                        f"w{int(wl_depth)}-{digest[:16]}.so")


def build(source: str, faults: bool = False,
          wl_depth: int = 0) -> tuple[Path, str, float]:
    """Compile one variant of ``source`` unless its library is current;
    returns (library, compiler log, seconds spent compiling)."""
    lib = _lib_path(source, faults, wl_depth)
    if lib.exists():
        return lib, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS,
                               *_variant_flags(faults, wl_depth), "-o", tmp,
                               str(CSRC / source)],
                              capture_output=True, text=True, check=False)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {source} (faults={faults}, "
                               f"D={wl_depth}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr, time.perf_counter() - t0


def build_all() -> dict[tuple, tuple[Path, str, float]]:
    """Compile every variant of every source, all nvcc processes started
    together; keyed by (source, faults, D)."""
    from concurrent.futures import ThreadPoolExecutor

    units = [(s, f, d) for s in SOURCES for f, d in VARIANTS]
    with ThreadPoolExecutor(len(units)) as pool:
        futures = {u: pool.submit(build, *u) for u in units}
        return {u: f.result() for u, f in futures.items()}


@functools.lru_cache(maxsize=None)
def library(source: str, faults: bool = False,
            wl_depth: int = 0) -> ctypes.CDLL:
    """The loaded library of one variant of ``source`` (built on first
    use)."""
    lib = ctypes.CDLL(str(build(source, faults, wl_depth)[0]))
    for name, argtypes in _SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda_f32(t: torch.Tensor, name: str) -> None:
    if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 CUDA tensor, "
                         f"got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")


class BlockCarry(NamedTuple):
    """The carried state of a CARRY launch: ``state_in`` at the block's
    first tick, ``state_out`` (another buffer of the same shape) after its
    last, both [rows, B] (the MLP's [NP, rows, B]) float32 on the
    stream's device; ``t0`` the global tick of the stream block's first
    row, ``b0`` the global index of the launch's first cluster."""

    state_in: torch.Tensor
    state_out: torch.Tensor
    t0: int
    b0: int = 0


def _check_stream(exo: torch.Tensor, out: torch.Tensor | None,
                  out_shape: tuple, T: int,
                  carry: BlockCarry | None = None, b0: int = 0) -> None:
    """The stream, and the output block and first cluster ``b0`` (or
    with ``carry`` the carried state, whose row count the C entry checks
    against the instantiation's)."""
    _require_cuda_f32(exo, "exo")
    if carry is None:
        if b0 < 0:
            raise ValueError(f"b0={b0} must be non-negative")
        _require_cuda_f32(out, "out")
        if tuple(out.shape) != out_shape or out.device != exo.device:
            raise ValueError(f"out must be {list(out_shape)} on "
                             f"{exo.device}")
    else:
        si, so = carry.state_in, carry.state_out
        _require_cuda_f32(si, "state_in")
        _require_cuda_f32(so, "state_out")
        want = out_shape[:-2] + (si.shape[-2], out_shape[-1])
        if (tuple(si.shape) != want or tuple(so.shape) != want
                or si.device != exo.device or so.device != exo.device):
            raise ValueError(f"state_in and state_out must both be "
                             f"[{', '.join(map(str, out_shape[:-2]))}"
                             f"{', ' if out_shape[:-2] else ''}rows, "
                             f"{out_shape[-1]}] on {exo.device}, got "
                             f"{list(si.shape)} and {list(so.shape)}")
        if si.data_ptr() == so.data_ptr():
            raise ValueError("state_out must be another buffer than "
                             "state_in")
        if carry.t0 < 0 or carry.b0 < 0:
            raise ValueError(f"t0={carry.t0} and b0={carry.b0} must be "
                             "non-negative")
    if T > exo.shape[0]:
        raise ValueError(f"T={T} exceeds the stream's {exo.shape[0]} ticks")


def _carry_args(carry: BlockCarry) -> tuple:
    """The C entries' (state_in, state_out, state_rows) arguments."""
    return (carry.state_in.data_ptr(), carry.state_out.data_ptr(),
            carry.state_in.shape[-2])


def launch_rollout_profiles(out: torch.Tensor | None, exo: torch.Tensor,
                            params: np.ndarray, actions: np.ndarray, *,
                            P: int, Z: int, K: int, T: int, seed: int,
                            stochastic: bool,
                            carbon: tuple | None = None,
                            fault_base: int = -1, wl_base: int = -1,
                            wl_depth: int = 0,
                            carry: BlockCarry | None = None,
                            b0: int = 0) -> None:
    """Launch the rule-profile rollout kernel: ``exo`` [T_pad, rows, B],
    ``out`` [24, B] on one CUDA device; ``params`` [22] and ``actions``
    [2, n_act] host float32. ``carbon`` = (sharpness, min_weight,
    stickiness) launches its carbon-aware instantiation; ``fault_base``
    and ``wl_base`` (first rows of the stream's fault and workload blocks,
    -1 when absent) and ``wl_depth`` pick the lane variant. ``carry``
    launches the CARRY instantiation: ``T`` ticks of a longer rollout
    from ``carry.state_in`` into ``carry.state_out`` (``out`` unused).
    ``b0``: the global index of the stream's first cluster (a CARRY
    launch reads ``carry.b0`` instead)."""
    _, rows, B = exo.shape
    _check_stream(exo, out, (24, B), T, carry, b0)
    params = np.ascontiguousarray(params, np.float32)
    actions = np.ascontiguousarray(actions, np.float32)
    if params.shape != (22,) or actions.ndim != 2 or actions.shape[0] != 2:
        raise ValueError("params must be [22] and actions [2, n_act]")
    if carbon is not None:
        carbon = np.ascontiguousarray(carbon, np.float32)
        if carbon.shape != (3,):
            raise ValueError("carbon must be (sharpness, min_weight, "
                             "stickiness)")
    lib = library("rollout_profiles.cu", fault_base >= 0, wl_depth)
    tail = (None if carbon is None else carbon.ctypes.data, int(fault_base),
            int(wl_base), int(wl_depth))
    if carry is None:
        err = lib.ccka_rollout_profiles(
            exo.data_ptr(), out.data_ptr(), params.ctypes.data,
            actions.ctypes.data, actions.shape[1], P, Z, K, T, B, rows,
            int(seed), int(stochastic), *tail, int(b0), _stream(exo))
    else:
        err = lib.ccka_rollout_profiles_carry(
            exo.data_ptr(), *_carry_args(carry), params.ctypes.data,
            actions.ctypes.data, actions.shape[1], P, Z, K, T, B, rows,
            int(seed), int(stochastic), *tail, int(carry.t0),
            int(carry.b0), _stream(exo))
    _check(err, f"rollout_profiles (P={P}, Z={Z}, K={K}, "
                f"carbon={carbon is not None}, fault_base={fault_base}, "
                f"wl_base={wl_base}, D={wl_depth}, "
                f"carry={carry is not None})")
    launch_rollout_profiles.launches[
        instantiation("carbon" if carbon is not None else "rule",
                      fault_base >= 0, wl_depth, carry is not None)] += 1


def instantiation(policy: str, faults: bool, wl_depth: int,
                  carry: bool = False) -> str:
    """The template flags of a rollout kernel instantiation, as a name
    suffix: "" for the rule (or the MLP) on the plain stream, else e.g.
    "<CARBON,FAULTS,WL_D=16>", "<PLAN>" or "<FAULTS,CARRY>"."""
    flags = [f for f, on in (("CARBON", policy == "carbon"),
                             ("PLAN", policy == "plan"), ("FAULTS", faults),
                             (f"WL_D={wl_depth}", wl_depth),
                             ("CARRY", carry)) if on]
    return f"<{','.join(flags)}>" if flags else ""


launch_rollout_profiles.launches = Counter()


def launch_rollout_plan(out: torch.Tensor | None, exo: torch.Tensor,
                        params: np.ndarray, plan: torch.Tensor, *, P: int,
                        Z: int, K: int, T: int, seed: int, stochastic: bool,
                        fault_base: int = -1, wl_base: int = -1,
                        wl_depth: int = 0,
                        carry: BlockCarry | None = None,
                        b0: int = 0) -> None:
    """Launch the plan-playback instantiation of the profile kernel:
    ``plan`` [T_pad, plan_rows, B] (one plan per cluster) or
    [T_pad, plan_rows] (one plan for every cluster), contiguous float32 on
    the stream's device with T_pad the stream's (with ``carry``: the plan
    from the block's first tick on, the block's ticks); the rest as for
    :func:`launch_rollout_profiles`."""
    T_pad, rows, B = exo.shape
    _check_stream(exo, out, (24, B), T, carry, b0)
    _require_cuda_f32(plan, "plan")
    batched = plan.dim() == 3
    if (plan.device != exo.device or plan.dim() not in (2, 3)
            or plan.shape[0] != T_pad or (batched and plan.shape[2] != B)):
        raise ValueError(f"plan {list(plan.shape)} on {plan.device} does not "
                         f"fit the stream {list(exo.shape)} on {exo.device}")
    params = np.ascontiguousarray(params, np.float32)
    if params.shape != (22,):
        raise ValueError("params must be [22]")
    lib = library("rollout_profiles.cu", fault_base >= 0, wl_depth)
    args = (params.ctypes.data, plan.data_ptr(), plan.shape[1],
            int(batched), P, Z, K, T, B, rows, int(seed), int(stochastic),
            int(fault_base), int(wl_base), int(wl_depth))
    if carry is None:
        err = lib.ccka_rollout_plan(exo.data_ptr(), out.data_ptr(), *args,
                                    int(b0), _stream(exo))
    else:
        err = lib.ccka_rollout_plan_carry(
            exo.data_ptr(), *_carry_args(carry), *args, int(carry.t0),
            int(carry.b0), _stream(exo))
    _check(err, f"rollout_plan (P={P}, Z={Z}, K={K}, plan "
                f"{list(plan.shape)}, fault_base={fault_base}, "
                f"wl_base={wl_base}, D={wl_depth}, "
                f"carry={carry is not None})")
    launch_rollout_plan.launches[
        instantiation("plan", fault_base >= 0, wl_depth,
                      carry is not None)] += 1


launch_rollout_plan.launches = Counter()


def _check_weights(weights: tuple, device) -> tuple[int, int, int, int]:
    """(NP, F, H, A) of the MLP kernel's weight tensors, or raise unless
    they are contiguous on ``device`` with the kernel's dtypes and
    consistent shapes."""
    w1, b1, w2, b2, w3, b3 = weights
    NP, F, H = w1.shape
    A = w3.shape[-1]
    want = {"w1": (w1, (NP, F, H), torch.bfloat16),
            "b1": (b1, (NP, H), torch.bfloat16),
            "w2": (w2, (NP, H, H), torch.bfloat16),
            "b2": (b2, (NP, H), torch.bfloat16),
            "w3": (w3, (NP, H, A), torch.float32),
            "b3": (b3, (NP, A), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if not (t.device == device and t.dtype == dtype
                and tuple(t.shape) == shape and t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"{list(shape)} on {device}, got {t.dtype} "
                             f"{list(t.shape)} on {t.device}")
    return NP, F, H, A


def launch_rollout_mlp(out: torch.Tensor | None, exo: torch.Tensor,
                       params: np.ndarray, slo: np.ndarray,
                       codec: np.ndarray, weights: tuple, *, P: int, Z: int,
                       K: int, T: int, seed: int, stochastic: bool,
                       fault_base: int = -1, wl_base: int = -1,
                       wl_depth: int = 0,
                       carry: BlockCarry | None = None,
                       b0: int = 0) -> None:
    """Launch the learned-policy rollout kernel: ``exo`` [T_pad, rows, B],
    ``out`` [NP, 24, B]; ``weights`` = (w1 [NP, F, H], b1 [NP, H],
    w2 [NP, H, H], b2 [NP, H]) bfloat16 and (w3 [NP, H, A], b3 [NP, A])
    float32, contiguous on the stream's device; ``params`` [22], ``slo``
    [P] and ``codec`` [4] host float32; the lanes and ``carry`` (states
    [NP, rows, B]) as for :func:`launch_rollout_profiles`."""
    _, rows, B = exo.shape
    NP, F, H, A = _check_weights(weights, exo.device)
    _check_stream(exo, out, (NP, 24, B), T, carry, b0)
    params = np.ascontiguousarray(params, np.float32)
    slo = np.ascontiguousarray(slo, np.float32)
    codec = np.ascontiguousarray(codec, np.float32)
    if params.shape != (22,) or slo.shape != (P,) or codec.shape != (4,):
        raise ValueError("params must be [22], slo [P] and codec [4]")
    lib = library("rollout_mlp.cu", fault_base >= 0, wl_depth)
    args = (params.ctypes.data, slo.ctypes.data, codec.ctypes.data,
            *(t.data_ptr() for t in weights), NP, F, H, A, P, Z, K, T, B,
            rows, int(seed), int(stochastic), int(fault_base), int(wl_base),
            int(wl_depth))
    if carry is None:
        err = lib.ccka_rollout_mlp(exo.data_ptr(), out.data_ptr(), *args,
                                   int(b0), _stream(exo))
    else:
        err = lib.ccka_rollout_mlp_carry(
            exo.data_ptr(), *_carry_args(carry), *args, int(carry.t0),
            int(carry.b0), _stream(exo))
    _check(err, f"rollout_mlp (P={P}, Z={Z}, K={K}, F={F}, H={H}, A={A}, "
                f"fault_base={fault_base}, wl_base={wl_base}, D={wl_depth}, "
                f"carry={carry is not None})")
    launch_rollout_mlp.launches[
        instantiation("mlp", fault_base >= 0, wl_depth,
                      carry is not None)] += 1


launch_rollout_mlp.launches = Counter()


def launch_mlp_forward(out: tuple, obs: torch.Tensor,
                       weights: tuple) -> None:
    """Launch ``mlp_forward_kernel``, the MLP rollout kernel's
    observation -> torso -> head on given observations: ``obs`` [N, F]
    float32; ``weights`` as for :func:`launch_rollout_mlp` (member 0 is
    used); ``out`` = (x [N, F], pre1 [N, H], h1 [N, H], pre2 [N, H],
    h2 [N, H], u [N, A]), x, h1 and h2 bfloat16, the rest float32, all
    contiguous on ``obs``'s device."""
    _require_cuda_f32(obs, "obs")
    _, F, H, A = _check_weights(weights, obs.device)
    if obs.dim() != 2 or obs.shape[1] != F:
        raise ValueError(f"obs must be [N, {F}], got {list(obs.shape)}")
    N = obs.shape[0]
    bf16, f32 = torch.bfloat16, torch.float32
    want = ((F, bf16), (H, f32), (H, bf16), (H, f32), (H, bf16), (A, f32))
    for t, (width, dtype) in zip(out, want, strict=True):
        if not (t.device == obs.device and t.dtype == dtype
                and tuple(t.shape) == (N, width) and t.is_contiguous()):
            raise ValueError(f"outputs must be contiguous [N, width] "
                             f"tensors {[w for w, _ in want]} of "
                             f"{[str(d) for _, d in want]} on {obs.device}")
    err = library("rollout_mlp.cu").ccka_mlp_forward(
        obs.data_ptr(), *(t.data_ptr() for t in out),
        *(t.data_ptr() for t in weights), N, F, H, A, _stream(obs))
    _check(err, f"mlp_forward (N={N}, F={F}, H={H}, A={A})")
    launch_mlp_forward.launches += 1


launch_mlp_forward.launches = 0


# The SASS opcodes sass_counts counts: tensor-core products, warp
# shuffles, the special-function unit (reciprocal, exp2, log2, sqrt,
# sin/cos), calls (the division and square-root slow paths), global
# loads, and local-memory loads and stores (spilled registers).
SASS_OPS = ("HMMA", "SHFL", "MUFU", "CALL", "LDG", "LDL", "STL")


def sass_counts(text: str) -> dict[str, dict[str, int]]:
    """Per kernel function of ``cuobjdump -sass`` output: its static
    instructions, each opcode of :data:`SASS_OPS`, and under "loop" the
    instructions of its longest loop (from the target of the backward
    branch that spans the most code to that branch: a rollout kernel's
    tick loop, the division slow paths it calls left out)."""
    out: dict[str, dict[str, int]] = {}
    counts = None
    for line in text.splitlines():
        if "Function :" in line:
            counts = out.setdefault(line.split("Function :")[1].strip(), {
                "instructions": 0, "loop": 0, **dict.fromkeys(SASS_OPS, 0)})
            addrs, spans = [], []
        elif counts is not None and line.lstrip().startswith("/*") and \
                ";" in line:
            addr, op = line.split("*/", 1)
            addr = int(addr.strip().lstrip("/*"), 16)
            op = op.split(";", 1)[0].split()
            # A predicated instruction starts with its guard (@P0).
            if op and op[0].startswith("@"):
                op = op[1:]
            mnemonic = op[0].split(".")[0] if op else ""
            counts["instructions"] += 1
            addrs.append(addr)
            if mnemonic in SASS_OPS:
                counts[mnemonic] += 1
            if mnemonic == "BRA" and op[-1].startswith("0x") and \
                    int(op[-1], 16) < addr:
                spans.append((int(op[-1], 16), addr))
                lo, hi = max(spans, key=lambda s: s[1] - s[0])
                counts["loop"] = sum(lo <= a <= hi for a in addrs)
    return out


def sass_summary(lib: Path) -> dict[str, dict[str, int]]:
    """:func:`sass_counts` of a built library's ``cuobjdump -sass`` (the
    toolkit's, beside nvcc), kernel names demangled where c++filt is
    found."""
    cuobjdump = Path(nvcc_path()).parent / "cuobjdump"
    out = sass_counts(subprocess.run([str(cuobjdump), "-sass", str(lib)],
                                     capture_output=True, text=True,
                                     check=True).stdout)
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and out:
        names = subprocess.run([cxxfilt], input="\n".join(out),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        out = dict(zip(names, out.values(), strict=True))
    return out


def launch_philox_uniforms(out: torch.Tensor, seed: int, tick0: int) -> None:
    """Launch ``philox_uniform_kernel`` into ``out`` [3, n_ticks, n_rows,
    n_clusters]."""
    _require_cuda_f32(out, "out")
    if out.dim() != 4 or out.shape[0] != 3:
        raise ValueError("out must be [3, n_ticks, n_rows, n_clusters]")
    _, n_ticks, n_rows, n_clusters = out.shape
    err = library("rollout_profiles.cu").ccka_philox_uniforms(
        out.data_ptr(), int(seed), int(tick0), n_ticks, n_rows, n_clusters,
        _stream(out))
    _check(err, "philox_uniforms")
