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
error. They allocate nothing: the caller passes the output tensor. Each
counts its launches by instantiation in its ``launches`` Counter.
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
                                  _I, _ULL, _I, _VP, _I, _I, _I, _VP),
        "ccka_philox_uniforms": (_VP, _ULL, _I, _I, _I, _I, _VP),
    },
    "rollout_mlp.cu": {
        "ccka_rollout_mlp": (_VP,) * 11 + (_I,) * 10 + (_ULL, _I, _I, _I,
                                                         _I, _VP),
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


def _check_stream(exo: torch.Tensor, out: torch.Tensor, out_shape: tuple,
                  T: int) -> None:
    _require_cuda_f32(exo, "exo")
    _require_cuda_f32(out, "out")
    if tuple(out.shape) != out_shape or out.device != exo.device:
        raise ValueError(f"out must be {list(out_shape)} on {exo.device}")
    if T > exo.shape[0]:
        raise ValueError(f"T={T} exceeds the stream's {exo.shape[0]} ticks")


def launch_rollout_profiles(out: torch.Tensor, exo: torch.Tensor,
                            params: np.ndarray, actions: np.ndarray, *,
                            P: int, Z: int, K: int, T: int, seed: int,
                            stochastic: bool,
                            carbon: tuple | None = None,
                            fault_base: int = -1, wl_base: int = -1,
                            wl_depth: int = 0) -> None:
    """Launch the rule-profile rollout kernel: ``exo`` [T_pad, rows, B],
    ``out`` [24, B] on one CUDA device; ``params`` [22] and ``actions``
    [2, n_act] host float32. ``carbon`` = (sharpness, min_weight,
    stickiness) launches its carbon-aware instantiation; ``fault_base``
    and ``wl_base`` (first rows of the stream's fault and workload blocks,
    -1 when absent) and ``wl_depth`` pick the lane variant."""
    _, rows, B = exo.shape
    _check_stream(exo, out, (24, B), T)
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
    err = lib.ccka_rollout_profiles(
        exo.data_ptr(), out.data_ptr(), params.ctypes.data,
        actions.ctypes.data, actions.shape[1], P, Z, K, T, B, rows,
        int(seed), int(stochastic),
        None if carbon is None else carbon.ctypes.data, int(fault_base),
        int(wl_base), int(wl_depth), _stream(exo))
    _check(err, f"rollout_profiles (P={P}, Z={Z}, K={K}, "
                f"carbon={carbon is not None}, fault_base={fault_base}, "
                f"wl_base={wl_base}, D={wl_depth})")
    launch_rollout_profiles.launches[
        instantiation(carbon is not None, fault_base >= 0, wl_depth)] += 1


def instantiation(carbon: bool, faults: bool, wl_depth: int) -> str:
    """The template flags of a rollout kernel instantiation, as a name
    suffix: "" for the plain stream, else e.g. "<CARBON,FAULTS,WL_D=16>"."""
    flags = [f for f, on in (("CARBON", carbon), ("FAULTS", faults),
                             (f"WL_D={wl_depth}", wl_depth)) if on]
    return f"<{','.join(flags)}>" if flags else ""


launch_rollout_profiles.launches = Counter()


def launch_rollout_mlp(out: torch.Tensor, exo: torch.Tensor,
                       params: np.ndarray, slo: np.ndarray,
                       codec: np.ndarray, weights: tuple, *, P: int, Z: int,
                       K: int, T: int, seed: int, stochastic: bool,
                       fault_base: int = -1, wl_base: int = -1,
                       wl_depth: int = 0) -> None:
    """Launch the learned-policy rollout kernel: ``exo`` [T_pad, rows, B],
    ``out`` [NP, 24, B]; ``weights`` = (w1 [NP, F, H], b1 [NP, H],
    w2 [NP, H, H], b2 [NP, H]) bfloat16 and (w3 [NP, H, A], b3 [NP, A])
    float32, contiguous on the stream's device; ``params`` [22], ``slo``
    [P] and ``codec`` [4] host float32; the lanes as for
    :func:`launch_rollout_profiles`."""
    _, rows, B = exo.shape
    w1, b1, w2, b2, w3, b3 = weights
    NP, F, H = w1.shape
    A = w3.shape[-1]
    _check_stream(exo, out, (NP, 24, B), T)
    want = {"w1": (w1, (NP, F, H), torch.bfloat16),
            "b1": (b1, (NP, H), torch.bfloat16),
            "w2": (w2, (NP, H, H), torch.bfloat16),
            "b2": (b2, (NP, H), torch.bfloat16),
            "w3": (w3, (NP, H, A), torch.float32),
            "b3": (b3, (NP, A), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if not (t.device == exo.device and t.dtype == dtype
                and tuple(t.shape) == shape and t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"{list(shape)} on {exo.device}, got {t.dtype} "
                             f"{list(t.shape)} on {t.device}")
    params = np.ascontiguousarray(params, np.float32)
    slo = np.ascontiguousarray(slo, np.float32)
    codec = np.ascontiguousarray(codec, np.float32)
    if params.shape != (22,) or slo.shape != (P,) or codec.shape != (4,):
        raise ValueError("params must be [22], slo [P] and codec [4]")
    lib = library("rollout_mlp.cu", fault_base >= 0, wl_depth)
    err = lib.ccka_rollout_mlp(
        exo.data_ptr(), out.data_ptr(), params.ctypes.data, slo.ctypes.data,
        codec.ctypes.data, *(t.data_ptr() for t in weights), NP, F, H, A,
        P, Z, K, T, B, rows, int(seed), int(stochastic), int(fault_base),
        int(wl_base), int(wl_depth), _stream(exo))
    _check(err, f"rollout_mlp (P={P}, Z={Z}, K={K}, F={F}, H={H}, A={A}, "
                f"fault_base={fault_base}, wl_base={wl_base}, D={wl_depth})")
    launch_rollout_mlp.launches[
        instantiation(False, fault_base >= 0, wl_depth)] += 1


launch_rollout_mlp.launches = Counter()


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
