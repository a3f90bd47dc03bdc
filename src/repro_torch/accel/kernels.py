"""Build, load and launch the assessment kernels B1–B4.

The four kernels live in ``csrc/assess.cu`` (CUDA C++ for ``sm_90a``, a
plain C interface). :func:`library` compiles it with ``nvcc`` at first use
into ``build/kernels/`` at the repository root — the file name carries a
hash of the source and flags, so an edited source rebuilds — and loads it
with ``ctypes``. Nothing is compiled or loaded at import: CPU-only hosts
import this module freely.

Each ``launch_*`` function checks device, dtype, shape and contiguity,
allocates its outputs and scratch with ``torch.empty``, launches on the
current stream without synchronising, raises if the C entry point reports
a CUDA error, and adds one to its entry of :data:`launches`. The plain
torch versions and the device dispatch live in
:mod:`repro_torch.accel.torch_backend`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "assess.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
# Largest dynamic shared memory a block may take on Hopper (227 KB).
MAX_SMEM = 232448

# Launches per kernel since the last reset_launches(): the proof that a
# run went through the kernels.
launches: Dict[str, int] = {"spatial": 0, "temporal": 0, "late": 0,
                            "reap": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build() -> Path:
    """Compile ``assess.cu`` unless a library of this source and these
    flags is already built; returns the library's path."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"libassess-{digest[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True)
        os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.assess_spatial.argtypes = [P] * 6 + [I] * 4 + [P, P]
        lib.assess_temporal.argtypes = [P] * 5 + [I] * 3 + [P, P, P]
        lib.assess_late.argtypes = [P] * 9 + [I, I, D, D, D, D] + [P] * 6
        lib.assess_reap.argtypes = [P] * 3 + [I, P, P, P]
        lib.assess_spatial_smem.argtypes = [I]
        lib.assess_temporal_smem.argtypes = [I]
        for fn in (lib.assess_spatial, lib.assess_temporal, lib.assess_late,
                   lib.assess_reap):
            fn.restype = ctypes.c_int
        lib.assess_spatial_smem.restype = ctypes.c_size_t
        lib.assess_temporal_smem.restype = ctypes.c_size_t
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Argument checks
# ---------------------------------------------------------------------------
def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _cols(device, cap, f64=(), i32=()) -> None:
    for name, t in f64:
        _check(t, name, torch.float64, (cap,), device)
    for name, t in i32:
        _check(t, name, torch.int32, (cap,), device)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


def _smem(bytes_: int, kernel: str, n: int) -> int:
    if bytes_ > MAX_SMEM:
        raise ValueError(f"{kernel}: {n} nodes need {bytes_} B of shared "
                         f"memory, above the {MAX_SMEM} B a block may use")
    return bytes_


# ---------------------------------------------------------------------------
# Launchers (CUDA tensors only)
# ---------------------------------------------------------------------------
def launch_spatial(rho, node, kind, jls, running, nh,
                   jcap: int) -> torch.Tensor:
    """B1: (jcap, 2, n) bool Eq. 1 hits per (job, phase, node)."""
    dev, cap = rho.device, rho.shape[0]
    n, k = nh.shape
    _cols(dev, cap, f64=[("rho", rho)],
          i32=[("node", node), ("kind", kind), ("jls", jls),
               ("running", running)])
    _check(nh, "nh", torch.int32, (n, k), dev)
    lib = library()
    _smem(lib.assess_spatial_smem(n), "spatial", n)
    fired = torch.empty((jcap, 2, n), dtype=torch.bool, device=dev)
    rc = lib.assess_spatial(
        rho.data_ptr(), node.data_ptr(), kind.data_ptr(), jls.data_ptr(),
        running.data_ptr(), nh.data_ptr(), cap, n, k, jcap,
        fired.data_ptr(), _stream(dev))
    _raise_on(rc, "spatial")
    launches["spatial"] += 1
    return fired


def launch_temporal(prog, tprog, node, jls, alive, jcap: int,
                    n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: (jcap, n) float64 ζ_now and ζ_prev sums, NaN where empty."""
    dev, cap = prog.device, prog.shape[0]
    _cols(dev, cap, f64=[("prog", prog), ("tprog", tprog)],
          i32=[("node", node), ("jls", jls), ("alive", alive)])
    lib = library()
    _smem(lib.assess_temporal_smem(n), "temporal", n)
    zn = torch.empty((jcap, n), dtype=torch.float64, device=dev)
    zp = torch.empty((jcap, n), dtype=torch.float64, device=dev)
    rc = lib.assess_temporal(
        prog.data_ptr(), tprog.data_ptr(), node.data_ptr(), jls.data_ptr(),
        alive.data_ptr(), cap, n, jcap, zn.data_ptr(), zp.data_ptr(),
        _stream(dev))
    _raise_on(rc, "temporal")
    launches["temporal"] += 1
    return zn, zp


def launch_late(prog, start, rate, spec, tseg, jls, running, runatt, order,
                now: float, min_runtime: float, q: float, win_factor: float,
                jcap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3: (jcap,) int32 LATE victim rows (-1: none) and winning flags."""
    dev, cap = prog.device, prog.shape[0]
    _cols(dev, cap, f64=[("prog", prog), ("start", start), ("rate", rate)],
          i32=[("spec", spec), ("tseg", tseg), ("jls", jls),
               ("running", running), ("runatt", runatt), ("order", order)])
    lib = library()
    c_rho = torch.empty((jcap, cap), dtype=torch.float64, device=dev)
    c_est = torch.empty((jcap, cap), dtype=torch.float64, device=dev)
    c_pos = torch.empty((jcap, cap), dtype=torch.int32, device=dev)
    victim = torch.empty(jcap, dtype=torch.int32, device=dev)
    win = torch.empty(jcap, dtype=torch.int32, device=dev)
    rc = lib.assess_late(
        prog.data_ptr(), start.data_ptr(), rate.data_ptr(), spec.data_ptr(),
        tseg.data_ptr(), jls.data_ptr(), running.data_ptr(),
        runatt.data_ptr(), order.data_ptr(), cap, jcap, float(now),
        float(min_runtime), float(q), float(win_factor), c_rho.data_ptr(),
        c_est.data_ptr(), c_pos.data_ptr(), victim.data_ptr(),
        win.data_ptr(), _stream(dev))
    _raise_on(rc, "late")
    launches["late"] += 1
    return victim, win


def launch_reap(a_state, tseg, live) -> torch.Tensor:
    """B4: (cap,) int32 mask of reapable running sibling attempts."""
    dev, cap = a_state.device, a_state.shape[0]
    _cols(dev, cap, i32=[("a_state", a_state), ("tseg", tseg),
                         ("live", live)])
    lib = library()
    done = torch.empty(cap, dtype=torch.int32, device=dev)
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    rc = lib.assess_reap(a_state.data_ptr(), tseg.data_ptr(),
                         live.data_ptr(), cap, done.data_ptr(),
                         out.data_ptr(), _stream(dev))
    _raise_on(rc, "reap")
    launches["reap"] += 1
    return out
