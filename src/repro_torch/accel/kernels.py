"""Build, load and launch the port's CUDA kernels.

The assessment kernels B1–B4 live in ``csrc/assess.cu``, the ε-fair
network's pricing kernel B5 in ``csrc/bulk.cu``, the flash-attention
forward B6 in ``csrc/flash_attention.cu``, its backward B7 (dK, dV) and
B8 (dQ) in ``csrc/flash_attention_bwd.cu`` and the decode attention B9 in
``csrc/decode_attention.cu`` (CUDA C++ for ``sm_90a``, plain C
interfaces). :func:`build` compiles each source with its own ``nvcc``,
all started together, into ``build/kernels/`` at the repository root —
each file name carries a hash of its source, of the shared headers
(``csrc/*.cuh``) and of the flags it is built with, so an edited source,
header or flag rebuilds — and :func:`library` loads them with
``ctypes``. B1–B5 are bit-exact against numpy and build with
``-fmad=false``; B6–B9 are held to tolerances and let ``nvcc`` fuse
multiply-adds. Nothing is compiled or loaded at import: CPU-only hosts
import this module freely.

Each ``launch_*`` function checks device, dtype, shape and contiguity,
allocates its outputs and scratch with ``torch.empty``, launches on the
current stream without synchronising, raises if the C entry point reports
a CUDA error, and adds one to its entry of :data:`launches` through
:func:`count_launch`, under a lock: the live runtime's host threads
launch B6–B8 at once, and ``launches[key] += 1`` is a read, an add and a
store that a thread switch can split. B1, B3 and B4
take an optional leading scenario axis: (cap,) row columns are one tick's
launch (counted as ``spatial``/``late``/``reap``), (N, cap) columns are
the batched sweep's one launch for all N scenarios (counted as
``*_sweep``). The plain torch versions and the device dispatch live in
:mod:`repro_torch.accel.torch_backend` and :mod:`repro_torch.accel.bulk`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"assess": CSRC / "assess.cu", "bulk": CSRC / "bulk.cu",
           "flash": CSRC / "flash_attention.cu",
           "flash_bwd": CSRC / "flash_attention_bwd.cu",
           "decode": CSRC / "decode_attention.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# The bit-exact kernels keep every multiply and add rounded on its own.
EXACT = ("-fmad=false",)
FLAGS = {"assess": NVCC_FLAGS + EXACT, "bulk": NVCC_FLAGS + EXACT,
         "flash": NVCC_FLAGS, "flash_bwd": NVCC_FLAGS,
         "decode": NVCC_FLAGS}
# Largest dynamic shared memory a block may take on Hopper (227 KB).
MAX_SMEM = 232448
# Largest gridDim.y: bounds the scenarios of one batched launch.
MAX_SCENARIOS = 65535
# Tile sizes of B6–B9, which their plain versions walk too (checked
# against the built library when it loads), and the head sizes they take.
FLASH_BLOCK_Q = 64
FLASH_BLOCK_K = 64
DECODE_BLOCK_K = 64
DECODE_MAX_GROUP = 64
HEAD_DIMS = (16, 32, 64, 128)

# Launches per kernel since the last reset_launches(): the proof that a
# run went through the kernels.
launches: Dict[str, int] = {"spatial": 0, "temporal": 0, "late": 0,
                            "reap": 0, "price": 0, "spatial_sweep": 0,
                            "late_sweep": 0, "reap_sweep": 0,
                            "flash_fwd": 0, "flash_dkv": 0, "flash_dq": 0,
                            "decode": 0}
_launch_lock = threading.Lock()

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def count_launch(key: str) -> None:
    """Add one to ``launches[key]``; safe across threads."""
    with _launch_lock:
        launches[key] += 1


def reset_launches() -> None:
    with _launch_lock:
        for name in launches:
            launches[name] = 0


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _target(name: str) -> Path:
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + headers + " ".join(FLAGS[name]).encode()
    ).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build() -> Dict[str, Path]:
    """Compile every source whose library (this source, these flags) is
    not built yet — one ``nvcc`` per source, all started together;
    returns each library's path by name. Raises if any build fails."""
    out = {name: _target(name) for name in SOURCES}
    todo = [(name, path) for name, path in out.items() if not path.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, path in todo:
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs.append((name, tmp, path, subprocess.Popen(
            [nvcc(), *FLAGS[name], "-o", str(tmp), str(SOURCES[name])])))
    failed = []
    for name, tmp, path, proc in procs:
        if proc.wait() != 0:
            failed.append(name)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}")
    return out


def _bind(name: str, lib: ctypes.CDLL) -> None:
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    F = ctypes.c_float
    tiles = []    # (library function, the wrappers' value)
    if name == "assess":
        lib.assess_spatial.argtypes = [P] * 6 + [I] * 5 + [P, P]
        lib.assess_temporal.argtypes = [P] * 5 + [I] * 3 + [P, P, P]
        lib.assess_late.argtypes = [P] * 9 + [I] * 3 + [D] * 4 + [P] * 6
        lib.assess_reap.argtypes = [P] * 3 + [I, I, P, P, P]
        lib.assess_spatial_smem.argtypes = [I]
        lib.assess_temporal_smem.argtypes = [I]
        fns = (lib.assess_spatial, lib.assess_temporal, lib.assess_late,
               lib.assess_reap)
        lib.assess_spatial_smem.restype = ctypes.c_size_t
        lib.assess_temporal_smem.restype = ctypes.c_size_t
    elif name == "bulk":
        lib.bulk_price.argtypes = [P] * 3 + [I, I, P, P]
        fns = (lib.bulk_price,)
    elif name == "flash":
        lib.flash_fwd.argtypes = [P] * 5 + [I] * 8 + [F, I, P]
        fns = (lib.flash_fwd,)
        tiles = [(lib.flash_fwd_block_q, FLASH_BLOCK_Q),
                 (lib.flash_fwd_block_k, FLASH_BLOCK_K)]
    elif name == "flash_bwd":
        lib.flash_bwd_dq.argtypes = [P] * 7 + [I] * 8 + [F, I, P]
        lib.flash_bwd_dkv.argtypes = [P] * 8 + [I] * 8 + [F, I, P]
        fns = (lib.flash_bwd_dq, lib.flash_bwd_dkv)
        tiles = [(lib.flash_bwd_block_q, FLASH_BLOCK_Q),
                 (lib.flash_bwd_block_k, FLASH_BLOCK_K)]
    else:
        lib.decode_attn.argtypes = [P] * 5 + [I] * 5 + [F, I, P]
        fns = (lib.decode_attn,)
        tiles = [(lib.decode_block_k, DECODE_BLOCK_K),
                 (lib.decode_max_group, DECODE_MAX_GROUP)]
    for fn in fns:
        fn.restype = ctypes.c_int
    for fn, want in tiles:
        fn.argtypes, fn.restype = [], ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"{name}: the library's tile {fn()} is not "
                               f"the wrappers' {want}")


def library(name: str = "assess") -> ctypes.CDLL:
    """The loaded kernel library ``name`` (every library is built on the
    first call)."""
    with _lib_lock:   # host threads may ask first at the same time
        if name not in _libs:
            paths = build()
            for lib_name, path in paths.items():
                if lib_name not in _libs:
                    lib = ctypes.CDLL(str(path))
                    _bind(lib_name, lib)
                    _libs[lib_name] = lib
    return _libs[name]


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


def _cols(device, rows, f64=(), i32=()) -> None:
    """Row columns: each of shape ``rows`` — (cap,) or (N, cap)."""
    for name, t in f64:
        _check(t, name, torch.float64, rows, device)
    for name, t in i32:
        _check(t, name, torch.int32, rows, device)


def _scenarios(t: torch.Tensor, kernel: str) -> Tuple[int, int, str]:
    """(N, cap, launch-count key) of a (cap,) or (N, cap) row column."""
    if t.dim() == 1:
        return 1, t.shape[0], kernel
    if t.dim() != 2:
        raise ValueError(f"{kernel}: rows must be (cap,) or (N, cap), got "
                         f"{tuple(t.shape)}")
    if not 1 <= t.shape[0] <= MAX_SCENARIOS:
        raise ValueError(f"{kernel}: {t.shape[0]} scenarios, expected 1 to "
                         f"{MAX_SCENARIOS}")
    return t.shape[0], t.shape[1], kernel + "_sweep"


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
    """B1: (jcap, 2, n) bool Eq. 1 hits per (job, phase, node); with
    (N, cap) rows, (N, jcap, 2, n) for all scenarios in one launch."""
    dev = rho.device
    N, cap, key = _scenarios(rho, "spatial")
    n, k = nh.shape
    _cols(dev, tuple(rho.shape), f64=[("rho", rho)],
          i32=[("node", node), ("kind", kind), ("jls", jls),
               ("running", running)])
    _check(nh, "nh", torch.int32, (n, k), dev)
    lib = library()
    _smem(lib.assess_spatial_smem(n), "spatial", n)
    fired = torch.empty(tuple(rho.shape[:-1]) + (jcap, 2, n),
                        dtype=torch.bool, device=dev)
    rc = lib.assess_spatial(
        rho.data_ptr(), node.data_ptr(), kind.data_ptr(), jls.data_ptr(),
        running.data_ptr(), nh.data_ptr(), cap, n, k, jcap, N,
        fired.data_ptr(), _stream(dev))
    _raise_on(rc, "spatial")
    count_launch(key)
    return fired


def launch_temporal(prog, tprog, node, jls, alive, jcap: int,
                    n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: (jcap, n) float64 ζ_now and ζ_prev sums, NaN where empty."""
    dev, cap = prog.device, prog.shape[0]
    _cols(dev, (cap,), f64=[("prog", prog), ("tprog", tprog)],
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
    count_launch("temporal")
    return zn, zp


def launch_late(prog, start, rate, spec, tseg, jls, running, runatt, order,
                now: float, min_runtime: float, q: float, win_factor: float,
                jcap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3: (jcap,) int32 LATE victim rows (-1: none) and winning flags;
    with (N, cap) rows, (N, jcap) each for all scenarios in one launch."""
    dev = prog.device
    N, cap, key = _scenarios(prog, "late")
    _cols(dev, tuple(prog.shape),
          f64=[("prog", prog), ("start", start), ("rate", rate)],
          i32=[("spec", spec), ("tseg", tseg), ("jls", jls),
               ("running", running), ("runatt", runatt), ("order", order)])
    lib = library()
    c_rho = torch.empty((N, jcap, cap), dtype=torch.float64, device=dev)
    c_est = torch.empty((N, jcap, cap), dtype=torch.float64, device=dev)
    c_pos = torch.empty((N, jcap, cap), dtype=torch.int32, device=dev)
    out_shape = tuple(prog.shape[:-1]) + (jcap,)
    victim = torch.empty(out_shape, dtype=torch.int32, device=dev)
    win = torch.empty(out_shape, dtype=torch.int32, device=dev)
    rc = lib.assess_late(
        prog.data_ptr(), start.data_ptr(), rate.data_ptr(), spec.data_ptr(),
        tseg.data_ptr(), jls.data_ptr(), running.data_ptr(),
        runatt.data_ptr(), order.data_ptr(), cap, jcap, N, float(now),
        float(min_runtime), float(q), float(win_factor), c_rho.data_ptr(),
        c_est.data_ptr(), c_pos.data_ptr(), victim.data_ptr(),
        win.data_ptr(), _stream(dev))
    _raise_on(rc, "late")
    count_launch(key)
    return victim, win


def launch_reap(a_state, tseg, live) -> torch.Tensor:
    """B4: (cap,) int32 mask of reapable running sibling attempts; with
    (N, cap) rows, (N, cap) for all scenarios in one call (two launches,
    each over every scenario)."""
    dev = a_state.device
    N, cap, key = _scenarios(a_state, "reap")
    _cols(dev, tuple(a_state.shape), i32=[("a_state", a_state),
                                          ("tseg", tseg), ("live", live)])
    lib = library()
    done = torch.empty(a_state.shape, dtype=torch.int32, device=dev)
    out = torch.empty(a_state.shape, dtype=torch.int32, device=dev)
    rc = lib.assess_reap(a_state.data_ptr(), tseg.data_ptr(),
                         live.data_ptr(), cap, N, done.data_ptr(),
                         out.data_ptr(), _stream(dev))
    _raise_on(rc, "reap")
    count_launch(key)
    return out


def launch_price(share, links, valid) -> torch.Tensor:
    """B5: (cap,) float64 frozen-rate prices, ``max(min(share[links] over
    valid links), 1.0)`` per flow row; +inf for rows with no valid link."""
    dev = share.device
    nL = share.shape[0] if share.dim() == 1 else -1
    cap = links.shape[0]
    _check(share, "share", torch.float64, (nL,), dev)
    _check(links, "links", torch.int32, (cap, 4), dev)
    _check(valid, "valid", torch.bool, (cap, 4), dev)
    lib = library("bulk")
    out = torch.empty(cap, dtype=torch.float64, device=dev)
    rc = lib.bulk_price(share.data_ptr(), links.data_ptr(),
                        valid.data_ptr(), cap, nL, out.data_ptr(),
                        _stream(dev))
    _raise_on(rc, "price")
    count_launch("price")
    return out


_ATTN_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def _attn_dtype(kernel: str, *tensors) -> int:
    dtype = tensors[0].dtype
    if dtype not in _ATTN_DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{kernel}: q, k and v must share one dtype of "
                        f"bfloat16 or float32, got "
                        f"{[t.dtype for t in tensors]}")
    return _ATTN_DTYPES[dtype]


def _aligned(kernel: str, **tensors) -> None:
    """B6–B9 load 16 bytes at a time."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} is not 16-byte aligned")


def launch_flash_fwd(q, k, v, causal: bool, window: int,
                     scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6: (out (b, sq, hq, d) in q's type, lse (b, hq, sq) float32) of
    causal and/or windowed GQA attention, query head h on KV head
    ``h // (hq // hkv)``, rows offset by ``sk - sq``."""
    dev = q.device
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    is_bf16 = _attn_dtype("flash_fwd", q, k, v)
    _check(q, "q", q.dtype, (b, sq, hq, d), dev)
    _check(k, "k", q.dtype, (b, sk, hkv, d), dev)
    _check(v, "v", q.dtype, (b, sk, hkv, d), dev)
    if d not in HEAD_DIMS or hq % hkv or min(b, sq, sk) < 1:
        raise ValueError(f"flash_fwd: head_dim {d} (one of {HEAD_DIMS}), "
                         f"heads {hq}/{hkv}, b {b}, sq {sq}, sk {sk}")
    _aligned("flash_fwd", q=q, k=k, v=v)
    lib = library("flash")
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), lse.data_ptr(), b, sq, sk, hq, hkv,
                       d, int(causal), int(window), float(scale), is_bf16,
                       _stream(dev))
    _raise_on(rc, "flash_fwd")
    count_launch("flash_fwd")
    return out, lse


def launch_decode(q, k, v, valid, scale: float) -> torch.Tensor:
    """B9: (b, hq, d) attention of one query token per sequence over the
    first ``valid[b]`` slots of a (b, S, hkv, d) cache; NaN rows where
    ``valid[b] <= 0``."""
    dev = q.device
    b, hq, d = q.shape
    S, hkv = k.shape[1], k.shape[2]
    is_bf16 = _attn_dtype("decode", q, k, v)
    _check(q, "q", q.dtype, (b, hq, d), dev)
    _check(k, "k", q.dtype, (b, S, hkv, d), dev)
    _check(v, "v", q.dtype, (b, S, hkv, d), dev)
    _check(valid, "valid", torch.int32, (b,), dev)
    if d not in HEAD_DIMS or hq % hkv or hq // hkv > DECODE_MAX_GROUP:
        raise ValueError(f"decode: head_dim {d} (one of {HEAD_DIMS}), "
                         f"heads {hq}/{hkv} (group at most "
                         f"{DECODE_MAX_GROUP})")
    _aligned("decode", k=k, v=v)
    lib = library("decode")
    out = torch.empty_like(q)
    rc = lib.decode_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         valid.data_ptr(), out.data_ptr(), b, S, hq, hkv, d,
                         float(scale), is_bf16, _stream(dev))
    _raise_on(rc, "decode")
    count_launch("decode")
    return out


def _flash_bwd_args(kernel, q, k, v, dout, lse, delta):
    """Checks of B7's and B8's common arguments; returns (b, sq, sk, hq,
    hkv, d, is_bf16)."""
    dev = q.device
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    is_bf16 = _attn_dtype(kernel, q, k, v, dout)
    _check(q, "q", q.dtype, (b, sq, hq, d), dev)
    _check(k, "k", q.dtype, (b, sk, hkv, d), dev)
    _check(v, "v", q.dtype, (b, sk, hkv, d), dev)
    _check(dout, "dout", q.dtype, (b, sq, hq, d), dev)
    _check(lse, "lse", torch.float32, (b, hq, sq), dev)
    _check(delta, "delta", torch.float32, (b, hq, sq), dev)
    if d not in HEAD_DIMS or hq % hkv or min(b, sq, sk) < 1:
        raise ValueError(f"{kernel}: head_dim {d} (one of {HEAD_DIMS}), "
                         f"heads {hq}/{hkv}, b {b}, sq {sq}, sk {sk}")
    _aligned(kernel, q=q, k=k, v=v, dout=dout)
    return b, sq, sk, hq, hkv, d, is_bf16


def launch_flash_dkv(q, k, v, dout, lse, delta, causal: bool, window: int,
                     scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """B7: (dk, dv), each (b, sk, hkv, d) in k's type: the gradient of
    B6's attention for each KV head, summed over its query group, given
    the forward's lse and ``delta = rowsum(dout * out)``, both (b, hq, sq)
    float32."""
    b, sq, sk, hq, hkv, d, is_bf16 = _flash_bwd_args(
        "flash_dkv", q, k, v, dout, lse, delta)
    lib = library("flash_bwd")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), b, sq, sk, hq, hkv,
                           d, int(causal), int(window), float(scale),
                           is_bf16, _stream(q.device))
    _raise_on(rc, "flash_dkv")
    count_launch("flash_dkv")
    return dk, dv


def launch_flash_dq(q, k, v, dout, lse, delta, causal: bool, window: int,
                    scale: float) -> torch.Tensor:
    """B8: dq (b, sq, hq, d) in q's type, with B7's arguments."""
    b, sq, sk, hq, hkv, d, is_bf16 = _flash_bwd_args(
        "flash_dq", q, k, v, dout, lse, delta)
    lib = library("flash_bwd")
    dq = torch.empty_like(q)
    rc = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          dq.data_ptr(), b, sq, sk, hq, hkv, d, int(causal),
                          int(window), float(scale), is_bf16,
                          _stream(q.device))
    _raise_on(rc, "flash_dq")
    count_launch("flash_dq")
    return dq
