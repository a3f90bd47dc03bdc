"""Build, load and launch the port's CUDA kernels.

The assessment kernels B1–B4 live in ``csrc/assess.cu``, the ε-fair
network's pricing kernel B5 in ``csrc/bulk.cu``, the flash-attention
forward B6 in ``csrc/flash_attention.cu``, its backward B7 (dK, dV) and
B8 (dQ) in ``csrc/flash_attention_bwd.cu``, the decode attention B9 in
``csrc/decode_attention.cu`` and the Mamba-2 SSD chunked scan B10 in
``csrc/ssd.cu`` (CUDA C++ for ``sm_90a``, plain C interfaces).
:func:`build` compiles each source with its own ``nvcc``, all started
together, into ``build/kernels/`` at the repository root —
each file name carries a hash of its source, of the shared headers
(``csrc/*.cuh``) and of the flags it is built with, so an edited source,
header or flag rebuilds — and :func:`library` loads them with
``ctypes``. B1–B5 are bit-exact against numpy and build with
``-fmad=false``; B6–B10 are held to tolerances and let ``nvcc`` fuse
multiply-adds. B6 has two bodies in one library: bf16 inputs with
head_dim 64 or 128 take the Hopper body (``csrc/flash_attention_sm90.cuh``:
wgmma products on TMA-fed 128 x 128 tiles), float32 and bf16 at head_dim
16, 32 or 80 the SIMT body (64 x 64 tiles); :func:`flash_fwd_tc` says
which.
B7 and B8 have two bodies each in the same way: bf16 at head_dim 64 or
128 the Hopper bodies (``csrc/flash_attention_bwd_sm90.cuh``, sharing
B6's TMA and wgmma primitives in ``csrc/sm90_primitives.cuh``), the rest
(float32, and bf16 at head_dim 16, 32 or 80) the SIMT bodies;
:func:`flash_bwd_tc` says which. With a GQA group above
1, B7's Hopper body writes f32 partials per query head and a second
kernel of the same library, ``flash_dkv_group_sum``, adds each KV head's
partials in head order. B9 is split-KV for every dtype and head_dim: a
block per ``DECODE_SPLIT`` keys of a (KV head, sequence) writes float32
partials, and a combine kernel of the same library adds the live splits
in split order. B10 has two bodies: bf16 with head_dim and d_state 64
or 128 and a chunk of 64 to 256 rows in steps of 64 take the Hopper body
(``csrc/ssd_sm90.cuh``: three kernels on wgmma), the rest the SIMT body;
:func:`ssd_tc` says which.
Nothing is compiled or loaded at import: CPU-only hosts import this
module freely.

Each ``launch_*`` function checks device, dtype, shape and contiguity,
allocates its outputs and scratch with ``torch.empty`` (the work buffers
of B1–B3 once per stream and shape, :func:`glance_work`,
:func:`late_work`), launches on the
current stream without synchronising, raises if the C entry point reports
a CUDA error, and adds one to its entry of :data:`launches` through
:func:`count_launch`, under a lock: the live runtime's host threads
launch B6–B8 at once, and ``launches[key] += 1`` is a read, an add and a
store that a thread switch can split. Every B6 launch counts as
``flash_fwd``, and a launch of its Hopper body also as ``flash_fwd_tc``;
B7 and B8 in the same way (``flash_dkv``/``flash_dkv_tc``,
``flash_dq``/``flash_dq_tc``), the group sum as ``flash_dkv_group_sum``.
A B9 call counts ``decode`` and ``decode_combine``; a B10 call ``ssd``,
and on the Hopper body also ``ssd_tc`` and its kernels' ``ssd_prep``,
``ssd_state``, ``ssd_out``.
B1, B3 and B4
take an optional leading scenario axis: (cap,) row columns are one tick's
launch (counted as ``spatial``/``late``/``reap``), (N, cap) columns are
the batched sweep's one launch for all N scenarios (counted as
``*_sweep``). B1, B2 and B3 are two launches each, a row pass and a job
pass; the second counts as ``spatial_jobs``/``spatial_sweep_jobs``,
``temporal_jobs`` and ``late_jobs``/``late_sweep_jobs``. B3 keeps its
records in a work buffer held per (device, stream, N, cap) across calls
(:func:`late_work`), B1 and B2 theirs in one held per (device, stream,
shape) (:func:`glance_work`); B4 is one launch and needs none. The plain
torch versions and the device dispatch live in
:mod:`repro_torch.accel.torch_backend` and :mod:`repro_torch.accel.bulk`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"assess": CSRC / "assess.cu", "bulk": CSRC / "bulk.cu",
           "flash": CSRC / "flash_attention.cu",
           "flash_bwd": CSRC / "flash_attention_bwd.cu",
           "decode": CSRC / "decode_attention.cu", "ssd": CSRC / "ssd.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# The bit-exact kernels keep every multiply and add rounded on its own.
EXACT = ("-fmad=false",)
FLAGS = {"assess": NVCC_FLAGS + EXACT, "bulk": NVCC_FLAGS + EXACT,
         "flash": NVCC_FLAGS, "flash_bwd": NVCC_FLAGS,
         "decode": NVCC_FLAGS, "ssd": NVCC_FLAGS}
# Largest dynamic shared memory a block may take on Hopper (227 KB).
MAX_SMEM = 232448
# Largest gridDim.y: bounds the scenarios of one batched launch.
MAX_SCENARIOS = 65535
# B1's and B2's rows per block of their row pass and the records a group
# block stages at a time (checked against the built library when it loads).
GLANCE_ROWS = 256
GLANCE_CHUNK = 512
# B3's rows per block of its row pass and the candidates a job keeps in
# shared memory (more are read from device memory); B4's rows per block.
# The built library's values are checked when it loads. A record keeps a
# segment's running-row count in 29 bits, which bounds cap.
LATE_ROWS = 256
LATE_SMEM_CANDS = 1024
LATE_MAX_CAP = 1 << 29
REAP_TILE = 1024
# Tile sizes of B6–B9, which their plain versions walk too (checked
# against the built library when it loads), and the head sizes they take.
# B6's SIMT body (float32; bf16 at head_dim 16, 32, 80) and its Hopper body
# (bf16 at FLASH_TC_HEAD_DIMS) have tiles of their own; B7 and B8 theirs,
# for each of their two bodies the (query tile, KV tile) pairs that skip
# (the Hopper bodies' blocks hold two 64-row consumers, each pairing its
# rows with streamed tiles of 64).
FLASH_FWD_BLOCK_Q = 64
FLASH_FWD_BLOCK_K = 64
FLASH_FWD_TC_BLOCK_Q = 128
FLASH_FWD_TC_BLOCK_K = 128
FLASH_TC_HEAD_DIMS = (64, 128)
FLASH_BWD_BLOCK_Q = 64
FLASH_BWD_BLOCK_K = 64
FLASH_BWD_TC_BLOCK_Q = 64
FLASH_BWD_TC_BLOCK_K = 64
# Every head size B6–B9 take; head_dim 80 (hubert-xlarge) runs the SIMT
# bodies of B6–B8 in both dtypes.
HEAD_DIMS = (16, 32, 64, 80, 128)
# B9's split-KV body: a block per DECODE_SPLIT keys of one (KV head,
# sequence), streamed in tiles of DECODE_BLOCK_K keys through a ring of
# DECODE_STAGES tiles; it takes every dtype and head_dim above.
DECODE_BLOCK_K = 32
DECODE_SPLIT = 128
DECODE_STAGES = 3
DECODE_MAX_GROUP = 64
# B10's SIMT body's row sub-tile, and the head sizes and state sizes it
# takes; its Hopper body takes bf16 at head_dim and d_state in
# SSD_TC_DIMS with chunks that are a multiple of SSD_TC_TILE up to
# SSD_TC_MAX_CHUNK rows.
SSD_TILE_ROWS = 64
SSD_DIMS = (16, 32, 64, 128)
SSD_TC_DIMS = (64, 128)
SSD_TC_TILE = 64
SSD_TC_MAX_CHUNK = 256
# What one call on B10's Hopper body counts: the call, the body, and each
# of its three kernels.
SSD_TC_KEYS = ("ssd", "ssd_tc", "ssd_prep", "ssd_state", "ssd_out")

# Launches per kernel since the last reset_launches(): the proof that a
# run went through the kernels.
launches: Dict[str, int] = {"spatial": 0, "temporal": 0, "late": 0,
                            "reap": 0, "price": 0, "spatial_sweep": 0,
                            "late_sweep": 0, "reap_sweep": 0,
                            "spatial_jobs": 0, "spatial_sweep_jobs": 0,
                            "temporal_jobs": 0,
                            "late_jobs": 0, "late_sweep_jobs": 0,
                            "flash_fwd": 0, "flash_fwd_tc": 0,
                            "flash_dkv": 0, "flash_dkv_tc": 0,
                            "flash_dkv_group_sum": 0, "flash_dq": 0,
                            "flash_dq_tc": 0,
                            "decode": 0, "decode_combine": 0,
                            "ssd": 0, "ssd_tc": 0, "ssd_prep": 0,
                            "ssd_state": 0, "ssd_out": 0}
_launch_lock = threading.Lock()
# B1, B2 and B3 enqueue two launches that share a cached work buffer, and
# ctypes lets other threads run during the call: this lock keeps another
# thread's launches of the same kernel from falling between the two.
_work_lock = threading.Lock()

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
# Seconds each source's nvcc took in the last build() that compiled it.
build_seconds: Dict[str, float] = {}


def flash_fwd_tc(dtype: torch.dtype, d: int) -> bool:
    """True where B6's Hopper body takes the inputs: bf16 at head_dim 64
    or 128. The SIMT body takes the rest."""
    return dtype == torch.bfloat16 and d in FLASH_TC_HEAD_DIMS


def flash_fwd_tiles(dtype: torch.dtype, d: int) -> Tuple[int, int]:
    """(block_q, block_k) of the B6 body that takes these inputs."""
    if flash_fwd_tc(dtype, d):
        return FLASH_FWD_TC_BLOCK_Q, FLASH_FWD_TC_BLOCK_K
    return FLASH_FWD_BLOCK_Q, FLASH_FWD_BLOCK_K


def flash_bwd_tc(dtype: torch.dtype, d: int) -> bool:
    """True where B7's and B8's Hopper bodies take the inputs: bf16 at
    head_dim 64 or 128. The SIMT bodies take the rest."""
    return dtype == torch.bfloat16 and d in FLASH_TC_HEAD_DIMS


def flash_bwd_tiles(dtype: torch.dtype, d: int) -> Tuple[int, int]:
    """(block_q, block_k) of the B7/B8 bodies that take these inputs."""
    if flash_bwd_tc(dtype, d):
        return FLASH_BWD_TC_BLOCK_Q, FLASH_BWD_TC_BLOCK_K
    return FLASH_BWD_BLOCK_Q, FLASH_BWD_BLOCK_K


def decode_splits(S: int) -> int:
    """Splits of a cache of S slots: B9's grid, sized from the capacity
    alone (the valid lengths stay on the card)."""
    return -(-S // DECODE_SPLIT)


def ssd_tc(dtype: torch.dtype, p: int, n: int, chunk: int) -> bool:
    """True where B10's Hopper body takes the inputs: bf16 with head_dim
    and d_state each 64 or 128 and a chunk (:func:`ssd_chunk`) that is a
    multiple of 64 up to 256 rows. The SIMT body takes the rest."""
    return (dtype == torch.bfloat16 and p in SSD_TC_DIMS
            and n in SSD_TC_DIMS and chunk % SSD_TC_TILE == 0
            and SSD_TC_TILE <= chunk <= SSD_TC_MAX_CHUNK)


def ssd_chunk(dtype: torch.dtype, p: int, n: int, s: int,
              chunk: int) -> int:
    """The chunk B10 runs s rows in: ``min(chunk, s)``, except that a
    sequence of one chunk (s <= chunk) runs as one chunk of s rounded up
    to the Hopper body's 64-row tile where that lets the body take it.
    Rows past s are zero (dt = 0, the identity), so it is the same scan."""
    if s <= chunk:
        rows = -(-s // SSD_TC_TILE) * SSD_TC_TILE
        if ssd_tc(dtype, p, n, rows):
            return rows
    return min(chunk, s)


def count_launch(*keys: str) -> None:
    """Add one to ``launches[key]`` for each key; safe across threads."""
    with _launch_lock:
        for key in keys:
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
    t0 = time.perf_counter()
    for name, path in todo:
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs.append((name, tmp, path, subprocess.Popen(
            [nvcc(), *FLAGS[name], "-o", str(tmp), str(SOURCES[name])])))
    failed, running = [], list(procs)
    while running:     # poll, so that each source's time is its own
        for item in list(running):
            name, tmp, path, proc = item
            if proc.poll() is None:
                continue
            running.remove(item)
            build_seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, path)
        time.sleep(0.05)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}")
    return out


def _bind(name: str, lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    F = ctypes.c_float
    tiles = []    # (library function, the wrappers' value)
    if name == "assess":
        lib.assess_spatial.argtypes = [P] * 6 + [I] * 5 + [P, P, P]
        lib.assess_temporal.argtypes = [P] * 5 + [I] * 3 + [P] * 4
        lib.assess_spatial_smem.argtypes = [I, I, I]
        lib.assess_temporal_smem.argtypes = [I, I, I]
        lib.assess_spatial_work_bytes.argtypes = [I, I, I]
        lib.assess_temporal_work_bytes.argtypes = [I, I]
        lib.assess_spatial_table_bytes.argtypes = [I, I, I, I]
        lib.assess_temporal_table_bytes.argtypes = [I, I, I]
        fns = (lib.assess_spatial, lib.assess_temporal) + bind_late(lib)
        for fn in (lib.assess_spatial_smem, lib.assess_temporal_smem,
                   lib.assess_spatial_work_bytes,
                   lib.assess_temporal_work_bytes,
                   lib.assess_spatial_table_bytes,
                   lib.assess_temporal_table_bytes):
            fn.restype = ctypes.c_size_t
        tiles = [(lib.assess_glance_rows, GLANCE_ROWS),
                 (lib.assess_glance_chunk, GLANCE_CHUNK),
                 (lib.assess_late_rows, LATE_ROWS),
                 (lib.assess_late_smem_cands, LATE_SMEM_CANDS),
                 (lib.assess_reap_tile, REAP_TILE)]
    elif name == "bulk":
        lib.bulk_price.argtypes = [P] * 3 + [I, I, P, P]
        fns = (lib.bulk_price,)
    elif name == "flash":
        lib.flash_fwd.argtypes = [P] * 5 + [I] * 8 + [F, I, P]
        lib.flash_fwd_tc.argtypes = [I, I]
        fns = (lib.flash_fwd, lib.flash_fwd_tc)
        tiles = [(lib.flash_fwd_block_q, FLASH_FWD_BLOCK_Q),
                 (lib.flash_fwd_block_k, FLASH_FWD_BLOCK_K),
                 (lib.flash_fwd_tc_block_q, FLASH_FWD_TC_BLOCK_Q),
                 (lib.flash_fwd_tc_block_k, FLASH_FWD_TC_BLOCK_K)]
    elif name == "flash_bwd":
        lib.flash_bwd_dq.argtypes = [P] * 7 + [I] * 8 + [F, I, P]
        lib.flash_bwd_dkv.argtypes = [P] * 8 + [I] * 8 + [F, I, P]
        lib.flash_bwd_group_sum.argtypes = [P] * 4 + [I] * 4 + [P]
        lib.flash_bwd_tc.argtypes = [I, I]
        fns = (lib.flash_bwd_dq, lib.flash_bwd_dkv, lib.flash_bwd_group_sum,
               lib.flash_bwd_tc)
        tiles = [(lib.flash_bwd_block_q, FLASH_BWD_BLOCK_Q),
                 (lib.flash_bwd_block_k, FLASH_BWD_BLOCK_K),
                 (lib.flash_bwd_tc_block_q, FLASH_BWD_TC_BLOCK_Q),
                 (lib.flash_bwd_tc_block_k, FLASH_BWD_TC_BLOCK_K)]
    elif name == "decode":
        lib.decode_attn.argtypes = [P] * 8 + [I] * 5 + [F, I, P]
        fns = (lib.decode_attn,)
        tiles = [(lib.decode_block_k, DECODE_BLOCK_K),
                 (lib.decode_split, DECODE_SPLIT),
                 (lib.decode_stages, DECODE_STAGES),
                 (lib.decode_max_group, DECODE_MAX_GROUP)]
    else:
        lib.ssd_fwd.argtypes = [P] * 8 + [I] * 8 + [P]
        lib.ssd_fwd_tc.argtypes = [P] * 13 + [I] * 7 + [P]
        lib.ssd_smem.argtypes = [I, I, I]
        lib.ssd_smem.restype = ctypes.c_size_t
        lib.ssd_tc.argtypes = [I] * 4
        fns = (lib.ssd_fwd, lib.ssd_fwd_tc, lib.ssd_tc)
        tiles = [(lib.ssd_tile_rows, SSD_TILE_ROWS),
                 (lib.ssd_tc_tile, SSD_TC_TILE),
                 (lib.ssd_tc_max_chunk, SSD_TC_MAX_CHUNK)]
    for fn in fns:
        fn.restype = ctypes.c_int
    for fn, want in tiles:
        fn.argtypes, fn.restype = [], ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"{name}: the library's tile {fn()} is not "
                               f"the wrappers' {want}")
    bodies = {"flash": ("flash_fwd_tc", flash_fwd_tc),
              "flash_bwd": ("flash_bwd_tc", flash_bwd_tc)}
    if name in bodies:
        fn_name, wrappers = bodies[name]
        check_bodies(name, getattr(lib, fn_name), wrappers)
    elif name == "ssd":
        check_ssd_bodies(lib.ssd_tc)


def bind_late(lib: ctypes.CDLL) -> tuple:
    """Argument types of B3's and B4's C interface (slice 9's, which
    ``chip_smoke.py --assess-parent`` also binds on an earlier library);
    returns the two launch functions."""
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.assess_late.argtypes = [P] * 9 + [I] * 3 + [D] * 4 + [P] * 4
    lib.assess_reap.argtypes = [P] * 3 + [I, I, P, P]
    lib.assess_late_work_bytes.argtypes = [I, I]
    lib.assess_late_work_bytes.restype = ctypes.c_size_t
    for fn in (lib.assess_late, lib.assess_reap):
        fn.restype = ctypes.c_int
    return lib.assess_late, lib.assess_reap


def check_bodies(name: str, library_fn, wrappers_fn) -> None:
    """Raise unless the library's choice of body (``library_fn(is_bf16,
    d)``) is the wrappers' (``wrappers_fn(dtype, d)``) for every dtype and
    head_dim the kernels take."""
    for dtype, is_bf16 in _ATTN_DTYPES.items():
        for d in HEAD_DIMS:
            if bool(library_fn(is_bf16, d)) != wrappers_fn(dtype, d):
                raise RuntimeError(f"{name}: the library's body for {dtype}, "
                                   f"head_dim {d} is not the wrappers'")


# Chunks at which B10's body choice is checked: both sides of its edges.
SSD_CHECK_CHUNKS = (16, 32, 63, 64, 100, 128, 192, 255, 256, 320, 512)


def check_ssd_bodies(library_fn) -> None:
    """Raise unless B10's library picks the Hopper body
    (``library_fn(is_bf16, p, n, chunk)``) exactly where :func:`ssd_tc`
    does, for every dtype, head_dim and d_state it takes and chunks on
    both sides of the body's edges."""
    for dtype, is_bf16 in _ATTN_DTYPES.items():
        for p in SSD_DIMS:
            for n in SSD_DIMS:
                for q in SSD_CHECK_CHUNKS:
                    if bool(library_fn(is_bf16, p, n, q)) != ssd_tc(
                            dtype, p, n, q):
                        raise RuntimeError(
                            f"ssd: the library's body for {dtype}, head_dim "
                            f"{p}, d_state {n}, chunk {q} is not the "
                            f"wrappers'")


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


def _glance_sizes(kernel: str, cap: int, n: int, jcap: int) -> None:
    if min(cap, n, jcap) < 1:
        raise ValueError(f"{kernel}: cap {cap}, {n} nodes and jcap {jcap} "
                         f"(each at least 1)")


# ---------------------------------------------------------------------------
# Launchers (CUDA tensors only)
# ---------------------------------------------------------------------------
def launch_spatial(rho, node, kind, jls, running, nh,
                   jcap: int) -> torch.Tensor:
    """B1: (jcap, 2, n) bool Eq. 1 hits per (job, phase, node); with
    (N, cap) rows, (N, jcap, 2, n) for all scenarios in one call. Two
    launches: the row pass (counted as ``spatial``/``spatial_sweep``) and
    the group pass (``spatial_jobs``/``spatial_sweep_jobs``)."""
    dev = rho.device
    N, cap, key = _scenarios(rho, "spatial")
    n, k = nh.shape
    _cols(dev, tuple(rho.shape), f64=[("rho", rho)],
          i32=[("node", node), ("kind", kind), ("jls", jls),
               ("running", running)])
    _check(nh, "nh", torch.int32, (n, k), dev)
    _glance_sizes("spatial", cap, n, jcap)
    lib = library()
    stream = _stream(dev)
    work = glance_work(lib, "spatial", dev, stream, N, cap, jcap, n)
    fired = torch.empty(tuple(rho.shape[:-1]) + (jcap, 2, n),
                        dtype=torch.bool, device=dev)
    with _work_lock:
        rc = lib.assess_spatial(
            rho.data_ptr(), node.data_ptr(), kind.data_ptr(),
            jls.data_ptr(), running.data_ptr(), nh.data_ptr(), cap, n, k,
            jcap, N, work.data_ptr(), fired.data_ptr(), stream)
    _raise_on(rc, "spatial")
    count_launch(key, key + "_jobs")
    return fired


def launch_temporal(prog, tprog, node, jls, alive, jcap: int,
                    n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2: (jcap, n) float64 ζ_now and ζ_prev sums, NaN where empty. Two
    launches: the row pass (counted as ``temporal``) and the group pass
    (``temporal_jobs``)."""
    dev, cap = prog.device, prog.shape[0]
    _cols(dev, (cap,), f64=[("prog", prog), ("tprog", tprog)],
          i32=[("node", node), ("jls", jls), ("alive", alive)])
    _glance_sizes("temporal", cap, n, jcap)
    lib = library()
    stream = _stream(dev)
    work = glance_work(lib, "temporal", dev, stream, 1, cap, jcap, n)
    # ζ_now and ζ_prev, one allocation
    z = torch.empty((2, jcap, n), dtype=torch.float64, device=dev)
    zn, zp = z[0], z[1]
    with _work_lock:
        rc = lib.assess_temporal(
            prog.data_ptr(), tprog.data_ptr(), node.data_ptr(),
            jls.data_ptr(), alive.data_ptr(), cap, n, jcap,
            work.data_ptr(), zn.data_ptr(), zp.data_ptr(), stream)
    _raise_on(rc, "temporal")
    count_launch("temporal", "temporal_jobs")
    return zn, zp


# B1's and B2's work buffers by (device index, stream, kernel, N, cap,
# jcap, n). A call rewrites every part of its buffer that it reads, so
# nothing in it is reset; calls on one stream run one after the other
# (their launch pairs kept whole by _work_lock), so they may share one.
_glance_work: Dict[Tuple[int, int, str, int, int, int, int],
                   torch.Tensor] = {}


def glance_work(lib, kernel: str, device: torch.device, stream: int, N: int,
                cap: int, jcap: int, n: int) -> torch.Tensor:
    """B1's (``kernel`` "spatial") or B2's ("temporal") work buffer for N
    scenarios of ``cap`` rows, ``jcap`` job slots and ``n`` nodes on
    ``stream``: the records and offset tables, and, where a group's
    bucket table does not fit a block's shared memory (B1 above about
    18,800 nodes, B2 above about 13,000), one table per (scenario, group)
    in device memory. On first use the buffer is allocated, not zeroed:
    nothing in it needs a value before a call. Later calls find it here."""
    key = (device.index, stream, kernel, N, cap, jcap, n)
    buf = _glance_work.get(key)
    if buf is None:
        if kernel == "spatial":
            nbytes = (lib.assess_spatial_work_bytes(cap, jcap, N)
                      + lib.assess_spatial_table_bytes(n, jcap, cap, N))
        else:
            nbytes = (lib.assess_temporal_work_bytes(cap, jcap)
                      + lib.assess_temporal_table_bytes(n, jcap, cap))
        buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
        buf = _glance_work.setdefault(key, buf)
    return buf


# B3's work buffers by (device index, stream, N, cap). A call reads and
# rewrites its buffer's counters, so two calls may share a buffer only if
# they run one after the other: calls on one stream do (their launch pairs
# kept whole by _work_lock), so the key holds the stream.
_late_work: Dict[Tuple[int, int, int, int], torch.Tensor] = {}


def late_work(lib, device: torch.device, stream: int, N: int,
              cap: int) -> torch.Tensor:
    """B3's work buffer for N scenarios of ``cap`` rows on ``stream``:
    allocated and zeroed on first use, then reused; every call leaves its
    counters at zero."""
    key = (device.index, stream, N, cap)
    buf = _late_work.get(key)
    if buf is None:
        buf = torch.zeros(lib.assess_late_work_bytes(cap, N),
                          dtype=torch.uint8, device=device)
        buf = _late_work.setdefault(key, buf)
    return buf


def launch_late(prog, start, rate, spec, tseg, jls, running, runatt, order,
                now: float, min_runtime: float, q: float, win_factor: float,
                jcap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3: (jcap,) int32 LATE victim rows (-1: none) and winning flags;
    with (N, cap) rows, (N, jcap) each for all scenarios in one call. Two
    launches: the row pass (counted as ``late``/``late_sweep``) and the job
    pass (``late_jobs``/``late_sweep_jobs``). Task segments must be
    contiguous runs of ``tseg``, each of one job
    (``torch_backend.check_segments``)."""
    dev = prog.device
    N, cap, key = _scenarios(prog, "late")
    _cols(dev, tuple(prog.shape),
          f64=[("prog", prog), ("start", start), ("rate", rate)],
          i32=[("spec", spec), ("tseg", tseg), ("jls", jls),
               ("running", running), ("runatt", runatt), ("order", order)])
    if not (1 <= cap < LATE_MAX_CAP and jcap >= 1):
        raise ValueError(f"late: cap {cap} (1 to {LATE_MAX_CAP - 1}) and "
                         f"jcap {jcap} (at least 1)")
    lib = library()
    stream = _stream(dev)
    work = late_work(lib, dev, stream, N, cap)
    # victims and winning flags, one allocation
    out = torch.empty((2,) + tuple(prog.shape[:-1]) + (jcap,),
                      dtype=torch.int32, device=dev)
    victim, win = out[0], out[1]
    with _work_lock:
        rc = lib.assess_late(
            prog.data_ptr(), start.data_ptr(), rate.data_ptr(),
            spec.data_ptr(), tseg.data_ptr(), jls.data_ptr(),
            running.data_ptr(), runatt.data_ptr(), order.data_ptr(), cap,
            jcap, N, float(now), float(min_runtime), float(q),
            float(win_factor), work.data_ptr(), victim.data_ptr(),
            win.data_ptr(), stream)
    _raise_on(rc, "late")
    count_launch(key, key + "_jobs")
    return victim, win


def launch_reap(a_state, tseg, live) -> torch.Tensor:
    """B4: (cap,) int32 mask of reapable running sibling attempts; with
    (N, cap) rows, (N, cap) for all scenarios in one launch. Task segments
    must be contiguous runs of ``tseg``."""
    dev = a_state.device
    N, cap, key = _scenarios(a_state, "reap")
    _cols(dev, tuple(a_state.shape), i32=[("a_state", a_state),
                                          ("tseg", tseg), ("live", live)])
    if cap < 1:
        raise ValueError("reap: no rows")
    lib = library()
    out = torch.empty(a_state.shape, dtype=torch.int32, device=dev)
    rc = lib.assess_reap(a_state.data_ptr(), tseg.data_ptr(),
                         live.data_ptr(), cap, N, out.data_ptr(),
                         _stream(dev))
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
    ``h // (hq // hkv)``, rows offset by ``sk - sq``. bf16 at head_dim 64
    or 128 runs the Hopper body (counted also as ``flash_fwd_tc``), the
    rest the SIMT body."""
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
    # The Hopper body's TMA maps take 16-byte-aligned bases (checked here)
    # and strides in multiples of 16 bytes (contiguous bf16 rows of
    # head_dim 64 or 128 are).
    _aligned("flash_fwd", q=q, k=k, v=v)
    tc = flash_fwd_tc(q.dtype, d)
    lib = library("flash")
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), lse.data_ptr(), b, sq, sk, hq, hkv,
                       d, int(causal), int(window), float(scale), is_bf16,
                       _stream(dev))
    _raise_on(rc, "flash_fwd")
    count_launch("flash_fwd")
    if tc:
        count_launch("flash_fwd_tc")
    return out, lse


def launch_decode(q, k, v, valid, scale: float) -> torch.Tensor:
    """B9: (b, hq, d) attention of one query token per sequence over the
    first ``valid[b]`` slots of a (b, S, hkv, d) cache; NaN rows where
    ``valid[b] <= 0``. Two launches: the split kernel (counted as
    ``decode``) writes float32 partials per query head and split, the
    combine (``decode_combine``) adds the live splits in split order."""
    dev = q.device
    b, hq, d = q.shape
    S, hkv = k.shape[1], k.shape[2]
    is_bf16 = _attn_dtype("decode", q, k, v)
    _check(q, "q", q.dtype, (b, hq, d), dev)
    _check(k, "k", q.dtype, (b, S, hkv, d), dev)
    _check(v, "v", q.dtype, (b, S, hkv, d), dev)
    _check(valid, "valid", torch.int32, (b,), dev)
    if d not in HEAD_DIMS or hq % hkv or hq // hkv > DECODE_MAX_GROUP \
            or min(b, S) < 1:
        raise ValueError(f"decode: head_dim {d} (one of {HEAD_DIMS}), "
                         f"heads {hq}/{hkv} (group at most "
                         f"{DECODE_MAX_GROUP}), b {b}, S {S}")
    _aligned("decode", k=k, v=v)
    lib = library("decode")
    splits = decode_splits(S)
    out = torch.empty_like(q)
    # the partials, one allocation: acc (b, hq, splits, d), m and l (b, hq,
    # splits)
    rows = b * hq * splits
    part = torch.empty(rows * (d + 2), dtype=torch.float32, device=dev)
    part_acc, part_m, part_l = part.split((rows * d, rows, rows))
    rc = lib.decode_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         valid.data_ptr(), out.data_ptr(),
                         part_acc.data_ptr(), part_m.data_ptr(),
                         part_l.data_ptr(), b, S, hq, hkv, d, float(scale),
                         is_bf16, _stream(dev))
    _raise_on(rc, "decode")
    count_launch("decode")
    count_launch("decode_combine")
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
    float32. bf16 at head_dim 64 or 128 runs the Hopper body (counted also
    as ``flash_dkv_tc``); with a group above 1 it writes f32 partials per
    query head, which :func:`launch_flash_dkv_group_sum` adds up."""
    b, sq, sk, hq, hkv, d, is_bf16 = _flash_bwd_args(
        "flash_dkv", q, k, v, dout, lse, delta)
    tc = flash_bwd_tc(q.dtype, d)
    split = tc and hq != hkv
    lib = library("flash_bwd")
    if split:
        dk = torch.empty((b, sk, hq, d), dtype=torch.float32, device=k.device)
        dv = torch.empty_like(dk)
    else:
        dk = torch.empty_like(k)
        dv = torch.empty_like(v)
    rc = lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), b, sq, sk, hq, hkv,
                           d, int(causal), int(window), float(scale),
                           is_bf16, _stream(q.device))
    _raise_on(rc, "flash_dkv")
    count_launch("flash_dkv")
    if tc:
        count_launch("flash_dkv_tc")
    if split:
        return launch_flash_dkv_group_sum(dk, dv, hkv)
    return dk, dv


def launch_flash_dkv_group_sum(dk_part, dv_part, hkv: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The group sum of B7's Hopper body: (dk, dv), each (b, sk, hkv, d)
    bf16, from (b, sk, hq, d) float32 partials, one per query head; KV
    head hk sums the partials of heads ``hk * group + g`` in order of g.
    One launch for both."""
    dev = dk_part.device
    b, sk, hq, d = dk_part.shape
    _check(dk_part, "dk_part", torch.float32, (b, sk, hq, d), dev)
    _check(dv_part, "dv_part", torch.float32, (b, sk, hq, d), dev)
    if hkv < 1 or hq % hkv or d % 4:
        raise ValueError(f"flash_dkv_group_sum: heads {hq}/{hkv}, head_dim "
                         f"{d} (a multiple of 4)")
    _aligned("flash_dkv_group_sum", dk_part=dk_part, dv_part=dv_part)
    lib = library("flash_bwd")
    dk = torch.empty((b, sk, hkv, d), dtype=torch.bfloat16, device=dev)
    dv = torch.empty_like(dk)
    rc = lib.flash_bwd_group_sum(dk_part.data_ptr(), dv_part.data_ptr(),
                                 dk.data_ptr(), dv.data_ptr(), b * sk, hq,
                                 hkv, d, _stream(dev))
    _raise_on(rc, "flash_dkv_group_sum")
    count_launch("flash_dkv_group_sum")
    return dk, dv


def launch_flash_dq(q, k, v, dout, lse, delta, causal: bool, window: int,
                    scale: float) -> torch.Tensor:
    """B8: dq (b, sq, hq, d) in q's type, with B7's arguments. bf16 at
    head_dim 64 or 128 runs the Hopper body (counted also as
    ``flash_dq_tc``)."""
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
    if flash_bwd_tc(q.dtype, d):
        count_launch("flash_dq_tc")
    return dq


def launch_ssd(x, dt, A, B, C, D, chunk: int, *,
               out_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """B10: (y (b, s, h, p) in x's type, final state (b, h, p, n)
    float32) of the SSD chunked scan from a zero state, in chunks of
    ``chunk`` rows (the last one ragged), head h on group ``h // (h //
    g)``. x, B and C share one of bfloat16 or float32; dt, A and D are
    float32. The state is written into ``out_state`` when one is given
    (a contiguous float32 (b, h, p, n) tensor, e.g. a cache's slice).
    Inputs that :func:`ssd_tc` names run the Hopper body: three kernels
    (counted as ``ssd_prep``, ``ssd_state``, ``ssd_out``) on scratch
    allocated here; the call counts as ``ssd`` and ``ssd_tc``. The rest
    run the SIMT body (``ssd``)."""
    dev = x.device
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if x.dtype not in _ATTN_DTYPES or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise TypeError(f"ssd: x, B and C must share one dtype of bfloat16 "
                        f"or float32, got {[x.dtype, B.dtype, C.dtype]}")
    _check(x, "x", x.dtype, (b, s, h, p), dev)
    _check(dt, "dt", torch.float32, (b, s, h), dev)
    _check(A, "A", torch.float32, (h,), dev)
    _check(B, "B", x.dtype, (b, s, g, n), dev)
    _check(C, "C", x.dtype, (b, s, g, n), dev)
    _check(D, "D", torch.float32, (h,), dev)
    if p not in SSD_DIMS or n not in SSD_DIMS or g < 1 or h % g \
            or min(b, s, chunk) < 1:
        raise ValueError(f"ssd: head_dim {p} and d_state {n} (each one of "
                         f"{SSD_DIMS}), heads {h} in {g} groups, b {b}, "
                         f"s {s}, chunk {chunk}")
    if out_state is None:
        out_state = torch.empty((b, h, p, n), dtype=torch.float32,
                                device=dev)
    _check(out_state, "out_state", torch.float32, (b, h, p, n), dev)
    lib = library("ssd")
    y = torch.empty_like(x)
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(), out_state.data_ptr())
    if not ssd_tc(x.dtype, p, n, chunk):
        smem = lib.ssd_smem(p, n, chunk)
        if smem > MAX_SMEM:
            raise ValueError(f"ssd: chunk {chunk} needs {smem} B of shared "
                             f"memory, above the {MAX_SMEM} B a block may "
                             f"use")
        rc = lib.ssd_fwd(*args, b, s, h, g, p, n, int(chunk),
                         _ATTN_DTYPES[x.dtype], _stream(dev))
        _raise_on(rc, "ssd")
        count_launch("ssd")
        return y, out_state
    # the Hopper body's tensor maps take 16-byte-aligned bases
    _aligned("ssd", x=x, B=B, C=C)
    nc = -(-s // chunk)
    tiles = chunk // SSD_TC_TILE
    f32 = dict(dtype=torch.float32, device=dev)
    a_cs = torch.empty((b, h, nc, chunk), **f32)
    dtp = torch.empty_like(a_cs)
    wts = torch.empty_like(a_cs)
    cb = torch.empty((b, nc, g, tiles * (tiles + 1) // 2,
                      SSD_TC_TILE * SSD_TC_TILE), **f32)
    # the state entering each chunk as a bf16 pair (hi, lo)
    st_in = torch.empty((b, nc, h, 2, p, n), dtype=torch.bfloat16,
                        device=dev)
    rc = lib.ssd_fwd_tc(*args, a_cs.data_ptr(), dtp.data_ptr(),
                        wts.data_ptr(), cb.data_ptr(), st_in.data_ptr(), b,
                        s, h, g, p, n, int(chunk), _stream(dev))
    _raise_on(rc, "ssd")
    for key in SSD_TC_KEYS:
        count_launch(key)
    return y, out_state
