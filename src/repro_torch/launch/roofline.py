"""Roofline analysis over the dry-run records, the port of the
reference's ``repro/launch/roofline.py``, on the H100's constants
(:mod:`repro_torch.launch.mesh`).

Per (arch × shape) cell on the single-node-group mesh (``mesh32x8``):

    compute_s    = FLOPs per device            / PEAK_FLOPS_BF16
    memory_s     = HBM-traffic lower bound     / HBM_BW
    collective_s = collective bytes per device / LINK_BW

Memory accounting: ``bytes_accessed_per_device`` adds every local op's
inputs and outputs, so it re-counts a buffer at every consumer and
counts what a fused kernel keeps on chip. The bound attribution uses the
buffer-level traffic ``arguments + outputs + 2×temporaries`` instead and
keeps the accessed-bytes figure as ``mem_hi``. True HBM time lies between
the two.

The dominant term is the bottleneck; the roofline fraction is
``useful_compute_s / max(term)`` where useful compute is the analytic
MODEL_FLOPS (6·N_active·D for training, 2·N_active·D for inference) at
peak: how much of the roofline-limited step time is irreducible model
math. Every record is exact: the port's layer loop is a Python loop, so
each layer's ops run and count (the reference's scanned records count a
scan body once and need its ``unroll`` probes).

A cell fits one H100 when one device's arguments, outputs (less those
updated in place) and peak temporaries together stay within
``HBM_BYTES``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        [--dir results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import Dict, List

from repro_torch.configs import (ALL_SHAPES, ARCH_IDS, get_config, get_shape,
                                 skip_reason)
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, LINK_BW,
                                     PEAK_FLOPS_BF16, mesh_name)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    tag: str
    compute_s: float
    memory_s: float      # buffer-traffic lower bound
    memory_hi_s: float   # accessed-bytes upper bound
    collective_s: float
    model_flops_global: float
    hlo_flops_global: float
    n_devices: int
    device_bytes: int    # one device's arguments, outputs, temporaries

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_s(self) -> float:
        return self.model_flops_global / self.n_devices / PEAK_FLOPS_BF16

    @property
    def roofline_fraction(self) -> float:
        return self.useful_s / max(self.step_s, 1e-30)

    @property
    def flops_utilization(self) -> float:
        """MODEL_FLOPS / the step's FLOPs on every device: the remat and
        replication waste detector."""
        return self.model_flops_global / max(self.hlo_flops_global, 1e-30)

    @property
    def fits(self) -> bool:
        return self.device_bytes <= HBM_BYTES


def model_flops(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    _, n_active = cfg.param_counts()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one new token per sequence
    return 2.0 * n_active * shape.global_batch


def advice(c: Cell) -> str:
    if c.bound == "collective":
        return ("shrink collective bytes: cast all-reduced activations/"
                "grads to bf16, reduce-scatter instead of all-reduce, or "
                "re-shard so the hot matmul keeps its contraction local")
    if c.bound == "memory":
        return ("raise arithmetic intensity: fuse the attention/scan path "
                "(the port's kernels), keep working sets in shared memory, "
                "batch decode requests deeper so weights are re-used per "
                "byte")
    if c.flops_utilization < 0.7:
        return ("compute-bound but wasteful: relax the remat policy "
                "(checkpoint dots only) to cut recompute FLOPs, or shard "
                "what DTensor replicates")
    return ("compute-bound at high utilization: gains now come from "
            "tensor-core shape alignment (multiples of 64) and overlap of "
            "the remaining collectives with compute")


def cell_of(rec: Dict) -> Cell:
    """The roofline terms of one dry-run record."""
    n_dev = rec["n_devices"]
    mem = rec["memory"]
    traffic_lb = (mem["argument_bytes"] + mem["output_bytes"]
                  + 2 * mem["temp_bytes"])
    return Cell(
        arch=rec["arch"], shape=rec["shape"], tag=rec.get("tag", ""),
        compute_s=rec["flops_per_device"] / PEAK_FLOPS_BF16,
        memory_s=traffic_lb / HBM_BW,
        memory_hi_s=rec["bytes_accessed_per_device"] / HBM_BW,
        collective_s=rec["collectives"]["total_bytes"] / LINK_BW,
        model_flops_global=model_flops(rec["arch"], rec["shape"]),
        hlo_flops_global=rec["flops_per_device"] * n_dev,
        n_devices=n_dev,
        device_bytes=(mem["argument_bytes"] + mem["output_bytes"]
                      - mem["alias_bytes"] + mem["temp_bytes"]))


def load_cells(dirpath: str, mesh: str = mesh_name(False)
               ) -> Dict[tuple, Cell]:
    """The records of ``mesh`` under ``dirpath`` (untagged: the dry run's
    own; the perf harness's records carry tags), by (arch, shape)."""
    by_key: Dict[tuple, Cell] = {}
    for path in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("mesh") != mesh or "skipped" in rec or rec.get("tag"):
            continue
        by_key[(rec["arch"], rec["shape"])] = cell_of(rec)
    return by_key


def table(cells: Dict[tuple, Cell]) -> str:
    lines = [
        "| arch | shape | compute | mem_lb | mem_hi | collective | bound | "
        "MODEL/HLO | roofline frac | GiB/device | fits one H100 |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_IDS:
        for shape in ALL_SHAPES:
            reason = skip_reason(get_config(arch), shape)
            if reason is not None:
                lines.append(f"| {arch} | {shape.name} | — | — | — | — "
                             f"| N/A | — | — | — | skip: {reason} |")
                continue
            c = cells.get((arch, shape.name))
            if c is None:
                lines.append(f"| {arch} | {shape.name} | … | … | … | … "
                             "| no record (failed or not run) | … | … "
                             "| … | |")
                continue
            lines.append(
                f"| {arch} | {shape.name} | {c.compute_s*1e3:.2f}ms | "
                f"{c.memory_s*1e3:.2f}ms | {c.memory_hi_s*1e3:.2f}ms | "
                f"{c.collective_s*1e3:.2f}ms | {c.bound} | "
                f"{c.flops_utilization:.2f} | {c.roofline_fraction:.2%} | "
                f"{c.device_bytes / 2**30:.1f} | "
                f"{'yes' if c.fits else 'no'} |")
    return "\n".join(lines)


def pick_hillclimb(cells: Dict[tuple, Cell]) -> List[tuple]:
    """worst roofline fraction, most collective-bound, most representative
    (largest-model training cell: the production case the fault-tolerant
    runtime exists for)."""
    live = list(cells.values())
    worst = min(live, key=lambda c: c.roofline_fraction)
    coll = max(live, key=lambda c: c.collective_s / max(c.step_s, 1e-30))
    train_cells = [c for c in live if c.shape == "train_4k"]
    rep = max(train_cells,
              key=lambda c: get_config(c.arch).param_counts()[0]) \
        if train_cells else worst
    seen, out = set(), []
    for c in (worst, coll, rep):
        if (c.arch, c.shape) not in seen:
            seen.add((c.arch, c.shape))
            out.append((c.arch, c.shape))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--csv", default="results/roofline_torch.csv")
    ap.add_argument("--mesh", default=mesh_name(False))
    args = ap.parse_args(argv)
    cells = load_cells(args.dir, args.mesh)
    print(table(cells))
    print()
    for (arch, shape), c in sorted(cells.items()):
        print(f"{arch} × {shape}: bound={c.bound}; {advice(c)}")
    if cells:
        print("\nhillclimb candidates:", pick_hillclimb(cells))
    os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
    with open(args.csv, "w") as f:
        f.write("arch,shape,compute_s,memory_s,memory_hi_s,collective_s,"
                "bound,model_over_hlo,roofline_fraction,device_bytes,fits\n")
        for (arch, shape), c in sorted(cells.items()):
            f.write(f"{arch},{shape},{c.compute_s:.6g},{c.memory_s:.6g},"
                    f"{c.memory_hi_s:.6g},{c.collective_s:.6g},{c.bound},"
                    f"{c.flops_utilization:.4f},"
                    f"{c.roofline_fraction:.4f},{c.device_bytes},"
                    f"{int(c.fits)}\n")


if __name__ == "__main__":
    main()
