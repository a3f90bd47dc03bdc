"""Dry run of every (architecture × shape) cell on the production meshes,
the port of the reference's ``repro/launch/dryrun.py``.

The reference compiles each cell's SPMD step for 512 fake CPU devices
and reads XLA's cost and memory analyses. Torch has no such compile; its
idiom is DTensor on the ``"fake"`` process-group backend
(:func:`~repro_torch.launch.mesh.make_production_mesh`): parameters,
inputs and the cache are ``meta`` tensors laid out by the sharding rules
(:func:`~repro_torch.parallel.sharding.physical_spec`) as DTensors, and
the step (``impl="ref"``: the oracles, plain torch) runs eagerly on them.
DTensor's sharding propagation picks each op's layout and issues the
collectives (on the fake group they move nothing), so one process stands
for every rank; nothing is allocated and no card is used.

The step runs twice and the second run is counted: the first fills
DTensor's caches, and DTensor's shape inference for each op signature
it meets first runs that op on ``meta`` tensors, which the counting
mode would see (about a layer's worth of extra ops, and the buffers the
caches keep in its peak).

What a record holds (the reference's keys):

- ``flops_per_device``: the FLOPs of the ops each rank runs on its local
  tensors (torch's FLOP formulas, ``torch.utils.flop_counter``, applied
  to the local shapes after DTensor has laid the op out), so work that
  DTensor replicates counts on every rank; ``flops_global`` beside it:
  ``FlopCounterMode`` over the global (DTensor) ops, the step's math once;
- ``bytes_accessed_per_device``: the bytes of every local op's tensor
  inputs and outputs (XLA's "bytes accessed" counts the same way);
- ``collectives``: the output bytes of every ``c10d_functional`` op (and
  of the ``c10d`` ops the sequence-parallel decode calls) on the local
  tensors, an all-reduce counted twice (ring = reduce-scatter +
  all-gather) as in the reference's ``collect_collectives``;
  ``bytes_by_op``, ``counts``, ``total_bytes``;
- ``memory``: ``argument_bytes`` (the local shards of the step's
  arguments), ``output_bytes`` (of its outputs; the donated arguments,
  updated in place and returned, the train state and the decode cache,
  also count in ``alias_bytes``, as the reference's ``donate_argnums``
  makes XLA count them), ``temp_bytes``: the peak of the bytes the
  step's own ops held live beyond its arguments (a write into a donated
  argument allocates nothing)
  (``torch.distributed._tools.mem_tracker.MemTracker`` is not used: it
  needs modules; the local ops' outputs are tracked by storage instead),
  ``code_bytes`` 0 (nothing is compiled);
- ``params_total``, ``params_active``, ``n_devices``.

An op that DTensor cannot lay out (no sharding rule, or a rule that the
op's in-place form or its mixed DTensor and plain arguments defeat)
fails its cell: ``[FAIL]`` with the op's name (:class:`CellFailed`),
and ``main`` exits 1, as the reference's does. Nothing is replicated
silently.

Usage (on the host; ``PYTHONPATH=src``):

    python -m repro_torch.launch.dryrun [--arch ID] [--shape NAME]
        [--mesh single|multi|both] [--out results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import (ALL_SHAPES, ARCH_IDS, get_config, get_shape,
                                 skip_reason)
from repro_torch.launch.mesh import make_production_mesh, mesh_name
from repro_torch.models import layers as L
from repro_torch.models import model as MODEL
from repro_torch.models.inputs import input_axes, input_specs
from repro_torch.parallel import sharding as SH
from repro_torch.train.loop import (TrainConfig, make_prefill_step,
                                    make_serve_step, make_train_step,
                                    train_state_axes, train_state_shapes)

OUT = "results/dryrun_torch"
# Collective ops as the local tensors see them (``c10d_functional``'s,
# DTensor's all-to-all, the ``c10d`` ops the sequence-parallel decode
# calls), by the reference's names.
_COLLECTIVES = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                ("all_gather", "all-gather"), ("allgather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"),
                ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))


def _collective(packet) -> Optional[str]:
    name = str(packet)
    if "c10d" not in name and "_dtensor" not in name:
        return None
    for key, kind in _COLLECTIVES:
        if key in name:
            return kind
    return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    """Every tensor of a tree of dicts, lists, tuples and ParamTrees."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, L.ParamTree):
        yield from L.tree_leaves(x).values()
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _local_counter(donated=()):
    """A dispatch mode over the ranks' local ops (DTensor runs first and
    desugars each op into local ops and collectives, which the mode then
    sees, as ``CommDebugMode`` does): FLOPs, bytes accessed, collective
    bytes and the live bytes of the outputs the step creates. The local
    storage of every tensor of ``donated`` (the arguments updated in
    place) counts as held already: a write into it allocates nothing."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class LocalOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.coll_bytes: Dict[str, int] = {}
            self.coll_counts: Dict[str, int] = {}
            self.live = 0
            self.peak = 0
            self._seen = weakref.WeakSet(
                (t.to_local() if isinstance(t, DTensor) else t
                 ).untyped_storage() for t in _tensors(donated))

        def _track(self, out):
            for t in _tensors(out):
                st = t.untyped_storage()
                if st in self._seen:
                    continue
                n = st.nbytes()
                self._seen.add(st)
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, n)

        def _free(self, n):
            self.live -= n

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
            kind = _collective(packet)
            if kind is not None:
                n = sum(_nbytes(t) for t in _tensors(out))
                n *= 2 if kind == "all-reduce" else 1
                self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + n
                self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            self._track(out)
            return out

    return LocalOps()


def _dtensor(leaf: torch.Tensor, spec, mesh):
    from torch.distributed.tensor import DTensor

    local = torch.empty(SH.local_shape(leaf.shape, spec, mesh),
                        dtype=leaf.dtype, device="meta")
    return DTensor.from_local(local, mesh, SH.placements(spec, mesh),
                              run_check=False, shape=leaf.shape,
                              stride=leaf.stride())


def distribute(tree, axes, mesh, rules):
    """A tree of ``meta`` tensors as DTensors laid out by ``axes`` under
    ``rules`` (structure of ``axes``)."""
    return SH.tree_map_axes(
        lambda ax, leaf: _dtensor(
            leaf, SH.physical_spec(leaf.shape, ax, rules, mesh), mesh),
        axes, tree)


def local_bytes(tree) -> int:
    """Bytes of one rank's shards of every tensor in ``tree``."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _tensors(tree):
        total += _nbytes(t.to_local() if isinstance(t, DTensor) else t)
    return total


def build_cell(cfg, shape, mesh, tc: TrainConfig):
    """Returns (fn, args tuple, in-place argument indices). Sharding rules
    come from the ACTIVE context (``run_cell``'s ``use_mesh`` may override
    them: the perf harness drives exactly that)."""
    param_rules, act_rules = SH._current_rules()
    # Donation, as the reference's: the train state and the decode KV
    # cache are updated in place, and count in ``alias_bytes``.
    if shape.kind == "train":
        fn = make_train_step(cfg, tc, donate=True)
        state = distribute(train_state_shapes(cfg, tc),
                           train_state_axes(cfg, tc), mesh, param_rules)
        state["params"] = L.ParamTree(state["params"], trainable=True)
        batch = distribute(input_specs(cfg, shape), input_axes(cfg, shape),
                           mesh, act_rules)
        return fn, (state, batch), (0,)
    if param_rules is SH.PARAM_RULES:
        # serving default: no FSDP re-gathers per token
        param_rules = SH.SERVE_PARAM_RULES
    params = L.ParamTree(distribute(MODEL.param_shapes(cfg),
                                    MODEL.param_axes(cfg), mesh,
                                    param_rules))
    specs = distribute(input_specs(cfg, shape), input_axes(cfg, shape),
                       mesh, act_rules)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, tc), (params, specs), ()
    fn = make_serve_step(cfg, tc)
    return fn, (params, specs["cache"], specs["tokens"], specs["pos"]), (1,)


def _op_tracker():
    """A dispatch mode that keeps the op being dispatched on DTensors, so
    that a cell that fails names the op DTensor could not lay out."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class LastOp(TorchDispatchMode):
        op = None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.op = func
            return func(*args, **(kwargs or {}))

    return LastOp()


class CellFailed(RuntimeError):
    """A cell whose step DTensor could not run: ``op`` names the op;
    ``argument_bytes`` the local shards of the arguments it was given."""

    def __init__(self, op: str, why: str, argument_bytes: int):
        super().__init__(f"{op}: {why}")
        self.op = op
        self.argument_bytes = argument_bytes


def failed_op(exc: BaseException) -> Optional[str]:
    """The op a failed cell stopped at (None for other errors)."""
    return getattr(exc, "op", None)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             tc: Optional[TrainConfig] = None, out_dir: str = OUT,
             save: bool = True, act_rules=None, param_rules=None,
             tag: str = "", mesh=None, cfg=None,
             shape=None) -> Dict[str, Any]:
    """One cell's record; ``mesh`` (default: the production mesh) may be
    any mesh with the production axes, ``cfg`` (default: the
    architecture's) any configuration of it and ``shape`` (default: the
    named one) any shape of its kind (the tests' small fake meshes,
    reduced configurations and shapes)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
        mname = mesh_name(multi_pod)
    else:
        mname = "mesh" + "x".join(map(str, mesh.shape))
    cell_id = f"{arch}__{shape_name}__{mname}" + (f"__{tag}" if tag else "")
    record: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "mesh": mname, "kind": shape.kind, "tag": tag}
    reason = skip_reason(cfg, shape)
    if reason is not None:
        record["skipped"] = reason
        _maybe_save(record, cell_id, out_dir, save)
        return record
    if tc is None:
        # production defaults: full remat for the train steps
        tc = TrainConfig(remat="full" if shape.kind == "train" else "none",
                         impl="ref")
    t0 = time.time()
    with SH.use_mesh(mesh, param_rules=param_rules, act_rules=act_rules):
        fn, args, in_place = build_cell(cfg, shape, mesh, tc)
        t_build = time.time() - t0
        arg_bytes = local_bytes(args)
        donated = [args[i] for i in in_place]
        # twice, the second counted: the first fills DTensor's caches
        # (sharding propagation, redistribution plans, the buffers they
        # keep), which would count in its peak and its ops. A donated
        # state is updated by both runs: on ``meta`` tensors there are no
        # values to change, only the same shapes and layouts
        for _ in range(2):
            counter, last = _local_counter(donated), _op_tracker()
            gc.collect()
            gc.disable()   # frees by reference count only: the same peak
            try:           # on every run (a collection's timing varies)
                with implicit_replication(), counter, \
                        FlopCounterMode(display=False) as flops, last:
                    out = fn(*args)
            except Exception as e:
                if last.op is None:
                    raise
                why = (str(e).strip().splitlines()
                       or [type(e).__name__])[0]
                raise CellFailed(str(last.op), why[:200], arg_bytes) from e
            finally:
                gc.enable()
        t_run = time.time() - t0 - t_build
    out_bytes = local_bytes(out)
    alias = local_bytes(donated)
    n_total, n_active = cfg.param_counts()
    coll = counter.coll_bytes
    record.update({
        "build_s": round(t_build, 2),
        "run_s": round(t_run, 2),
        "flops_per_device": float(counter.flops),
        "flops_global": float(flops.get_total_flops()),
        "bytes_accessed_per_device": float(counter.bytes),
        "collectives": {"bytes_by_op": coll,
                        "counts": counter.coll_counts,
                        "total_bytes": sum(coll.values())},
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": counter.peak, "alias_bytes": alias,
                   "code_bytes": 0},
        "params_total": n_total,
        "params_active": n_active,
        "n_devices": mesh.size(),
    })
    _maybe_save(record, cell_id, out_dir, save)
    return record


def _maybe_save(record, cell_id, out_dir, save):
    if not save:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(record, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run (H100)")
    ap.add_argument("--arch", default=None, help="architecture id (or all)")
    ap.add_argument("--shape", default=None, help="shape name (or all)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else [s.name for s in ALL_SHAPES]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                label = f"{arch} × {shape_name} × {mesh_name(multi)}"
                tc = None
                if args.remat:
                    tc = TrainConfig(remat=args.remat, impl="ref")
                try:
                    rec = run_cell(arch, shape_name, multi, tc=tc,
                                   out_dir=args.out)
                except Exception as e:  # a failure here is a finding
                    failures.append((label, e))
                    print(f"[FAIL] {label}: {type(e).__name__}: "
                          f"{str(e)[:300]}", flush=True)
                    if args.verbose:
                        traceback.print_exc()
                    continue
                if "skipped" in rec:
                    print(f"[SKIP] {label}: {rec['skipped']}", flush=True)
                else:
                    gb = rec["memory"]["argument_bytes"] / 2 ** 30
                    tb = rec["memory"]["temp_bytes"] / 2 ** 30
                    print(f"[ OK ] {label}: flops/dev="
                          f"{rec['flops_per_device']:.3e} args={gb:.2f}GiB "
                          f"temp={tb:.2f}GiB coll="
                          f"{rec['collectives']['total_bytes'] / 2 ** 20:.1f}"
                          f"MiB (build {rec['build_s']}s run "
                          f"{rec['run_s']}s)", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES")
        raise SystemExit(1)
    print("\nall requested dry-run cells passed")


if __name__ == "__main__":
    main()
