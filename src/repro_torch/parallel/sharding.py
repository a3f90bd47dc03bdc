"""Logical-axis sharding, the port of the reference's
``repro/parallel/sharding.py``.

Model code names every tensor dimension with a *logical* axis (e.g.
``("batch", "seq", "heads", "head_dim")``); a rule table maps logical axes
onto the axes of a :class:`~torch.distributed.device_mesh.DeviceMesh`
(``mesh_dim_names``). Where the reference hands the resolved
``PartitionSpec`` to XLA's SPMD partitioner, the port hands
:func:`placements` to DTensor, whose sharding propagation inserts the
collectives. Two rule tables exist because parameters and activations
want different placements (e.g. ``embed`` is FSDP-sharded over ``data``
on *weights* but must stay unsharded on *activations*, whose batch dim
already occupies ``data``).

Rules map one logical name to one mesh axis or a tuple of axes (e.g.
``batch → ("pod", "data")``). A mapping is dropped for a tensor whose
dimension is not divisible by the mesh-axis size (MQA ``kv_heads=1``, odd
vocab sizes, ``global_batch=1`` long-context decode), as production
frameworks degrade to replication.

:func:`physical_spec` returns a plain tuple with one entry per dimension:
``None``, an axis name, or a tuple of names. It reads only the mesh's
axis names and sizes (:func:`mesh_sizes`), so a ``DeviceMesh``, a JAX
``AbstractMesh`` or a plain ``{name: size}`` dict all serve.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]
ShardingRules = Dict[str, Axis]
Spec = Tuple[Axis, ...]

# ---------------------------------------------------------------------------
# Default rule tables for the production meshes (pod, data, model).
# ---------------------------------------------------------------------------
PARAM_RULES: ShardingRules = {
    # FSDP/ZeRO: the d_model dim of every weight is sharded over `data`.
    "embed": "data",
    # Tensor parallelism over `model`.
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",         # expert parallelism rides the model axis
    "expert_mlp": None,        # per-expert FFN width stays local
    "mamba_inner": "model",
    "mamba_heads": "model",
    "mamba_group_state": None, # B/C projections replicated (groups < mesh)
    "frontend_feature": None,
    "layers": None,            # scan dim
    "head_dim": None,
    "state": None,
    "conv_kernel": None,
    "norm": None,
}

# Serving layout: no FSDP. Re-gathering ZeRO-sharded weights on every
# decoded token costs ~6 weight all-gathers per layer per token; decode
# wants weights resident: TP over `model`, replicated over `data`.
SERVE_PARAM_RULES: ShardingRules = dict(PARAM_RULES, embed=None)

ACT_RULES: ShardingRules = {
    "batch": ("pod", "data"),
    "seq": None,
    # KV-cache sequence dim: sharded over `model` (distributed flash-decode;
    # falls back automatically when `model` is already taken by kv_heads).
    "kv_seq": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_cap": ("pod", "data"),  # MoE dispatch buffer capacity dim
    "expert_mlp": None,
    "mamba_inner": "model",
    "mamba_heads": "model",
    "mamba_group_state": None,
    "head_dim": None,
    "state": None,
    "conv_kernel": None,
}

# ---------------------------------------------------------------------------
# Mesh + rules context (thread-local so that threads can hold distinct
# meshes).
# ---------------------------------------------------------------------------
_ctx = threading.local()


def current_mesh():
    return getattr(_ctx, "mesh", None)


def _current_rules() -> Tuple[ShardingRules, ShardingRules]:
    return (
        getattr(_ctx, "param_rules", PARAM_RULES),
        getattr(_ctx, "act_rules", ACT_RULES),
    )


@contextlib.contextmanager
def use_mesh(mesh, param_rules: Optional[ShardingRules] = None,
             act_rules: Optional[ShardingRules] = None):
    """Activate a mesh (and optional rule overrides) for model code."""
    prev = (getattr(_ctx, "mesh", None),
            getattr(_ctx, "param_rules", PARAM_RULES),
            getattr(_ctx, "act_rules", ACT_RULES))
    _ctx.mesh = mesh
    _ctx.param_rules = param_rules or PARAM_RULES
    _ctx.act_rules = act_rules or ACT_RULES
    try:
        yield mesh
    finally:
        _ctx.mesh, _ctx.param_rules, _ctx.act_rules = prev


@contextlib.contextmanager
def set_rules(param_rules: Optional[ShardingRules] = None,
              act_rules: Optional[ShardingRules] = None):
    """Override rule tables only (mesh unchanged): the perf sweeps."""
    with use_mesh(current_mesh(), param_rules, act_rules):
        yield


# ---------------------------------------------------------------------------
# Logical → physical resolution.
# ---------------------------------------------------------------------------
def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (``mesh_dim_names``), of
    any mesh whose ``shape`` is such a mapping (JAX's meshes), or of the
    mapping itself."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    shape = getattr(mesh, "shape", mesh)
    if not isinstance(shape, Mapping):
        raise TypeError(f"a mesh names its axes; got {type(mesh).__name__}")
    return dict(shape)


def physical_spec(shape: Sequence[int],
                  logical: Sequence[Optional[str]],
                  rules: ShardingRules,
                  mesh) -> Spec:
    """Resolve logical axis names to one entry per dimension (``None``, an
    axis name or a tuple of names), dropping mappings whose mesh-axis
    product does not evenly divide the dimension, and never mapping one
    mesh axis twice."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims, "
                         f"axes {tuple(logical)} {len(logical)}")
    sizes = mesh_sizes(mesh)
    used: set = set()
    out: List[Axis] = []
    for dim, name in zip(shape, logical):
        axis: Axis = rules.get(name) if name is not None else None
        if axis is None:
            out.append(None)
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        # keep only mesh axes that exist, are unused, and divide the dim
        kept = []
        size = 1
        for a in axes:
            if a in sizes and a not in used:
                kept.append(a)
                size *= sizes[a]
        if kept and dim % size == 0 and dim > 0:
            used.update(kept)
            out.append(tuple(kept) if len(kept) > 1 else kept[0])
        else:
            out.append(None)
    return tuple(out)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of a spec, one per mesh dimension: ``Shard(i)``
    where dimension ``i`` of the tensor maps onto that mesh axis (alone or
    in a tuple), ``Replicate()`` elsewhere and on an axis of size 1 (one
    shard is the whole tensor; DTensor would refuse views of a dimension
    "sharded" one way)."""
    from torch.distributed.tensor import Replicate, Shard

    owner: Dict[str, int] = {}
    for i, entry in enumerate(spec):
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            owner[a] = i
    return tuple(Shard(owner[a]) if a in owner and size > 1 else Replicate()
                 for a, size in zip(mesh.mesh_dim_names, mesh.shape))


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a tensor laid out by ``spec``."""
    sizes = mesh_sizes(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            dim //= sizes[a]
        out.append(dim)
    return tuple(out)


def is_axes(x) -> bool:
    """True for a leaf of an axes tree: a tuple of names and ``None``s."""
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)


def tree_map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over an axes tree (dicts and lists) and trees
    of the same structure, keeping the structure."""
    if is_axes(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, Mapping):
        return {k: tree_map_axes(fn, v, *(t[k] for t in trees))
                for k, v in axes_tree.items()}
    return [tree_map_axes(fn, v, *(t[i] for t in trees))
            for i, v in enumerate(axes_tree)]


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Lay an activation out by its logical axes, the counterpart of the
    reference's ``with_sharding_constraint``: the identity off a mesh or on
    a plain tensor; a DTensor is redistributed to the act rules'
    placements."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    _, act_rules = _current_rules()
    spec = physical_spec(x.shape, logical, act_rules, mesh)
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def is_dtensor(x) -> bool:
    """True for a DTensor (the dry run's tensors on a mesh)."""
    if current_mesh() is None:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def gather_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dimension ``dim`` whole on every device: a DTensor
    sharded on it is redistributed (that dimension replicated, the rest
    as it was); anything else is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                 else p for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def lay_out(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """A tensor the model allocates itself (a cache), laid out by its
    logical axes: the identity off a mesh; on a mesh a plain tensor
    becomes a DTensor of the act rules' placements
    (``distribute_tensor``), a DTensor is constrained."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        return constrain(x, *logical)
    _, act_rules = _current_rules()
    spec = physical_spec(x.shape, logical, act_rules, mesh)
    return distribute_tensor(x, mesh, placements(spec, mesh))


def param_sharding_tree(axes_tree, shapes_tree, mesh,
                        rules: Optional[ShardingRules] = None):
    """Map a tree of logical-axis tuples and a matching tree of tensors
    (or anything with a ``shape``) to a tree of placements."""
    if rules is None:
        rules, _ = _current_rules()
    return tree_map_axes(
        lambda axes, leaf: placements(
            physical_spec(leaf.shape, axes, rules, mesh), mesh),
        axes_tree, shapes_tree)
