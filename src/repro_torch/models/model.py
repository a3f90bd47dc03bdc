"""Model builder: one entry point for the registry's ten architectures,
the port of the reference's ``repro/models/model.py``.

Families:

- dense / moe / audio / vlm: one stack of uniform layers (norm, GQA
  attention, norm, MLP or the top-k MoE of :mod:`repro_torch.models.moe`
  where ``cfg.moe.period == 1``); audio feeds frame features through a
  projection instead of token embeddings, vlm prepends projected patch
  features to the embedded text, with positions over the whole sequence;
- ssm: a stack of Mamba-2 layers (:mod:`repro_torch.models.mamba2`);
- hybrid (Jamba): blocks of ``block_len`` layers, attention at
  ``hybrid.attn_index`` and Mamba-2 elsewhere, MoE in the FFN slot of the
  layers ``moe.is_moe_layer`` names and a dense MLP in the rest.

``init_params`` materializes a :class:`~repro_torch.models.layers.ParamTree`
in the reference's layout, with one sub-tree per layer (``layers``) or
per block (``blocks``: the block's ``attn``, its lists ``mamba``, ``moe``
and ``mlp`` in layer order, and its ``lns``, one ``{ln1, ln2}`` pair a
layer), where the reference stacks them on leading axes; ``forward``,
``prefill``, ``init_cache`` and ``decode_step`` keep the reference's
signatures and cache layouts, with ``impl="kernel"`` as the port's
default: attention goes through kernel B6 (prefill, forward) and B9
(decode), the Mamba-2 layers' chunked scan through B10 (prefill; decode
is the oracle's single-token recurrence, as in the reference), on CUDA
tensors, and through their plain versions on CPU tensors; ``impl="ref"``
selects the oracles. The MoE router, queue and expert products are plain
torch, as they are plain jnp in the reference. The reference's
``lax.scan`` over stacked layers is a Python loop here, so its ``unroll``
knob has no counterpart. ``forward`` is differentiable (training builds
the weights with ``ParamTree(..., trainable=True)``); its
``remat`` policies are the reference's (``_REMAT_POLICIES``), one
``torch.utils.checkpoint`` per layer (hybrid: per block): ``"full"``
recomputes the whole layer in the backward (``nothing_saveable``);
``"dots"`` saves the outputs of the matrix products and recomputes the
rest (``checkpoint_dots``), ``"dots_no_batch"`` saves only the products
without a batch dimension (``checkpoint_dots_with_no_batch_dims``), each
through a selective-checkpoint policy (:func:`dots_policy`). The attention
kernels are not products the dispatcher sees, so B6 runs again in the
recompute under every policy but ``"none"``, as the reference's Pallas
forward does. ``param_shapes``, ``param_axes`` and ``cache_axes`` give
the weights' ``meta`` tensors and the logical axes of the weights and of
the cache (``parallel.sharding``) without allocating: the dry run
(``launch/dryrun.py``) lays them out on a mesh.

Encoder-only configurations (hubert-xlarge) have no decode step, as the
reference's shape list has none for them (``configs.base.skip_reason``):
``init_cache`` and ``decode_step`` raise; ``forward`` and ``prefill``
run.

Entry points run on the CUDA card unless the caller passes a CPU device
(``init_params(..., device="cpu")``); tensors then stay where the
weights are.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.accel.torch_backend import require_device
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.parallel.sharding import (constrain, gather_dim, lay_out,
                                           tree_map_axes)

Params = L.ParamTree


def uses_moe(cfg: ModelConfig, j: int) -> bool:
    """True where layer ``j`` (of a uniform stack, or within a hybrid
    block) has the MoE in its FFN slot."""
    if cfg.moe is None:
        return False
    if cfg.hybrid is not None:
        return cfg.moe.is_moe_layer(j)
    return cfg.moe.period == 1


def _no_decode(cfg: ModelConfig, what: str) -> None:
    if cfg.is_encoder_only():
        raise ValueError(f"{cfg.arch_id}: {what}: encoder-only arch, no "
                         f"autoregressive decode step")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_layer(cfg: ModelConfig, f: L.ParamFactory) -> Dict[str, Any]:
    if cfg.family == "ssm":
        return {"ln1": L.init_norm(cfg, f), "mixer": M.init_mamba(cfg, f)}
    return {"ln1": L.init_norm(cfg, f), "mixer": L.init_attention(cfg, f),
            "ln2": L.init_norm(cfg, f),
            "ffn": (MOE.init_moe(cfg, f) if uses_moe(cfg, 0)
                    else L.init_mlp(cfg, f))}


def _init_block(cfg: ModelConfig, f: L.ParamFactory) -> Dict[str, Any]:
    """One hybrid block, drawn layer by layer in the reference's order."""
    block: Dict[str, Any] = {"mamba": [], "moe": [], "mlp": [], "lns": []}
    for j in range(cfg.hybrid.block_len):
        block["lns"].append({"ln1": L.init_norm(cfg, f),
                             "ln2": L.init_norm(cfg, f)})
        if cfg.hybrid.layer_kind(j) == ATTN:
            block["attn"] = L.init_attention(cfg, f)
        else:
            block["mamba"].append(M.init_mamba(cfg, f))
        if uses_moe(cfg, j):
            block["moe"].append(MOE.init_moe(cfg, f))
        else:
            block["mlp"].append(L.init_mlp(cfg, f))
    return block


def n_blocks(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid.block_len


def _build(cfg: ModelConfig, f: L.ParamFactory) -> Dict[str, Any]:
    """The weights tree as nested dicts and lists, each leaf drawn by
    ``f`` in the reference's order."""
    d, v = cfg.d_model, cfg.vocab_size
    tree: Dict[str, Any] = {
        "embed": f.normal((v, d), ("vocab", "embed"), scale=1.0)}
    if cfg.frontend is not None:
        tree["frontend"] = {"w": f.normal((cfg.frontend.feature_dim, d),
                                          ("frontend_feature", "embed"))}
    if cfg.hybrid is not None:
        tree["blocks"] = [_init_block(cfg, f) for _ in range(n_blocks(cfg))]
    else:
        tree["layers"] = [_init_layer(cfg, f) for _ in range(cfg.n_layers)]
    tree["final_norm"] = L.init_norm(cfg, f)
    if not cfg.tie_embeddings:
        tree["lm_head"] = f.normal((v, d), ("vocab", "embed"))
    return tree


def init_params(cfg: ModelConfig, generator: Union[int, torch.Generator],
                *, device: str = "cuda") -> Params:
    """Random weights with the reference's distributions, drawn from
    ``generator`` (a seeded ``torch.Generator`` on ``device``, or a seed)
    in ``cfg.param_dtype``."""
    dev = require_device(device, "init_params")
    if isinstance(generator, int):
        seed, generator = generator, torch.Generator(device=dev)
        generator.manual_seed(seed)
    f = L.ParamFactory(generator, L.DTYPES[cfg.param_dtype], dev)
    return L.ParamTree(_build(cfg, f))


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The weights tree (nested dicts and lists, the layout of
    :func:`init_params`) with ``meta`` tensors as leaves: shapes and
    dtypes, nothing allocated."""
    return _build(cfg, L.MetaFactory(L.DTYPES[cfg.param_dtype]))


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of every leaf of :func:`param_shapes`, in the same
    structure. The reference stacks the layers (the hybrid's blocks, and
    within a block its layers of one kind) on leading ``"layers"`` axes
    (``"layers"``, ``"norm_pair"`` for the hybrid's norms); the port keeps
    a list of them, so its axes leave those names out."""
    return _build(cfg, L.AxesFactory())


def cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical-axis tree matching :func:`init_cache`'s structure. The
    cache is stacked on its leading layer (block) axes as in the
    reference, so these axes are the reference's."""
    kv = {"k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
          "v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim")}
    mamba = {"conv": ("batch", None, None),
             "state": ("batch", "mamba_heads", "head_dim", "state")}
    if cfg.hybrid is not None:
        return {"attn": kv, "mamba": {
            k: ("layers", "inner_layers", *a) for k, a in mamba.items()}}
    if cfg.family == "ssm":
        return {"mamba": {k: ("layers", *a) for k, a in mamba.items()}}
    return {"attn": kv}


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def _embed(params: Params, tokens: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    # F.embedding's backward sums repeated tokens in a fixed order on the
    # card (no atomics), so a microbatch's gradient is the same bits on
    # every run, as the runtime's exactly-once reduce needs. Training on
    # a mesh (the dry run) gathers the table's vocab axis first: DTensor
    # lays a lookup into a vocab-sharded table out as a MaskPartial and
    # cannot take its gradient from the Partial sums the first layer
    # returns
    table = params["embed"]
    if table.requires_grad:
        table = gather_dim(table, 0)
    return F.embedding(tokens.long(), table).to(dtype)


def _frontend(params: Params, feats: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """einsum("bsf,fd->bsd") of the features in the activation type."""
    return feats.to(dtype) @ params["frontend"]["w"].to(dtype)


def embed_inputs(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
                 dtype: torch.dtype) -> torch.Tensor:
    """The stack's input (b, s, d): audio frames projected, VLM patches
    projected ahead of the embedded text, token embeddings otherwise."""
    if cfg.family == "audio":
        h = _frontend(params, batch["feats"], dtype)
    else:
        h = _embed(params, batch["tokens"], dtype)
        if cfg.family == "vlm":
            h = torch.cat([_frontend(params, batch["feats"], dtype), h],
                          dim=1)
    return constrain(h, "batch", "seq", "embed")


def _lm_head(cfg: ModelConfig, params: Params, h: torch.Tensor
             ) -> torch.Tensor:
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return constrain(h @ w.to(h.dtype).T, "batch", "seq", "vocab")


def ffn(cfg: ModelConfig, p: Params, x: torch.Tensor, moe: bool):
    """The FFN slot: (out, MoE aux loss or None)."""
    if moe:
        return MOE.moe_block(cfg, p, x)
    return L.mlp_block(cfg, p, x), None


# ---------------------------------------------------------------------------
# Layers and blocks (training and prefill)
# ---------------------------------------------------------------------------
def _write_kv(kv_out: Dict[str, torch.Tensor], i: int,
              kv: Dict[str, torch.Tensor]) -> None:
    s = kv["k"].shape[1]
    kv_out["k"][i, :, :s] = kv["k"]
    kv_out["v"][i, :, :s] = kv["v"]


def _cast(p, dtype: Optional[torch.dtype]):
    return p if dtype is None else L.cast_tree(p, dtype)


def _layer(cfg, lp, h, positions, impl, cache, i, dtype=None):
    """One uniform layer; returns (h, aux or None) and writes its cache
    into layer ``i`` of ``cache`` when one is given. ``dtype``: the
    layer's weights are cast to it while it runs."""
    lp = _cast(lp, dtype)
    x = L.apply_norm(cfg, lp["ln1"], h)
    if cfg.family == "ssm":
        out, _ = M.mamba_block(
            cfg, lp["mixer"], x, impl=impl, return_state=cache is not None,
            out=None if cache is None
            else {name: t[i] for name, t in cache["mamba"].items()})
        return h + out, None
    out, kv = L.attention_block(cfg, lp["mixer"], x, positions=positions,
                                impl=impl)
    if cache is not None:
        _write_kv(cache["attn"], i, kv)
    h = h + out
    x2 = L.apply_norm(cfg, lp["ln2"], h)
    out, aux = ffn(cfg, lp["ffn"], x2, uses_moe(cfg, 0))
    return h + out, aux


def _block(cfg, bp, h, positions, impl, cache, i, dtype=None):
    """One hybrid block; returns (h, summed aux) and writes its attention
    KV and its Mamba layers' tails and states into block ``i`` of
    ``cache`` when one is given. ``dtype``: each layer's weights are cast
    to it while that layer runs (a block's MoE layers at once would not
    fit the card in float32)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    mi = nm = nl = 0
    for j in range(cfg.hybrid.block_len):
        lns = _cast(bp["lns"][j], dtype)
        x = L.apply_norm(cfg, lns["ln1"], h)
        if cfg.hybrid.layer_kind(j) == ATTN:
            out, kv = L.attention_block(cfg, _cast(bp["attn"], dtype), x,
                                        positions=positions, impl=impl)
            if cache is not None:
                _write_kv(cache["attn"], i, kv)
        else:
            out, _ = M.mamba_block(
                cfg, _cast(bp["mamba"][mi], dtype), x, impl=impl,
                return_state=cache is not None,
                out=None if cache is None
                else {n: t[i, mi] for n, t in cache["mamba"].items()})
            mi += 1
        h = h + out
        x2 = L.apply_norm(cfg, lns["ln2"], h)
        if uses_moe(cfg, j):
            out, a = ffn(cfg, _cast(bp["moe"][nm], dtype), x2, True)
            aux = aux + a
            nm += 1
        else:
            out, _ = ffn(cfg, _cast(bp["mlp"][nl], dtype), x2, False)
            nl += 1
        h = h + out
    return h, aux


# ---------------------------------------------------------------------------
# Forward (training and prefill)
# ---------------------------------------------------------------------------
REMAT = ("none", "full", "dots", "dots_no_batch")
_ATEN = torch.ops.aten
# The matrix products the "dots" policies save: the reference's
# dot_general, as the dispatcher sees it. ``x @ w`` of a 3-D activation
# and a weight that needs its gradient folds into ``mm``; an einsum, an
# unfolded ``matmul`` and the MoE's expert products reach ``bmm``.
_PRODUCTS = (_ATEN.mm, _ATEN.addmm, _ATEN.bmm, _ATEN.baddbmm)


def has_batch_dims(op, args) -> bool:
    """True where the product ``op(*args)`` has a batch dimension in the
    reference's sense: a ``bmm``/``baddbmm`` over more than one batch
    entry whose operands both step along it. A batch of one (an einsum
    without batch dimensions) or an operand broadcast along it (stride 0:
    ``matmul`` of an activation by a weight that it did not fold into
    ``mm``) is a product without one, as ``mm`` and ``addmm`` are."""
    if op.overloadpacket in (_ATEN.mm, _ATEN.addmm):
        return False
    a, b = args[-2:] if op.overloadpacket is _ATEN.baddbmm else args[:2]
    return a.shape[0] > 1 and a.stride(0) != 0 and b.stride(0) != 0


def dots_policy(remat: str):
    """The selective-checkpoint policy of ``"dots"`` (save every
    product's output) or ``"dots_no_batch"`` (save those without a batch
    dimension); every other op is recomputed."""
    batched_too = remat == "dots"

    def policy(ctx, op, *args, **kwargs):
        if op.overloadpacket in _PRODUCTS and (
                batched_too or not has_batch_dims(op, args)):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def check_remat(remat: str) -> None:
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r}: expected one of {REMAT}")


def _remat_kwargs(remat: str) -> Dict[str, Any]:
    """``checkpoint``'s options for a policy other than ``"none"``."""
    kw: Dict[str, Any] = {"use_reentrant": False}
    if remat != "full":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, dots_policy(remat))
    return kw


def _forward(cfg, params, batch, impl, cache=None, compute_dtype=None,
             last_only=False, remat="none"):
    """(logits, aux) of the stack; writes each unit's cache into
    ``cache`` (the layout of :func:`init_cache`) when one is given."""
    check_remat(remat)
    dtype = compute_dtype or L.DTYPES[cfg.activation_dtype]
    h = embed_inputs(cfg, params, batch, dtype)
    positions = torch.arange(h.shape[1], device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.hybrid is not None:
        units, run = params["blocks"], _block
    else:
        units, run = params["layers"], _layer
    for i, up in enumerate(units):
        if remat != "none":
            h, a = checkpoint(run, cfg, up, h, positions, impl, cache, i,
                              compute_dtype, **_remat_kwargs(remat))
        else:
            h, a = run(cfg, up, h, positions, impl, cache, i, compute_dtype)
        if a is not None:
            aux = aux + a
    if last_only:
        h = h[:, -1:]
    h = L.apply_norm(cfg, _cast(params["final_norm"], compute_dtype), h)
    return _lm_head(cfg, params, h), aux


def _positions(cfg: ModelConfig, batch: Dict[str, Any]) -> Tuple[int, int]:
    """(batch, sequence positions) of a batch: VLM patches and text
    together."""
    if cfg.family == "audio":
        return batch["feats"].shape[:2]
    b, s = batch["tokens"].shape
    if cfg.family == "vlm":
        s += batch["feats"].shape[1]
    return b, s


def _device(cfg: ModelConfig, batch: Dict[str, Any]) -> torch.device:
    return batch["feats" if cfg.family == "audio" else "tokens"].device


def forward(
    cfg: ModelConfig,
    params: Params,
    batch: Dict[str, Any],
    *,
    impl: str = "kernel",
    remat: str = "none",
    collect_cache: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    last_only: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (logits (b, s, v), the MoE aux loss summed over layers (0
    without MoE), caches|None). ``batch`` holds ``tokens`` (b, s) int32,
    or for audio ``feats`` (b, s, feature_dim), or for vlm both (patch
    features (b, n_prefix, feature_dim) ahead of the text). Caches are
    laid out as the reference's: {'k', 'v'}, each (layers, b, s,
    kv_heads, hd); for ssm {'conv', 'state'}; for hybrid {'attn': {'k',
    'v'} (blocks, ...), 'mamba': {'conv', 'state'} (blocks, block_len -
    1, ...)}. ``remat`` is one of :data:`REMAT`.

    Two options the reference lacks serve a reference run at full width:
    ``compute_dtype`` runs the activations in that type and casts each
    layer's weights to it only while the layer runs (an f32 reference of
    a bf16 model without an f32 copy of the weights), and ``last_only``
    computes the head for the last position only (logits (b, 1, v))."""
    cache = None
    if collect_cache:
        b, s = _positions(cfg, batch)
        cache = _cache(cfg, b, s, _device(cfg, batch))
    logits, aux = _forward(cfg, params, batch, impl, cache, compute_dtype,
                           last_only, remat)
    return logits, aux, None if cache is None else _collected(cfg, cache)


def _collected(cfg: ModelConfig, cache: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's ``forward`` caches of a decode cache."""
    if cfg.hybrid is not None:
        return cache
    return cache["mamba"] if cfg.family == "ssm" else cache["attn"]


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            max_len: Optional[int] = None, impl: str = "kernel"):
    """Run the prompt (``batch`` as :func:`forward` takes it) through the
    model; returns (last-position logits, cache).

    The cache is allocated once (a KV cache at ``max_len``; the Mamba
    layers' conv tails and states, which do not grow) and each layer
    writes into it as it runs, where the reference stacks the layers'
    caches and then pads a KV cache out (``_pad_kv``): one copy of the
    cache, not three. B10 writes each layer's final state straight into
    its slice. The head runs for the last position only (the reference
    computes every position's logits and keeps the last)."""
    b, s = _positions(cfg, batch)
    cache = _cache(cfg, b, max(max_len or s, s), _device(cfg, batch))
    logits, _ = _forward(cfg, params, batch, impl, cache, last_only=True)
    return logits[:, -1], cache


def _cache(cfg: ModelConfig, batch: int, max_len: int,
           device: Union[str, torch.device]) -> Dict[str, Any]:
    dtype = L.DTYPES[cfg.activation_dtype]

    def kv(n):
        shape = (n, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim())
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def mamba(*lead):
        layer = M.init_mamba_cache(cfg, batch, dtype, device=device)
        return {name: t.new_zeros((*lead, *t.shape))
                for name, t in layer.items()}

    if cfg.hybrid is not None:
        nb = n_blocks(cfg)
        cache = {"attn": kv(nb),
                 "mamba": mamba(nb, cfg.hybrid.block_len - 1)}
    elif cfg.family == "ssm":
        cache = {"mamba": mamba(cfg.n_layers)}
    else:
        cache = {"attn": kv(cfg.n_layers)}
    # on a mesh (the dry run) each leaf is laid out by its logical axes
    return tree_map_axes(lambda axes, t: lay_out(t, *axes),
                         cache_axes(cfg), cache)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: Union[str, torch.device] = "cuda"
               ) -> Dict[str, Any]:
    """Zero-filled decode cache: {'attn': {'k', 'v'}}, each (layers,
    batch, max_len, kv_heads, head_dim) in the activation type; for ssm
    {'mamba': {'conv': (layers, batch, k-1, conv_dim) in the activation
    type, 'state': (layers, batch, heads, head_dim, d_state) float32}}
    (``max_len`` unused); for hybrid both, the KV cache per block and the
    Mamba leaves (blocks, block_len - 1, ...). Raises for encoder-only
    configurations."""
    _no_decode(cfg, "init_cache")
    return _cache(cfg, batch, max_len, device)


def _decode_layer(cfg, lp, h, cache, i, pos, impl):
    x = L.apply_norm(cfg, lp["ln1"], h)
    if cfg.family == "ssm":
        lc = {name: t[i] for name, t in cache["mamba"].items()}
        out, _ = M.mamba_decode(cfg, lp["mixer"], x, lc)
        return h + out
    lc = {name: t[i] for name, t in cache["attn"].items()}
    out, _ = L.attention_decode(cfg, lp["mixer"], x, lc, pos, impl=impl)
    h = h + out
    x2 = L.apply_norm(cfg, lp["ln2"], h)
    return h + ffn(cfg, lp["ffn"], x2, uses_moe(cfg, 0))[0]


def _decode_block(cfg, bp, h, cache, i, pos, impl):
    mi = nm = nl = 0
    for j in range(cfg.hybrid.block_len):
        lns = bp["lns"][j]
        x = L.apply_norm(cfg, lns["ln1"], h)
        if cfg.hybrid.layer_kind(j) == ATTN:
            lc = {name: t[i] for name, t in cache["attn"].items()}
            out, _ = L.attention_decode(cfg, bp["attn"], x, lc, pos,
                                        impl=impl)
        else:
            mc = {name: t[i, mi] for name, t in cache["mamba"].items()}
            out, _ = M.mamba_decode(cfg, bp["mamba"][mi], x, mc)
            mi += 1
        h = h + out
        x2 = L.apply_norm(cfg, lns["ln2"], h)
        if uses_moe(cfg, j):
            h = h + ffn(cfg, bp["moe"][nm], x2, True)[0]
            nm += 1
        else:
            h = h + ffn(cfg, bp["mlp"][nl], x2, False)[0]
            nl += 1
    return h


@torch.no_grad()
def decode_step(
    cfg: ModelConfig,
    params: Params,
    cache: Dict[str, Any],
    tokens: torch.Tensor,   # (b,) int32
    pos: torch.Tensor,      # (b,) int32 current write position
    *,
    impl: str = "kernel",
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token for every sequence in the batch. Returns (logits (b, v),
    cache). The port writes the token's K/V (Mamba layers: the conv
    window and the state) into ``cache`` in place (the reference returns
    an updated copy); the returned cache is the same object. ``pos`` is
    unused by the ssm stack. Raises for encoder-only configurations."""
    _no_decode(cfg, "decode_step")
    h = _embed(params, tokens, L.DTYPES[cfg.activation_dtype])[:, None]
    h = constrain(h, "batch", "seq", "embed")
    if cfg.hybrid is not None:
        for i, bp in enumerate(params["blocks"]):
            h = _decode_block(cfg, bp, h, cache, i, pos, impl)
    else:
        for i, lp in enumerate(params["layers"]):
            h = _decode_layer(cfg, lp, h, cache, i, pos, impl)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return _lm_head(cfg, params, h)[:, 0], cache
