"""Model builder: the dense decoder stack of the reference's
``repro/models/model.py``, for serving.

``init_params`` materializes a :class:`~repro_torch.models.layers.ParamTree`
(the reference's parameter layout, one sub-tree per layer in a
``ModuleList`` where the reference stacks layers on a leading axis);
``forward``, ``prefill``, ``init_cache`` and ``decode_step`` keep the
reference's signatures and layouts, with ``impl="kernel"`` as the port's
default: attention goes through kernel B6 (prefill) and B9 (decode) on
CUDA tensors and through their plain versions on CPU tensors.
``impl="ref"`` selects the oracles. The reference's ``lax.scan`` over
stacked layers is a Python loop here, so its ``unroll`` knob has no
counterpart. ``forward`` is differentiable (training builds the weights
with ``ParamTree(..., trainable=True)``); its ``remat="full"`` recomputes
each layer in the backward, one ``torch.utils.checkpoint`` per layer, the
counterpart of the reference's ``nothing_saveable`` policy. The
``"dots"`` policies and the ``param_shapes``/``param_axes`` trees wait for
later slices and raise.

Only ``family == "dense"`` is ported. The moe, ssm, hybrid, audio and vlm
families raise until their slices (ROADMAP Queue A).

Entry points run on the CUDA card unless the caller passes a CPU device
(``init_params(..., device="cpu")``); tensors then stay where the
weights are.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.accel.torch_backend import require_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = L.ParamTree


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family!r} family is not ported yet; "
            f"only the dense stack is (see ROADMAP.md Queue A)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_layer(cfg: ModelConfig, f: L.ParamFactory) -> Dict[str, Any]:
    return {"ln1": L.init_norm(cfg, f), "mixer": L.init_attention(cfg, f),
            "ln2": L.init_norm(cfg, f), "ffn": L.init_mlp(cfg, f)}


def init_params(cfg: ModelConfig, generator: Union[int, torch.Generator],
                *, device: str = "cuda") -> Params:
    """Random weights with the reference's distributions, drawn from
    ``generator`` (a seeded ``torch.Generator`` on ``device``, or a seed)
    in ``cfg.param_dtype``."""
    check_family(cfg)
    dev = require_device(device, "init_params")
    if isinstance(generator, int):
        seed, generator = generator, torch.Generator(device=dev)
        generator.manual_seed(seed)
    f = L.ParamFactory(generator, L.DTYPES[cfg.param_dtype], dev)
    d, v = cfg.d_model, cfg.vocab_size
    tree: Dict[str, Any] = {"embed": f.normal((v, d), scale=1.0)}
    tree["layers"] = [_init_layer(cfg, f) for _ in range(cfg.n_layers)]
    tree["final_norm"] = L.init_norm(cfg, f)
    if not cfg.tie_embeddings:
        tree["lm_head"] = f.normal((v, d))
    return L.ParamTree(tree)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def _embed(params: Params, tokens: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    # F.embedding's backward sums repeated tokens in a fixed order on the
    # card (no atomics), so a microbatch's gradient is the same bits on
    # every run, as the runtime's exactly-once reduce needs
    return F.embedding(tokens.long(), params["embed"]).to(dtype)


def _lm_head(cfg: ModelConfig, params: Params, h: torch.Tensor
             ) -> torch.Tensor:
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype).T


def _layer(cfg, lp, h, positions, impl, kv_out, i):
    x = L.apply_norm(cfg, lp["ln1"], h)
    out, kv = L.attention_block(cfg, lp["mixer"], x, positions=positions,
                                impl=impl)
    if kv_out is not None:
        s = h.shape[1]
        kv_out["k"][i, :, :s] = kv["k"]
        kv_out["v"][i, :, :s] = kv["v"]
    h = h + out
    x2 = L.apply_norm(cfg, lp["ln2"], h)
    return h + L.mlp_block(cfg, lp["ffn"], x2)


# ---------------------------------------------------------------------------
# Forward (training and prefill)
# ---------------------------------------------------------------------------
REMAT = ("none", "full")


def check_remat(remat: str) -> None:
    if remat in ("dots", "dots_no_batch"):
        raise NotImplementedError(
            f"remat={remat!r} is not ported yet; 'none' and 'full' are "
            f"(see ROADMAP.md)")
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r}: expected one of {REMAT}")


def _forward(cfg, params, tokens, impl, kv_out=None, compute_dtype=None,
             last_only=False, remat="none"):
    check_family(cfg)
    check_remat(remat)
    dtype = compute_dtype or L.DTYPES[cfg.activation_dtype]
    h = _embed(params, tokens, dtype)
    positions = torch.arange(h.shape[1], device=h.device)
    for i, lp in enumerate(params["layers"]):
        if compute_dtype is not None:
            lp = L.cast_tree(lp, compute_dtype)
        if remat == "full":
            h = checkpoint(_layer, cfg, lp, h, positions, impl, kv_out, i,
                           use_reentrant=False)
        else:
            h = _layer(cfg, lp, h, positions, impl, kv_out, i)
    if last_only:
        h = h[:, -1:]
    final = params["final_norm"]
    if compute_dtype is not None:
        final = L.cast_tree(final, compute_dtype)
    h = L.apply_norm(cfg, final, h)
    return _lm_head(cfg, params, h)


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
    """Returns (logits (b, s, v), moe_aux_loss (0: dense), caches|None);
    caches are {'k', 'v'}, each (layers, b, s, kv_heads, hd). ``remat``
    is ``"none"`` or ``"full"`` (each layer recomputed in the backward).

    Two options the reference lacks serve a reference run at full width:
    ``compute_dtype`` runs the activations in that type and casts each
    layer's weights to it only while the layer runs (an f32 reference of
    a bf16 model without an f32 copy of the weights), and ``last_only``
    computes the head for the last position only (logits (b, 1, v))."""
    tokens = batch["tokens"]
    kv = None
    if collect_cache:
        kv = init_cache(cfg, tokens.shape[0], tokens.shape[1],
                        device=tokens.device)["attn"]
    logits = _forward(cfg, params, tokens, impl, kv, compute_dtype,
                      last_only, remat)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, aux, kv


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            max_len: Optional[int] = None, impl: str = "kernel"):
    """Run the prompt through the model; returns (last-token logits,
    cache).

    The KV cache is allocated once at ``max_len`` and each layer writes
    its K/V into it as it runs, where the reference stacks the layers'
    K/V and then pads them out (``_pad_kv``): one copy of the cache, not
    three."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = init_cache(cfg, b, max(max_len or s, s), device=tokens.device)
    logits = _forward(cfg, params, tokens, impl, cache["attn"])
    return logits[:, -1], cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: Union[str, torch.device] = "cuda"
               ) -> Dict[str, Any]:
    """Zero-filled decode cache: {'attn': {'k', 'v'}}, each (layers,
    batch, max_len, kv_heads, head_dim) in the activation type."""
    check_family(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim())
    dtype = L.DTYPES[cfg.activation_dtype]
    return {"attn": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}}


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
    cache). The port writes the token's K/V into ``cache`` in place (the
    reference returns an updated copy); the returned cache is the same
    object."""
    check_family(cfg)
    h = _embed(params, tokens, L.DTYPES[cfg.activation_dtype])[:, None]
    kv = cache["attn"]
    for i, lp in enumerate(params["layers"]):
        x = L.apply_norm(cfg, lp["ln1"], h)
        out, _ = L.attention_decode(
            cfg, lp["mixer"], x, {"k": kv["k"][i], "v": kv["v"][i]}, pos,
            impl=impl)
        h = h + out
        x2 = L.apply_norm(cfg, lp["ln2"], h)
        h = h + L.mlp_block(cfg, lp["ffn"], x2)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return _lm_head(cfg, params, h)[:, 0], cache
