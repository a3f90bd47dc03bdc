"""AdamW as plain functions on dicts of tensors, the reference's
``repro/optim/adamw.py`` line for line: moments in float32 whatever the
parameters' type, bf16 parameters updated through a float32 round trip
(no float32 master copy), a global-norm clip accumulated in float32, and
the bias corrections of the step count.

``torch.optim.AdamW`` is not used: its order of operations and its
decoupled decay differ from the reference's ``pf - lr·(step + wd·pf)``.

``adamw_update_`` updates in place (the reference's train step jitted
with ``donate_argnums``): each leaf's new moments and weights are
written into the given tensors' storage. ``adamw_update`` runs it on
copies and writes none of its inputs, because the live runtime's hosts
still hold the previous parameters, and a straggling attempt may still
read them; the two give the same bits by construction.

Trees are dicts ``{path: tensor}`` with one key order
(:func:`repro_torch.models.layers.tree_leaves`); grads, parameters and
both moments share it.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple, Union

import torch

from repro_torch.parallel.sharding import is_dtensor

Tree = Mapping[str, torch.Tensor]
OptState = Dict[str, object]


def adamw_init(params: Tree) -> OptState:
    """Zero float32 moments beside each parameter and a zero count."""
    first = next(iter(params.values()))
    return {
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def adamw_update(grads: Tree, state: OptState, params: Tree, **hyper
                 ) -> Tuple[Dict[str, torch.Tensor], OptState,
                            Dict[str, torch.Tensor]]:
    """Returns (new params, new state, {"grad_norm", "lr"}):
    :func:`adamw_update_` (with its keywords ``hyper``) on copies of the
    weights, the moments and the count, so no input is written."""
    new_p = {k: p.detach().clone() for k, p in params.items()}
    new_state = {"m": {k: t.clone() for k, t in state["m"].items()},
                 "v": {k: t.clone() for k, t in state["v"].items()},
                 "count": state["count"].clone()}
    metrics = adamw_update_(grads, new_state, new_p, **hyper)
    return new_p, new_state, metrics


@torch.no_grad()
def adamw_update_(
    grads: Tree,
    state: OptState,
    params: Tree,
    *,
    lr: Union[float, torch.Tensor, Callable[[torch.Tensor], torch.Tensor]],
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip_norm: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """The count, each leaf's moments in ``state`` and each parameter of
    ``params`` are overwritten, leaf by leaf. Returns {"grad_norm",
    "lr"}.

    Every product, sum and quotient is its own op, as in the reference
    (``b1·m + (1-b1)·g`` is a ``mul_``, a ``mul`` and an ``add_``, never
    one ``addcmul_`` or ``add_(alpha=)``, which the card may contract to
    a fused multiply-add). Each leaf's float32 temporaries are dropped as
    soon as they are used: at the last of a large model's leaves the
    card holds little else (a 163,840-entry head is 1.34 GB a copy). On a
    mesh a gradient may be a partial sum: it is reduced once, onto its
    moment's layout, before its two uses."""
    count = state["count"].add_(1)
    if callable(lr):
        lr_t = lr(count)
    else:
        lr_t = torch.as_tensor(lr, dtype=torch.float32, device=count.device)

    # global-norm clip (fp32 accumulation)
    gsq = sum(g.float().square().sum() for g in grads.values())
    gnorm = torch.sqrt(gsq)
    clip = torch.clamp(grad_clip_norm / (gnorm + 1e-12), max=1.0)

    bc1 = 1.0 - b1 ** count.float()
    bc2 = 1.0 - b2 ** count.float()
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        gf = grads[k].float() * clip
        if is_dtensor(gf):
            gf = gf.redistribute(m.device_mesh, m.placements)
        m.mul_(b1).add_((1.0 - b1) * gf)
        v.mul_(b2).add_(gf.square().mul_(1.0 - b2))
        del gf
        step = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        pf = p.float()
        step.add_(weight_decay * pf).mul_(lr_t)
        if p.dtype == torch.float32:     # pf is p itself
            p.sub_(step)
        else:
            p.copy_(pf.sub_(step))
        del step, pf
    return {"grad_norm": gnorm, "lr": lr_t}
