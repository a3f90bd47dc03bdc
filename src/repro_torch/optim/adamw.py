"""AdamW as plain functions on dicts of tensors, the reference's
``repro/optim/adamw.py`` line for line: moments in float32 whatever the
parameters' type, bf16 parameters updated through a float32 round trip
(no float32 master copy), a global-norm clip accumulated in float32, and
the bias corrections of the step count.

``torch.optim.AdamW`` is not used: its order of operations and its
decoupled decay differ from the reference's ``pf - lr·(step + wd·pf)``.

The update is out of place: ``adamw_update`` returns new tensors and
writes none of its inputs, because the live runtime's hosts still hold
the previous parameters, and a straggling attempt may still read them.

Trees are dicts ``{path: tensor}`` with one key order
(:func:`repro_torch.models.layers.tree_leaves`); grads, parameters and
both moments share it.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple, Union

import torch

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


@torch.no_grad()
def adamw_update(
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
) -> Tuple[Dict[str, torch.Tensor], OptState, Dict[str, torch.Tensor]]:
    """Returns (new params, new state, {"grad_norm", "lr"})."""
    count = state["count"] + 1
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

    # Each leaf's float32 temporaries are dropped as soon as they are
    # used (the same operations in the same order): the new moments sit
    # beside the old ones, so at the last of a large model's leaves the
    # card holds little else (a 163,840-entry head is 1.34 GB a copy).
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        gf = grads[k].float() * clip
        m_new = b1 * state["m"][k] + (1.0 - b1) * gf
        v_new = b2 * state["v"][k] + (1.0 - b2) * gf.square()
        del gf
        step = (m_new / bc1) / ((v_new / bc2).sqrt() + eps)
        pf = p.float()
        pf = pf - lr_t * (step + weight_decay * pf)
        del step
        new_p[k] = pf.to(p.dtype)
        del pf
        new_m[k] = m_new
        new_v[k] = v_new
    metrics = {"grad_norm": gnorm, "lr": lr_t}
    return new_p, {"m": new_m, "v": new_v, "count": count}, metrics
