"""Error-feedback int8 gradient compression, the reference's
``repro/optim/compress.py``: quantize each gradient to int8 with a
per-tensor scale and carry the quantization residual into the next step.
Trees are dicts ``{path: tensor}``.

The reference's tensors are its stacked leaves: one ``layers/mixer/wq``
of shape (n_layers, ...) for all layers, with one scale. The port keeps
one leaf per layer (``layers/<i>/mixer/wq``), so :func:`error_feedback_step`
gives the layers of one stacked leaf one shared scale, the largest over
them, as the reference does.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import torch

Tree = Mapping[str, torch.Tensor]
_LAYER = re.compile(r"^layers/\d+/")


def ef_state_init(params: Tree) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def ef_int8_compress(g: torch.Tensor, peak: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, scale) of ``g``; the scale is ``max|g| / 127``, or
    ``peak / 127`` when the tensor's scale is shared with others."""
    gf = g.float()
    if peak is None:
        peak = gf.abs().max()
    scale = torch.clamp(peak, min=1e-30) / 127.0
    # torch.round, as jnp.round, rounds half to even
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def error_feedback_step(grads: Tree, ef_state: Tree
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """Returns (compressed-then-decompressed grads, new ef_state)."""
    corrected = {k: g.float() + ef_state[k] for k, g in grads.items()}
    peaks: Dict[str, torch.Tensor] = {}
    for k, c in corrected.items():
        stacked = _LAYER.sub("layers/", k)
        m = c.abs().max()
        peaks[stacked] = m if stacked not in peaks else \
            torch.maximum(peaks[stacked], m)
    new_g, new_e = {}, {}
    for k, c in corrected.items():
        q, s = ef_int8_compress(c, peaks[_LAYER.sub("layers/", k)])
        deq = ef_int8_decompress(q, s)
        new_g[k] = deq.to(grads[k].dtype)
        new_e[k] = c - deq
    return new_g, new_e
