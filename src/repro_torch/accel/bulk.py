"""Bulk-launch network solver backends (DESIGN.md §17.2).

The ε-fair model's per-drain work factors into two dense steps over the
columnar flow/link tables:

- ``waterfill(eff, links, valid)`` — the ε-fair max-min solve: per-link
  equilibrium shares plus per-flow rates (the §15.3 water-fill, also
  inlined in ``FairNetwork._recompute``);
- ``price(share, links, valid)`` — batch pricing: the frozen-rate rule
  ``max(min(share[links]), 1)`` for a *batch* of flows at once (used by
  the drain-boundary re-allocation of in-flight transfers, §17.4).

Two implementations ship behind one protocol:

- ``numpy`` — the bit-exact host reference (the solver loop, verbatim);
- ``torch`` — :class:`TorchBulk`: the water-fill rounds as eager torch
  ops on the backend's device, and the pricing step as kernel B5
  (``csrc/bulk.cu``) on a CUDA device or its plain version
  :func:`price_ref` on the CPU. Both are bit-identical to numpy.

``get_bulk_backend(None)`` is ``torch`` on the CUDA card: without a card
it raises rather than fall back to the CPU. CPU runs name their backend:
``"numpy"`` or ``TorchBulk("cpu")``.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.accel import kernels as K
from repro_torch.accel.torch_backend import on_cpu, require_device

BULK_BACKENDS = ("numpy", "torch")

F64 = torch.float64


class BulkBackend:
    """One drain's dense network math. Stateless w.r.t. the flow tables;
    may cache padded device buffers internally."""

    name: str = "?"

    def waterfill(self, eff: np.ndarray, links: np.ndarray,
                  valid: np.ndarray, eps: float
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """ε-fair max-min solve over ``k`` flows and ``nL`` links.

        ``eff`` (nL,) effective link capacities; ``links`` (k, 4) int
        link ids, -1 padded; ``valid = links >= 0``. Returns
        ``(share, rate)``: per-link equilibrium shares (never-bottleneck
        links expose residual headroom) and per-flow equilibrium rates.
        """
        raise NotImplementedError

    def price(self, share: np.ndarray, links: np.ndarray,
              valid: np.ndarray) -> np.ndarray:
        """Frozen-rate batch pricing: per-flow ``max(min(share[links
        over valid]), 1.0)`` — the launch rule applied to many flows in
        one step."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# numpy — bit-exact reference
# ---------------------------------------------------------------------------
class NumpyBulk(BulkBackend):
    name = "numpy"

    def waterfill(self, eff, links, valid, eps):
        nL = len(eff)
        k = len(links)
        share = eff.copy()
        rate = np.zeros(k)
        if not k:
            return share, rate
        flat_links = np.where(valid, links, 0)
        rem = eff.copy()
        alive = valid.any(axis=1)
        was_bott = np.zeros(nL, dtype=bool)
        eps1 = 1.0 + eps
        while True:
            a_links = flat_links[alive][valid[alive]]
            if not len(a_links):
                break
            cnt = np.bincount(a_links, minlength=nL)
            live = cnt > 0
            s_all = np.where(live, rem / np.maximum(cnt, 1), np.inf)
            s = float(s_all.min())
            bott = live & (s_all <= s * eps1)
            hit = alive & (bott[flat_links] & valid).any(axis=1)
            rate[hit] = s
            h_links = flat_links[hit][valid[hit]]
            rem = np.maximum(
                rem - np.bincount(h_links, minlength=nL) * s, 0.0)
            share[bott] = s
            was_bott |= bott
            alive &= ~hit
        free = ~was_bott
        share[free] = rem[free]
        return share, rate

    def price(self, share, links, valid):
        if not len(links):
            return np.zeros(0)
        per = np.where(valid, share[np.where(valid, links, 0)], np.inf)
        return np.maximum(per.min(axis=1), 1.0)


# ---------------------------------------------------------------------------
# torch — eager water-fill rounds + kernel B5
# ---------------------------------------------------------------------------
def price_ref(share: torch.Tensor, links: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Plain version of B5: (cap,) ``max(min(share[links] over valid
    links), 1.0)``, +inf for rows with no valid link."""
    per = torch.where(valid, share[links.clamp_min(0).long()], torch.inf)
    return per.amin(1).clamp_min(1.0)


def price(share: torch.Tensor, links: torch.Tensor,
          valid: torch.Tensor) -> torch.Tensor:
    """B5 on CUDA tensors, its plain version on CPU tensors; raises for
    anything else (no fallback)."""
    if on_cpu(share, links, valid):
        return price_ref(share, links, valid)
    return K.launch_price(share, links, valid)


def pad_flows(links: np.ndarray, valid: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """A pricing call's (cap, 4) int32 link ids and flags, ``cap`` the
    next power of two of the flow count, at least 16 (the reference's
    padding); pad rows and invalid slots hold link 0, flagged invalid."""
    k = len(links)
    cap = 16
    while cap < k:
        cap *= 2
    L = np.zeros((cap, 4), dtype=np.int32)
    V = np.zeros((cap, 4), dtype=bool)
    L[:k] = np.where(valid, links, 0)
    V[:k] = valid
    return L, V


class TorchBulk(BulkBackend):
    """The bulk solver on a torch device. ``device="cuda"`` (the default,
    also what ``get_bulk_backend(None)`` builds) raises if no card is
    present; ``device="cpu"`` runs the plain versions.

    ``waterfill`` runs the rounds of :meth:`NumpyBulk.waterfill` as torch
    ops on the device, bit-identical to it: per-round link counts are
    scatter-adds of exact small integers, ``cnt * s`` is rounded as its
    own op before the subtraction (no fused multiply-add: eager torch
    runs each op as its own kernel), and the division and the minima are
    IEEE-exact. Each round costs one host read of ``alive.any()``;
    :attr:`n_calls` and :attr:`n_rounds` count them."""

    name = "torch"

    def __init__(self, device: str = "cuda") -> None:
        self.device = require_device(device, "TorchBulk")
        self.n_calls = 0        # water-fill solves
        self.n_rounds = 0       # water-fill rounds (one host sync each)
        self.n_prices = 0       # pricing calls

    def _t(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def waterfill(self, eff, links, valid, eps):
        k = len(links)
        if not k:
            return eff.copy(), np.zeros(0)
        self.n_calls += 1
        nL = len(eff)
        eff_t = self._t(np.asarray(eff, dtype=np.float64))
        V = self._t(np.asarray(valid, dtype=bool))
        L = self._t(np.where(valid, links, 0).astype(np.int64))
        Lf = L.reshape(-1)
        share = eff_t.clone()
        rem = eff_t.clone()
        rate = torch.zeros(k, dtype=F64, device=self.device)
        alive = V.any(dim=1)
        was_bott = torch.zeros(nL, dtype=torch.bool, device=self.device)
        eps1 = 1.0 + eps

        def counts(rows):
            w = (rows[:, None] & V).reshape(-1).to(F64)
            return torch.zeros(nL, dtype=F64, device=self.device) \
                .scatter_add_(0, Lf, w)

        while bool(alive.any()):
            self.n_rounds += 1
            cnt = counts(alive)
            live = cnt > 0
            s_all = torch.where(live, rem / torch.clamp_min(cnt, 1.0),
                                torch.inf)
            s = s_all.min()
            bott = live & (s_all <= s * eps1)
            hit = alive & (bott[L] & V).any(dim=1)
            rate = torch.where(hit, s, rate)
            dec = counts(hit) * s
            rem = torch.clamp_min(rem - dec, 0.0)
            share = torch.where(bott, s, share)
            was_bott |= bott
            alive &= ~hit
        share = torch.where(was_bott, share, rem)
        return share.cpu().numpy(), rate.cpu().numpy()

    def price(self, share, links, valid):
        k = len(links)
        if not k:
            return np.zeros(0)
        self.n_prices += 1
        L, V = pad_flows(links, valid)
        out = price(self._t(np.asarray(share, dtype=np.float64)),
                    self._t(L), self._t(V))
        return out[:k].cpu().numpy()


def get_bulk_backend(spec: Union[str, BulkBackend, None]) -> BulkBackend:
    """Resolve a bulk backend name (or pass an instance through). ``None``
    and ``"torch"`` build :class:`TorchBulk` on the CUDA card, which
    raises when no card is present."""
    if isinstance(spec, BulkBackend):
        return spec
    name = (spec or "torch").lower()
    if name == "numpy":
        return NumpyBulk()
    if name == "torch":
        return TorchBulk("cuda")
    raise ValueError(
        f"unknown bulk backend {spec!r}; expected one of {BULK_BACKENDS}")


__all__ = ["BULK_BACKENDS", "BulkBackend", "NumpyBulk", "TorchBulk",
           "get_bulk_backend", "pad_flows", "price", "price_ref"]
