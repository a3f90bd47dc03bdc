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
- ``torch`` — :class:`TorchBulk`: on a CUDA device the water-fill as one
  launch of its kernel (every round in one block) and the pricing step as
  kernel B5, both in ``csrc/bulk.cu``, with the solved shares kept on the
  device for the pricing call that follows; on the CPU their plain
  versions :func:`waterfill_ref` (the rounds as eager torch ops) and
  :func:`price_ref`. All are bit-identical to numpy.

``get_bulk_backend(None)`` is ``torch`` on the CUDA card: without a card
it raises rather than fall back to the CPU. CPU runs name their backend:
``"numpy"`` or ``TorchBulk("cpu")``.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.accel import kernels as K
from repro_torch.accel.torch_backend import on_cpu, require_device

BULK_BACKENDS = ("numpy", "torch")

F64 = torch.float64
# numpy's dtype of each torch dtype the staging buffers hold
_NUMPY = {torch.float64: np.float64, torch.int32: np.int32,
          torch.bool: np.bool_}


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
    """:attr:`n_calls` counts solves and :attr:`n_rounds` their rounds."""

    name = "numpy"
    n_calls = 0
    n_rounds = 0

    def waterfill(self, eff, links, valid, eps):
        nL = len(eff)
        k = len(links)
        share = eff.copy()
        rate = np.zeros(k)
        if not k:
            return share, rate
        self.n_calls += 1
        flat_links = np.where(valid, links, 0)
        rem = eff.copy()
        alive = valid.any(axis=1)
        was_bott = np.zeros(nL, dtype=bool)
        eps1 = 1.0 + eps
        while True:
            a_links = flat_links[alive][valid[alive]]
            if not len(a_links):
                break
            self.n_rounds += 1
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
# torch — the water-fill kernel + kernel B5
# ---------------------------------------------------------------------------
def waterfill_ref(eff: torch.Tensor, links: torch.Tensor,
                  valid: torch.Tensor, eps: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Plain version of the water-fill kernel: the rounds of
    :meth:`NumpyBulk.waterfill` as eager torch ops on the tensors'
    device, bit-identical to it — per-round link counts are scatter-adds
    of exact small integers, ``cnt * s`` is rounded as its own op before
    the subtraction (no fused multiply-add: eager torch runs each op as
    its own kernel), and the division and the minima are IEEE-exact.
    ``eff`` (nL,) float64, ``links`` (k, 4) int32, ``valid`` (k, 4)
    bool. Returns ``(share, rate, rounds)``; each round reads
    ``alive.any()`` on the host."""
    nL, k = eff.shape[0], links.shape[0]
    dev = eff.device
    L = torch.where(valid, links, 0).long()
    Lf = L.reshape(-1)
    share = eff.clone()
    rem = eff.clone()
    rate = torch.zeros(k, dtype=F64, device=dev)
    alive = valid.any(dim=1)
    was_bott = torch.zeros(nL, dtype=torch.bool, device=dev)
    eps1 = 1.0 + eps

    def counts(rows):
        w = (rows[:, None] & valid).reshape(-1).to(F64)
        return torch.zeros(nL, dtype=F64, device=dev).scatter_add_(0, Lf, w)

    rounds = 0
    while bool(alive.any()):
        rounds += 1
        cnt = counts(alive)
        live = cnt > 0
        s_all = torch.where(live, rem / torch.clamp_min(cnt, 1.0),
                            torch.inf)
        s = s_all.min()
        bott = live & (s_all <= s * eps1)
        hit = alive & (bott[L] & valid).any(dim=1)
        rate = torch.where(hit, s, rate)
        dec = counts(hit) * s
        rem = torch.clamp_min(rem - dec, 0.0)
        share = torch.where(bott, s, share)
        was_bott |= bott
        alive &= ~hit
    share = torch.where(was_bott, share, rem)
    return share, rate, rounds


def waterfill(eff: torch.Tensor, links: torch.Tensor, valid: torch.Tensor,
              eps: float) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The water-fill kernel on CUDA tensors (one launch, then one host
    read of its round count and status, which raises on an error), its
    plain version on CPU tensors; raises for anything else (no
    fallback). Returns ``(share, rate, rounds)``."""
    if on_cpu(eff, links, valid):
        return waterfill_ref(eff, links, valid, eps)
    out = K.launch_waterfill(eff, links, valid, eps)
    info, share, rate = K.waterfill_views(out, eff.shape[0],
                                          links.shape[0])
    rounds, status = info.tolist()
    _raise_on_status(status)
    return share, rate, rounds


def _raise_on_status(status: int) -> None:
    if status:
        raise RuntimeError(f"waterfill kernel: "
                           f"{K.WATERFILL_ERRORS.get(status, status)}")


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


def _pow2(n: int, least: int) -> int:
    """The least power of two that is at least ``n`` and ``least``."""
    size = least
    while size < n:
        size *= 2
    return size


def pad_rows(k: int) -> int:
    """A pricing call's row count for ``k`` flows: the next power of two,
    at least 16 (the reference's padding)."""
    return _pow2(k, 16)


def pad_flows(links: np.ndarray, valid: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """A pricing call's (cap, 4) int32 link ids and flags, ``cap`` =
    :func:`pad_rows`; pad rows and invalid slots hold link 0, flagged
    invalid."""
    k = len(links)
    cap = pad_rows(k)
    L = np.zeros((cap, 4), dtype=np.int32)
    V = np.zeros((cap, 4), dtype=bool)
    L[:k] = np.where(valid, links, 0)
    V[:k] = valid
    return L, V


class TorchBulk(BulkBackend):
    """The bulk solver on a torch device. ``device="cuda"`` (the default,
    also what ``get_bulk_backend(None)`` builds) raises if no card is
    present; ``device="cpu"`` runs the plain versions.

    On the card a water-fill solve is one copy up (capacities, ids and
    flags through a pinned staging buffer), one launch of the water-fill
    kernel, one copy down of its shares, rates, round count and status,
    and one host read (the synchronisation before the copy is read). A
    pricing call is one copy up of the padded ids and flags, one launch
    of B5 and one copy down of the prices. The staging buffers grow by
    powers of two and are reused after each call's synchronisation.

    The shares of the last solve stay on the device: :meth:`price` given
    that very array (``FairNetwork`` prices against ``link_share`` right
    after the solve that set it) reads the device copy and uploads no
    share; any other array is uploaded with the ids. ``check_reuse=True``
    compares the array's bytes with the device copy on every reuse and
    raises if they differ (the CPU tests run with it).

    :attr:`n_calls` counts solves, :attr:`n_rounds` their rounds (counted
    on the device), :attr:`n_reads` the water-fill's host reads (one a
    solve), :attr:`n_prices` pricing calls and :attr:`n_reused` those that
    priced against the device copy of the shares."""

    name = "torch"

    def __init__(self, device: str = "cuda", check_reuse: bool = False
                 ) -> None:
        self.device = require_device(device, "TorchBulk")
        self.check_reuse = check_reuse
        self.n_calls = 0        # water-fill solves
        self.n_rounds = 0       # water-fill rounds
        self.n_reads = 0        # water-fill host reads
        self.n_prices = 0       # pricing calls
        self.n_reused = 0       # pricing calls on the resident shares
        self._resident = None   # (host array, device copy) of the shares
        self._bufs = {}         # staging and device buffers by name

    def _t(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _buffer(self, name: str, nbytes: int, pinned: bool):
        """(a uint8 buffer of at least ``nbytes``, its numpy view if pinned),
        kept across calls: pinned host memory or device memory."""
        got = self._bufs.get(name)
        if got is None or got[0].numel() < nbytes:
            size = _pow2(nbytes, 4096)
            if pinned:
                buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
                got = (buf, buf.numpy())
            else:
                got = (torch.empty(size, dtype=torch.uint8,
                                   device=self.device), None)
            self._bufs[name] = got
        return got

    def _upload(self, name: str, parts) -> list:
        """Copy ``parts`` to the device in one copy through the pinned
        buffer ``name``: each part is (torch dtype, shape, fill), laid out
        at a multiple of 16 bytes, and ``fill(view)`` writes it into its
        numpy view of the pinned bytes. Returns each part's view of the
        device buffer ``name``."""
        spans, n = [], 0
        for dtype, shape, _fill in parts:
            size = math.prod(shape) * dtype.itemsize
            spans.append((n, size))
            n += -(-size // 16) * 16
        host, raw = self._buffer(name + "_host", n, pinned=True)
        for (off, size), (dtype, shape, fill) in zip(spans, parts):
            fill(raw[off:off + size].view(_NUMPY[dtype]).reshape(shape))
        dev = self._buffer(name, n, pinned=False)[0]
        dev[:n].copy_(host[:n], non_blocking=True)
        return [dev[off:off + size].view(dtype).view(shape)
                for (off, size), (dtype, shape, _f) in zip(spans, parts)]

    def _download(self, name: str, out: torch.Tensor) -> np.ndarray:
        """Copy the uint8 device tensor ``out`` into the pinned buffer
        ``name``, wait for it, and return the pinned bytes (a numpy
        view)."""
        n = out.numel()
        host, raw = self._buffer(name, n, pinned=True)
        host[:n].copy_(out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return raw[:n]

    def waterfill(self, eff, links, valid, eps):
        k = len(links)
        if not k:
            return eff.copy(), np.zeros(0)
        self.n_calls += 1
        nL = len(eff)
        if self.device.type == "cpu":
            share_t, rate_t, rounds = waterfill_ref(
                self._t(np.asarray(eff, dtype=np.float64)),
                self._t(np.asarray(links, dtype=np.int32)),
                self._t(np.asarray(valid, dtype=bool)), eps)
            share, rate = share_t.numpy().copy(), rate_t.numpy()
        else:
            share_t, share, rate, rounds = self._fill_on_card(
                eff, links, valid, eps, k, nL)
        self.n_rounds += rounds
        self.n_reads += 1
        self._resident = (share, share_t)
        return share, rate

    def _fill_on_card(self, eff, links, valid, eps, k, nL):
        def put(x):
            return lambda view: np.copyto(view, x, casting="unsafe")

        args = self._upload("fill", [
            (F64, (nL,), put(eff)), (torch.int32, (k, 4), put(links)),
            (torch.bool, (k, 4), put(valid))])
        out = K.launch_waterfill(*args, eps)
        raw = self._download("fill_out", out)
        rounds, status = raw[:8].view(np.int32).tolist()
        _raise_on_status(status)
        share = raw[8:8 + 8 * nL].view(np.float64).copy()
        rate = raw[8 + 8 * nL:].view(np.float64).copy()
        return out[8:8 + 8 * nL].view(F64), share, rate, rounds

    def _reused(self, share) -> bool:
        """True when ``share`` is the array the last solve returned (its
        device copy is priced against); checks the bytes under
        ``check_reuse``."""
        if self._resident is None or share is not self._resident[0]:
            return False
        if self.check_reuse:
            dev = self._resident[1].cpu().numpy()
            if share.tobytes() != dev.tobytes():
                raise RuntimeError("TorchBulk: the solved shares changed "
                                   "after the solve; the device copy is "
                                   "stale")
        self.n_reused += 1
        return True

    def price(self, share, links, valid):
        k = len(links)
        if not k:
            return np.zeros(0)
        self.n_prices += 1
        reused = self._reused(share)
        if self.device.type == "cpu":
            L, V = pad_flows(links, valid)
            share_t = self._resident[1] if reused else self._t(
                np.asarray(share, dtype=np.float64))
            return price(share_t, self._t(L), self._t(V))[:k].numpy()
        cap = pad_rows(k)

        def ids(view):          # pad_flows' ids: link 0 where invalid
            np.multiply(links, valid, out=view[:k], casting="unsafe")
            view[k:] = 0

        def flags(view):
            view[:k] = valid
            view[k:] = False

        parts = [(torch.int32, (cap, 4), ids), (torch.bool, (cap, 4), flags)]
        if not reused:
            parts.append((F64, (len(share),),
                          lambda view: np.copyto(view, share)))
        args = self._upload("price", parts)
        if reused:
            args.append(self._resident[1])
        out = price(args[2], args[0], args[1])
        raw = self._download("price_out", out[:k].view(torch.uint8))
        return raw.view(np.float64).copy()


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
           "get_bulk_backend", "pad_flows", "pad_rows", "price", "price_ref",
           "waterfill", "waterfill_ref"]
