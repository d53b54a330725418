"""Party transport: the collective layer the MPC protocols speak through.

Port of the stacked half of ``zkmpc_tpu/parallel/transport.py``.  In
``StackedTransport`` all parties live in one device tensor with a leading
party axis P (the analogue of the reference's in-process ``LocalTestNet``),
so share openings are axis-0 reductions on one device.  Protocol code
fetches the ambient transport from a context variable.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch


class CommStats:
    """Per-transport collective accounting: one round per collective call
    plus the payload bytes it moves."""

    def __init__(self):
        self.rounds = 0
        self.bytes_moved = 0

    def record(self, x):
        self.rounds += 1
        self.bytes_moved += x.numel() * x.element_size()

    def reset(self):
        self.rounds = 0
        self.bytes_moved = 0

    def __repr__(self):
        return f"CommStats(rounds={self.rounds}, bytes={self.bytes_moved})"


class Transport:
    """Interface for the party-collective layer."""

    n_parties: int
    device: torch.device

    def __init__(self):
        self.stats = CommStats()

    def psum(self, x):
        """Sum an identically-shaped tensor over all parties."""
        raise NotImplementedError

    def all_gather(self, x):
        """Gather per-party tensors into a leading party axis [P, ...]."""
        raise NotImplementedError

    def party_index(self, batch_ndim: int):
        """Party id, shaped to broadcast against [*(stacked P), batch...]."""
        raise NotImplementedError



class StackedTransport(Transport):
    """All parties stacked on a leading axis of every tensor (one device)."""

    kind = "stacked"

    def __init__(self, n_parties: int, device="cpu"):
        super().__init__()
        self.n_parties = n_parties
        self.device = torch.device(device)

    def psum(self, x):
        self.stats.record(x)
        return x.sum(dim=0, keepdim=True).expand(x.shape)

    def all_gather(self, x):
        # x: [P, batch...] -> [P, P, batch...] (every party sees all shares)
        self.stats.record(x)
        return x[None].expand((self.n_parties,) + tuple(x.shape))

    def party_index(self, batch_ndim: int):
        idx = torch.arange(self.n_parties, device=self.device)
        return idx.reshape((self.n_parties,) + (1,) * batch_ndim)


_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "zkmpc_torch_transport", default=None)


def current() -> Transport:
    t = _CURRENT.get()
    if t is None:
        raise RuntimeError(
            "no MPC transport in scope; wrap the protocol in "
            "`with transport.scope(...):`")
    return t


@contextlib.contextmanager
def scope(t: Transport):
    token = _CURRENT.set(t)
    try:
        yield t
    finally:
        _CURRENT.reset(token)
