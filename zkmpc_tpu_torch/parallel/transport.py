"""Party transport: the collective layer the MPC protocols speak through.

Port of ``zkmpc_tpu/parallel/transport.py``.  Every share tensor has a
leading party axis of length ``rows``.  In ``StackedTransport`` all parties
live in one device tensor (``rows == n_parties``, the analogue of the
reference's in-process ``LocalTestNet``), so share openings are axis-0
reductions on one device.  ``parallel.native_net.SocketTransport`` runs one
party per process over the TCP mesh: the axis keeps length 1, the party's
own row.  Protocol code fetches the ambient transport from a context
variable.
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
    """Interface for the party-collective layer.

    ``n_parties`` is the protocol's party count; ``rows`` the length of
    every share tensor's leading axis (the parties this process holds,
    ``row_ids``)."""

    kind: str
    n_parties: int
    rows: int
    device: torch.device

    def __init__(self):
        self.stats = CommStats()

    def psum(self, x):
        """Sum a [rows, ...] tensor over all parties (every row gets the
        sum)."""
        raise NotImplementedError

    def all_gather(self, x):
        """[rows, ...] -> [rows, P, ...]: each row sees every party's
        tensor on a holder axis."""
        raise NotImplementedError

    def party_index(self, batch_ndim: int):
        """The ids of the rows held, shaped [rows, 1 * batch_ndim]."""
        raise NotImplementedError

    def deal(self, x, dealer: int, shape):
        """Party ``dealer`` hands each party its row: the process that plays
        the dealer passes the integer tensor ``x`` [n_parties, *shape], every
        other process None; each gets its rows [rows, *shape].  One round."""
        raise NotImplementedError

    @property
    def row_ids(self) -> list:
        """The party ids of the rows this process holds, in order."""
        raise NotImplementedError

    def party_id_scalar(self) -> int:
        """This process's party id, where it plays one party (a socket
        party); a process that plays several raises."""
        ids = self.row_ids
        if len(ids) != 1:
            raise ValueError(f"this process plays parties {ids}, not one")
        return ids[0]

    @property
    def holds_all_rows(self) -> bool:
        """Whether this process holds every party's row (the stacked
        layout): an opening of a point share is then a local fold, and a
        party-shaped input needs no owner's row picked out."""
        return self.rows == self.n_parties

    def holds(self, party: int) -> bool:
        """Whether this process plays ``party``."""
        return party in self.row_ids

    def own_rows(self, x):
        """This process's rows of a tensor drawn for every party
        ([n_parties, ...], a tensor, FpArray or SWPoint): every random draw
        is made at the stacked shape, and a party keeps its own row."""
        raise NotImplementedError

    def leader_mask(self, batch_ndim: int):
        """True on the leader's (party 0's) row."""
        return self.party_index(batch_ndim) == 0

    def atomic_broadcast(self, x):
        """Equivocation-free broadcast of per-party values, shaped as
        `all_gather`'s result.  On the stacked transport it is structural:
        every row sees the one gathered tensor, so no party can send
        different values to different peers; the socket transport runs the
        commit-then-open round."""
        return self.all_gather(x)


class StackedTransport(Transport):
    """All parties stacked on a leading axis of every tensor (one device)."""

    kind = "stacked"

    def __init__(self, n_parties: int, device="cuda"):
        super().__init__()
        self.n_parties = n_parties
        self.rows = n_parties
        self.device = torch.device(device)

    @property
    def row_ids(self) -> list:
        return list(range(self.n_parties))

    def own_rows(self, x):
        return x

    def deal(self, x, dealer: int, shape):
        assert tuple(x.shape) == (self.n_parties,) + tuple(shape), (x.shape, shape)
        self.stats.record(x)
        return x

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
