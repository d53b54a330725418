"""Party transport: the collective layer the MPC protocols speak through.

Port of ``zkmpc_tpu/parallel/transport.py``.  Every share tensor has a
leading party axis of length ``rows``.  In ``StackedTransport`` all parties
live in one device tensor (``rows == n_parties``, the analogue of the
reference's in-process ``LocalTestNet``), so share openings are axis-0
reductions on one device.  ``MeshTransport`` runs one party a rank of a
``torch.distributed`` process group (the JAX package's mesh mode, one SPMD
program instance a party; `parallel.mesh.run_parties` starts the ranks),
and ``parallel.native_net.SocketTransport`` one party a process over the
TCP mesh: on both the axis keeps length 1, the party's own row.  Protocol
code fetches the ambient transport from a context variable.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import secrets
import socket

import numpy as np
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
        different values to different peers; the socket and mesh
        transports, one process a party, run `atomic_broadcast_bytes`."""
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


class OnePartyTransport(Transport):
    """A transport of one party a process (a socket party, a mesh rank):
    share tensors keep a party axis of one row, the party's own."""

    rows = 1
    party_id: int

    def party_index(self, batch_ndim: int):
        return torch.full((1,) + (1,) * batch_ndim, self.party_id, dtype=torch.int64,
                          device=self.device)

    @property
    def row_ids(self) -> list:
        return [self.party_id]

    def own_rows(self, x):
        return x[self.party_id:self.party_id + 1]


#: the process-group backends `MeshTransport` runs on
BACKENDS = ("gloo", "nccl")


def _one_device_a_rank(keys) -> None:
    """NCCL takes one device a rank: raise where two ranks' device keys
    are equal."""
    seen = {}
    for rank, k in enumerate(keys):
        if k in seen:
            raise ValueError(f"backend 'nccl' takes one device a rank, and ranks {seen[k]} "
                             f"and {rank} share {k}: NCCL refuses two ranks on one device; "
                             f"use backend='gloo' (its collectives go through the host)")
        seen[k] = rank


def check_backend(backend: str, devices) -> None:
    """Refuse a backend the ranks' ``devices`` (one a rank) cannot run:
    NCCL moves CUDA tensors and takes one device a rank, so ranks that
    share a device, or run on the CPU, must use gloo.  Nothing is ever
    switched here: a refused backend raises `ValueError` naming the fix."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown process-group backend {backend!r}: one of {BACKENDS}")
    if backend != "nccl":
        return
    devs = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"backend 'nccl' needs a CUDA device a rank, not "
                         f"{[str(d) for d in devs]}: use backend='gloo'")
    _one_device_a_rank([f"cuda:{d.index or 0}" for d in devs])


class MeshTransport(OnePartyTransport):
    """One party of a ``torch.distributed`` process group, in this rank:
    share tensors keep a party axis of length 1 (the party's own row), as
    on a socket.  ``group``: the process group (None: the default one);
    its rank is the party id and its size the party count.  ``device``:
    where the rank computes; every result comes back there.

    On gloo each collective copies the tensor to the host, runs there and
    copies the result back to ``device`` (gloo has no CUDA all-gather);
    on NCCL the tensors stay on the device, which must be the rank's own.
    `psum` is an int64 all-reduce, `all_gather` an all-gather, `deal` a
    scatter from the dealer, and `atomic_broadcast` the commit-echo-open
    rounds of `atomic_broadcast_bytes`, point to point: a collective
    forwarded rank to rank lets one rank hand different values to
    different peers."""

    kind = "mesh"

    def __init__(self, group=None, device="cuda"):
        super().__init__()
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.backend = str(dist.get_backend(group))
        self.n_parties = dist.get_world_size(group)
        self.party_id = dist.get_rank(group)
        self.device = torch.device(device)
        check_backend(self.backend, [self.device])
        if self.backend == "nccl":
            # the ranks may name one card differently: compare the cards
            key = f"{socket.gethostname()}: {torch.cuda.get_device_properties(self.device).uuid}"
            keys = [None] * self.n_parties
            dist.all_gather_object(keys, key, group=group)
            _one_device_a_rank(keys)
        self._wire_device = self.device if self.backend == "nccl" else torch.device("cpu")

    def describe(self) -> str:
        """The backend and the layout, for a log line."""
        where = ("each rank on its own device" if self.backend == "nccl"
                 else f"collectives through the host, results back on {self.device}")
        return f"{self.backend}, {self.n_parties} ranks ({where})"

    def _peer(self, j: int) -> int:
        return j if self.group is None else self._dist.get_global_rank(self.group, j)

    def _row(self, x):
        if x.shape[:1] != (1,):
            raise ValueError(f"a mesh rank's tensor has one row, not {tuple(x.shape)}")
        return x

    def _wire(self, x, dtype=None):
        """A private copy of ``x`` where the collective runs."""
        return x.detach().to(self._wire_device, dtype or x.dtype, copy=True).contiguous()

    def psum(self, x):
        # tightened limbs (< 2^16) summed over a few parties stay far below
        # 2^32, the JAX package's contract; the caller resolves carries
        self._row(x)
        self.stats.record(x)
        y = self._wire(x, torch.int64)
        self._dist.all_reduce(y, op=self._dist.ReduceOp.SUM, group=self.group)
        return y.to(self.device, x.dtype)

    def all_gather(self, x):
        self._row(x)
        self.stats.record(x)
        y = self._wire(x[0], torch.uint8 if x.dtype == torch.bool else None)
        parts = [torch.empty_like(y) for _ in range(self.n_parties)]
        self._dist.all_gather(parts, y, group=self.group)
        return torch.stack(parts, dim=0)[None].to(self.device, x.dtype)

    def deal(self, x, dealer: int, shape):
        """The dealer's rows go out in one scatter."""
        me, n = self.party_id, self.n_parties
        shape = tuple(shape)
        if (x is None) == (me == dealer):
            raise ValueError(f"deal: the dealer (party {dealer}) and only the dealer passes "
                             f"the rows (this is party {me})")
        rows = None
        if me == dealer:
            if tuple(x.shape) != (n,) + shape:
                raise ValueError(f"deal: rows {tuple(x.shape)} where {(n,) + shape} are due")
            rows = list(self._wire(x, torch.int64).unbind(0))
        out = torch.empty(shape, dtype=torch.int64, device=self._wire_device)
        self._dist.scatter(out, rows, src=self._peer(dealer), group=self.group)
        out = out[None].to(self.device)
        self.stats.record(out)
        return out

    def _swap(self, outgoing, nbytes: int) -> list:
        """Point to point: ``outgoing[j]`` (``nbytes`` bytes) goes to each
        peer j straight from this rank, and each peer's bytes for this rank
        come back, by party (this rank's own slot is ``outgoing[me]``)."""
        me = self.party_id
        peers = [j for j in range(self.n_parties) if j != me]
        got = {j: torch.empty(nbytes, dtype=torch.uint8, device=self._wire_device)
               for j in peers}

        def tensor(b):
            if len(b) != nbytes:
                raise ValueError(f"a message of {len(b)} bytes where {nbytes} are due")
            return torch.frombuffer(bytearray(b), dtype=torch.uint8).to(self._wire_device)
        reqs = [self._dist.isend(tensor(outgoing[j]), self._peer(j), group=self.group)
                for j in peers]
        reqs += [self._dist.irecv(got[j], self._peer(j), group=self.group) for j in peers]
        for r in reqs:
            r.wait()
        return [outgoing[me] if j == me else got[j].cpu().numpy().tobytes()
                for j in range(self.n_parties)]

    def atomic_broadcast(self, x):
        """`atomic_broadcast_bytes` over `_swap`: an equivocating party
        makes every honest one raise `AssertionError`."""
        self._row(x)
        self.stats.record(x)
        arr = x[0].detach().cpu().contiguous().numpy()
        opened = atomic_broadcast_bytes(self._swap, self.party_id, self.n_parties,
                                        arr.tobytes())
        parts = [np.frombuffer(o, dtype=arr.dtype).reshape(arr.shape) for o in opened]
        return torch.from_numpy(np.stack(parts, axis=0)[None]).to(self.device)


def commit_echo_open(swap, me: int, commitments, openings) -> list:
    """The rounds of an atomic broadcast among one-party processes, over
    ``swap(outgoing, nbytes)``: a point-to-point exchange that sends
    ``outgoing[j]`` (``nbytes`` bytes) to each peer j and returns each
    party's bytes for this one, by party (its own slot ``outgoing[me]``).
    What this party sends each peer is given by party (an honest party
    sends every peer the same): the blake2b commitments; an echo of a
    digest of every commitment received, so that a party that sent
    different commitments to different peers is caught; then the
    openings, each checked against its commitment.  Returns the openings
    by party; an equivocating party makes every honest one raise
    `AssertionError`."""
    n = len(commitments)
    coms = swap(commitments, 32)
    view = hashlib.blake2b(b"".join(coms), digest_size=32).digest()
    for j, echo in enumerate(swap([view] * n, 32)):
        if echo != view:
            raise AssertionError(f"atomic broadcast: party {j} saw other commitments than "
                                 f"party {me}: a party equivocated")
    opened = swap(openings, len(openings[me]))
    for j, (c, o) in enumerate(zip(coms, opened)):
        if hashlib.blake2b(o, digest_size=32).digest() != c:
            raise AssertionError(f"atomic broadcast: party {j} equivocated")
    return opened


def atomic_broadcast_bytes(swap, me: int, n: int, mine: bytes) -> list:
    """Commit-then-open broadcast of this party's ``mine`` (every party's
    of one length) in the three rounds of `commit_echo_open`, each message
    behind a fresh 16-byte salt; returns every party's message by party.
    Both one-party transports run it: `MeshTransport` over its
    point-to-point sends, `native_net.NativeMeshNet` over its frames."""
    msg = secrets.token_bytes(16) + mine
    com = hashlib.blake2b(msg, digest_size=32).digest()
    return [o[16:] for o in commit_echo_open(swap, me, [com] * n, [msg] * n)]


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
