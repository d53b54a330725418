"""The native full-mesh party transport (``native/mpcnet.cpp``) through
ctypes, and a `Transport` that runs the share protocols over it.

Port of ``zkmpc_tpu/parallel/native_net.py`` (the reference's mpc-net,
`mpc-net/src/multi.rs`): one OS process per party, a TCP full mesh with
framed channels, leader star patterns and byte counters.  Both packages
speak the same wire: the C++ source is shared, not copied, and
`SocketTransport` moves tensors as little-endian uint32 limb buffers, so a
party of either package can sit on one mesh with the other's.

The library is compiled from ``native/mpcnet.cpp`` at first use with the
host C++ compiler ``nvcc`` uses (``$NVCC_CCBIN``, else ``g++``), into
``build/zkmpc_tpu_torch/net-<source hash>/`` beside the kernels.  A failed
build raises.

A peer that fails to connect, closes its end or sends a frame of the wrong
length makes every party that waits on it raise `ConnectionError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from ..ops.build import BUILD_ROOT, PKG_DIR
from . import transport as T

SOURCE = os.path.join(os.path.dirname(PKG_DIR), "native", "mpcnet.cpp")
LIB_NAME = "libmpcnet.so"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-pthread", "-std=c++17"]

#: seconds `NativeMeshNet.connect` waits for the whole mesh to come up
CONNECT_TIMEOUT_S = 120.0
#: the mesh channel of `SocketTransport.deal`'s point-to-point frames
DEAL_CHAN = 1

_lock = threading.Lock()
_lib = None


def _host_cxx() -> str:
    cxx = os.environ.get("NVCC_CCBIN") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (g++ or $NVCC_CCBIN): the mesh library "
                           "cannot be built")
    return cxx


def build() -> str:
    """Compile ``native/mpcnet.cpp`` if this source hash has no library
    yet; returns the library path.  Processes that start together each
    write a private file and rename it into place."""
    cxx = _host_cxx()
    h = hashlib.sha256(" ".join([os.path.basename(cxx)] + CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    out_dir = os.path.join(BUILD_ROOT, f"net-{h.hexdigest()[:16]}")
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.isfile(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.tmp{os.getpid()}.{threading.get_ident()}"
    proc = subprocess.run([cxx] + CXX_FLAGS + ["-o", tmp, SOURCE], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path


def lib():
    """The loaded mesh library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(build())
            p, i, u32, buf = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_char_p
            L.mpcnet_create.restype = p
            L.mpcnet_create.argtypes = [i, i, ctypes.POINTER(buf), ctypes.POINTER(i)]
            L.mpcnet_connect.argtypes = [p]
            L.mpcnet_send.argtypes = [p, i, i, buf, u32]
            L.mpcnet_recv.argtypes = [p, i, i, buf, ctypes.POINTER(u32)]
            L.mpcnet_broadcast.argtypes = [p, i, buf, u32, buf]
            L.mpcnet_gather_to_leader.argtypes = L.mpcnet_broadcast.argtypes
            L.mpcnet_scatter_from_leader.argtypes = L.mpcnet_broadcast.argtypes
            for f in ("mpcnet_bytes_sent", "mpcnet_bytes_recv", "mpcnet_num_broadcasts"):
                getattr(L, f).restype = ctypes.c_uint64
                getattr(L, f).argtypes = [p]
            L.mpcnet_destroy.argtypes = [p]
            _lib = L
    return _lib


def read_addrs(path: str) -> list:
    """An address file: one ``host:port`` a line, ordered by party id."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


class NativeMeshNet:
    """One party's handle on the TCP full mesh (the reference's
    `MPCNetConnection`, `multi.rs:112-354`)."""

    def __init__(self, party_id: int, addrs):
        """``addrs``: one ``host:port`` string a party, ordered by id (the
        reference's address-file format, `multi.rs:155-184`)."""
        if not 0 <= party_id < len(addrs):
            raise ValueError(f"party id {party_id} is not in the address list of "
                             f"{len(addrs)} parties")
        self.party_id = party_id
        self.n_parties = len(addrs)
        hosts, ports = [], []
        for a in addrs:
            host, port = a.rsplit(":", 1)
            hosts.append(host.encode())
            ports.append(int(port))
        self._L = lib()
        self._h = self._L.mpcnet_create(party_id, self.n_parties,
                                        (ctypes.c_char_p * len(hosts))(*hosts),
                                        (ctypes.c_int * len(ports))(*ports))

    @classmethod
    def create(cls, party_id: int, addrs) -> "NativeMeshNet":
        return cls(party_id, addrs)

    @classmethod
    def from_file(cls, party_id: int, path: str) -> "NativeMeshNet":
        return cls(party_id, read_addrs(path))

    def _handle(self):
        if not self._h:
            raise ConnectionError(f"party {self.party_id}: the mesh is closed")
        return self._h

    def connect(self, timeout: float = CONNECT_TIMEOUT_S):
        """Bootstrap the mesh (listen, dial the lower ids, a barrier round).
        Raises `ConnectionError` if it fails or is not up within
        ``timeout`` seconds (a listener would otherwise wait for a peer
        that never comes); the handle is then abandoned, not freed, as the
        native call may still hold it."""
        h = self._handle()
        rc = []
        th = threading.Thread(target=lambda: rc.append(self._L.mpcnet_connect(h)),
                              daemon=True)
        th.start()
        th.join(timeout)
        if th.is_alive():
            self._h = None
            raise ConnectionError(f"party {self.party_id}: the mesh did not come up within "
                                  f"{timeout:.0f} s")
        if rc[0] != 0:
            raise ConnectionError(f"party {self.party_id}: mesh bootstrap failed")

    def send_bytes(self, to: int, data: bytes, chan: int = 0):
        if self._L.mpcnet_send(self._handle(), to, chan, data, len(data)) != 0:
            raise ConnectionError(f"party {self.party_id}: send to {to} failed")

    def recv_bytes(self, frm: int, max_len: int = 1 << 26, chan: int = 0) -> bytes:
        buf = ctypes.create_string_buffer(max_len)
        ln = ctypes.c_uint32(max_len)
        rc = self._L.mpcnet_recv(self._handle(), frm, chan, buf, ctypes.byref(ln))
        if rc != 0:
            raise ConnectionError(f"party {self.party_id}: recv from {frm} failed ({rc})")
        return buf.raw[:ln.value]

    def broadcast_bytes(self, mine: bytes, chan: int = 0) -> list:
        """Every party's equal-length buffer, ordered by id (own included)."""
        n = self.n_parties
        out = ctypes.create_string_buffer(len(mine) * n)
        if self._L.mpcnet_broadcast(self._handle(), chan, mine, len(mine), out) != 0:
            raise ConnectionError(f"party {self.party_id}: broadcast failed")
        raw = out.raw
        return [raw[i * len(mine):(i + 1) * len(mine)] for i in range(n)]

    def swap_bytes(self, outgoing, nbytes: int, chan: int = 0) -> list:
        """Point to point: ``outgoing[j]`` (``nbytes`` bytes) goes to each
        peer j, and each peer's frame for this party comes back, by party
        (this party's own slot is ``outgoing[me]``).  The mesh's reader
        threads take every frame in, so the sends cannot block."""
        me, n = self.party_id, self.n_parties
        for j in range(n):
            if j != me:
                self.send_bytes(j, outgoing[j], chan=chan)
        out = []
        for j in range(n):
            b = outgoing[me] if j == me else self.recv_bytes(j, max_len=nbytes, chan=chan)
            if len(b) != nbytes:
                raise ConnectionError(f"party {me}: a frame of {len(b)} bytes from party {j} "
                                      f"where {nbytes} are due")
            out.append(b)
        return out

    def atomic_broadcast_bytes(self, mine: bytes, chan: int = 0) -> list:
        """Commit-then-open broadcast with an echo of the commitments
        (`transport.atomic_broadcast_bytes` over `swap_bytes`): an
        equivocating party raises `AssertionError` in every honest one.
        The JAX package's mesh runs the two rounds without the echo, so
        the two packages' parties share no atomic broadcast."""
        return T.atomic_broadcast_bytes(lambda out, nbytes: self.swap_bytes(out, nbytes, chan),
                                        self.party_id, self.n_parties, mine)

    def gather_to_leader(self, mine: bytes, chan: int = 0):
        """Every party's buffer on party 0 (a list by id), None elsewhere
        (`worker_send_or_leader_receive`, `lib.rs:80-124`)."""
        n = self.n_parties
        out = ctypes.create_string_buffer(len(mine) * n) if self.party_id == 0 else None
        if self._L.mpcnet_gather_to_leader(self._handle(), chan, mine, len(mine), out) != 0:
            raise ConnectionError(f"party {self.party_id}: gather failed")
        if out is None:
            return None
        raw = out.raw
        return [raw[i * len(mine):(i + 1) * len(mine)] for i in range(n)]

    def scatter_from_leader(self, slices, item_len: int, chan: int = 0) -> bytes:
        """The leader passes one buffer a party, the others None; each gets
        its own (`worker_receive_or_leader_send`, `lib.rs:181`)."""
        flat = b"".join(slices) if self.party_id == 0 else None
        mine = ctypes.create_string_buffer(item_len)
        if self._L.mpcnet_scatter_from_leader(self._handle(), chan, flat, item_len,
                                              mine) != 0:
            raise ConnectionError(f"party {self.party_id}: scatter failed")
        return mine.raw

    @property
    def stats(self) -> dict:
        h = self._handle()
        return dict(bytes_sent=self._L.mpcnet_bytes_sent(h),
                    bytes_recv=self._L.mpcnet_bytes_recv(h),
                    broadcasts=self._L.mpcnet_num_broadcasts(h))

    def close(self):
        """Shut the sockets down: every peer waiting on this party fails."""
        if self._h:
            self._L.mpcnet_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _to_wire(x: torch.Tensor) -> tuple:
    """An integer tensor -> (little-endian uint32 bytes, its shape); a
    value outside [0, 2^32) raises."""
    if x.dtype.is_floating_point or x.dtype.is_complex:
        raise TypeError(f"the socket transport moves integer tensors, not {x.dtype}")
    arr = x.detach().to("cpu", torch.int64).numpy()
    if arr.size and (arr.min() < 0 or arr.max() >= 1 << 32):
        raise ValueError("a limb does not fit uint32: tighten before it goes on the wire")
    return arr.astype("<u4").tobytes(), arr.shape


def _from_wire(b: bytes, shape) -> np.ndarray:
    if len(b) != 4 * int(np.prod(shape, dtype=np.int64)):
        raise ConnectionError(f"a frame of {len(b)} bytes where {shape} uint32 words are due")
    return np.frombuffer(b, dtype="<u4").reshape(shape).astype(np.int64)


class SocketTransport(T.OnePartyTransport):
    """One party of the mesh, in this process: share tensors keep a party
    axis of length 1 (the party's own row), and a collective copies the
    tensor to the host, moves it as uint32 limbs through the mesh, sums or
    stacks the parties' tensors and copies the result back to ``device``."""

    kind = "socket"

    def __init__(self, net: NativeMeshNet, device="cuda"):
        super().__init__()
        self.net = net
        self.n_parties = net.n_parties
        self.party_id = net.party_id
        self.device = torch.device(device)

    def _exchange(self, x, bcast):
        if x.shape[:1] != (1,):
            raise ValueError(f"a socket party's tensor has one row, not {tuple(x.shape)}")
        data, shape = _to_wire(x)
        self.stats.record(x)
        return [_from_wire(b, shape) for b in bcast(data)]

    def _back(self, arr, like):
        return torch.from_numpy(arr).to(self.device, like.dtype)

    def psum(self, x):
        # tightened limbs (< 2^16) summed over a few parties stay far
        # below 2^32, the JAX package's contract; the caller resolves
        # carries
        parts = self._exchange(x, self.net.broadcast_bytes)
        return self._back(np.sum(parts, axis=0), x)

    def all_gather(self, x):
        return self._back(np.stack(self._exchange(x, self.net.broadcast_bytes), axis=1), x)

    def atomic_broadcast(self, x):
        parts = self._exchange(x, self.net.atomic_broadcast_bytes)
        return self._back(np.stack(parts, axis=1), x)

    def deal(self, x, dealer: int, shape):
        """The dealer's rows go out as uint32 frames: the leader's through
        the mesh's scatter, another dealer's one frame a peer on
        `DEAL_CHAN`."""
        me, n = self.party_id, self.n_parties
        shape = tuple(shape)
        if (x is None) == (me == dealer):
            raise ValueError(f"deal: the dealer (party {dealer}) and only the dealer passes "
                             f"the rows (this is party {me})")
        nbytes = 4 * int(np.prod(shape, dtype=np.int64))
        rows = None
        if me == dealer:
            if tuple(x.shape) != (n,) + shape:
                raise ValueError(f"deal: rows {tuple(x.shape)} where {(n,) + shape} are due")
            data, _ = _to_wire(x)
            rows = [data[j * nbytes:(j + 1) * nbytes] for j in range(n)]
        if dealer == 0:
            mine = self.net.scatter_from_leader(rows, nbytes, chan=DEAL_CHAN)
        elif me == dealer:
            for j in range(n):
                if j != me:
                    self.net.send_bytes(j, rows[j], chan=DEAL_CHAN)
            mine = rows[me]
        else:
            mine = self.net.recv_bytes(dealer, max_len=nbytes, chan=DEAL_CHAN)
        out = torch.from_numpy(_from_wire(mine, (1,) + shape)).to(self.device)
        self.stats.record(out)
        return out
