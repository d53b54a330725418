"""What each rank of `test_torch_mesh.py` runs under its
`parallel.transport.MeshTransport` (`parallel.mesh.run_parties`).

A rank imports this module by name, so it imports the port alone: a rank
that loads JAX or the JAX package fails.  The parent runs the same
functions on a `StackedTransport` to get the stacked run's rows.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from zkmpc_tpu_torch import inputs as IN
from zkmpc_tpu_torch.mpc import bits as B
from zkmpc_tpu_torch.mpc import rand as R
from zkmpc_tpu_torch.mpc.mul_share import MpcMulFp
from zkmpc_tpu_torch.mpc.share import SHARED, MpcContext, MpcFp, king_share, mpc_scope, \
    rand_shared
from zkmpc_tpu_torch.ops.limbs import FR, FpArray
from zkmpc_tpu_torch.parallel import mesh
from zkmpc_tpu_torch.parallel import transport as T

N = 3
P = FR.p
#: the parties' 256-bit private seeds: above 2^63, one given as bytes
SEEDS = [(1 << 255) + 11, bytes(range(32)), (1 << 200) + 13]


def _opened(x):
    """The opened values of this process's first row."""
    return [int(v) for v in x.to_ints()[0].reshape(-1)]


def private_draws(t, seeds=SEEDS) -> dict:
    """Each private draw on ``t`` under the parties' private seeds, a
    stream each: name -> (this process's share rows, opened ints)."""
    gens = R.PartyGenerators.for_transport(t, {i: seeds[i] for i in t.row_ids})
    dev = t.device
    owner = 1
    ops = {
        "rand_shared": lambda g: rand_shared(g, FR, (2, 3)),
        "king_share": lambda g: king_share(FpArray.from_int(FR, [5, 6, 7], device=dev), g),
        "bit_rand": lambda g: B.bit_rand(g, FR, (2, 5)),
        "input_share": lambda g: IN.input_share(
            FpArray.from_int(FR, [9, P - 4], device=dev) if t.holds(owner) else None,
            owner, g, shape=(2,)),
    }
    out = {}
    with mpc_scope(MpcContext(t, "semi")):
        for k, (name, op) in enumerate(ops.items()):
            x = op(gens.stream(k + 1))
            out[name] = (x.value.limbs, _opened(x.reveal()))
    return out


def arith(t, xs, ys) -> list:
    """The protocol of ``tests/test_mpc.py::test_mesh_matches_stacked``:
    x*y + x - y opened, from every party's share limbs [P, n, nlimbs]."""
    with mpc_scope(MpcContext(t, "semi")):
        x = MpcFp(FpArray(t.own_rows(torch.as_tensor(xs)).to(t.device), FR, 2), SHARED)
        y = MpcFp(FpArray(t.own_rows(torch.as_tensor(ys)).to(t.device), FR, 2), SHARED)
        return _opened((x * y + x - y).reveal())


def mul_share(t, factors) -> list:
    """``tests/test_mul_share.py::test_mul_share_mesh``: the product of the
    parties' multiplicative shares ([P, 1, nlimbs] limbs) opened."""
    with mpc_scope(MpcContext(t, "semi")):
        f = FpArray(t.own_rows(torch.as_tensor(factors)).to(t.device), FR, 2)
        return _opened(MpcMulFp.from_shares(f).reveal())


def equivocate(t, how: str) -> str:
    """Party 1 equivocates in an atomic broadcast: ``"open"`` opens another
    message than the one it committed to, ``"commit"`` sends party 0 and
    party 2 different commitments (each with its matching opening).
    Returns what this rank's broadcast raised ("" where it passed)."""
    msg = bytes([t.party_id]) * 8
    salt = bytes(16)

    def com(m):
        return hashlib.blake2b(salt + m, digest_size=32).digest()
    if t.party_id == 1:
        other = b"x" * 8
        if how == "open":
            coms, opens = [com(msg)] * N, [salt + other] * N
            opens[1] = salt + msg
        else:
            coms = [com(msg), com(msg), com(other)]
            opens = [salt + msg, salt + msg, salt + other]
    else:
        coms, opens = [com(msg)] * N, [salt + msg] * N
    try:
        T.commit_echo_open(t._swap, t.party_id, coms, opens)
    except AssertionError as e:
        return str(e)
    return ""


def all_cases(t, key_path, a_limbs, b_limbs, r, s, xs, ys, factors) -> dict:
    """Every case of the test in one start of the ranks (one CPU thread a
    rank, beside the test's other workers)."""
    torch.set_num_threads(1)
    out = dict(draws=private_draws(t), arith=arith(t, xs, ys), mul_share=mul_share(t, factors),
               ops=dict(psum=t.psum(torch.tensor([[t.party_id, 7, 1 << 40]])),
                        gathered=t.all_gather(torch.tensor([[t.party_id, 5]])),
                        atomic=t.atomic_broadcast(torch.tensor([[t.party_id, 9]])),
                        bits=t.atomic_broadcast(torch.tensor([[t.party_id == 1, True]])),
                        dealt=t.deal(torch.arange(12).reshape(N, 4) if t.party_id == 2
                                     else None, 2, (4,)),
                        index=t.party_index(2), describe=t.describe()))
    out["equivocation"] = {how: equivocate(t, how) for how in ("open", "commit")}
    try:
        MpcContext(t, "spdz", alpha_share=FpArray.zeros(FR, (1,), t.device))
        out["spdz"] = ""
    except NotImplementedError as e:
        out["spdz"] = str(e)
    out["prove"] = mesh.prove_rank(t, key_path, a_limbs, b_limbs, r=r, s=s)
    out["stats"] = (t.stats.rounds, t.stats.bytes_moved)
    return out


def fail_in_rank_1(t):
    """Rank 1 raises; the others wait for it in a collective."""
    torch.set_num_threads(1)
    if t.party_id == 1:
        raise ValueError("rank 1 fails on purpose")
    t.psum(torch.zeros((1, 4), dtype=torch.int64))
    return np.zeros(0)
