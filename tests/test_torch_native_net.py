"""The port's socket mode against the JAX package and its own stacked runs.

Parties are threads on a localhost TCP mesh (`parallel.native_net`, built
from ``native/mpcnet.cpp`` with the host C++ compiler), as in
``tests/test_native_net.py``.  Every wait is bounded: a party that fails
closes its net, so the peers waiting on it fail at once, and every thread
is joined with a timeout.

- (a) The mesh ops, the port's parties alone: broadcast, channels,
  gather/scatter, the commit-then-open broadcast and a party caught
  equivocating in it, the counters, the uint32 wire and a dead peer.
- (b) A mixed mesh: party 0 is the JAX package's `NativeMeshNet` /
  `SocketTransport`, parties 1-2 the port's; a byte broadcast, a reveal and
  a Beaver multiply on dummy triples give every party the same values.
- (c) With the same private seeds (`mpc.rand.PartyGenerators`), party i's
  socket tensors are row i of the stacked run's, and the opened values are
  the stacked run's, at every private draw site: `rand_shared` (Groth16's
  r and s), `king_share`, `bit_rand` and the bit protocols, `input_share`,
  Marlin's masks, and over them `MpcMulFp`, `MpcU8` and
  `modulus_conversion`.  With party 1's private seed changed alone, party
  1's rows change and every opened value stays; a replicated
  ``torch.Generator`` is refused for a private draw on a socket.
- (d) The online input protocol over the mesh, each party holding only its
  own ``online_setup.json``: the shares are `input_with_r`'s rows and the
  JAX binary's formula; a tampered bracket-MAC share raises at the owner
  and the other parties fail without hanging; the binary's process exits
  nonzero when its peer dies; the socket flags are checked.
- (e) `slow`: `cli.online.run` over the mesh on the CPU with Groth16 gives
  the stacked run's proof under the same private seeds.
"""

import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from test_torch_online import _jax_formula, write_setups
from torch_parity import CPU
from zkmpc_tpu_torch import inputs as IN
from zkmpc_tpu_torch.cli import online as ON
from zkmpc_tpu_torch.mpc import bits as B
from zkmpc_tpu_torch.mpc import rand as R
from zkmpc_tpu_torch.mpc.group import MpcSWPoint
from zkmpc_tpu_torch.mpc.mul_share import MpcMulFp
from zkmpc_tpu_torch.mpc.share import (SHARED, MpcContext, MpcFp, beaver_inv, king_share,
                                       modulus_conversion, mpc_scope, rand_shared)
from zkmpc_tpu_torch.mpc.uint8 import MpcU8
from zkmpc_tpu_torch.ops.curve import SWPoint
from zkmpc_tpu_torch.ops.limbs import EDFR, FR, FpArray
from zkmpc_tpu_torch.snark import marlin
from zkmpc_tpu_torch.parallel import transport as T
from zkmpc_tpu_torch.parallel.native_net import NativeMeshNet, SocketTransport
from zkmpc_tpu_torch.parallel.transport import StackedTransport
from zkmpc_tpu_torch.spec import curves as SC

torch.set_num_threads(1)

N = 3
P = FR.p
#: seconds a test waits for its parties
TIMEOUT = 60
#: the parties' private seeds of the online runs
PRIVATE_SEEDS = [11, 12, 13]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def run_parties(fn, n=N, nets=None):
    """Run fn(i, net) for each party in its own thread over a fresh
    localhost mesh; returns (results, errors), one entry a party.  A party
    closes its net when it ends, so a failure reaches its peers as
    `ConnectionError`; a thread still alive after TIMEOUT fails the test.
    ``nets``: optional net classes by party (default the port's)."""
    addrs = [f"127.0.0.1:{p}" for p in free_ports(n)]
    results, errors = [None] * n, [None] * n

    def worker(i):
        net = (nets or {}).get(i, NativeMeshNet)(i, addrs)
        try:
            net.connect()
            results[i] = fn(i, net)
        except BaseException as e:
            errors[i] = e
        finally:
            net.close()

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a party hung"
    return results, errors


def run_ok(fn, **kw):
    results, errors = run_parties(fn, **kw)
    assert not any(errors), errors
    return results


def _socket_scope(net):
    return mpc_scope(MpcContext(SocketTransport(net, CPU), "semi"))


# --------------------------------------------------------------- (a) mesh ops


def _equivocate(i, net):
    """Party 1 commits to one message and opens another."""
    msg = bytes([i]) * 8
    if i != 1:
        return net.atomic_broadcast_bytes(msg)
    salt = bytes(16)
    net.broadcast_bytes(hashlib.blake2b(salt + msg, digest_size=32).digest())
    net.broadcast_bytes(salt + b"x" * 8)


def _wire(i, net):
    t = SocketTransport(net, CPU)
    x = torch.tensor([[i, 7, (1 << 32) - 1 - 2 * i]])
    got = (t.psum(torch.tensor([[i, 7, i]])), t.all_gather(x), t.atomic_broadcast(x[:, :2]),
           t.party_index(2), t.leader_mask(0), t.own_rows(torch.arange(N)),
           t.party_id_scalar())
    for bad in (torch.tensor([[1 << 32]]), torch.tensor([[-1]]), torch.ones((2, 1))):
        with pytest.raises((ValueError, TypeError)):
            t.psum(bad)
    return got


def _dead_peer(i, net):
    if i == 2:
        return None                  # closes its net at once
    return net.broadcast_bytes(b"hello")


MESH_CASES = {
    "broadcast": lambda i, net: net.broadcast_bytes(bytes([i]) * 8),
    "channels": lambda i, net: (
        net.send_bytes((i + 1) % N, b"c2-%d" % i, chan=2),
        net.send_bytes((i + 1) % N, b"c1-%d" % i, chan=1),
        net.recv_bytes((i - 1) % N, chan=1), net.recv_bytes((i - 1) % N, chan=2))[2:],
    "gather_scatter": lambda i, net: (
        net.gather_to_leader(bytes([10 + i]) * 4),
        net.scatter_from_leader([bytes([20 + j]) * 4 for j in range(N)] if i == 0 else None,
                                4)),
    "atomic": lambda i, net: net.atomic_broadcast_bytes(bytes([i]) * 16),
    "counters": lambda i, net: (net.broadcast_bytes(b"abcd"), net.stats)[1],
    "equivocation": _equivocate,
    "wire": _wire,
    "dead_peer": _dead_peer,
}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_ops(case):
    results, errors = run_parties(MESH_CASES[case])
    if case == "equivocation":
        assert all(isinstance(e, AssertionError) and "party 1 equivocated" in str(e)
                   for e in (errors[0], errors[2])), errors
        return
    if case == "dead_peer":
        assert all(isinstance(e, ConnectionError) for e in errors[:2]), errors
        return
    assert not any(errors), errors
    for i, got in enumerate(results):
        if case == "broadcast":
            assert got == [bytes([j]) * 8 for j in range(N)]
        elif case == "channels":
            j = (i - 1) % N
            assert got == (b"c1-%d" % j, b"c2-%d" % j)
        elif case == "gather_scatter":
            assert got == ([bytes([10 + j]) * 4 for j in range(N)] if i == 0 else None,
                           bytes([20 + i]) * 4)
        elif case == "atomic":
            assert got == [bytes([j]) * 16 for j in range(N)]
        elif case == "counters":
            # the genesis barrier (an empty frame to each peer), then one
            # 4-byte frame to each: 5-byte headers
            assert got == dict(bytes_sent=(N - 1) * (5 + 9), bytes_recv=(N - 1) * (5 + 9),
                               broadcasts=1)
        else:
            psum, gathered, atomic, idx, lead, own, pid = got
            assert psum.tolist() == [[3, 3 * 7, 3]] and psum.dtype == torch.int64
            assert gathered.shape == (1, N, 3) and gathered[0, :, 2].tolist() == \
                [(1 << 32) - 1 - 2 * j for j in range(N)]
            assert atomic.tolist() == [[[j, 7] for j in range(N)]]
            assert idx.tolist() == [[[i]]] and lead.tolist() == [i == 0]
            assert own.tolist() == [i] and pid == i
    if case == "wire":
        with pytest.raises(ValueError, match="not one"):
            StackedTransport(N, CPU).party_id_scalar()


# ------------------------------------------------------------- (b) mixed mesh


def test_mixed_mesh_with_the_jax_package():
    """Party 0 runs the JAX package's transport, parties 1-2 the port's."""
    from zkmpc_tpu.mpc.share import SHARED as JSHARED
    from zkmpc_tpu.mpc.share import MpcContext as JCtx
    from zkmpc_tpu.mpc.share import MpcFp as JMpcFp
    from zkmpc_tpu.mpc.share import mpc_scope as jscope
    from zkmpc_tpu.ops.limbs import FR as JFR
    from zkmpc_tpu.ops.limbs import FpArray as JFp
    from zkmpc_tpu.parallel import native_net as JN
    JN.build_native()
    rng = np.random.default_rng(3)
    xs = [[int(v) for v in rng.integers(0, 1 << 62, 4)] for _ in range(N)]
    ys = [[int(v) for v in rng.integers(0, 1 << 62, 4)] for _ in range(N)]
    want_x = [sum(col) % P for col in zip(*xs)]
    want_xy = [a * sum(col) % P for a, col in zip(want_x, zip(*ys))]

    def party(i, net):
        mine = net.broadcast_bytes(b"p%d" % i)
        if i == 0:
            with jscope(JCtx(JN.SocketTransport(net), backend="semi")):
                x = JMpcFp(JFp.from_int(JFR, np.asarray(xs[0], dtype=object)), JSHARED)
                y = JMpcFp(JFp.from_int(JFR, np.asarray(ys[0], dtype=object)), JSHARED)
                opened = [x.reveal(), (x * y).reveal()]
            return mine, [[int(v) for v in np.asarray(o.to_ints()).reshape(-1)]
                          for o in opened]
        with _socket_scope(net):
            x = MpcFp(FpArray.from_int(FR, [xs[i]], device=CPU), SHARED)
            y = MpcFp(FpArray.from_int(FR, [ys[i]], device=CPU), SHARED)
            opened = [x.reveal(), (x * y).reveal()]
        return mine, [[int(v) for v in o.to_ints().reshape(-1)] for o in opened]

    results = run_ok(party, nets={0: JN.NativeMeshNet})
    for mine, opened in results:
        assert mine == [b"p%d" % j for j in range(N)]
        assert opened == [want_x, want_xy]


# ------------------------------------------------- (c) socket rows = stacked rows


def _g1(ks):
    return SWPoint.g1_from_affine_ints([SC.g1_mul(SC.G1_GEN, k) for k in ks], CPU)


def _g2(ks):
    return SWPoint.g2_from_affine_ints([SC.g2_mul(SC.G2_GEN, k) for k in ks], CPU)


def _ops():
    """Each op: a function of (generator) under an MPC scope -> a list of
    (shares or None, opened ints); shares are party-shaped tensors."""
    def fp(x):
        return x.limbs

    def opened(x):
        return [int(v) for v in x.to_ints()[0].reshape(-1)]

    def dealt(gen, n=3):
        return king_share(FpArray.from_int(FR, [5 + j for j in range(n)], device=CPU), gen)

    def reveal(gen):
        x = dealt(gen)
        return [(fp(x.value), opened(x.reveal()))]

    def beaver(gen):
        x, y = dealt(gen), dealt(gen)
        z = x * y
        return [(fp(z.value), opened(z.reveal()))]

    def inverse(gen):
        z = beaver_inv(dealt(gen))
        return [(fp(z.value), opened(z.reveal()))]

    def random(gen):
        r = rand_shared(gen, FR, (2, 3))
        return [(fp(r.value), opened(r.reveal()))]

    def points(gen):
        out = []
        for mk, ks in ((_g1, [[3, 4], [5, 6], [7, 0]]), (_g2, [[2], [9], [11]])):
            stacked = SWPoint.concat([mk(k).reshape(1, len(k)) for k in ks], axis=0)
            shares = T.current().own_rows(stacked)
            pt = MpcSWPoint(shares, SHARED).reveal()
            aff = pt[0].to_affine_ints()
            out.append((None, [list(map(_flat, aff))]))
        return out

    def bitrand(gen):
        b = B.bit_rand(gen, FR, (2, 5))
        return [(fp(b.value), opened(b.reveal()))]

    def compare(gen):
        a = B.bit_rand(gen, FR, (2, 8))
        b = king_share(FpArray.from_int(FR, [[(v >> j) & 1 for j in range(8)]
                                             for v in (9, 200)], device=CPU), gen)
        lt = B.bitwise_lt(a, b)
        return [(fp(lt.value), opened(lt.reveal())), (fp(a.value), opened(a.reveal()))]

    def dealt_input(gen, owner=1):
        t = T.current()
        val = FpArray.from_int(FR, [9, P - 4], device=CPU) if t.holds(owner) else None
        x = IN.input_share(val, owner, gen, shape=(2,))
        return [(fp(x.value), opened(x.reveal()))]

    def marlin_masks(gen):
        zero = MpcFp.const(FR, [0] * 4)
        m = marlin._sum_zero_mask(gen, 4)
        c = marlin._mask_vh(zero, gen, 4)
        return [(fp(m.value), opened(m.reveal())), (fp(c.value), opened(c.reveal()))]

    def mul_share(gen):
        f = rand_shared(gen, FR, (3,))
        x = MpcMulFp.from_shares(f.value)
        y = MpcMulFp.from_public(FpArray.from_int(FR, [2, 3, 4], device=CPU))
        z = (x * y).square().scale(FpArray.from_int(FR, [5, 6, 7], device=CPU))
        return [(fp(f.value), opened(x.reveal())), (fp(z.value), opened(z.reveal()))]

    def uint8(gen):
        vals = ([0xA5, 0x3C, 0x00], [0x0F, 0xFF, 0x81])
        a, b = (MpcU8(king_share(FpArray.from_int(
            FR, [[(v >> j) & 1 for j in range(8)] for v in vs], device=CPU), gen))
            for vs in vals)
        outs = [a.xor(b), a.and_(b), a.or_(b), a.not_()]
        return [(fp(u.bits.value), u.reveal_ints()) for u in outs]

    def convert(gen):
        x = king_share(FpArray.from_int(FR, [5, (1 << 250) + 3], device=CPU), gen)
        y = modulus_conversion(x, EDFR, gen)
        return [(fp(y.value), opened(y.reveal()))]

    return dict(reveal=reveal, beaver=beaver, beaver_inv=inverse, rand_shared=random,
                king_share=reveal, group_reveal=points, bit_rand=bitrand, bitwise_lt=compare,
                input_share=dealt_input, input_share_leader=lambda g: dealt_input(g, 0),
                marlin_masks=marlin_masks, mul_share=mul_share, uint8=uint8,
                modulus_conversion=convert)


def _seeds(k, changed=None):
    """Op k's private seeds by party; ``changed``: a party whose seed
    differs."""
    return {i: 1000 * k + i + (7 if i == changed else 0) for i in range(N)}


def _play(scope, changed=None, names=None):
    """Every op (or those ``names``) under a fresh MPC scope and its own
    private seeds, on the transport ``scope`` opens."""
    out = {}
    for k, (name, op) in enumerate(_ops().items()):
        if names is not None and name not in names:
            continue
        with scope() as c:
            out[name] = op(R.PartyGenerators.for_transport(c.transport, _seeds(k, changed)))
    return out


def _socket_play(changed=None, names=None):
    def party(i, net):
        t = SocketTransport(net, CPU)
        return _play(lambda: mpc_scope(MpcContext(t, "semi")), changed, names), t.stats.rounds
    return run_ok(party)


def _stacked_play(changed=None):
    return _play(lambda: mpc_scope(MpcContext(StackedTransport(N, CPU), "semi")), changed)


def _flat(xy):
    if xy is None:
        return None
    return [v for c in xy for v in (c if isinstance(c, tuple) else (c,))]


@pytest.fixture(scope="module")
def socket_base():
    """Every op over the mesh under `_seeds`: (outputs, rounds) a party."""
    return _socket_play()


def test_socket_rows_equal_stacked_rows(socket_base):
    """For every op, party i's socket share tensor equals row i of the
    stacked run's under the same private seeds, and the opened values are
    equal."""
    stacked = _stacked_play()
    results = socket_base
    for i, (got, _) in enumerate(results):
        for name, items in stacked.items():
            for (s_sh, s_open), (g_sh, g_open) in zip(items, got[name]):
                assert g_open == s_open, (name, i)
                if s_sh is not None:
                    assert g_sh.shape[0] == 1, name
                    assert torch.equal(g_sh[0], s_sh[i]), (name, i)
    assert stacked["reveal"][0][1] == [5, 6, 7]
    assert stacked["beaver"][0][1] == [25, 36, 49]
    assert stacked["beaver_inv"][0][1] == [pow(v, -1, P) for v in (5, 6, 7)]
    assert stacked["group_reveal"][0][1] == [[_flat(SC.g1_mul(SC.G1_GEN, 15)),
                                               _flat(SC.g1_mul(SC.G1_GEN, 10))]]
    assert stacked["group_reveal"][1][1] == [[_flat(SC.g2_mul(SC.G2_GEN, 22))]]
    assert set(stacked["bit_rand"][0][1]) <= {0, 1}
    a_bits = stacked["bitwise_lt"][1][1]
    a_vals = [sum(b << j for j, b in enumerate(a_bits[8 * k:8 * k + 8])) for k in range(2)]
    assert stacked["bitwise_lt"][0][1] == [int(a_vals[0] < 9), int(a_vals[1] < 200)]
    assert stacked["input_share"][0][1] == stacked["input_share_leader"][0][1] == [9, P - 4]
    m, c = (o for _, o in stacked["marlin_masks"])
    assert m[4] == (P - m[0]) % P and c[1:4] == [0] * 3 and c[0] == (P - c[4]) % P
    f = stacked["mul_share"][0][1]
    assert stacked["mul_share"][1][1] == [(v * k) ** 2 * s % P for v, k, s in
                                          zip(f, (2, 3, 4), (5, 6, 7))]
    a, b = [0xA5, 0x3C, 0x00], [0x0F, 0xFF, 0x81]
    assert [o for _, o in stacked["uint8"]] == [
        [x ^ y for x, y in zip(a, b)], [x & y for x, y in zip(a, b)],
        [x | y for x, y in zip(a, b)], [x ^ 0xFF for x in a]]
    assert stacked["modulus_conversion"][0][1] == [5, ((1 << 250) + 3) % EDFR.p]
    assert len({rounds for _, rounds in results}) == 1


#: the ops whose rows hold party 1's own draws (input_share: party 1 owns
#: and deals it), and those whose other rows are the other parties' own
#: draws alone (`bit_rand`'s XOR tree mixes every party's bits into every
#: row)
_PARTY1_DRAWS = ("rand_shared", "bit_rand", "input_share")
_OWN_ROW_DRAWS = ("rand_shared",)
#: the ops whose opened values do not open a fresh random value
_OPENED_STAY = ("beaver", "beaver_inv", "input_share", "input_share_leader", "uint8",
                "modulus_conversion")


def test_a_private_seed_moves_only_its_partys_rows(socket_base):
    """Over the mesh, with every other party's private seed (and no public
    seed at all) the same, a change of party 1's private seed changes
    party 1's rows of `rand_shared`, `bit_rand` and `input_share` (owned
    by party 1), leaves the other parties' `rand_shared` rows as they
    were, and
    every opened value that does not open a fresh random value (the
    inputs, products, inverses, conversions, comparisons) stays the
    same.  So no other process can recompute party 1's rows."""
    base = socket_base
    moved = _socket_play(changed=1, names=_PARTY1_DRAWS + _OPENED_STAY)
    for name in _PARTY1_DRAWS:
        assert not torch.equal(base[1][0][name][0][0], moved[1][0][name][0][0]), name
    for name in _OWN_ROW_DRAWS:
        for i in (0, 2):
            assert torch.equal(base[i][0][name][0][0], moved[i][0][name][0][0]), (name, i)
    for name in _OPENED_STAY:
        for i in range(N):
            assert [o for _, o in base[i][0][name]] == [o for _, o in moved[i][0][name]], name


def test_replicated_generator_refused_on_a_socket():
    """A replicated torch.Generator passed to a private draw on a socket
    transport raises `ValueError` before anything goes on the wire; the
    stacked transport still takes it."""
    def party(i, net):
        gen = torch.Generator().manual_seed(5)
        raised = []
        with _socket_scope(net):
            for draw in (lambda: rand_shared(gen, FR, (2,)),
                         lambda: king_share(FpArray.from_int(FR, [1], device=CPU), gen),
                         lambda: B.bit_rand(gen, FR, (3,)),
                         lambda: IN.input_share(FpArray.from_int(FR, [1], device=CPU)
                                                if i == 0 else None, 0, gen, shape=(1,))):
                with pytest.raises(ValueError, match="PartyGenerators"):
                    draw()
                raised.append(True)
        return raised
    assert run_ok(party) == [[True] * 4] * N
    with mpc_scope(MpcContext(StackedTransport(N, CPU), "semi")):
        assert rand_shared(torch.Generator().manual_seed(5), FR, (2,)).value.shape == (N, 2)


# --------------------------------------------------- (d) the online input protocol


def _own_dirs(base, tmp_path):
    """One directory a party, holding only its own online_setup.json."""
    dirs = []
    for i in range(N):
        d = tmp_path / f"party{i}"
        os.makedirs(d / str(i))
        shutil.copy(base / str(i) / "online_setup.json", d / str(i) / "online_setup.json")
        dirs.append(str(d))
    return dirs


def test_input_protocol_over_the_mesh(tmp_path):
    base = tmp_path / "all"
    write_setups(str(base))
    dirs = _own_dirs(base, tmp_path)
    cases = ((3, 0, 0), (5, 1, 1), (P - 1, 3, 2))
    with mpc_scope(MpcContext(StackedTransport(N, CPU), "semi")):
        setups = ON.read_setups(str(base), N)
        want = [ON.input_with_r(x, slot, owner, *setups, device=CPU).value.limbs
                for x, slot, owner in cases]

    def party(i, net, setup_dir):
        setup = ON.read_setup(setup_dir[i], i)
        out = []
        with _socket_scope(net):
            for x, slot, owner in cases:
                sh = ON.input_with_r_socket(net, x if i == owner else None, slot, owner,
                                            *setup, device=CPU)
                out.append((sh.value.limbs, int(sh.reveal().to_ints()[0])))
        return out

    results = run_ok(lambda i, net: party(i, net, dirs))
    for k, (x, slot, owner) in enumerate(cases):
        jax_rows = _jax_formula(str(base), x, slot, owner)
        for i in range(N):
            limbs, opened = results[i][k]
            assert torch.equal(limbs[0], want[k][i]) and opened == x
            assert int(FpArray(limbs, FR, 2).to_ints()[0]) == jax_rows[i]
    # party 2's bracket-MAC share under party 0's key tampered: party 0
    # raises, the others fail at once
    path = tmp_path / "party2" / "2" / "online_setup.json"
    doc = json.loads(path.read_text())
    doc["r_bracket"][0][0] = doc["r_bracket"][0][1]
    path.write_text(json.dumps(doc))
    _, errors = run_parties(lambda i, net: party(i, net, dirs))
    assert isinstance(errors[0], AssertionError) and "bracket MAC" in str(errors[0]), errors
    assert all(isinstance(e, ConnectionError) for e in errors[1:]), errors
    # a peer that dies after the mesh comes up: the binary's process
    # raises ConnectionError and exits nonzero
    inputs = tmp_path / "inputs.json"
    inputs.write_text(json.dumps({"x": 3, "y": 5}))
    pair = tmp_path / "pair"
    pair.write_text("".join(f"127.0.0.1:{p}\n" for p in free_ports(2)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "zkmpc_tpu_torch.cli.online", str(inputs), "--outdir", dirs[1],
         "--id", "1", "--addrs", str(pair), "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        peer = NativeMeshNet.from_file(0, str(pair))
        peer.connect(timeout=TIMEOUT)
        peer.close()
        out, _ = proc.communicate(timeout=TIMEOUT)
    finally:
        proc.kill()
    assert proc.returncode != 0 and "ConnectionError" in out, out
    # the flags: socket mode needs both, and the address file sets the count
    addrs = tmp_path / "addrs"
    addrs.write_text("127.0.0.1:1\n127.0.0.1:2\n127.0.0.1:3\n")
    for kw, flag in ((dict(party_id=0), "--id"), (dict(addrs=str(addrs)), "--addrs"),
                     (dict(party_id=3, addrs=str(addrs)), "--id"),
                     (dict(n_parties=4, party_id=0, addrs=str(addrs)), "--parties")):
        with pytest.raises(ValueError, match=flag):
            ON.run("unused.json", device=CPU, **kw)


# ---------------------------------------------------------- (e) the binary, slow


@pytest.mark.slow
def test_online_over_the_mesh_equals_stacked(tmp_path, monkeypatch):
    """`cli.online.run` as three mesh parties on the CPU with Groth16, each
    reading only its own setup file and holding its own private seed:
    every party verifies, and the proof is the stacked run's under the
    same private seeds.  The MSMs take the ladder."""
    from torch_parity import fewer_attempts
    from zkmpc_tpu_torch.ops import msm
    monkeypatch.setattr(msm, "MIN_BUCKETED_POINTS", 1 << 30)
    base = tmp_path / "all"
    write_setups(str(base))
    dirs = _own_dirs(base, tmp_path)
    inputs = tmp_path / "inputs.json"
    inputs.write_text(json.dumps({"x": 3, "y": 5}))
    addrs = tmp_path / "addrs"
    addrs.write_text("".join(f"127.0.0.1:{p}\n" for p in free_ports(N)))
    stacked = {}
    reports = [{} for _ in range(N)]
    errors = [None] * N

    def party(i):
        try:
            ON.run(str(inputs), dirs[i], party_id=i, addrs=str(addrs), zksnark="groth16",
                   device=CPU, report=reports[i], private_seeds=PRIVATE_SEEDS[i])
        except BaseException as e:
            errors[i] = e
    with fewer_attempts():
        assert ON.run(str(inputs), str(base), zksnark="groth16", device=CPU, report=stacked,
                      private_seeds=PRIVATE_SEEDS)
        threads = [threading.Thread(target=party, args=(i,), daemon=True) for i in range(N)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=3600)
    assert not any(t.is_alive() for t in threads) and not any(errors), errors
    for r in reports:
        assert r["verified"] and r["wrong_instance_rejected"] and r["c"] == 15
        assert r["proof"] == stacked["proof"] and r["net"]["broadcasts"] > 0
