"""The party-axis mesh of the port: one rank a party in a
``torch.distributed`` process group (`parallel.mesh.run_parties`,
`parallel.transport.MeshTransport`), here on gloo over the CPU.

The ranks run `torch_mesh_ranks.all_cases` once (one start of three
processes): the protocols of the JAX package's two mesh tests
(``tests/test_mpc.py::test_mesh_matches_stacked``, run live here too, and
``tests/test_mul_share.py::test_mul_share_mesh``), the private draws under
256-bit seeds against the stacked run's rows, the transport's collectives,
an equivocating party in the atomic broadcast, and the 4-gate wide-mul
prove with the committed fixture's key, shares, r and s, which must give
the JAX package's proof (`fixtures/make_torch_slice_fixture.py`).  The
JAX package is imported inside the CPU tests only; the ``gpu`` case runs
the same prove with three ranks on one card.
"""

import time

import numpy as np
import pytest
import torch

import torch_mesh_ranks as MR
from fixtures import make_torch_slice_fixture as MK
from zkmpc_tpu_torch.ops.limbs import FR, FpArray
from zkmpc_tpu_torch.parallel import mesh
from zkmpc_tpu_torch.parallel import transport as T
from zkmpc_tpu_torch.snark import driver

torch.set_num_threads(1)

#: the CPU tests' device (`torch_parity.CPU`; that module imports the JAX
#: package, which the ``gpu`` case's machine lacks)
CPU = torch.device("cpu")
N = MR.N
P = FR.p
#: seconds the ranks of a test may take
TIMEOUT = 120


def _deal(rng, vals):
    """Additive shares [P, n] of ``vals`` as ``test_mesh_matches_stacked``
    deals them: parties 1..P-1 draw below 2^60, party 0 holds the rest."""
    shares, rem = [], list(vals)
    for _ in range(N - 1):
        r = [int(rng.integers(0, 1 << 60)) for _ in vals]
        shares.append(r)
        rem = [(a - b) % P for a, b in zip(rem, r)]
    return np.asarray([rem] + shares, dtype=object)


def _limbs(ints):
    return FpArray.from_int(FR, ints, device=CPU).limbs.numpy()


@pytest.fixture(scope="module")
def case_inputs():
    rng = np.random.default_rng(0)
    xs, ys = _deal(rng, [6, 9]), _deal(rng, [7, 11])
    factors = np.asarray([[2], [3], [5]], dtype=object)
    return xs, ys, factors


@pytest.fixture(scope="module")
def fx():
    return MK.load(np.load(MK.PATH))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, case_inputs, fx):
    """Every rank's `all_cases` (3 ranks, gloo, the CPU), and the seconds
    the ranks took."""
    xs, ys, factors = case_inputs
    dpk = driver.dpk_from_host(fx["doc"], CPU)
    _, (a, b, _) = driver.make_prove_fn(dpk, N)
    key = str(tmp_path_factory.mktemp("mesh") / "dpk.pkl")
    mesh.write_key(dpk, key)
    t0 = time.time()
    out = mesh.run_parties(MR.all_cases, N, CPU, "gloo", TIMEOUT,
                           args=(key, a.numpy(), b.numpy(), fx["r"], fx["s"], _limbs(xs),
                                 _limbs(ys), _limbs(factors)))
    return out, time.time() - t0


def test_mesh_matches_stacked_and_the_jax_mesh(ranks, case_inputs):
    """x*y + x - y on [6, 9] and [7, 11]: every rank opens what the JAX
    package's MeshTransport opens under shard_map (run live, as
    ``tests/test_mpc.py:104`` runs it), what the port's stacked transport
    opens, and the plain field values."""
    import functools

    import jax
    from jax.sharding import PartitionSpec as PS

    from zkmpc_tpu.mpc import share as JMS
    from zkmpc_tpu.ops.limbs import FR as JFR
    from zkmpc_tpu.ops.limbs import FpArray as JFp
    from zkmpc_tpu.parallel.transport import MeshTransport as JMesh
    xs, ys, _ = case_inputs
    jt = JMesh(N, "parties")
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:N]), ("parties",))

    def proto(xl, yl):
        with JMS.mpc_scope(JMS.MpcContext(jt, backend="semi")):
            x = JMS.MpcFp(JFp(xl.reshape(xl.shape[1:]), JFR, 2), JMS.SHARED)
            y = JMS.MpcFp(JFp(yl.reshape(yl.shape[1:]), JFR, 2), JMS.SHARED)
            return (x * y + x - y).reveal().limbs[None]
    smap = functools.partial(jax.shard_map, mesh=jmesh, in_specs=PS("parties"),
                             out_specs=PS("parties"))
    out = jax.jit(smap(proto))(JFp.from_int(JFR, xs).limbs, JFp.from_int(JFR, ys).limbs)
    jax_vals = [int(v) for v in JFp(np.asarray(out)[0], JFR, 2 * N).to_ints()]
    want = [(6 * 7 + 6 - 7) % P, (9 * 11 + 9 - 11) % P]
    stacked = MR.arith(T.StackedTransport(N, CPU), _limbs(xs), _limbs(ys))
    assert jax_vals == stacked == want
    for got in ranks[0]:
        assert got["arith"] == want


def test_mul_share_mesh(ranks):
    """The multiplicative shares 2, 3, 5 of the ranks open to 30."""
    for got in ranks[0]:
        assert got["mul_share"] == [30]


def test_mesh_rows_equal_stacked_rows(ranks):
    """Under the same 256-bit private seeds each rank's rows of
    `rand_shared`, `king_share`, `bit_rand` and `input_share` are row i of
    the stacked run's, and the opened values agree."""
    stacked = MR.private_draws(T.StackedTransport(N, CPU))
    assert stacked["king_share"][1] == [5, 6, 7]
    assert stacked["input_share"][1] == [9, P - 4]
    assert set(stacked["bit_rand"][1]) <= {0, 1}
    for i, got in enumerate(ranks[0]):
        for name, (rows, opened) in stacked.items():
            mine, mine_opened = got["draws"][name]
            assert mine.shape[0] == 1, name
            assert torch.equal(mine[0], rows[i]), (name, i)
            assert mine_opened == opened, (name, i)


def test_mesh_transport_collectives(ranks):
    """psum, all_gather, atomic_broadcast (int64 and bool), deal and
    party_index on one row a rank; the CommStats of the run are equal on
    every rank; the SPDZ backend is refused on a mesh rank."""
    for i, got in enumerate(ranks[0]):
        ops = got["ops"]
        assert ops["psum"].tolist() == [[3, 3 * 7, 3 << 40]]
        assert ops["gathered"].tolist() == [[[j, 5] for j in range(N)]]
        assert ops["atomic"].tolist() == [[[j, 9] for j in range(N)]]
        assert ops["bits"].dtype == torch.bool
        assert ops["bits"].tolist() == [[[j == 1, True] for j in range(N)]]
        assert ops["dealt"].tolist() == [list(range(4 * i, 4 * i + 4))]
        assert ops["index"].tolist() == [[[i]]]
        assert ops["describe"].startswith("gloo, 3 ranks")
        assert "mesh transport" in got["spdz"]
    assert len({got["stats"] for got in ranks[0]}) == 1


def test_mesh_prove_equals_reference_proof(ranks, fx):
    """The 4-gate wide-mul prove over the ranks, with the fixture's key,
    shares, r and s: every rank's opened proof is the JAX package's."""
    for got in ranks[0]:
        rep = got["prove"]
        assert rep["proof"] == fx["proof"]
        assert rep["on_device"] and rep["openings"] > 0


@pytest.mark.parametrize("how", ["open", "commit"])
def test_equivocating_rank_fails_atomic_broadcast(ranks, how):
    """A party that opens another message than it committed to, or sends
    different commitments to different peers, makes both honest ranks
    raise in the atomic broadcast."""
    errs = [got["equivocation"][how] for got in ranks[0]]
    want = "party 1 equivocated" if how == "open" else "a party equivocated"
    assert want in errs[0] and want in errs[2], errs


def test_failed_rank_raises_within_its_timeout():
    """A rank that raises makes run_parties raise `RankFailed` with its
    traceback, kill the ranks still waiting and return within the
    timeout; an unknown or unnamed backend raises before any rank starts."""
    t0 = time.time()
    with pytest.raises(mesh.RankFailed, match="rank 1 fails on purpose"):
        mesh.run_parties(MR.fail_in_rank_1, N, CPU, "gloo", 60)
    assert time.time() - t0 < 60
    with pytest.raises(ValueError, match="named"):
        mesh.run_parties(MR.fail_in_rank_1, N, CPU, None, 60)
    with pytest.raises(ValueError, match="unknown"):
        mesh.run_parties(MR.fail_in_rank_1, N, CPU, "mpi", 60)


@pytest.mark.parametrize("devices", [["cuda:0"] * 3, ["cuda", "cuda:1", "cuda:0"], ["cpu"] * 3])
def test_nccl_on_a_shared_device_is_refused(devices):
    """NCCL takes one CUDA device a rank: ranks that share one (or run on
    the CPU) are refused with a `ValueError` that names gloo, before any
    process starts; distinct devices pass the check."""
    with pytest.raises(ValueError, match="gloo"):
        T.check_backend("nccl", devices)
    with pytest.raises(ValueError, match="gloo"):
        mesh.run_parties(MR.fail_in_rank_1, len(devices), devices[0], "nccl", 60)
    T.check_backend("nccl", ["cuda:0", "cuda:1", "cuda:2"])
    T.check_backend("gloo", devices)


@pytest.mark.gpu
def test_mesh_prove_on_the_card(fx, tmp_path):
    """Three ranks on one card over gloo: the 4-gate prove with the
    fixture's r and s gives the JAX package's proof in every rank, whose
    tensors stay on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    dpk = driver.dpk_from_host(fx["doc"], dev)
    _, (a, b, _) = driver.make_prove_fn(dpk, N)
    key = str(tmp_path / "dpk.pkl")
    mesh.write_key(dpk, key)
    for rep in mesh.run_parties(mesh.prove_rank, N, dev, "gloo", 300,
                                args=(key, a.cpu().numpy(), b.cpu().numpy(), None, fx["r"],
                                      fx["s"])):
        assert rep["proof"] == fx["proof"] and rep["on_device"]
