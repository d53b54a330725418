"""The chips axis of the port (`parallel.sharded`, `parallel.mesh.run_parties`
with ``n_chips``): one start of six gloo ranks on the CPU, 3 parties x 2
chips, party p, chip c at global rank 2p + c.

The ranks run `all_cases` (this module is what they import, so it imports
neither JAX nor the JAX package): the four-step `sharded_fft` and
`sharded_ifft` at n = 64 and 32 (the sizes of ``tests/test_sharded.py``)
on the chips groups (C = 2) and on one extra group of ranks 0-3 (C = 4);
`sharded_sw_msm` at 16 G1 points and `replicated_sharded_sw_msm` at 15
points (so the last block pads) on G1 and G2, one case a party's chips
group (`MSM_CASE`), with the port's unsharded `sw_msm` beside each on the
party's chip-1 rank (64-bit scalars and ladders, `SF.MSM_BITS`); then the
4-gate wide-mul prove, each party's chips taking the party's private
seed, its MSMs split over the chips group.  The JAX side
(``Domain(FR, n).fft``, the JAX package's sharded functions and its 3 x 2
``shard_map`` prove under the r and s shares the mesh parties draw) and
the port's stacked proof under the same seeds come from
``fixtures/torch_sharded_3x2.npz`` (`fixtures/make_torch_sharded_fixture.py`,
which checks that the two proofs are one; ``tests/test_torch_groth16.py``
holds the stacked prove live); the ``slow`` test regenerates it.  The
``gpu`` case runs six ranks on one card.
"""

import json

import numpy as np
import pytest
import torch

from fixtures import make_torch_sharded_fixture as SF
from fixtures import make_torch_slice_fixture as MK
from zkmpc_tpu_torch.ops import msm as OM
from zkmpc_tpu_torch.ops.curve import SWPoint
from zkmpc_tpu_torch.ops.limbs import FR, FpArray
from zkmpc_tpu_torch.ops.ntt import Domain
from zkmpc_tpu_torch.parallel import mesh, sharded
from zkmpc_tpu_torch.snark import driver, groth16

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = SF.N_PARTIES
C = SF.N_CHIPS
#: seconds the ranks may take
TIMEOUT = 300
#: the MSM case of each party's chips group (its chip-1 rank also runs it
#: unsharded); ranks 0-3 also run ``sharded`` at C = 4
MSM_CASE = {0: "sharded", 1: "replicated_g1", 2: "replicated_g2"}


def _points(group, pts, device=CPU):
    return (SWPoint.g1_from_affine_ints(pts, device) if group == "g1"
            else SWPoint.g2_from_affine_ints(pts, device))


def _affine(p: SWPoint):
    return p.reshape((1,)).to_affine_ints()[0]


def _fr(vals, device=CPU):
    return FpArray.from_int(FR, np.asarray(vals, dtype=object), device=device)


def _fft_cases(chips, device) -> dict:
    """str(n) -> (this chip's block of `sharded_fft` of `SF.fft_inputs(n)`,
    its block of `sharded_ifft` of that), as ints."""
    out = {}
    for n in SF.FFT_SIZES:
        per = n // chips.size
        block = _fr(SF.fft_inputs(n)[chips.index * per:(chips.index + 1) * per], device)
        ev = sharded.sharded_fft(FR, n, block, chips)
        back = sharded.sharded_ifft(FR, n, ev, chips)
        out[str(n)] = ([int(v) for v in ev.to_ints()], [int(v) for v in back.to_ints()])
    return out


def _msm_cases(chips, four, party, device) -> dict:
    """name -> {chips or "unsharded": affine result} for `SF.msm_inputs`:
    the party's case of `MSM_CASE` over its chips group, either
    `sharded_sw_msm` of each chip's slice or `replicated_sharded_sw_msm`,
    `sharded_sw_msm` over the C = 4 group on ranks 0-3, and on chip 1 the
    party's case through the port's unsharded `sw_msm` (the ladder: a
    16-point bucketed MSM takes minutes on a CPU, and the value does not
    depend on the path)."""
    msms = SF.msm_inputs()

    def split(name, g):
        group, pts, sc = msms[name]
        if name != "sharded":
            return sharded.replicated_sharded_sw_msm(
                _points(group, pts, device), _fr(sc, device), g, nbits=SF.MSM_BITS)
        per = len(pts) // g.size
        lo, hi = g.index * per, (g.index + 1) * per
        return sharded.sharded_sw_msm(_points(group, pts[lo:hi], device),
                                      _fr(sc[lo:hi], device), g, nbits=SF.MSM_BITS)
    name = MSM_CASE[party]
    out = {name: {str(chips.size): _affine(split(name, chips))}}
    if four is not None:
        out.setdefault("sharded", {})[str(four.size)] = _affine(split("sharded", four))
    if chips.index == 1:
        group, pts, sc = msms[name]
        bucketed = OM.MIN_BUCKETED_POINTS
        OM.MIN_BUCKETED_POINTS = 1 << 30
        try:
            out[name]["unsharded"] = _affine(OM.sw_msm(_points(group, pts, device),
                                                       _fr(sc, device), nbits=SF.MSM_BITS))
        finally:
            OM.MIN_BUCKETED_POINTS = bucketed
    return out


def all_cases(t, key_path, a_limbs, b_limbs, seeds, chips=None) -> dict:
    """A rank's cases, in one start of the six ranks (one CPU thread a
    rank, beside the test's other workers)."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank = dist.get_rank()
    # new_group is collective over the world: every rank makes the C = 4 group
    four_group = dist.new_group([0, 1, 2, 3])
    four = sharded.ChipsGroup(four_group, t.device) if rank < 4 else None
    out = dict(rank=rank, party=t.party_id, chip=chips.index, n_chips=chips.size,
               describe=t.describe(),
               fft={str(g.size): _fft_cases(g, t.device) for g in (chips, four) if g},
               msm=_msm_cases(chips, four, t.party_id, t.device))
    out["prove"] = mesh.prove_rank(t, key_path, a_limbs, b_limbs, seed=seeds[t.party_id],
                                   chips=chips)
    return out


@pytest.fixture(scope="module")
def fx():
    return SF.load(np.load(SF.PATH))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, fx):
    """Every rank's `all_cases` (3 parties x 2 chips, gloo, the CPU), and
    the proving key."""
    dpk = driver.dpk_from_host(MK.load(np.load(MK.PATH))["doc"], CPU)
    _, (a, b, _) = driver.make_prove_fn(dpk, N)
    key = str(tmp_path_factory.mktemp("sharded") / "dpk.pkl")
    mesh.write_key(dpk, key)
    out = mesh.run_parties(all_cases, N, CPU, "gloo", TIMEOUT, n_chips=C,
                           args=(key, a.numpy(), b.numpy(), fx["prove"]["seeds"]))
    return out, dpk


@pytest.mark.parametrize("n", SF.FFT_SIZES)
@pytest.mark.parametrize("chips", SF.FFT_CHIPS)
def test_sharded_fft_and_ifft_match_reference(ranks, fx, n, chips):
    """Each chip's block of the four-step NTT is its block of the JAX
    package's ``Domain(FR, n).fft``, of the port's own `Domain` and of the
    JAX package's ``sharded_fft``; the inverse gives the coefficients
    back, as the JAX package's does."""
    ref = fx["fft"][str(n)]
    coeffs, want = ref["coeffs"], ref["domain_fft"]
    assert [int(v) for v in Domain(FR, n, CPU).fft(_fr(coeffs)).to_ints()] == want
    jax_ev, jax_back = ref["sharded"][str(chips)]
    assert jax_ev == want and jax_back == coeffs
    per = n // chips
    held = [r for r in ranks[0] if str(chips) in r["fft"]]
    assert len(held) == (N * C if chips == C else 4)
    for r in held:
        i = r["chip"] if chips == C else r["rank"]
        ev, back = r["fft"][str(chips)][str(n)]
        assert ev == want[i * per:(i + 1) * per], (r["rank"], n, chips)
        assert back == coeffs[i * per:(i + 1) * per], (r["rank"], n, chips)


@pytest.mark.parametrize("name,chips", [("sharded", 2), ("sharded", 4), ("replicated_g1", 2),
                                        ("replicated_g2", 2)])
def test_sharded_msm_matches_host(ranks, fx, name, chips):
    """Every chip's sharded MSM is the host sum (`spec.curves`), the JAX
    package's sharded MSM and the port's unsharded `sw_msm`; the 15-point
    replicated MSMs pad the last chip's block."""
    ref = fx["msm"][name]
    group, pts, sc = SF.msm_inputs()[name]
    host = SF.host_msm(group, pts, sc)
    assert json.loads(json.dumps(SF._plain(host))) == ref["host"] == ref["jax"][str(chips)]
    cases = [r["msm"].get(name, {}) for r in ranks[0]]
    got = [c[str(chips)] for c in cases if str(chips) in c]
    assert len(got) == (C if chips == C else 4)
    assert all(g == host for g in got)
    (unsharded,) = [c["unsharded"] for c in cases if "unsharded" in c]
    assert unsharded == host


def test_prove_3x2_equals_stacked_and_jax_proofs(ranks, fx):
    """Both chips of each party give one proof; it is the port's stacked
    proof under the same private seeds and the JAX package's 3 x 2
    ``shard_map`` proof under the r and s shares those seeds draw; it
    verifies and a wrong instance does not."""
    out, dpk = ranks
    proofs = {(r["party"], r["chip"]): r["prove"]["proof"] for r in out}
    assert sorted(proofs) == [(p, c) for p in range(N) for c in range(C)]
    for p in range(N):
        assert proofs[(p, 0)] == proofs[(p, 1)], p
    stacked = fx["prove"]["stacked_proof"]
    assert stacked == fx["prove"]["proof"]
    assert all(pf == stacked for pf in proofs.values())
    inst = driver.expected_instance(SF.N_GATES)
    assert groth16.verify(dpk.pk.vk, inst, stacked)
    assert not groth16.verify(dpk.pk.vk, [inst[0], (inst[1] + 1) % FR.p], stacked)


def test_r_and_s_are_the_seeds_draws(fx):
    """The fixture's r and s shares are the first two private draws of
    the parties' seeds (the prove's), so the JAX proof was made under the
    shares the mesh parties draw."""
    for (want, want_bound), (limbs, bound) in zip((fx["prove"]["r"], fx["prove"]["s"]),
                                                  SF.r_s_shares()):
        assert np.array_equal(want, limbs) and want_bound == bound


def test_the_split_really_ran(ranks):
    """Rank 2p + c plays party p on chip c of a 3 x 2 layout; every MSM
    call of its prove split over its chips group (one gather each, more
    than none), and its openings went over its party group."""
    for r in ranks[0]:
        rep = r["prove"]
        assert (r["party"], r["chip"], r["n_chips"]) == (r["rank"] // C, r["rank"] % C, C)
        assert r["describe"].startswith("gloo, 3 parties × 2 chips, 6 ranks"), r["describe"]
        assert rep["chips_gathers"] == rep["msm_calls"] > 0, rep
        assert rep["openings"] > 0 and rep["on_device"]


def test_run_parties_needs_a_chip():
    with pytest.raises(ValueError, match="one chip"):
        mesh.run_parties(all_cases, N, CPU, "gloo", 60, n_chips=0)


@pytest.mark.slow
def test_against_live_reference(fx):
    """Regenerates the fixture with the JAX package (several minutes on a
    CPU) and holds it against the committed one."""
    live = SF.load(SF.generate())
    assert live["fft"] == fx["fft"] and live["msm"] == fx["msm"]
    for key in ("proof", "stacked_proof", "seeds", "bounds"):
        assert live["prove"][key] == fx["prove"][key], key


@pytest.mark.gpu
def test_chips_prove_on_the_card(tmp_path):
    """Six ranks (3 parties x 2 chips) on one card over gloo: the 4-gate
    prove with the slice fixture's r and s gives the JAX package's proof in
    every rank, every MSM split over the chips group, the tensors on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    sl = MK.load(np.load(MK.PATH))
    dpk = driver.dpk_from_host(sl["doc"], dev)
    _, (a, b, _) = driver.make_prove_fn(dpk, N)
    key = str(tmp_path / "dpk.pkl")
    mesh.write_key(dpk, key)
    for rep in mesh.run_parties(mesh.prove_rank, N, dev, "gloo", 300, n_chips=C,
                                args=(key, a.cpu().numpy(), b.cpu().numpy(), None, sl["r"],
                                      sl["s"])):
        assert rep["proof"] == sl["proof"] and rep["on_device"]
        assert rep["chips_gathers"] == rep["msm_calls"] > 0
