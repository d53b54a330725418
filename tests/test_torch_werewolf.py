"""The port's werewolf game at 3 players against the JAX package.

- The domain logic (`apps/werewolf.py`): tau matrices, shuffle matrices and
  the roles dealt, live against the JAX module for seeds 0-3 at 3, 5 and 7
  players, with lone and grouped werewolves.
- The game binary (`cli/werewolf_game.py`) on the CPU: ``init`` (at 8
  slots), ``role_assignment``, ``vote --votes 2,2,0`` and ``judgment`` in
  one game directory, against ``fixtures/torch_werewolf_3p.npz``
  (`fixtures/make_torch_werewolf_fixture.py`): the state files, and each
  proved phase's circuit (counts, A/B/C, instance and opened assignment),
  exactly.  ``init``'s SHE shares are the port's own draws: they are
  checked by shape and by their MACs under the dealer's key.  A prove of
  these circuits takes minutes of CPU MSMs (a 64-point bucketed MSM alone
  took 105 s on one CPU thread), so the CPU tests hold the circuits; the
  `gpu` case proves the vote phase on the card with the JAX package's r
  and s and requires the JAX proof, and runs ``vote`` and ``judgment``
  there end to end.
- The vote phase's verifying key from the port's setup equals the JAX
  package's, under which the JAX proof verifies and a wrong instance does
  not.
- KeyPublicizeCircuit, DivinationCircuit (ElGamal randomness of
  ``RAND_BITS`` bits) and AnonymousVotingCircuit with their per-input
  Pedersen commitment checks at ``COM_NBITS`` message bits, built by
  `fixtures/make_torch_werewolf_fixture.build` with shared wires: counts,
  A/B/C, instance and opened assignment, exactly.  The full-width
  circuits (15,266 and 22,249 constraints in the reference) are proved on
  the card by ``chip_smoke.py`` phase 9.

The bit protocols draw one candidate for each random bitwise-shared value
(`torch_parity.fewer_attempts(1)`): nothing held here depends on the draws.
The JAX package is imported inside the CPU tests only, so that the `gpu`
case runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_werewolf.py
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from fixtures import make_torch_werewolf_fixture as WF
from zkmpc_tpu_torch.apps import werewolf as TW
from zkmpc_tpu_torch.cli import werewolf_game as WG
from zkmpc_tpu_torch.mpc.share import MpcContext, mpc_scope
from zkmpc_tpu_torch.ops.limbs import FR, FpArray
from zkmpc_tpu_torch.parallel.transport import StackedTransport
from zkmpc_tpu_torch.she import preprocessing as PP
from zkmpc_tpu_torch.snark import groth16
from zkmpc_tpu_torch.utils import serialize as SER

torch.set_num_threads(1)

CPU = torch.device("cpu")
P = FR.p


@pytest.fixture(scope="module")
def fx():
    return WF.load(np.load(WF.PATH))


def _groupings(n):
    """The game's grouping and one whose werewolves know each other."""
    out = [WG._grouping(n)]
    if n >= 5:
        out.append(TW.GroupingParameter({TW.Role.FORTUNE_TELLER: (1, False),
                                         TW.Role.WEREWOLF: (2, True),
                                         TW.Role.VILLAGER: (n - 3, False)}))
    return out


@pytest.mark.parametrize("players", [3, 5, 7])
def test_roles_and_shuffles_match_reference(players):
    from zkmpc_tpu.apps import werewolf as JW
    for gp in _groupings(players):
        jgp = JW.GroupingParameter({JW.Role(r.value): v for r, v in gp.groups.items()})
        n, m = gp.num_players(), gp.num_groups()
        assert (n, m, gp.max_group_size()) == (jgp.num_players(), jgp.num_groups(),
                                               jgp.max_group_size())
        np.testing.assert_array_equal(gp.generate_tau_matrix(), jgp.generate_tau_matrix())
        for seed in range(4):
            rt, rj = random.Random(seed), random.Random(seed)
            mt = [TW.generate_individual_shuffle_matrix(n, m, rt) for _ in range(players)]
            mj = [JW.generate_individual_shuffle_matrix(n, m, rj) for _ in range(players)]
            for a, b in zip(mt, mj):
                np.testing.assert_array_equal(a, b)
            got = [TW.calc_shuffle_matrix(gp, mt, pid) for pid in range(n)]
            want = [JW.calc_shuffle_matrix(jgp, mj, pid) for pid in range(n)]
            assert [(r.value, i, f) for r, i, f in got] == [(r.value, i, f) for r, i, f in want]
            roles = [r.value for r, _, _ in got]
            assert {v: roles.count(v) for v in roles} == \
                {r.value: c for r, (c, _) in gp.groups.items()}


@pytest.mark.parametrize("name", ["key_publicize", "divination", "vote_commit"])
def test_werewolf_circuit_matches_reference(name, fx):
    from torch_parity import check_circuit, fewer_attempts
    ref = fx["circuits"][name]
    with fewer_attempts(1), mpc_scope(MpcContext(StackedTransport(WF.N_PARTIES, CPU), "semi")):
        cs, out = WF.build("zkmpc_tpu_torch", name, WF.Draws("zkmpc_tpu_torch", 0))
    check_circuit(cs, ref, WF.N_PARTIES)
    assert out == ref["outputs"]


@pytest.fixture(scope="module")
def game(tmp_path_factory):
    """The game binary's ``init``, ``role_assignment``, ``vote`` and
    ``judgment`` on the CPU in one game directory, each prove replaced by
    a record of its circuit; the SHE dealer kept for the MAC check."""
    from torch_parity import fewer_attempts
    gamedir = str(tmp_path_factory.mktemp("werewolf_game"))
    out = {"circuits": {}, "dealers": []}
    make_dealer = PP.make_dealer

    def dealer(*a, **k):
        out["dealers"].append(make_dealer(*a, **k))
        return out["dealers"][-1]
    with fewer_attempts(1), pytest.MonkeyPatch.context() as mp:
        mp.setattr(PP, "make_dealer", dealer)
        for mode in WF.MODES:
            def record(args, cs, gen, seed, report, mode=mode):
                out["circuits"][mode] = (cs, seed)
                report["prove_s"] = 0.0
                return True
            mp.setattr(WG, "_prove_and_verify", record)
            assert WG.MODES[mode](WF.game_args(gamedir, device="cpu"))
    out["gamedir"] = gamedir
    return out


@pytest.mark.parametrize("mode", WF.MODES)
def test_game_phase_matches_reference(mode, game, fx):
    from torch_parity import check_circuit
    ref = fx["game"][mode]
    assert WF.read_state(game["gamedir"], mode) == json.loads(json.dumps(ref["state"]))
    if mode != "init":
        cs, seed = game["circuits"][mode]
        assert seed == WF.SEED + {"role_assignment": 23, "vote": 41, "judgment": 51}[mode]
        check_circuit(cs, ref["circuit"], WF.N_PARTIES)
        return
    # the SHE preprocessing's <r> shares: one file a party, 8 slots each,
    # MAC shares summing to alpha times the shared value in every slot
    (dealer,) = game["dealers"]
    alpha = sum(int(a) for a in dealer.alpha_shares.to_ints()) % P
    files = [SER.read_online_setup(os.path.join(game["gamedir"], str(i), "online_setup.json"))
             for i in range(WF.N_PARTIES)]
    assert [f[0] for f in files] == list(range(WF.N_PARTIES))
    assert all(len(r) == len(mac) == 8 for _, r, mac in files)
    for slot in range(8):
        r = sum(f[1][slot] for f in files) % P
        assert sum(f[2][slot] for f in files) % P == alpha * r % P


def test_vote_proof_verifies_under_the_ports_key(game, fx):
    """The port's setup of the vote circuit gives the JAX package's
    verifying key; the JAX proof verifies under it, a wrong instance not."""
    ref = fx["vote_proof"]
    cs, seed = game["circuits"]["vote"]
    vk = groth16._verifying_key(groth16.setup_params(cs, seed))
    assert WF.plain([vk.alpha_g1, vk.beta_g2, vk.gamma_g2, vk.delta_g2, vk.ic]) == ref["vk"]
    proof = tuple(tuple(tuple(c) if isinstance(c, list) else c for c in pt)
                  for pt in ref["proof"])
    instance = cs.instance_ints()
    assert groth16.verify(vk, instance, proof)
    assert not groth16.verify(vk, [1, (instance[1] + 1) % P], proof)


@pytest.mark.gpu
def test_vote_and_judgment_on_the_card(tmp_path, fx):
    """On the card: ``init``, ``vote --votes 2,2,0`` and ``judgment`` end
    to end (each proof verifies, a wrong instance is rejected) with K1 and
    K2 launched; the vote circuit re-proved with the JAX package's r and s
    gives the JAX proof."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from zkmpc_tpu_torch.ops import build as K
    dev = torch.device("cuda")
    args = WF.game_args(str(tmp_path), device="cuda")
    circuits = {}
    real = WG._prove_and_verify

    def keep(a, cs, gen, seed, report):
        circuits[seed] = cs
        return real(a, cs, gen, seed, report)
    assert WG.mode_init(args)
    K.reset_launches()
    reports = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(WG, "_prove_and_verify", keep)
        for mode in ("vote", "judgment"):
            reports[mode] = {}
            assert WG.MODES[mode](args, reports[mode])
    assert all(r["verified"] and r["wrong_instance_rejected"] for r in reports.values())
    assert min(K.LAUNCHES.get("mont_mul", 0), K.LAUNCHES.get("point_add_g1", 0)) > 0
    assert WF.read_state(str(tmp_path), "vote") == fx["game"]["vote"]["state"]
    assert WF.read_state(str(tmp_path), "judgment") == fx["game"]["judgment"]["state"]
    ref = fx["vote_proof"]
    cs = circuits[ref["setup_seed"]]

    def share(name):
        limbs, bound = fx[name]
        return FpArray(torch.as_tensor(limbs.astype(np.int64)).to(dev), FR, bound)
    with WG._scope(WF.N_PARTIES, dev):
        dpk = groth16.device_setup(cs, seed=ref["setup_seed"], device=dev)
        proof = groth16.proof_to_ints(groth16.prove(dpk, cs, r=share("r"), s=share("s")))
    assert WF.plain(proof) == ref["proof"]
    assert groth16.verify(dpk.pk.vk, cs.instance_ints(), proof)
