"""Werewolf game binary: every phase of the reference's `bin-werewolf`
(`examples/bin_werewolf.rs:88-935`).

Port of ``zkmpc_tpu/cli/werewolf_game.py``: a single-process simulation of
the parties (each phase's MPC runs over the stacked transport) with the
state passed between phases through JSON files in ``--gamedir``, the
reference's mode-per-invocation design.

Modes:
  init             role assignment files + SPDZ preprocessing (`:166-252`)
  preprocessing    KeyPublicize MPC proof + ElGamal key publication (`:254-355`)
  role_assignment  shuffle + RoleAssignment MPC proof (`:357-486`)
  night            DivinationCircuit MPC proof + seer decryption (`:488-703`)
  vote             AnonymousVoting proof (`:705-782`)
  judgment         WinningJudge proof (`:784-935`)

Each proof is verified, and so must be its rejection of a wrong instance.
``--zksnark marlin`` proves every phase under one universal SRS, kept in
``<gamedir>/universal_srs.json`` (the reference's trust model,
`bin_werewolf.rs:430`); without ``--srs-degree`` the first Marlin phase
sets it up at the smallest degree that holds its own circuit.

Usage: python -m zkmpc_tpu_torch.cli.werewolf_game <mode> [--players 3]
       [--gamedir werewolf_game] [--target 1] [--votes 2,2,0]
       [--zksnark groth16|marlin] [--device cuda]

It runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import random as pyrandom
import sys
import time

import numpy as np
import torch

from ..apps import werewolf as WD
from ..circuits import werewolf as WC
from ..crypto import elgamal as EG
from ..crypto import pedersen as PD
from ..mpc import bits as B
from ..mpc import te as TE
from ..mpc.share import MpcContext, MpcFp, _sum_axis0, king_share, mpc_scope
from ..ops.limbs import FR, FpArray
from ..parallel import transport as T
from ..parallel.transport import StackedTransport
from ..she import bgv
from ..she import preprocessing as PP
from ..snark import groth16, kzg, marlin
from ..snark.r1cs import ConstraintSystem
from ..spec import curves as SC
from ..utils import serialize as SER

GAME_STATES = {1: "werewolf win", 2: "villager win", 3: "continue"}


def _state_path(gamedir, name):
    os.makedirs(gamedir, exist_ok=True)
    return os.path.join(gamedir, name)


def _save(gamedir, name, doc):
    with open(_state_path(gamedir, name), "w") as f:
        json.dump(doc, f, indent=1)


def _load(gamedir, name):
    with open(os.path.join(gamedir, name)) as f:
        return json.load(f)


def _device(args) -> torch.device:
    return torch.device(getattr(args, "device", "cuda"))


def _generator(args, stream: int) -> torch.Generator:
    """The draws of one mode, seeded from (seed, stream) on the run's device."""
    return torch.Generator(_device(args)).manual_seed(args.seed + stream)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _scope(n, device):
    return mpc_scope(MpcContext(StackedTransport(n, device), backend="semi"))


def _fr(vals, device):
    return FpArray.from_int(FR, np.asarray(vals, dtype=object), device=device)


def _shared_scalar(v, generator):
    """The leader deals the scalar v: a shared wire of shape ()."""
    x = king_share(_fr([int(v)], generator.device), generator)
    return x.map(lambda f: FpArray(f.limbs[..., 0, :], f.spec, f.bound))


def _opened_int(w: MpcFp) -> int:
    return int(np.asarray(w.reveal().to_ints()).reshape(-1)[0])


def _universal_srs(args, cs, report):
    """ONE universal Marlin SRS shared by every phase, set up once, kept in
    the gamedir and reloaded by later phases.  Without ``srs_degree`` the
    first phase sets it up at the smallest degree its own circuit needs."""
    path = _state_path(args.gamedir, "universal_srs.json")
    need = marlin.srs_degree_for(cs)
    if os.path.exists(path):
        srs = kzg.load_srs(path)
    else:
        degree = getattr(args, "srs_degree", None) or need
        t0 = time.time()
        srs = marlin.universal_setup(degree, seed=args.seed + 99, device=_device(args))
        kzg.save_srs(srs, path)
        report["srs_setup_s"] = time.time() - t0
        print(f"universal setup: degree {degree} ({report['srs_setup_s']:.2f}s, one-time, "
              f"shared by all phases)")
    report.update(srs_degree=len(srs.powers) - 1, srs_degree_needed=need)
    if need > len(srs.powers) - 1:
        raise SystemExit(f"the universal SRS has degree {len(srs.powers) - 1}; this phase's "
                         f"circuit needs {need}")
    return srs


def _rounds() -> int:
    """Openings made so far on the ambient transport."""
    return T.current().stats.rounds


def _synthesized(report, cs, t0, rounds0, device):
    """Record a phase's synthesis: seconds (to a device synchronize),
    openings and constraints; the circuit must be satisfied."""
    _sync(device)
    report.update(synthesis_s=time.time() - t0, synthesis_openings=_rounds() - rounds0,
                  constraints=len(cs.constraints), variables=cs.num_vars)
    if not cs.is_satisfied_ints():
        raise AssertionError("circuit unsatisfied")


def _prove_and_verify(args, cs, generator, setup_seed, report) -> bool:
    """Prove and verify one phase circuit under the selected zkSNARK; a
    wrong instance must be rejected too.

    marlin: indexes under the SHARED universal SRS; groth16: a
    circuit-specific setup through the device MSM path (`device_setup`).
    ``report`` receives the seconds of setup (or index), prove and verify,
    the prove's openings, the domain size and both outcomes."""
    dev = _device(args)
    t0 = time.time()
    if getattr(args, "zksnark", "groth16") == "marlin":
        index = marlin.index_with_srs(_universal_srs(args, cs, report), cs, device=dev)
        _sync(dev)
        report["index_s"] = time.time() - t0
        rounds, t0 = _rounds(), time.time()
        proof = marlin.prove(index, cs, generator)
        _sync(dev)
        report.update(domain_n=index.domain_n)

        def check(instance):
            return marlin.verify(index, instance, proof)
    else:
        dpk = groth16.device_setup(cs, seed=setup_seed, device=dev)
        _sync(dev)
        report["setup_s"] = time.time() - t0
        rounds, t0 = _rounds(), time.time()
        proof = groth16.proof_to_ints(groth16.prove(dpk, cs, generator))
        report.update(domain_n=dpk.pk.domain_n)

        def check(instance):
            return groth16.verify(dpk.pk.vk, instance, proof)
    report.update(prove_s=time.time() - t0, prove_openings=_rounds() - rounds, proof=proof)
    instance = cs.instance_ints()
    bad = list(instance)
    bad[1] = (bad[1] + 1) % FR.p
    t0 = time.time()
    ok = check(instance)
    report.update(verify_s=time.time() - t0, verified=ok, wrong_instance_rejected=not check(bad))
    return ok and report["wrong_instance_rejected"]


def _grouping(n_players):
    # the reference's default: 1 fortune teller, 1 werewolf, rest villagers
    return WD.GroupingParameter({WD.Role.FORTUNE_TELLER: (1, False),
                                 WD.Role.WEREWOLF: (1, False),
                                 WD.Role.VILLAGER: (n_players - 2, False)})


def _find_role(gamedir, n, role_name):
    for pid in range(n):
        if _load(gamedir, f"role_{pid}.json")["role"] == role_name:
            return pid
    raise SystemExit(f"no player with role {role_name}")


def mode_init(args, report=None):
    """Role files + preprocessing (`bin_werewolf.rs:166-252`): the shuffles
    deal the roles, then SHE/SPDZ preprocessing (keys, initialize under
    ZKPoPKs, pair, triple) at ``--slots`` slots writes each party's
    ``<gamedir>/<i>/online_setup.json``."""
    rep = report if report is not None else {}
    dev = _device(args)
    n = args.players
    gp = _grouping(n)
    rng = pyrandom.Random(args.seed)
    shuffles = [WD.generate_individual_shuffle_matrix(gp.num_players(), gp.num_groups(), rng)
                for _ in range(n)]
    for pid in range(n):
        role, role_id, fellows = WD.calc_shuffle_matrix(gp, shuffles, pid)
        _save(args.gamedir, f"role_{pid}.json",
              {"role": role.value, "role_id": role_id, "fellows": fellows or []})
    _save(args.gamedir, "public.json", {"players": n, "alive": list(range(n)), "seed": args.seed})
    _save(args.gamedir, "shuffles.json",
          {"matrices": [[[int(v) for v in row] for row in S] for S in shuffles]})

    t0 = time.time()
    gen = _generator(args, 0)
    ctx = PP.make_dealer(bgv.SheParams(args.slots), n, gen, device=dev)
    PP.initialize(ctx, gen)                             # raises on a rejected ZKPoPK
    (r_shares, r_macs), _ = PP.pair(ctx, gen)
    (a, _), (b, _), (c, _) = PP.triple(ctx, gen)
    # the reference's triple test: a*b == c in every slot
    av, bv, cv = (_sum_axis0(x).to_ints() for x in (a, b, c))
    if not all(int(x) * int(y) % FR.p == int(z) for x, y, z in zip(av, bv, cv)):
        raise AssertionError("preprocessing triple a*b != c")
    for i in range(n):
        SER.write_online_setup(os.path.join(args.gamedir, str(i), "online_setup.json"), i,
                               SER.fparray_to_hex(r_shares[i]), SER.fparray_to_hex(r_macs[i]))
    _sync(dev)
    rep["preprocessing_s"] = time.time() - t0
    print(f"init: roles dealt, preprocessing {rep['preprocessing_s']:.2f}s "
          f"({args.slots} slots)")
    return True


def mode_preprocessing(args, report=None):
    """KeyPublicize proof: the fortune teller's ElGamal public key is summed
    (dummies elsewhere) and published (`bin_werewolf.rs:254-355`)."""
    rep = report if report is not None else {}
    dev = _device(args)
    n = args.players
    ft_id = _find_role(args.gamedir, n, "FortuneTeller")
    keys = EG.keygen(args.seed + 10)
    _save(args.gamedir, "fortune_teller_key.json",
          {"sk": keys.sk, "pk": [int(keys.pk[0]), int(keys.pk[1])]})
    gen = _generator(args, 11)
    with _scope(n, dev):
        t0, r0 = time.time(), _rounds()
        pk_x = [_shared_scalar(keys.pk[0] if i == ft_id else 0, gen) for i in range(n)]
        pk_y = [_shared_scalar(keys.pk[1] if i == ft_id else 0, gen) for i in range(n)]
        is_ft = [_shared_scalar(1 if i == ft_id else 0, gen) for i in range(n)]
        cs = ConstraintSystem(FR)
        WC.key_publicize_circuit(cs, pk_x, pk_y, is_ft, int(keys.pk[0]), int(keys.pk[1]))
        _synthesized(rep, cs, t0, r0, dev)
        ok = _prove_and_verify(args, cs, gen, args.seed + 12, rep)
    _save(args.gamedir, "elgamal_pubkey.json",
          {"pk": [int(keys.pk[0]), int(keys.pk[1])], "verified": bool(ok)})
    print(f"preprocessing: key publicized, proof ok={ok} ({rep['prove_s']:.2f}s, "
          f"{len(cs.constraints)} constraints)")
    return ok


def mode_role_assignment(args, report=None):
    """RoleAssignment MPC proof (`bin_werewolf.rs:357-486`)."""
    rep = report if report is not None else {}
    dev = _device(args)
    n = args.players
    gp = _grouping(n)
    L = gp.num_players() + gp.num_groups()
    tau = gp.generate_tau_matrix()
    shuffles = [np.asarray(S, dtype=np.int64)
                for S in _load(args.gamedir, "shuffles.json")["matrices"]]
    role_ids = [WD.calc_shuffle_matrix(gp, shuffles, pid)[1] for pid in range(n)]

    pp = PD.PedersenParams.sample(args.seed + 20)
    rng = pyrandom.Random(args.seed + 21)
    r_ints = [rng.randrange(1 << 16) for _ in range(n)]
    role_coms = [PD.commit_public_ints(pp, role_ids[i], r_ints[i]) for i in range(n)]
    _save(args.gamedir, "role_commitments.json",
          {"commitments": [[int(c[0]), int(c[1])] for c in role_coms], "r": r_ints})
    gen = _generator(args, 22)
    with _scope(n, dev):
        t0, r0 = time.time(), _rounds()
        shuffle_wires = [[[_shared_scalar(int(S[i, j]), gen) for j in range(L)]
                          for i in range(L)] for S in shuffles]
        role_values = [_shared_scalar(v, gen) for v in role_ids]
        role_r_bits = [king_share(_fr([(r >> b) & 1 for b in range(16)], dev), gen)
                       for r in r_ints]
        cs = ConstraintSystem(FR)
        WC.role_assignment_circuit(cs, tau, shuffle_wires, role_values, role_r_bits,
                                   role_coms, gen, num_players=n, pedersen_pp=pp,
                                   com_nbits=16)
        _synthesized(rep, cs, t0, r0, dev)
        ok = _prove_and_verify(args, cs, gen, args.seed + 23, rep)
    print(f"role_assignment: proof ok={ok} ({rep['prove_s']:.2f}s, "
          f"{len(cs.constraints)} constraints)")
    return ok


def mode_night(args, report=None):
    """Divination: the seer learns whether the target is a werewolf, with
    an MPC proof that the published ciphertext is well formed
    (`bin_werewolf.rs:488-703`)."""
    rep = report if report is not None else {}
    dev = _device(args)
    n = args.players
    wolf_id = _find_role(args.gamedir, n, "Werewolf")
    target = args.target if args.target is not None else wolf_id
    ftk = _load(args.gamedir, "fortune_teller_key.json")
    keys = EG.ElGamalKeys(int(ftk["sk"]), tuple(ftk["pk"]))
    gen = _generator(args, 30)
    with _scope(n, dev):
        t0, r0 = time.time(), _rounds()
        is_w = [_shared_scalar(1 if i == wolf_id else 0, gen) for i in range(n)]
        is_t = [_shared_scalar(1 if i == target else 0, gen) for i in range(n)]
        r_bits = B.bit_rand(gen, FR, (args.rand_bits,))
        hit = is_w[0] * is_t[0]
        for i in range(1, n):
            hit = hit + is_w[i] * is_t[i]
        c1, c2 = EG.encrypt_shared(keys.pk, TE.select_base(hit, SC.TE_GEN), r_bits)
        c1_xy = c1.reveal_affine_ints()[0]
        c2_xy = c2.reveal_affine_ints()[0]
        cs = ConstraintSystem(FR)
        WC.divination_circuit(cs, is_w, is_t, r_bits, keys.pk, c1_xy, c2_xy, gen)
        _synthesized(rep, cs, t0, r0, dev)
        ok = _prove_and_verify(args, cs, gen, args.seed + 31, rep)
    is_wolf = EG.decrypt_ints(keys, c1_xy, c2_xy) == SC.TE_GEN
    _save(args.gamedir, "divination.json",
          {"target": target, "is_werewolf": bool(is_wolf), "verified": bool(ok)})
    print(f"night: target {target} is_werewolf={is_wolf} proof ok={ok} "
          f"({rep['prove_s']:.2f}s, {len(cs.constraints)} constraints)")
    return ok


def vote_wires(votes, n, generator):
    """The vote matrix [voter][candidate] as dealt 0/1 wires."""
    return [[_shared_scalar(1 if v == i else 0, generator) for i in range(n)] for v in votes]


def mode_vote(args, report=None):
    """Anonymous voting proof (`bin_werewolf.rs:705-782`)."""
    rep = report if report is not None else {}
    dev = _device(args)
    n = args.players
    votes = [int(v) for v in args.votes.split(",")] if args.votes else \
        [(i + 1) % n for i in range(n)]
    gen = _generator(args, 40)
    with _scope(n, dev):
        t0, r0 = time.time(), _rounds()
        wires = vote_wires(votes, n, gen)
        winner = _opened_int(WC.calculate_voting_output(wires, gen))
        cs = ConstraintSystem(FR)
        WC.anonymous_voting_circuit(cs, wires, winner, gen)
        _synthesized(rep, cs, t0, r0, dev)
        ok = _prove_and_verify(args, cs, gen, args.seed + 41, rep)
    _save(args.gamedir, "vote.json", {"votes": votes, "most_voted": winner, "verified": bool(ok)})
    print(f"vote: winner={winner} proof ok={ok} ({rep['prove_s']:.2f}s)")
    return ok


def mode_judgment(args, report=None):
    """Winning judgment proof (`bin_werewolf.rs:784-935`)."""
    rep = report if report is not None else {}
    dev = _device(args)
    n = args.players
    alive = _load(args.gamedir, "public.json").get("alive", list(range(n)))
    wolf_id = _find_role(args.gamedir, n, "Werewolf")
    gen = _generator(args, 50)
    with _scope(n, dev):
        t0, r0 = time.time(), _rounds()
        am_w = [_shared_scalar(1 if i == wolf_id and i in alive else 0, gen) for i in range(n)]
        state = _opened_int(WC.calculate_game_state(len(alive), am_w, gen))
        cs = ConstraintSystem(FR)
        WC.winning_judge_circuit(cs, len(alive), am_w, state, gen)
        _synthesized(rep, cs, t0, r0, dev)
        ok = _prove_and_verify(args, cs, gen, args.seed + 51, rep)
    _save(args.gamedir, "judgment.json",
          {"state": state, "meaning": GAME_STATES[state], "verified": bool(ok)})
    print(f"judgment: {GAME_STATES[state]} proof ok={ok} ({rep['prove_s']:.2f}s)")
    return ok


MODES = {"init": mode_init, "preprocessing": mode_preprocessing,
         "role_assignment": mode_role_assignment, "night": mode_night,
         "vote": mode_vote, "judgment": mode_judgment}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=sorted(MODES))
    ap.add_argument("--players", type=int, default=3)
    ap.add_argument("--gamedir", default="werewolf_game")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--target", type=int, default=None)
    ap.add_argument("--votes", default=None, help="comma-separated target ids, one per player")
    ap.add_argument("--rand-bits", type=int, default=32,
                    help="ElGamal randomness bits (251 for full security)")
    ap.add_argument("--zksnark", choices=["groth16", "marlin"], default="groth16",
                    help="marlin = one shared universal SRS for all phases")
    ap.add_argument("--srs-degree", type=int, default=None,
                    help="universal SRS degree for --zksnark marlin (default: the "
                         "smallest that holds the first Marlin phase's circuit)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a run without a card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    sys.exit(0 if MODES[args.mode](args) else 1)


if __name__ == "__main__":
    main()
