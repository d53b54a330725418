"""Interactive werewolf game: the reference's `werewolf-cli`
(`examples/werewolf_cli/{main,game}.rs`).

Port of ``zkmpc_tpu/cli/werewolf_cli.py``: a terminal game loop over
Night -> Morning -> Discussion -> Voting with roles dealt by the verifiable
shuffle, night kills, seer divinations, vote eliminations and win checks.
``--prove`` runs the seer's divination and each vote as collaborative
Groth16 proofs at one party per player (the reference's optional proof
mode), through the game binary's helpers (`cli/werewolf_game.py`); without
it the game logic runs alone.

Usage:
  python -m zkmpc_tpu_torch.cli.werewolf_cli --names alice,bob,carol [--prove]
  python -m zkmpc_tpu_torch.cli.werewolf_cli --script 'kills=2;votes=1,2,0'
    (scripted, non-interactive)

The proofs run on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import random as pyrandom
import sys
import time

import torch

from ..apps import werewolf as WD
from ..circuits import werewolf as WC
from ..crypto import elgamal as EG
from ..mpc import bits as B
from ..mpc import te as TE
from ..ops.limbs import FR
from ..snark.r1cs import ConstraintSystem
from ..spec import curves as SC
from . import werewolf_game as WG


@dataclasses.dataclass
class Player:
    id: int
    name: str
    role: str              # "Werewolf" | "FortuneTeller" | "Villager"
    is_alive: bool = True


@dataclasses.dataclass
class GameRules:
    """`game.rs:GameRules`: player bounds, werewolf ratio, seer count."""
    min_players: int = 3
    max_players: int = 12
    werewolf_ratio: float = 0.34
    seer_count: int = 1


class Game:
    """`game.rs:Game`: a state machine over the four phases.  With
    ``prove``, ``proofs`` collects one report a proof (what was proved,
    constraints, seconds, openings, outcome)."""

    def __init__(self, names, rules: GameRules | None = None, seed: int = 0,
                 prove: bool = False, device="cuda"):
        self.rules = rules or GameRules()
        n = len(names)
        assert self.rules.min_players <= n <= self.rules.max_players
        n_wolves = max(1, int(n * self.rules.werewolf_ratio))
        n_seers = self.rules.seer_count
        gp = WD.GroupingParameter({WD.Role.FORTUNE_TELLER: (n_seers, n_seers > 1),
                                   WD.Role.WEREWOLF: (n_wolves, n_wolves > 1),
                                   WD.Role.VILLAGER: (n - n_wolves - n_seers, False)})
        rng = pyrandom.Random(seed)
        self.gp = gp
        self.shuffles = [WD.generate_individual_shuffle_matrix(
            gp.num_players(), gp.num_groups(), rng) for _ in range(n)]
        roles = [WD.calc_shuffle_matrix(gp, self.shuffles, pid)[0] for pid in range(n)]
        self.players = [Player(i, nm, roles[i].value) for i, nm in enumerate(names)]
        self.day = 1
        self.phase = "Night"
        self.prove = prove
        self.seed = seed
        self.device = torch.device(device)
        self.log: list[str] = []
        self.proofs: list[dict] = []

    # ------------------------------------------------------------- helpers

    def alive(self):
        return [p for p in self.players if p.is_alive]

    def wolves_alive(self):
        return [p for p in self.alive() if p.role == "Werewolf"]

    def _say(self, msg):
        self.log.append(msg)
        print(msg)

    # --------------------------------------------------------------- phases

    def night(self, kill_id: int | None, divine_id: int | None = None):
        """Werewolves kill; the seer divines (`game.rs` night phase)."""
        assert self.phase == "Night"
        if divine_id is not None:
            is_wolf = self.players[divine_id].role == "Werewolf"
            if self.prove:
                is_wolf = self._prove_divination(divine_id)
            self._say(f"[seer] player {divine_id} {'IS' if is_wolf else 'is NOT'} a werewolf")
        if kill_id is not None and self.players[kill_id].is_alive:
            self.players[kill_id].is_alive = False
            self._say(f"[night] player {kill_id} ({self.players[kill_id].name}) was killed")
        self.phase = "Morning"

    def morning(self):
        assert self.phase == "Morning"
        state = self._judge()
        self._say(f"[morning] day {self.day}: {len(self.alive())} alive, game state = {state}")
        self.phase = "Discussion" if state == 3 else "Over"
        return state

    def discussion(self):
        assert self.phase == "Discussion"
        self.phase = "Voting"

    def vote(self, votes: dict):
        """votes: voter id -> target id.  The most voted is eliminated (a
        tie keeps the lowest id, as the circuit's running argmax does)."""
        assert self.phase == "Voting"
        n = len(self.players)
        tally = [0] * n
        for voter, target in votes.items():
            if self.players[voter].is_alive:
                tally[target] += 1
        winner = max(range(n), key=lambda i: (tally[i], -i))
        if self.prove:
            winner = self._prove_vote(votes)
        self.players[winner].is_alive = False
        self._say(f"[vote] player {winner} ({self.players[winner].name}) eliminated with "
                  f"{tally[winner]} votes")
        state = self._judge()
        self.day += 1
        self.phase = "Night" if state == 3 else "Over"
        return state

    def _judge(self) -> int:
        """1 = werewolf win, 2 = villager win, 3 = continue
        (WinningJudgeCircuit semantics)."""
        n_w = len(self.wolves_alive())
        n_alive = len(self.alive())
        if n_w == 0:
            return 2
        if n_w < n_alive - n_w:
            return 3
        return 1

    # ------------------------------------------------- optional MPC proofs

    def _prove(self, what, cs, generator, setup_seed, report):
        """Groth16-prove a synthesized circuit through the game binary's
        helper; the proof must verify and a wrong instance be rejected."""
        args = argparse.Namespace(zksnark="groth16", device=str(self.device))
        report["what"] = what
        ok = WG._prove_and_verify(args, cs, generator, setup_seed, report)
        self.proofs.append(report)
        assert ok, f"{what} proof rejected"

    def _prove_divination(self, target: int) -> bool:
        keys = EG.keygen(self.seed + 99)
        n = len(self.players)
        gen = torch.Generator(self.device).manual_seed(self.seed + self.day)
        report = {}
        with WG._scope(n, self.device):
            t0, r0 = time.time(), WG._rounds()
            is_w = [WG._shared_scalar(1 if p.role == "Werewolf" else 0, gen)
                    for p in self.players]
            is_t = [WG._shared_scalar(1 if i == target else 0, gen) for i in range(n)]
            r_bits = B.bit_rand(gen, FR, (16,))
            hit = is_w[0] * is_t[0]
            for i in range(1, n):
                hit = hit + is_w[i] * is_t[i]
            c1, c2 = EG.encrypt_shared(keys.pk, TE.select_base(hit, SC.TE_GEN), r_bits)
            c1_xy = c1.reveal_affine_ints()[0]
            c2_xy = c2.reveal_affine_ints()[0]
            cs = ConstraintSystem(FR)
            WC.divination_circuit(cs, is_w, is_t, r_bits, keys.pk, c1_xy, c2_xy, gen)
            WG._synthesized(report, cs, t0, r0, self.device)
            self._prove(f"divination day {self.day}", cs, gen, self.seed + 7, report)
        return EG.decrypt_ints(keys, c1_xy, c2_xy) == SC.TE_GEN

    def _prove_vote(self, votes: dict) -> int:
        n = len(self.players)
        voters = [v for v in votes if self.players[v].is_alive]
        gen = torch.Generator(self.device).manual_seed(self.seed + 100 + self.day)
        report = {}
        with WG._scope(n, self.device):
            t0, r0 = time.time(), WG._rounds()
            wires = WG.vote_wires([votes[v] for v in voters], n, gen)
            winner = WG._opened_int(WC.calculate_voting_output(wires, gen))
            cs = ConstraintSystem(FR)
            WC.anonymous_voting_circuit(cs, wires, winner, gen)
            WG._synthesized(report, cs, t0, r0, self.device)
            self._prove(f"vote day {self.day}", cs, gen, self.seed + 8, report)
        return winner


def run_scripted(names, script: str, seed: int = 0, prove: bool = False, device="cuda"):
    """Drive the game from a script 'kills=a,b,..;votes=v0|v1|..;divines=..'
    where each round's votes are a comma-joined voter -> target list."""
    game = Game(names, seed=seed, prove=prove, device=device)
    parts = dict(kv.split("=", 1) for kv in script.split(";") if kv)
    kills = [int(x) for x in parts.get("kills", "").split(",") if x != ""]
    divines = [int(x) for x in parts.get("divines", "").split(",") if x != ""]
    vote_rounds = [vr for vr in parts.get("votes", "").split("|") if vr]
    rnd = 0
    while game.phase != "Over":
        game.night(kills[rnd] if rnd < len(kills) else None,
                   divines[rnd] if rnd < len(divines) else None)
        game.morning()
        if game.phase == "Over":
            break
        game.discussion()
        if rnd < len(vote_rounds):
            votes = {i: int(t) for i, t in enumerate(vote_rounds[rnd].split(","))}
        else:
            votes = {p.id: (p.id + 1) % len(names) for p in game.alive()}
        game.vote(votes)
        rnd += 1
        if rnd > 20:
            break
    return game


def interactive(names, seed, prove, device="cuda"):
    game = Game(names, seed=seed, prove=prove, device=device)
    print("roles dealt (secret).  phases: night -> morning -> vote")
    while game.phase != "Over":
        kill = input("night kill id (empty = none): ").strip()
        div = input("seer divines id (empty = none): ").strip()
        game.night(int(kill) if kill else None, int(div) if div else None)
        if game.morning() != 3:
            break
        game.discussion()
        votes = {}
        for p in game.alive():
            votes[p.id] = int(input(f"player {p.id} ({p.name}) votes for: ").strip())
        game.vote(votes)
    print("game over:", "werewolves win" if game._judge() == 1 else "villagers win")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--names", default="alice,bob,carol")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prove", action="store_true")
    ap.add_argument("--script", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the proofs (default cuda; cpu without a card)")
    args = ap.parse_args(argv)
    names = args.names.split(",")
    if args.script is not None:
        game = run_scripted(names, args.script, args.seed, args.prove, args.device)
        sys.exit(0 if game.phase == "Over" or game._judge() != 3 else 1)
    interactive(names, args.seed, args.prove, args.device)


if __name__ == "__main__":
    main()
