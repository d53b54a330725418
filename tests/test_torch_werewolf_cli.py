"""The port's werewolf CLI game and the protocol and short-Weierstrass
gadget circuits against the JAX package.

- `cli/werewolf_cli.py`: the four games of ``tests/test_werewolf_cli.py``
  (roles dealt, villagers win by vote, werewolves win by kills, a scripted
  5-player game) end in the JAX CLI's states: players, roles, who is
  alive, day, phase and log, live against the JAX module (no proofs; the
  card runs ``run_scripted(..., prove=True)`` in ``chip_smoke.py`` phase 9).
- `circuits/protocol_circuits.py` (equality-zero, not-equality-zero at 5
  and 0, bit decomposition, smaller-than, smaller-than-or-equal through
  ``check_eq``, smaller-or-equal against a public bound) and
  `circuits/sw_gadget.py` (add, double, double-and-add; a shared witness
  point's curve check; the offset scalar ladder over shared bits): each
  circuit's counts, A/B/C, instance and opened assignment, and the opened
  points, exactly as in ``fixtures/torch_werewolf_3p.npz``.  The bit
  protocols draw one candidate for each random bitwise-shared value
  (`torch_parity.fewer_attempts(1)`).
"""

import numpy as np
import pytest
import torch

from fixtures import make_torch_werewolf_fixture as WF
from torch_parity import CPU, check_circuit, fewer_attempts
from zkmpc_tpu_torch.cli import werewolf_cli as TC
from zkmpc_tpu_torch.mpc.share import MpcContext, mpc_scope
from zkmpc_tpu_torch.parallel.transport import StackedTransport

torch.set_num_threads(1)

PROTOCOL = ["eq_zero", "neq_zero_5", "neq_zero_0", "bit_decomposition", "smaller_than",
            "smaller_than_eq", "smaller_eq_than"]
SW = ["sw_add", "sw_witness", "sw_scalar_mul"]


@pytest.fixture(scope="module")
def fx():
    return WF.load(np.load(WF.PATH))


def _state(game):
    return ([(p.id, p.name, p.role, p.is_alive) for p in game.players], game.day,
            game.phase, game.log)


def _villagers_win(C):
    g = C.Game(["a", "b", "c"], seed=3)
    wolf = next(p.id for p in g.players if p.role == "Werewolf")
    g.night(None, None)
    assert g.morning() == 3
    g.discussion()
    assert g.vote({p.id: wolf for p in g.alive()}) == 2
    return g


def _werewolves_win(C):
    g = C.Game(["a", "b", "c"], seed=3)
    wolf = next(p.id for p in g.players if p.role == "Werewolf")
    g.night(next(p.id for p in g.players if p.id != wolf), None)
    assert g.morning() == 1
    return g


def _roles_dealt(C):
    g = C.Game(["a", "b", "c"], seed=3)
    assert sorted(p.role for p in g.players) == ["FortuneTeller", "Villager", "Werewolf"]
    return g


def _scripted(C):
    g = C.run_scripted(["a", "b", "c", "d", "e"], "kills=0;votes=1,1,1,1,1", seed=1)
    assert g.day >= 1 and not g.players[0].is_alive
    return g


GAMES = {"roles_dealt": _roles_dealt, "villagers_win_by_vote": _villagers_win,
         "werewolf_win_by_kills": _werewolves_win, "scripted": _scripted}


@pytest.mark.parametrize("name", list(GAMES))
def test_cli_game_ends_as_the_reference(name):
    from zkmpc_tpu.cli import werewolf_cli as JC
    assert _state(GAMES[name](TC)) == _state(GAMES[name](JC))


@pytest.mark.parametrize("name", PROTOCOL + SW)
def test_gadget_circuit_matches_reference(name, fx):
    ref = fx["circuits"][name]
    with fewer_attempts(1), mpc_scope(MpcContext(StackedTransport(WF.N_PARTIES, CPU), "semi")):
        cs, out = WF.build("zkmpc_tpu_torch", name, WF.Draws("zkmpc_tpu_torch", 0))
    check_circuit(cs, ref, WF.N_PARTIES)
    assert out == ref["outputs"]
