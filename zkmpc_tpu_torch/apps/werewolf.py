"""Werewolf game domain logic: roles, grouping, shuffle matrices.

Port of ``zkmpc_tpu/apps/werewolf.py`` (the reference's
`src/werewolf/{types,utils}.rs`): roles are assigned by conjugating a fixed
tau permutation-graph matrix with secret player permutations,
rho = M^T tau M; a player learns its role from the cycle structure of rho
applied to its unit vector.  Pure Python and numpy: the shuffles come from
``random.Random``, so the same seed deals the same roles in both packages.
"""

from __future__ import annotations

import dataclasses
import enum
import random as pyrandom

import numpy as np


class Role(enum.Enum):
    FORTUNE_TELLER = "FortuneTeller"
    WEREWOLF = "Werewolf"
    VILLAGER = "Villager"

    def is_werewolf(self) -> bool:
        return self is Role.WEREWOLF


# ordering matches the reference's BTreeMap<Role, _> iteration
# (FortuneTeller < Werewolf < Villager, `types.rs:6-11` derive Ord)
_ROLE_ORDER = [Role.FORTUNE_TELLER, Role.WEREWOLF, Role.VILLAGER]


@dataclasses.dataclass
class GroupingParameter:
    """role -> (count, is_not_alone), reference `types.rs:38-124`."""

    groups: dict

    def num_players(self) -> int:
        return sum(c for c, _ in self.groups.values())

    def num_groups(self) -> int:
        return sum(1 if not_alone else c for c, not_alone in self.groups.values())

    def max_group_size(self) -> int:
        return max(c if not_alone else 1 for c, not_alone in self.groups.values())

    def generate_tau_matrix(self) -> np.ndarray:
        """(n+m)x(n+m) 0/1 matrix; one cycle per group through its players
        and its group node (`types.rs:46-88`)."""
        n = self.num_players()
        m = self.num_groups()
        tau = np.zeros((n + m, n + m), dtype=np.int64)
        player = 0
        group = 0
        for role in _ROLE_ORDER:
            if role not in self.groups:
                continue
            count, not_alone = self.groups[role]
            if not_alone:
                assert count >= 2, "not-alone group needs >= 2 members"
                tau[player, n + group] = 1
                for _ in range(count - 1):
                    tau[player + 1, player] = 1
                    player += 1
                tau[n + group, player] = 1
                player += 1
                group += 1
            else:
                for _ in range(count):
                    tau[player, n + group] = 1
                    tau[n + group, player] = 1
                    player += 1
                    group += 1
        return tau

    def corresponding_role(self, role_id: int) -> Role:
        count = self.num_players()
        for role in _ROLE_ORDER:
            if role not in self.groups:
                continue
            role_count, not_alone = self.groups[role]
            count += 1 if not_alone else role_count
            if role_id < count:
                return role
        raise ValueError(f"invalid role id {role_id}")


def generate_individual_shuffle_matrix(n: int, m: int, rng: pyrandom.Random) -> np.ndarray:
    """Random player-permutation matrix, identity on group nodes
    (`utils.rs:84-105`)."""
    perm = list(range(n))
    rng.shuffle(perm)
    s = np.zeros((n + m, n + m), dtype=np.int64)
    for i in range(n):
        s[i, perm[i]] = 1
    for i in range(n, n + m):
        s[i, i] = 1
    return s


def calc_shuffle_matrix(gp: GroupingParameter, shuffle_matrices: list, player_id: int):
    """-> (role, role_id, fellows or None), reference `utils.rs:16-82`."""
    n = gp.num_players()
    m = gp.num_groups()
    tau = gp.generate_tau_matrix()
    M = np.eye(n + m, dtype=np.int64)
    for s in shuffle_matrices:
        M = (M @ s) % 2                  # permutation matrices: entries stay 0/1
    rho = M.T @ tau @ M
    # rho^1 ... rho^n applied to the player's unit vector
    result = []
    cur = np.zeros(n + m, dtype=np.int64)
    cur[player_id] = 1
    for _ in range(n):
        cur = rho @ cur
        nz = np.nonzero(cur)[0]
        assert len(nz) == 1
        result.append(int(nz[0]))
    role_val = max(result)
    role = gp.corresponding_role(role_val)
    fellows = sorted({x for x in result if x != player_id and x < n})
    return role, role_val, (fellows or None)
