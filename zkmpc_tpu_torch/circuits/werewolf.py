"""Werewolf circuit suite: KeyPublicize, Divination (in-circuit ElGamal),
AnonymousVoting, WinningJudge, RoleAssignment.

Port of ``zkmpc_tpu/circuits/werewolf.py`` (the reference's
`src/circuits/werewolf.rs`).  Every circuit synthesizes identically over
public or shared wires; the scalar protocols run as the batched gadget
forms (`snark/gadgets.py:mul_many/less_than_many`), one tensor round per
protocol layer.  Wires are allocated and constraints emitted in the JAX
package's order, so the R1CS matrices are its matrices.  Where the JAX
package splits or folds a key per sub-protocol, these take one
``torch.Generator`` and draw from it in turn: no circuit, instance or
opened value depends on the protocols' draws.

The two strengthenings of the JAX package over the reference are kept:
permutation booleanity is the direct b(b-1) = 0 constraint, and the voting
argmax tracks the running best vote count.
"""

from __future__ import annotations

import numpy as np

from ..mpc import bits as B
from ..mpc.share import MpcFp
from ..ops.limbs import FR
from ..snark.gadgets import (Boolean, FpVar, _stack_values, less_than_many, matmul_gadget,
                             mul_many)
from ..snark.r1cs import LC, ConstraintSystem
from ..spec import curves as SC
from .elgamal_gadget import ElGamalCiphertextVar, alloc_public_point, encrypt_gadget
from .pedersen_gadget import TEAffineVar, pedersen_com_circuit


def _bools(cs: ConstraintSystem, bits: MpcFp) -> list:
    """One Boolean witness per element of a [n] bit wire."""
    return [Boolean.new_witness(cs, B._index_last(bits, j)) for j in range(bits.shape[-1])]


def _commit_checks(cs, messages, randomness, commitments, pp, generator, nbits=None):
    """One PedersenComCircuit per message, in order: messages[i] (an
    allocated FpVar, or a value allocated here just before its circuit)
    committed under the bits randomness[i] (None: zero randomness) to the
    public commitments[i].  The messages' bit decompositions run as one
    batched protocol run; wires and constraints come in the JAX package's
    order (its one decomposition a circuit)."""
    values = [m.value if isinstance(m, FpVar) else m for m in messages]
    decomp = B.bit_decomposition(_stack_values(values), generator)     # [k, full]
    for i, m in enumerate(messages):
        r_bools = [] if randomness is None else _bools(cs, randomness[i])
        var = m if isinstance(m, FpVar) else FpVar.new_witness(cs, m)
        pedersen_com_circuit(cs, var, r_bools, commitments[i], pp, generator, nbits=nbits,
                             m_bits_val=decomp[i])


# ---------------------------------------------------------------------------
# KeyPublicizeCircuit (`werewolf.rs:43-143`)
# ---------------------------------------------------------------------------


def key_publicize_circuit(cs: ConstraintSystem, pk_x_wires, pk_y_wires, is_ft_wires,
                          sum_x_pub: int, sum_y_pub: int, pedersen_pp=None,
                          xy_randomness=None, xy_commitments=None, generator=None,
                          com_nbits=None):
    """Witness per-player (pk-or-dummy x, y, is_fortune_teller); enforce the
    is_ft flags boolean and that sum_i pk_i * is_ft_i is the published
    aggregate key.

    With pedersen_pp, xy_randomness and xy_commitments set, each pk_x and
    pk_y witness is also bound to a published Pedersen commitment (the
    reference's `verify_commitments`, `werewolf.rs:48-78`: 15,266
    constraints at 3 players).  xy_randomness/xy_commitments: 2n entries
    (x's then y's) of randomness-bit wires and public commitment points."""
    x_vars = [FpVar.new_witness(cs, w) for w in pk_x_wires]
    y_vars = [FpVar.new_witness(cs, w) for w in pk_y_wires]
    ft_vars = [FpVar.new_witness(cs, w) for w in is_ft_wires]
    if pedersen_pp is not None:
        _commit_checks(cs, x_vars + y_vars, xy_randomness, xy_commitments, pedersen_pp,
                       generator, com_nbits)
    for b in ft_vars:
        cs.enforce(b.lc, LC.constant(1) - b.lc, LC({}))     # b in {0,1}
    xs = mul_many([(x, f) for x, f in zip(x_vars, ft_vars)])
    ys = mul_many([(y, f) for y, f in zip(y_vars, ft_vars)])
    sum_x = xs[0]
    sum_y = ys[0]
    for t in xs[1:]:
        sum_x = sum_x + t
    for t in ys[1:]:
        sum_y = sum_y + t
    sum_x.enforce_equal(FpVar.new_input(cs, MpcFp.const(cs.spec, sum_x_pub)))
    sum_y.enforce_equal(FpVar.new_input(cs, MpcFp.const(cs.spec, sum_y_pub)))
    return cs


# ---------------------------------------------------------------------------
# DivinationCircuit (`werewolf.rs:441-579`)
# ---------------------------------------------------------------------------


def divination_circuit(cs: ConstraintSystem, is_werewolf_wires, is_target_wires,
                       r_bits_wire: MpcFp, elgamal_pk_xy, c1_xy, c2_xy, generator,
                       pedersen_pp=None, wire_randomness=None, wire_commitments=None,
                       com_nbits=None):
    """In-circuit: the target-is-werewolf bit selects M in {G, 0}; the
    ElGamal encryption of M under witness randomness bits must equal the
    public ciphertext (c1, c2).

    is_werewolf_wires / is_target_wires: per-player {0,1} wires;
    r_bits_wire: shared randomness bits [nbits]; elgamal_pk_xy, c1_xy, c2_xy:
    public affine points.  With pedersen_pp set, every flag is bound to a
    published Pedersen commitment (`werewolf.rs:149-179`: 2n commitments,
    22,249 constraints at 3 players); wire_randomness/wire_commitments: 2n
    entries (is_werewolf's then is_target's)."""
    ww = [Boolean.new_witness(cs, w) for w in is_werewolf_wires]
    tg = [Boolean.new_witness(cs, w) for w in is_target_wires]
    if pedersen_pp is not None:
        _commit_checks(cs, [b.var for b in ww + tg], wire_randomness, wire_commitments,
                       pedersen_pp, generator, com_nbits)
    is_wt = [Boolean(v) for v in mul_many([(a.var, b.var) for a, b in zip(ww, tg)])]
    hit = is_wt[0]
    for b in is_wt[1:]:
        hit = Boolean.or_(hit, b)

    msg = TEAffineVar.conditionally_select(hit, TEAffineVar.constant(cs, SC.TE_GEN),
                                           TEAffineVar.neutral(cs))
    r_bools = _bools(cs, r_bits_wire)
    gen = alloc_public_point(cs, SC.TE_GEN)
    pk = alloc_public_point(cs, elgamal_pk_xy)
    enc = encrypt_gadget(cs, gen, pk, msg, r_bools)
    enc.enforce_equal(ElGamalCiphertextVar(alloc_public_point(cs, c1_xy),
                                           alloc_public_point(cs, c2_xy)))
    return cs


# ---------------------------------------------------------------------------
# AnonymousVotingCircuit (`werewolf.rs:581-810`)
# ---------------------------------------------------------------------------


def _column_sums(rows):
    out = []
    for i in range(len(rows[0])):
        acc = rows[0][i]
        for row in rows[1:]:
            acc = acc + row[i]
        out.append(acc)
    return out


def anonymous_voting_circuit(cs: ConstraintSystem, is_target_id, most_voted_id_pub: int,
                             generator, pedersen_pp=None, player_randomness=None,
                             player_commitments=None, com_nbits=None):
    """is_target_id: [alive][players] vote-matrix wires; prove that the
    argmax of the column sums is the published most_voted_id.  Optional
    player commitment checks (`werewolf.rs:649-659`)."""
    vote_vars = [[FpVar.new_witness(cs, w) for w in row] for row in is_target_id]
    num_voted = _column_sums(vote_vars)
    best_votes = FpVar.constant(cs, 0)
    best_id = FpVar.constant(cs, 0)
    for i, votes in enumerate(num_voted):
        gt = less_than_many([(best_votes, votes)], generator)[0]
        best_votes = FpVar.conditionally_select(gt, votes, best_votes)
        best_id = FpVar.conditionally_select(gt, FpVar.constant(cs, i), best_id)
    best_id.enforce_equal(FpVar.new_input(cs, MpcFp.const(cs.spec, most_voted_id_pub)))
    if pedersen_pp is not None:
        _player_commit_checks(cs, pedersen_pp, player_randomness, player_commitments,
                              generator, com_nbits)
    return cs


def calculate_voting_output(is_target_id, generator) -> MpcFp:
    """The MPC `calculate_output` (`werewolf.rs:615-640`): running
    strictly-greater argmax over the column sums, on shared values."""
    best_votes = MpcFp.const(FR, 0)
    best_id = MpcFp.const(FR, 0)
    for i, votes in enumerate(_column_sums(is_target_id)):
        gt = B.less_than(best_votes, votes, generator)
        best_votes = best_votes + gt * (votes - best_votes)
        best_id = best_id + gt * (MpcFp.const(FR, i) - best_id)
    return best_id


def _player_commit_checks(cs, pp, randomness, commitments, generator, nbits=None):
    """Each player's secret, allocated as a witness, bound to its public
    commitment under zero randomness."""
    _commit_checks(cs, list(randomness), None, commitments, pp, generator, nbits)


# ---------------------------------------------------------------------------
# WinningJudgeCircuit (`werewolf.rs:812-961`)
# ---------------------------------------------------------------------------


def winning_judge_circuit(cs: ConstraintSystem, num_alive: int, am_werewolf_wires,
                          game_state_pub: int, generator, pedersen_pp=None,
                          am_werewolf_iwcs=None, player_randomness=None,
                          player_commitments=None):
    """game_state: 1 = werewolf win, 2 = villager win, 3 = continue;
    calced = is_zero(num_w) ? 2 : (num_w < num_citizen ? 3 : 1)."""
    num_alive_var = FpVar.new_input(cs, MpcFp.const(cs.spec, num_alive))
    am_vars = [FpVar.new_witness(cs, w) for w in am_werewolf_wires]
    game_state_var = FpVar.new_input(cs, MpcFp.const(cs.spec, game_state_pub))

    num_w = am_vars[0]
    for v in am_vars[1:]:
        num_w = num_w + v
    num_c = num_alive_var - num_w

    z = num_w.is_zero(generator)
    lt = less_than_many([(num_w, num_c)], generator)[0]
    inner = FpVar.conditionally_select(lt, FpVar.constant(cs, 3), FpVar.constant(cs, 1))
    calced = FpVar.conditionally_select(z, FpVar.constant(cs, 2), inner)
    game_state_var.enforce_equal(calced)

    if pedersen_pp is not None and am_werewolf_iwcs is not None:
        pairs = list(zip(am_werewolf_iwcs, am_vars))
        _commit_checks(cs, [v for _, v in pairs], [iwc.randomness_bits for iwc, _ in pairs],
                       [iwc.commitment for iwc, _ in pairs], pedersen_pp, generator)
    if pedersen_pp is not None and player_commitments is not None:
        _player_commit_checks(cs, pedersen_pp, player_randomness, player_commitments,
                              generator)
    return cs


def calculate_game_state(num_alive: int, am_werewolf_wires, generator) -> MpcFp:
    """MPC evaluation of the game-state formula on shared flags."""
    num_w = am_werewolf_wires[0]
    for v in am_werewolf_wires[1:]:
        num_w = num_w + v
    num_c = MpcFp.const(FR, num_alive) - num_w
    z = B.equality_zero(num_w, generator)
    lt = B.less_than(num_w, num_c, generator)
    inner = MpcFp.const(FR, 1) + lt * MpcFp.const(FR, 2)   # 3 if lt else 1
    return inner + z * (MpcFp.const(FR, 2) - inner)


# ---------------------------------------------------------------------------
# RoleAssignmentCircuit (`werewolf.rs:963-1236`)
# ---------------------------------------------------------------------------


def role_assignment_circuit(cs: ConstraintSystem, tau_matrix: np.ndarray, shuffle_wires,
                            role_values, role_r_bits, role_commitments, generator,
                            num_players: int, pedersen_pp=None, com_nbits: int = 16,
                            player_randomness=None, player_commitments=None):
    """Witness per-player permutation matrices; rho = M^T tau M; the i-th
    rho-power orbit of each player's unit vector gives the role id; its max
    is committed.

    tau_matrix: public [L, L] 0/1 ints; shuffle_wires: per player an [L][L]
    list of wires; role_values: per-player role-id wires (the claimed
    outputs, enforced); role_r_bits: per-player shared randomness bits of
    the role commitments; role_commitments: public points."""
    L = tau_matrix.shape[0]
    n = num_players

    S_vars = []
    for mat in shuffle_wires:
        S = [[FpVar.new_witness(cs, mat[i][j]) for j in range(L)] for i in range(L)]
        S_vars.append(S)
        _enforce_permutation_matrix(cs, S, n)

    # M = prod S_k; Minv = prod S_k^T in reverse order
    M = S_vars[0]
    for S in S_vars[1:]:
        M = matmul_gadget(M, S)
    Minv = _transpose(S_vars[-1])
    for S in reversed(S_vars[:-1]):
        Minv = matmul_gadget(Minv, _transpose(S))

    # rho = Minv @ (tau @ M): tau is public, so tau @ M is linear
    rho = matmul_gadget(Minv, _const_matmul(cs, tau_matrix, M))
    rho_pows = [rho]
    for _ in range(n - 1):
        rho_pows.append(matmul_gadget(rho_pows[-1], rho))

    # orbit values: val[j][i] = sum_k k * rho^i[k][j]; their max is the role id
    role_vars = []
    for j in range(n):
        vals = []
        for rp in rho_pows:
            terms = [rp[k][j].scale(k) for k in range(L)]
            val = terms[0]
            for t in terms[1:]:
                val = val + t
            vals.append(val)
        role_var = FpVar.new_witness(cs, role_values[j])
        _enforce_max(cs, vals, role_var, generator)
        role_vars.append(role_var)

    if pedersen_pp is not None:
        _commit_checks(cs, role_vars, role_r_bits, role_commitments, pedersen_pp, generator,
                       com_nbits)
    if pedersen_pp is not None and player_commitments is not None:
        _player_commit_checks(cs, pedersen_pp, player_randomness, player_commitments,
                              generator)
    return cs


def _transpose(M):
    return [list(row) for row in zip(*M)]


def _const_matmul(cs, A_ints: np.ndarray, B_vars):
    """Public-constant matrix times wire matrix: pure linear combinations."""
    out = []
    for i in range(A_ints.shape[0]):
        row = []
        for j in range(len(B_vars[0])):
            val = None
            for k in range(len(B_vars)):
                c = int(A_ints[i, k])
                if c == 0:
                    continue
                term = B_vars[k][j].scale(c)
                val = term if val is None else val + term
            row.append(val if val is not None else FpVar.constant(cs, 0))
        out.append(row)
    return out


def _enforce_permutation_matrix(cs, S, n: int):
    """Player block is a permutation matrix, group block is identity
    (`werewolf.rs:1613-1659`): booleanity b(b-1) = 0, unit row and column
    sums, identity tail."""
    L = len(S)
    one = LC.constant(1)
    for i in range(n):
        row_lc = LC({})
        col_lc = LC({})
        for j in range(n):
            v = S[i][j]
            cs.enforce(v.lc, one - v.lc, LC({}))
            row_lc = row_lc + v.lc
            col_lc = col_lc + S[j][i].lc
        cs.enforce(row_lc, one, one)
        cs.enforce(col_lc, one, one)
    for i in range(L):
        for j in range(L):
            if i >= n or j >= n:
                cs.enforce(S[i][j].lc, one, one if i == j else LC({}))


def _enforce_max(cs, vals, max_var, generator):
    """max_var is the max of vals: every val <= max_var, and max_var is one
    of them (the membership product, which the reference's `test_max`,
    `werewolf.rs:1480-1519`, omits)."""
    for lt in less_than_many([(max_var, v) for v in vals], generator):
        lt.enforce_false()            # not (max < v)  <=>  v <= max
    diffs = [max_var - v for v in vals]
    prod = diffs[0]
    for d in diffs[1:]:
        prod = mul_many([(prod, d)])[0]
    cs.enforce(prod.lc, LC.constant(1), LC({}))
