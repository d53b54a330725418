"""In-circuit twisted-Edwards and Pedersen commitment gadgets.

Port of ``zkmpc_tpu/circuits/pedersen_gadget.py``: curve points are (x, y)
FpVar pairs over Fr; addition is enforced with the complete Edwards
formulas; the commitment folds message and randomness bits against public
generator multiples through 2-bit window lookups and a log-depth tree of
batched complete adds.  The tree runs one loop iteration per level and
allocates wires and emits constraints in the reference's order, so the
R1CS matrices are the reference's.
"""

from __future__ import annotations

import numpy as np

from .. import params
from ..mpc import bits as B
from ..mpc.share import PUBLIC, MpcFp, beaver_inv
from ..snark.gadgets import Boolean, FpVar, _stack_values, two_bit_lookup
from ..snark.r1cs import LC, ConstraintSystem
from ..spec import curves as SC

ED_D = params.ED_D
P = params.FR_MODULUS


class TEAffineVar:
    """Affine TE point as circuit wires."""

    __slots__ = ("x", "y")

    def __init__(self, x: FpVar, y: FpVar):
        self.x = x
        self.y = y

    @classmethod
    def constant(cls, cs: ConstraintSystem, xy):
        return cls(FpVar.constant(cs, int(xy[0])), FpVar.constant(cs, int(xy[1])))

    @classmethod
    def neutral(cls, cs: ConstraintSystem):
        return cls.constant(cs, SC.TE_NEUTRAL)

    def add(self, other: "TEAffineVar") -> "TEAffineVar":
        """Complete Edwards addition with witness allocation (a = -1):
        x3 (1 + d x1 x2 y1 y2) = x1 y2 + y1 x2
        y3 (1 - d x1 x2 y1 y2) = y1 y2 + x1 x2."""
        cs = self.x.cs
        x1, y1, x2, y2 = self.x, self.y, other.x, other.y
        u = x1 * x2             # witness + constraint
        v = y1 * y2
        t = u * v               # x1x2y1y2
        xy = x1 * y2
        yx = y1 * x2
        dt = t.scale(ED_D)
        one = FpVar.constant(cs, 1)
        denom_x = one + dt
        denom_y = one - dt
        x3 = FpVar.new_witness(cs, (xy.value + yx.value) * _inv_wire(denom_x))
        y3 = FpVar.new_witness(cs, (v.value + u.value) * _inv_wire(denom_y))
        cs.enforce(x3.lc, denom_x.lc, xy.lc + yx.lc)
        cs.enforce(y3.lc, denom_y.lc, v.lc + u.lc)
        return TEAffineVar(x3, y3)

    def conditionally_add_constant(self, bit: Boolean, xy) -> "TEAffineVar":
        """self + (bit ? constant point : neutral).  The select between a
        constant point and the neutral is linear in the bit, cx = px*b and
        cy = 1 + (py-1)*b, so it costs no constraint; only the add pays."""
        return self.add(TEAffineVar(*_linear_leaf(self.x.cs, bit, xy)))

    def two_bit_window_add_constant(self, bits, p0, p1) -> "TEAffineVar":
        """self + (b0?p0:0) + (b1?p1:0) through a 4-entry table lookup per
        coordinate: 2 lookup constraints and one complete add per bit pair."""
        table = [SC.TE_NEUTRAL, p0, p1, SC.te_add(p0, p1)]
        tx = two_bit_lookup(bits, [t[0] for t in table])
        ty = two_bit_lookup(bits, [t[1] for t in table])
        return self.add(TEAffineVar(tx, ty))

    def double(self) -> "TEAffineVar":
        """The complete formulas double correctly."""
        return self.add(self)

    @staticmethod
    def conditionally_select(bit: Boolean, a: "TEAffineVar",
                             b: "TEAffineVar") -> "TEAffineVar":
        return TEAffineVar(FpVar.conditionally_select(bit, a.x, b.x),
                           FpVar.conditionally_select(bit, a.y, b.y))

    def conditionally_add(self, bit: Boolean, other: "TEAffineVar") -> "TEAffineVar":
        """self + (bit ? other : neutral) for a variable point other."""
        cs = self.x.cs
        return self.add(TEAffineVar.conditionally_select(
            bit, other, TEAffineVar.neutral(cs)))

    def scalar_mul_le(self, bits: list) -> "TEAffineVar":
        """Variable-base double-and-add over Boolean bits (LSB first)."""
        acc = TEAffineVar.neutral(self.x.cs)
        cur = self
        for bit in bits:
            acc = acc.conditionally_add(bit, cur)
            cur = cur.double()
        return acc

    def enforce_equal(self, other: "TEAffineVar"):
        self.x.enforce_equal(other.x)
        self.y.enforce_equal(other.y)


def _inv_wire(v: FpVar) -> MpcFp:
    """The inverse of a wire's value (0 for 0): a public value is inverted
    on the host, one round trip instead of the Montgomery products of
    x^(p-2) (the same value); a shared one by a Beaver inverse."""
    val = v.value
    if val.visibility == PUBLIC:
        p = val.spec.p
        ints = np.asarray(val.value.to_ints()[0], dtype=object)      # party 0's copy
        return MpcFp.const(val.spec, np.vectorize(
            lambda x: pow(int(x), -1, p) if int(x) % p else 0, otypes=[object])(ints))
    return beaver_inv(val)


def _linear_leaf(cs, bit: Boolean, xy):
    """(bit ? xy : neutral) as two FpVars linear in the bit."""
    px, py1 = int(xy[0]) % P, (int(xy[1]) - 1) % P
    bval = bit.var.value
    cx = FpVar(cs, bit.var.lc.scale(px), bval * MpcFp.const(cs.spec, px))
    cy = FpVar(cs, LC.constant(1) + bit.var.lc.scale(py1),
               MpcFp.const(cs.spec, 1) + bval * MpcFp.const(cs.spec, py1))
    return cx, cy


def pedersen_com_circuit(cs: ConstraintSystem, x: FpVar, r_bools: list,
                         commitment_xy, pp, generator, nbits: int | None = None,
                         m_bits_val: MpcFp | None = None) -> None:
    """The PedersenComCircuit: enforce that commit(x, r) equals the public
    commitment point.

    x: allocated FpVar (shared or public); r_bools: randomness-bit Booleans
    (an empty list is the zero randomness); commitment_xy: public affine
    point, allocated as two instance variables; m_bits_val: x's full-width
    bit decomposition when a batched run already made it (`FpVar.to_bits`).
    """
    m_bits = x.to_bits(generator, nbits, bits_val=m_bits_val)
    com = pedersen_commit_gadget(cs, m_bits, r_bools, pp)
    cx = FpVar.new_input(cs, MpcFp.const(cs.spec, int(commitment_xy[0])))
    cy = FpVar.new_input(cs, MpcFp.const(cs.spec, int(commitment_xy[1])))
    com.x.enforce_equal(cx)
    com.y.enforce_equal(cy)


def pedersen_commit_gadget(cs: ConstraintSystem, m_bits: list, r_bits: list,
                           pp) -> TEAffineVar:
    """C = sum m_i G_i + sum r_j 2^j H as circuit wires.

    m_bits/r_bits: lists of Booleans; pp: crypto.pedersen.PedersenParams.
    Bits fold two at a time through 4-entry window tables (2 lookup
    constraints and one complete add per pair).  From 8 bits up, all pair
    lookups run as one batched Beaver round and the window points are
    summed by a log-depth tree of batched complete adds: the same
    constraint count, O(log bits) protocol rounds instead of O(bits)."""
    h_pows = []
    h = pp.blind_base
    for _ in range(len(r_bits)):
        h_pows.append(h)
        h = SC.te_add(h, h)
    bits = list(m_bits) + list(r_bits)
    bases = list(pp.generators[:len(m_bits)]) + h_pows
    if not bits:
        return TEAffineVar.neutral(cs)
    if len(bits) < 8:
        acc = TEAffineVar.neutral(cs)
        i = 0
        while i + 1 < len(bits):
            acc = acc.two_bit_window_add_constant(
                [bits[i], bits[i + 1]], bases[i], bases[i + 1])
            i += 2
        if i < len(bits):
            acc = acc.conditionally_add_constant(bits[i], bases[i])
        return acc
    level = _window_lookup_leaves(cs, bits, bases)
    while len(level[0]) > 1:
        level = _te_tree_level(cs, level)
    return TEAffineVar(level[0][0], level[1][0])


def _window_lookup_leaves(cs, bits, bases):
    """Batched 2-bit window lookups: ONE Beaver round computes every pair
    product b0*b1; each pair gives one leaf point through 2 lookup
    constraints.  A trailing odd bit becomes a constraint-free linear leaf."""
    p = cs.spec.p
    npairs = len(bits) // 2
    tables = [[SC.TE_NEUTRAL, bases[2 * i], bases[2 * i + 1],
               SC.te_add(bases[2 * i], bases[2 * i + 1])] for i in range(npairs)]
    b0v = _stack_values([bits[2 * i].var.value for i in range(npairs)])
    b1v = _stack_values([bits[2 * i + 1].var.value for i in range(npairs)])
    prod = b0v * b1v                               # ONE batched Beaver round

    def coeff(sel):
        return MpcFp.const(cs.spec, [sel(t) % p for t in tables])

    vals = []
    for k in (0, 1):
        c0 = coeff(lambda t: int(t[0][k]))
        d1 = coeff(lambda t: int(t[1][k]) - int(t[0][k]))
        d2 = coeff(lambda t: int(t[2][k]) - int(t[0][k]))
        d3 = coeff(lambda t: int(t[3][k]) - int(t[2][k]) - int(t[1][k]) + int(t[0][k]))
        vals.append(c0 + b0v * d1 + b1v * d2 + prod * d3)
    x_vars = _alloc_vec(cs, vals[0])
    y_vars = _alloc_vec(cs, vals[1])
    # per coordinate: b1 * (b0*(c3-c2-c1+c0) + (c2-c0)) = out - b0*(c1-c0) - c0
    for i in range(npairs):
        b0, b1 = bits[2 * i], bits[2 * i + 1]
        for k, ovars in ((0, x_vars), (1, y_vars)):
            c0, c1, c2, c3 = (int(tables[i][j][k]) % p for j in range(4))
            b_lc = b0.var.lc.scale((c3 - c2 - c1 + c0) % p) + LC.constant((c2 - c0) % p)
            c_lc = ovars[i].lc - b0.var.lc.scale((c1 - c0) % p) - LC.constant(c0)
            cs.enforce(b1.var.lc, b_lc, c_lc)
    if len(bits) % 2:
        lx, ly = _linear_leaf(cs, bits[-1], bases[len(bits) - 1])
        x_vars.append(lx)
        y_vars.append(ly)
    return (x_vars, y_vars)


def _alloc_vec(cs, vals):
    """Allocate one witness wire per element of a batched MpcFp [m]."""
    return [FpVar(cs, LC.of(v), B._index_last(vals, i))
            for i, v in enumerate(cs.new_witness_vec(vals))]


def _te_tree_level(cs, level):
    """One tree level: batched complete adds of the first half of the
    points with the second.  4 protocol rounds whatever the width (one
    fused Beaver round for u, v, xy, yx; one for t; one batched inverse;
    one fused round for x3, y3); an odd last point rides up."""
    x_vars, y_vars = level
    m = len(x_vars)
    m2 = m // 2
    ax, bx = x_vars[:m2], x_vars[m2:2 * m2]
    ay, by = y_vars[:m2], y_vars[m2:2 * m2]
    axv, ayv, bxv, byv = (_stack_values([v.value for v in vs])
                          for vs in (ax, ay, bx, by))
    prods = MpcFp.concat([axv, ayv, axv, ayv], axis=0) * \
        MpcFp.concat([bxv, byv, byv, bxv], axis=0)         # ONE fused round
    u_v, v_v = prods[0:m2], prods[m2:2 * m2]
    xy_v, yx_v = prods[2 * m2:3 * m2], prods[3 * m2:4 * m2]
    t_v = u_v * v_v
    dt = t_v * MpcFp.const(cs.spec, ED_D)
    one = MpcFp.const(cs.spec, 1)
    inv = beaver_inv(MpcFp.concat([one + dt, one - dt], axis=0))
    res = MpcFp.concat([xy_v + yx_v, v_v + u_v], axis=0) * inv   # ONE fused round
    x3_v, y3_v = res[0:m2], res[m2:2 * m2]

    u_w, v_w, t_w, xy_w, yx_w, x3_w, y3_w = (
        _alloc_vec(cs, w) for w in (u_v, v_v, t_v, xy_v, yx_v, x3_v, y3_v))
    d = ED_D % cs.spec.p
    for i in range(m2):
        cs.enforce(ax[i].lc, bx[i].lc, u_w[i].lc)
        cs.enforce(ay[i].lc, by[i].lc, v_w[i].lc)
        cs.enforce(u_w[i].lc, v_w[i].lc, t_w[i].lc)
        cs.enforce(ax[i].lc, by[i].lc, xy_w[i].lc)
        cs.enforce(ay[i].lc, bx[i].lc, yx_w[i].lc)
        cs.enforce(x3_w[i].lc, LC.constant(1) + t_w[i].lc.scale(d),
                   xy_w[i].lc + yx_w[i].lc)
        cs.enforce(y3_w[i].lc, LC.constant(1) - t_w[i].lc.scale(d),
                   v_w[i].lc + u_w[i].lc)
    if m % 2:
        return (x3_w + [x_vars[-1]], y3_w + [y_vars[-1]])
    return (x3_w, y3_w)


def pedersen_crh_gadget(cs: ConstraintSystem, in_bits: list, cp) -> TEAffineVar:
    """Pedersen CRH in-circuit: H(x) = sum x_i G_i, no blinding;
    cp: crypto.pedersen.CrhParams."""
    acc = TEAffineVar.neutral(cs)
    for i, bit in enumerate(in_bits):
        acc = acc.conditionally_add_constant(bit, cp.generators[i])
    return acc


def pedersen_two_to_one_crh_gadget(cs: ConstraintSystem, left_bits: list,
                                   right_bits: list, cp) -> TEAffineVar:
    """TwoToOneCRH gadget: the CRH of the concatenated bit wires."""
    assert len(left_bits) == len(right_bits)
    return pedersen_crh_gadget(cs, list(left_bits) + list(right_bits), cp)
