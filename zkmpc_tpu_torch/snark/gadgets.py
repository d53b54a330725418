"""R1CS gadget layer over MPC wires: FpVar / Boolean / comparisons.

Port of ``zkmpc_tpu/snark/gadgets.py``: gadget values are batched MpcFp
tensors, witness allocation runs the MPC protocols (Beaver products,
equality-zero, bit decomposition), and the constraint structure
accumulates on the host in the ConstraintSystem.  Every gadget carries a
whole tensor, so the R1CS is the reference's while the online rounds batch.
Where the reference takes a JAX key, these take a ``torch.Generator``.
"""

from __future__ import annotations

from ..mpc import bits as B
from ..mpc.share import MpcFp, beaver_inv
from .r1cs import LC, ConstraintSystem


class FpVar:
    """A field wire in the circuit: LC + (tensor) value.

    Scalar-shaped values per variable; the vector helpers return lists of
    FpVars that share one batched protocol round.
    """

    __slots__ = ("cs", "lc", "value")

    def __init__(self, cs: ConstraintSystem, lc: LC, value: MpcFp):
        self.cs = cs
        self.lc = lc
        self.value = value

    # ------------------------------------------------------------ allocation

    @classmethod
    def new_witness(cls, cs: ConstraintSystem, value: MpcFp) -> "FpVar":
        return cls(cs, LC.of(cs.new_witness(value)), value)

    @classmethod
    def new_input(cls, cs: ConstraintSystem, value: MpcFp) -> "FpVar":
        return cls(cs, LC.of(cs.new_instance(value)), value)

    @classmethod
    def new_witness_vec(cls, cs: ConstraintSystem, values: MpcFp):
        return [cls(cs, LC.of(v), values[i])
                for i, v in enumerate(cs.new_witness_vec(values))]

    @classmethod
    def constant(cls, cs: ConstraintSystem, c: int) -> "FpVar":
        return cls(cs, LC.constant(c), MpcFp.const(cs.spec, c))

    # ------------------------------------------------------------ arithmetic

    def __add__(self, other: "FpVar") -> "FpVar":
        other = self._coerce(other)
        return FpVar(self.cs, self.lc + other.lc, self.value + other.value)

    __radd__ = __add__

    def __sub__(self, other: "FpVar") -> "FpVar":
        other = self._coerce(other)
        return FpVar(self.cs, self.lc - other.lc, self.value - other.value)

    def __neg__(self):
        return FpVar(self.cs, -self.lc, -self.value)

    def scale(self, k: int) -> "FpVar":
        return FpVar(self.cs, self.lc.scale(k),
                     self.value * MpcFp.const(self.cs.spec, k))

    def __mul__(self, other: "FpVar") -> "FpVar":
        """Allocates the product witness and one constraint."""
        other = self._coerce(other)
        out = FpVar.new_witness(self.cs, self.value * other.value)
        self.cs.enforce(self.lc, other.lc, out.lc)
        return out

    def square(self):
        return self * self

    def _coerce(self, other):
        if isinstance(other, FpVar):
            return other
        if isinstance(other, int):
            return FpVar.constant(self.cs, other)
        raise TypeError(type(other))

    # ----------------------------------------------------------- assertions

    def enforce_equal(self, other: "FpVar"):
        other = self._coerce(other)
        self.cs.enforce(self.lc - other.lc, LC.constant(1), LC({}))

    def mul_equals(self, other: "FpVar", result: "FpVar"):
        self.cs.enforce(self.lc, other.lc, result.lc)

    # ------------------------------------------------------------ predicates

    def is_zero(self, generator) -> "Boolean":
        """Allocates b = [self == 0] through the MPC equality-zero protocol,
        with the standard constraints x*b = 0 and x*inv = 1 - b (inv a
        witness)."""
        b_val = B.equality_zero(self.value, generator)
        b = Boolean.new_witness(self.cs, b_val)
        inv = FpVar.new_witness(self.cs, _safe_inverse(self.value, b_val))
        self.cs.enforce(self.lc, b.var.lc, LC({}))
        self.cs.enforce(self.lc, inv.lc, LC.constant(1) - b.var.lc)
        return b

    def is_eq(self, other: "FpVar", generator) -> "Boolean":
        return (self - other).is_zero(generator)

    def to_bits(self, generator, nbits: int | None = None, bits_val: MpcFp | None = None):
        """Bit-decompose with booleanity and recomposition constraints;
        returns Booleans, LSB first.

        nbits below the full width is a sound range restriction: the
        recomposition over the first nbits forces x < 2^nbits (the MPC
        decomposition still runs at full width).  ``bits_val``: this wire's
        full-width decomposition when a batched protocol run over several
        wires already made it (the same wires and constraints follow)."""
        spec = self.cs.spec
        full = spec.p.bit_length()
        nbits = nbits or full
        if bits_val is None:
            bits_val = B.bit_decomposition(self.value, generator)   # [.., full]
        if nbits < full:
            bits_val = B._slice_last(bits_val, 0, nbits)
        bools = Boolean.new_witness_vec(self.cs, bits_val)
        self.cs.enforce(_recompose(bools, spec.p), LC.constant(1), self.lc)
        return bools

    def enforce_cmp(self, other: "FpVar", generator, allow_equal: bool = False):
        """self < other (or <=) under the signed reading of field elements."""
        lt = less_than_gadget(self, other, generator)
        if allow_equal:
            Boolean.or_(lt, self.is_eq(other, generator)).enforce_true()
        else:
            lt.enforce_true()

    @staticmethod
    def conditionally_select(cond: "Boolean", a: "FpVar", b: "FpVar") -> "FpVar":
        """out = cond ? a : b."""
        cs = a.cs
        out = FpVar.new_witness(cs, b.value + cond.var.value * (a.value - b.value))
        # cond * (a - b) = out - b
        cs.enforce(cond.var.lc, a.lc - b.lc, out.lc - b.lc)
        return out


def _recompose(bools, p: int) -> LC:
    lc = LC({})
    for i, bv in enumerate(bools):
        lc = lc + bv.var.lc.scale(pow(2, i, p))
    return lc


def _safe_inverse(x: MpcFp, is_zero_bit: MpcFp) -> MpcFp:
    """The inverse of x where x != 0, of 1 where x == 0 (x + b is never 0)."""
    return beaver_inv(x + is_zero_bit)


class Boolean:
    """A wire constrained to {0,1}."""

    __slots__ = ("var",)

    def __init__(self, var: FpVar):
        self.var = var

    @classmethod
    def new_witness(cls, cs: ConstraintSystem, value: MpcFp) -> "Boolean":
        v = FpVar.new_witness(cs, value)
        cs.enforce(v.lc, LC.constant(1) - v.lc, LC({}))    # b * (1 - b) = 0
        return cls(v)

    @classmethod
    def new_witness_vec(cls, cs: ConstraintSystem, values: MpcFp):
        """values: [.., n] bits -> n Booleans, one scalar witness each."""
        return [cls.new_witness(cs, B._index_last(values, i))
                for i in range(values.shape[-1])]

    @classmethod
    def constant(cls, cs: ConstraintSystem, b: bool) -> "Boolean":
        return cls(FpVar.constant(cs, 1 if b else 0))

    def enforce_true(self):
        self.var.cs.enforce(self.var.lc, LC.constant(1), LC.constant(1))

    def enforce_false(self):
        self.var.cs.enforce(self.var.lc, LC.constant(1), LC({}))

    def not_(self) -> "Boolean":
        return Boolean(FpVar.constant(self.var.cs, 1) - self.var)

    @staticmethod
    def and_(a: "Boolean", b: "Boolean") -> "Boolean":
        return Boolean(a.var * b.var)

    @staticmethod
    def or_(a: "Boolean", b: "Boolean") -> "Boolean":
        return Boolean(a.var + b.var - a.var * b.var)

    @staticmethod
    def xor(a: "Boolean", b: "Boolean") -> "Boolean":
        return Boolean(a.var + b.var - (a.var * b.var).scale(2))

    @staticmethod
    def kary_and(bools: list) -> "Boolean":
        acc = bools[0]
        for b in bools[1:]:
            acc = Boolean.and_(acc, b)
        return acc


# ---------------------------------------------------------------------------
# Batched gadget forms: one protocol round for many wires (the values are
# stacked into one tensor, the protocol runs once, then each wire gets its
# constraints).
# ---------------------------------------------------------------------------


def _stack_values(vals) -> MpcFp:
    return MpcFp.concat([v.reshape(1) for v in vals], axis=0)


def mul_many(pairs) -> list:
    """Products of (FpVar, FpVar) pairs with ONE batched Beaver round."""
    if not pairs:
        return []
    cs = pairs[0][0].cs
    prods = _stack_values([a.value for a, _ in pairs]) * \
        _stack_values([b.value for _, b in pairs])
    out = []
    for i, (a, b) in enumerate(pairs):
        w = FpVar.new_witness(cs, prods[i])
        cs.enforce(a.lc, b.lc, w.lc)
        out.append(w)
    return out


def matmul_gadget(A, B_):
    """C = A @ B for FpVar matrices (lists of rows): all partial products in
    one batched Beaver round, tied to C by linear combinations."""
    n, k, m = len(A), len(B_), len(B_[0])
    prods = mul_many([(A[i][t], B_[t][j]) for i in range(n) for j in range(m)
                      for t in range(k)])
    C = []
    idx = 0
    for _ in range(n):
        row = []
        for _ in range(m):
            acc = prods[idx]
            for t in range(1, k):
                acc = acc + prods[idx + t]
            idx += k
            row.append(acc)
        C.append(row)
    return C


def to_bits_many(vars_, generator, nbits: int | None = None):
    """Bit-decompose many wires with one batched protocol run."""
    if not vars_:
        return []
    cs = vars_[0].cs
    full = cs.spec.p.bit_length()
    nbits = nbits or full
    bits_val = B.bit_decomposition(_stack_values([v.value for v in vars_]),
                                   generator)                   # [n, full]
    out = []
    for i, v in enumerate(vars_):
        row = bits_val[i]
        if nbits < full:
            row = B._slice_last(row, 0, nbits)
        bools = Boolean.new_witness_vec(cs, row)
        cs.enforce(_recompose(bools, cs.spec.p), LC.constant(1), v.lc)
        out.append(bools)
    return out


def is_zero_many(vars_, generator) -> list:
    """[v == 0] for many wires, one batched equality-zero run."""
    if not vars_:
        return []
    cs = vars_[0].cs
    batch = _stack_values([v.value for v in vars_])
    b_val = B.equality_zero(batch, generator)                   # [n]
    safe = beaver_inv(batch + b_val)                            # batched inverse
    out = []
    for i, v in enumerate(vars_):
        b = Boolean.new_witness(cs, b_val[i])
        inv = FpVar.new_witness(cs, safe[i])
        cs.enforce(v.lc, b.var.lc, LC({}))
        cs.enforce(v.lc, inv.lc, LC.constant(1) - b.var.lc)
        out.append(b)
    return out


def less_than_many(pairs, generator) -> list:
    """[a < b] Booleans for many pairs, batching the comparison protocol and
    the bit decompositions into single runs."""
    if not pairs:
        return []
    cs = pairs[0][0].cs
    xs = _stack_values([a.value for a, _ in pairs])
    ys = _stack_values([b.value for _, b in pairs])
    lt_val = B.less_than(xs, ys, generator)                     # [n]
    lts = [Boolean.new_witness(cs, lt_val[i]) for i in range(len(pairs))]
    diffs = [FpVar.conditionally_select(lt, b - a, (a - b) + FpVar.constant(cs, 1))
             for (a, b), lt in zip(pairs, lts)]
    half_bits = (cs.spec.p - 1).bit_length() - 1
    for bools in to_bits_many(diffs, generator):
        for bit in bools[half_bits:]:
            bit.enforce_false()
    return lts


def two_bit_lookup(bits, table) -> FpVar:
    """out = table[b0 + 2*b1] with ONE constraint (ark's TwoBitLookupGadget).

    bits: [b0, b1] Booleans (LSB first); table: 4 public ints.
    Constraint: b1 * (b0*(c3-c2-c1+c0) + (c2-c0)) = out - b0*(c1-c0) - c0.
    """
    b0, b1 = bits
    cs = b0.var.cs
    p = cs.spec.p
    c0, c1, c2, c3 = (int(t) % p for t in table)
    b0v, b1v = b0.var.value, b1.var.value
    prod = b0v * b1v                        # Beaver when both shared
    val = (MpcFp.const(cs.spec, c0)
           + b0v * MpcFp.const(cs.spec, (c1 - c0) % p)
           + b1v * MpcFp.const(cs.spec, (c2 - c0) % p)
           + prod * MpcFp.const(cs.spec, (c3 - c2 - c1 + c0) % p))
    out = FpVar.new_witness(cs, val)
    b_lc = b0.var.lc.scale((c3 - c2 - c1 + c0) % p) + LC.constant((c2 - c0) % p)
    c_lc = out.lc - b0.var.lc.scale((c1 - c0) % p) - LC.constant(c0)
    cs.enforce(b1.var.lc, b_lc, c_lc)
    return out


def less_than_gadget(a: FpVar, b: FpVar, generator) -> Boolean:
    """Allocate [a < b] (signed interval semantics) with its correctness
    constraints: d = lt ? (b - a) : (a - b + 1) is bit-decomposed and its
    top bits forced to zero, so d < 2^half_bits <= (p-1)/2."""
    cs = a.cs
    lt = Boolean.new_witness(cs, B.less_than(a.value, b.value, generator))
    diff = FpVar.conditionally_select(lt, b - a, (a - b) + FpVar.constant(cs, 1))
    half_bits = (cs.spec.p - 1).bit_length() - 1
    for bit in diff.to_bits(generator, nbits=cs.spec.p.bit_length())[half_bits:]:
        bit.enforce_false()
    return lt
