"""R1CS constraint system builder.

Port of ``zkmpc_tpu/snark/r1cs.py``: variables are One / Instance(i) /
Witness(i), constraints are <a,z>*<b,z> = <c,z> rows of sparse linear
combinations.  The structure (matrices) is host-side Python; assignments
are batched ``MpcFp`` tensors, so the same circuit synthesizes over public
values or secret shares.
"""

from __future__ import annotations

import numpy as np

from ..mpc.share import PUBLIC, MpcFp, _promote_to_shared
from ..ops.limbs import FieldSpec

ONE = 0  # variable index of the constant 1 (instance variable 0)


class LC:
    """Sparse linear combination: {var_index: int coefficient}."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms = dict(terms or {})

    @classmethod
    def of(cls, var: int, coeff: int = 1):
        return cls({var: coeff})

    @classmethod
    def constant(cls, c: int):
        return cls({ONE: c})

    def __add__(self, other: "LC"):
        t = dict(self.terms)
        for v, c in other.terms.items():
            t[v] = t.get(v, 0) + c
        return LC(t)

    def __sub__(self, other: "LC"):
        t = dict(self.terms)
        for v, c in other.terms.items():
            t[v] = t.get(v, 0) - c
        return LC(t)

    def scale(self, k: int):
        return LC({v: c * k for v, c in self.terms.items()})

    def __neg__(self):
        return self.scale(-1)


class ConstraintSystem:
    """Collects constraints + assignments during circuit synthesis."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.num_instance = 1            # slot 0 = ONE
        self.num_witness = 0
        self.constraints: list[tuple[LC, LC, LC]] = []
        self._instance_vals: list[MpcFp] = []
        self._witness_vals: list[MpcFp] = []

    # ------------------------------------------------------------ allocation

    def new_instance(self, value: MpcFp) -> int:
        idx = self.num_instance
        self.num_instance += 1
        self._instance_vals.append(value)
        return idx

    def new_witness(self, value: MpcFp) -> int:
        idx = self.num_witness
        self.num_witness += 1
        self._witness_vals.append(value)
        return ~idx  # witness indices are encoded as negative (bitwise-not)

    def new_witness_vec(self, values: MpcFp) -> list[int]:
        """Allocate a whole batched wire tensor [n] as n witness variables
        (one tensor, one batched protocol round for the ops behind it)."""
        (n,) = values.shape
        start = self.num_witness
        self.num_witness += n
        self._witness_vals.append(values)
        return [~(start + i) for i in range(n)]

    def new_instance_vec(self, values: MpcFp) -> list[int]:
        (n,) = values.shape
        start = self.num_instance
        self.num_instance += n
        self._instance_vals.append(values)
        return list(range(start, start + n))

    def _col(self, var: int) -> int:
        if var >= 0:
            return var
        return self.num_instance + (~var)

    def enforce(self, a: LC, b: LC, c: LC):
        self.constraints.append((a, b, c))

    # ------------------------------------------------------------- assembly

    @property
    def num_vars(self):
        return self.num_instance + self.num_witness

    def matrices(self):
        """Returns (A, B, C) as (rows, cols, coeffs) COO triples (host)."""
        out = []
        p = self.spec.p
        for which in range(3):
            rows, cols, coeffs = [], [], []
            for r, cons in enumerate(self.constraints):
                lc = cons[which]
                for v, cval in sorted(lc.terms.items(), key=lambda t: self._col(t[0])):
                    if cval % p == 0:
                        continue
                    rows.append(r)
                    cols.append(self._col(v))
                    coeffs.append(cval % p)
            out.append((np.asarray(rows, dtype=np.int32),
                        np.asarray(cols, dtype=np.int32),
                        np.asarray(coeffs, dtype=object)))
        return out

    def full_assignment(self) -> MpcFp:
        """z = [1, instance..., witness...] as one shared MpcFp [num_vars]."""
        one = MpcFp.const(self.spec, 1)
        wires = [one] + self._instance_vals + self._witness_vals
        z = MpcFp.concat([w.reshape(-1) for w in wires], axis=0)
        if z.visibility == PUBLIC:
            z = _promote_to_shared(z)
        return z

    def instance_ints(self):
        """Host-side canonical instance values [num_instance] (incl. the
        leading 1), from party 0's replicated copy."""
        vals = [1]
        for w in self._instance_vals:
            assert w.visibility == PUBLIC, "instance wires must be public"
            vals.extend(int(v) for v in np.asarray(w.value.to_ints()[0]).reshape(-1))
        return vals

    # ----------------------------------------------------------- evaluation

    def is_satisfied_ints(self) -> bool:
        """Host-side sanity check: open the whole assignment (one opening)
        and test every constraint over Python ints."""
        z = [int(v) for v in self.full_assignment().reveal().to_ints()[0]]
        p = self.spec.p

        def ev(lc):
            return sum(c * z[self._col(v)] for v, c in lc.terms.items()) % p
        return all(ev(a) * ev(b) % p == ev(c) for a, b, c in self.constraints)
