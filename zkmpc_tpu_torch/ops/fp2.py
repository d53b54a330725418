"""Batched quadratic extension field Fq2 = Fq[u]/(u^2 + 5).

Port of ``zkmpc_tpu/ops/fp2.py``: BLS12-377 G2 point coordinates.  An
``Fp2Array`` is a pair of ``FpArray`` tensors (c0 + c1*u) with the same
arithmetic interface as ``FpArray``, so the point formulas are generic over
both.  Products stack their Fq multiplies into one Montgomery-multiply call,
as the reference does, so bounds and limbs follow it exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .limbs import FQ, FpArray, mul_many


class Fp2Array:
    __slots__ = ("c0", "c1")

    # nonresidue as a small negative integer: u^2 = -5, so nr*x = -(5x)
    _NR_NEG = 5

    def __init__(self, c0: FpArray, c1: FpArray):
        self.c0 = c0
        self.c1 = c1

    # ------------------------------------------------------------ constructors

    @classmethod
    def from_int(cls, values, shape=None, device="cuda"):
        """values: object array of (c0, c1) int tuples."""
        arr = np.asarray(values, dtype=object)
        c0 = np.vectorize(lambda t: t[0], otypes=[object])(arr)
        c1 = np.vectorize(lambda t: t[1], otypes=[object])(arr)
        return cls(FpArray.from_int(FQ, c0, shape, device),
                   FpArray.from_int(FQ, c1, shape, device))

    @classmethod
    def zeros(cls, shape=(), device="cuda"):
        return cls(FpArray.zeros(FQ, shape, device), FpArray.zeros(FQ, shape, device))

    @classmethod
    def ones(cls, shape=(), device="cuda"):
        return cls(FpArray.ones(FQ, shape, device), FpArray.zeros(FQ, shape, device))

    def to_ints(self):
        c0 = self.c0.to_ints()
        c1 = self.c1.to_ints()
        out = np.empty(c0.shape, dtype=object)
        flat0, flat1, flat = c0.reshape(-1), c1.reshape(-1), out.reshape(-1)
        for i in range(flat0.size):
            flat[i] = (int(flat0[i]), int(flat1[i]))
        return out

    # -------------------------------------------------------------- interface

    @property
    def shape(self):
        return self.c0.shape

    @property
    def device(self):
        return self.c0.device

    def reshape(self, *shape):
        return Fp2Array(self.c0.reshape(*shape), self.c1.reshape(*shape))

    def broadcast_to(self, shape):
        return Fp2Array(self.c0.broadcast_to(shape), self.c1.broadcast_to(shape))

    def __getitem__(self, idx):
        return Fp2Array(self.c0[idx], self.c1[idx])

    def __add__(self, other):
        return Fp2Array(self.c0 + other.c0, self.c1 + other.c1)

    def __sub__(self, other):
        return Fp2Array(self.c0 - other.c0, self.c1 - other.c1)

    def __neg__(self):
        return Fp2Array(-self.c0, -self.c1)

    def __mul__(self, other):
        return mul_many([(self, other)])[0]

    def _mul_plan(self, other):
        """`limbs.mul_many`'s plan of ``self * other`` (``other`` None: the
        square): one stacked pair of Fq operands and the result from it."""
        if other is None:
            # c0 = (a0 + a1)(a0 - 5 a1) + 4 a0 a1, c1 = 2 a0 a1; the two Fq
            # products as one stacked Montgomery multiply
            s = FpArray.stack([self.c0, self.c0 + self.c1], axis=0)
            t = FpArray.stack([self.c1, self.c0 - self.c1.smul(5)], axis=0)

            def finish(prods):
                v0, w = prods[0][0], prods[0][1]
                return Fp2Array(w + v0.smul(4), v0.double())
            return [s._mul_operands(t)], finish
        # Karatsuba: v0 = a0 b0, v1 = a1 b1;
        # c0 = v0 - 5 v1, c1 = (a0+a1)(b0+b1) - v0 - v1, the three Fq
        # products as one stacked Montgomery multiply
        shp = (self.shape if self.shape == other.shape
               else tuple(torch.broadcast_shapes(self.shape, other.shape)))
        a0, a1 = self.c0.broadcast_to(shp), self.c1.broadcast_to(shp)
        b0, b1 = other.c0.broadcast_to(shp), other.c1.broadcast_to(shp)
        s = FpArray.stack([a0, a1, a0 + a1], axis=0)
        t = FpArray.stack([b0, b1, b0 + b1], axis=0)

        def finish(prods):
            v0, v1, v01 = prods[0][0], prods[0][1], prods[0][2]
            return Fp2Array(v0 - v1.smul(self._NR_NEG), v01 - v0 - v1)
        return [s._mul_operands(t)], finish

    def smul(self, k: int):
        return Fp2Array(self.c0.smul(k), self.c1.smul(k))

    def double(self):
        return self.smul(2)

    def square(self):
        return mul_many([(self, None)])[0]

    def inv(self):
        # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + 5 a1^2)
        norm = self.c0.square() + self.c1.square().smul(5)
        ninv = norm.inv()
        return Fp2Array(self.c0 * ninv, -(self.c1 * ninv))

    def tighten(self):
        return Fp2Array(self.c0.tighten(), self.c1.tighten())

    def is_zero(self):
        return self.c0.is_zero() & self.c1.is_zero()

    @staticmethod
    def select(cond, a: "Fp2Array", b: "Fp2Array"):
        return Fp2Array(FpArray.select(cond, a.c0, b.c0),
                        FpArray.select(cond, a.c1, b.c1))

    @staticmethod
    def stack(arrays, axis=0):
        return Fp2Array(FpArray.stack([a.c0 for a in arrays], axis),
                        FpArray.stack([a.c1 for a in arrays], axis))

    @staticmethod
    def concat(arrays, axis=0):
        return Fp2Array(FpArray.concat([a.c0 for a in arrays], axis),
                        FpArray.concat([a.c1 for a in arrays], axis))

    def __repr__(self):
        return f"Fp2Array(shape={self.shape})"
