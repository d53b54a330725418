"""Pure-Python (arbitrary-precision int) modular arithmetic.

The port's copy of what it uses from ``zkmpc_tpu/spec/field.py``: inverses
and roots of unity for host-side setup and the NTT tables.
"""

from __future__ import annotations


def inv(x: int, p: int) -> int:
    if x % p == 0:
        raise ZeroDivisionError("inverse of zero")
    return pow(x, -1, p)


def batch_inv(xs, p):
    return [inv(x, p) for x in xs]


def two_adic_root_of_unity(p: int, generator: int, two_adicity: int) -> int:
    return pow(generator % p, (p - 1) >> two_adicity, p)


def root_of_unity(p: int, generator: int, two_adicity: int, n: int) -> int:
    """n-th root of unity for power-of-two n (ark `FftField::get_root_of_unity`)."""
    assert n & (n - 1) == 0 and n > 0
    log_n = n.bit_length() - 1
    assert log_n <= two_adicity
    base = two_adic_root_of_unity(p, generator, two_adicity)
    return pow(base, 1 << (two_adicity - log_n), p)
