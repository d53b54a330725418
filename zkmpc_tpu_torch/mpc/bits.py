"""MPC bitwise protocols over shared field elements.

Port of ``zkmpc_tpu/mpc/bits.py``: shared bits are field shares in {0,1};
AND is a Beaver multiply, everything else is affine.  Every protocol is
batched over tensors, so a test over a vector costs the rounds of a single
test.  The log-depth trees run as plain loops over their levels (one
batched Beaver round a level), the form the reference writes for its
socket transport.

Protocols:
- ``bit_rand``: uniform shared bits, the XOR of one private bit per party;
  under SPDZ the square-root trick on an authenticated <r> (``bit_rand_sqrt``).
- ``rand_number_bitwise``: a bitwise-shared uniform value < p, the first
  valid one of ``attempts`` batched candidates, selected obliviously.
- ``equality_zero``: open c = x + r with bitwise-shared r; AND-tree of the
  XNORs of c's and r's bits.
- ``bitwise_lt``: the MSB prefix-or comparator.
- ``bit_decomposition``: open c = x - r, a shared binary addition with carry
  lookahead, and a subtraction of p where the sum wraps.
- ``is_smaller_or_equal_than_mod_minus_one_div_two`` / ``less_than``: the
  Catrina-de Hoogh LSB method.

Under the SPDZ backend every wire carries its MAC shares through the same
layout changes (`MpcFp.map`), and the shift fills carry the MAC of the
value shifted in.
"""

from __future__ import annotations

import functools

import torch

from ..ops.limbs import FieldSpec, FpArray, W as LIMB_W
from . import rand as R
from .share import (PUBLIC, SHARED, MpcFp, _promote_to_shared, _sum_last_axis, ctx,
                    rand_shared)

# ---------------------------------------------------------------------------
# boolean algebra on shared bits (bits are MpcFp in {0,1})
# ---------------------------------------------------------------------------


def b_and(a: MpcFp, b: MpcFp) -> MpcFp:
    return a * b


def b_or(a: MpcFp, b: MpcFp) -> MpcFp:
    return a + b - a * b


def b_xor(a: MpcFp, b: MpcFp) -> MpcFp:
    ab = a * b
    return a + b - ab.smul(2)


def b_not(a: MpcFp) -> MpcFp:
    return MpcFp.const(a.spec, 1) - a


def _tree_reduce_lastaxis(bits: MpcFp, op) -> MpcFp:
    """Reduce [.., n] -> [..] with a log-depth tree of batched ops."""
    x = bits
    while x.shape[-1] > 1:
        n = x.shape[-1]
        half = n // 2
        folded = op(_slice_last(x, 0, half), _slice_last(x, half, 2 * half))
        if n % 2:
            folded = _concat_last(folded, _slice_last(x, 2 * half, n))
        x = folded
    return _index_last(x, 0)


def kary_and(bits: MpcFp) -> MpcFp:
    return _tree_reduce_lastaxis(bits, b_and)


def kary_or(bits: MpcFp) -> MpcFp:
    return _tree_reduce_lastaxis(bits, b_or)


# --- views along the bit axis (the last batch axis) -------------------------


def _limb_view(x: MpcFp, fn) -> MpcFp:
    """A view of x along the bit axis by a limb-tensor function, applied to
    the value and the MAC shares alike (bounds kept)."""
    return x.map(lambda f: FpArray(fn(f.limbs), f.spec, f.bound))


def _slice_last(x: MpcFp, a, b) -> MpcFp:
    return _limb_view(x, lambda l: l[..., a:b, :])


def _index_last(x: MpcFp, i) -> MpcFp:
    return _limb_view(x, lambda l: l[..., i, :])


def _expand_last(x: MpcFp, n: int) -> MpcFp:
    return _limb_view(x, lambda l: l[..., None, :].expand(
        tuple(l.shape[:-1]) + (n, l.shape[-1])))


def _cat_fp(a: FpArray, b: FpArray, dim: int) -> FpArray:
    return FpArray(torch.cat([a.limbs, b.limbs], dim=dim), a.spec, max(a.bound, b.bound))


def _concat_last(x: MpcFp, y: MpcFp) -> MpcFp:
    # a public (replicated) wire joined to a shared one is first promoted to
    # a trivial sharing, else its value would be summed P times on reveal
    if x.visibility != y.visibility:
        if x.visibility == PUBLIC:
            x = _promote_to_shared(x)
        else:
            y = _promote_to_shared(y)
    mac = None if x.mac is None else _cat_fp(x.mac, y.mac, -2)
    return MpcFp(_cat_fp(x.value, y.value, -2), x.visibility, mac)


def _shift_by(x: MpcFp, d: int) -> MpcFp:
    """y_i = x_{i-d} along the last axis, filled with public ones (for a
    shared wire: the leader holds the one, with its MAC shares)."""
    one = MpcFp.const(x.spec, 1)
    if x.is_shared():
        one = _promote_to_shared(one)

    def f(fp: FpArray, fill: FpArray) -> FpArray:
        limbs = fp.limbs
        fl = fill.limbs                                          # [P, nlimbs]
        fl = fl.reshape(fl.shape[:1] + (1,) * (limbs.dim() - 2) + fl.shape[1:])
        fl = fl.expand(tuple(limbs.shape[:-2]) + (d, limbs.shape[-1]))
        return FpArray(torch.cat([fl, limbs[..., :-d, :]], dim=-2), fp.spec,
                       max(fp.bound, fill.bound))
    mac = None if x.mac is None else f(x.mac, one.mac)
    return MpcFp(f(x.value, one.value), x.visibility, mac)


def _shift_by_zero(x: MpcFp, d: int) -> MpcFp:
    """y_i = x_{i-d}, zero-filled at the bottom."""
    return _limb_view(x, lambda l: torch.cat([torch.zeros_like(l[..., :d, :]),
                                              l[..., :-d, :]], dim=-2))


def _shift_down_zero(x: MpcFp, d: int = 1) -> MpcFp:
    """y_i = x_{i+d}, zero-filled at the top (zeros are plain zeros for both
    public and shared wires)."""
    return _limb_view(x, lambda l: torch.cat([l[..., d:, :],
                                              torch.zeros_like(l[..., :d, :])], dim=-2))


def _tree_sum_fp(fp: FpArray) -> FpArray:
    while fp.limbs.shape[-3] > 1:
        n = fp.limbs.shape[-3]
        half = n // 2
        folded = FpArray(fp.limbs[..., :half, :, :], fp.spec, fp.bound) + \
            FpArray(fp.limbs[..., half:2 * half, :, :], fp.spec, fp.bound)
        if n % 2:
            folded = FpArray(torch.cat([folded.limbs, fp.limbs[..., 2 * half:, :, :]],
                                       dim=-3), fp.spec, max(folded.bound, fp.bound))
        fp = folded
    return FpArray(fp.limbs[..., 0, :, :], fp.spec, fp.bound)


def _tree_sum_axis(x: MpcFp) -> MpcFp:
    """Sum over the second-to-last batch axis (pairwise folds)."""
    return x.map(_tree_sum_fp)


def _sum_last(x: MpcFp) -> MpcFp:
    return x.map(_sum_last_axis)


def _bits_to_field(bits: MpcFp) -> MpcFp:
    """[.., nbits] shared bits -> shared value sum 2^i b_i (local)."""
    return _sum_last(bits * _table(bits.spec, "pow2", bits.shape[-1]))


def _int_bits(v: int, n: int) -> list:
    return [(v >> i) & 1 for i in range(n)]


def _table(spec: FieldSpec, kind: str, n: int) -> MpcFp:
    """A public table that every protocol call takes, as a constant wire:
    ``pow2`` the powers 2^i, ``p`` the bits of p, ``2^n-p`` the bits of
    2^n - p, each of length n."""
    return MpcFp.from_public(_table_limbs(spec, kind, n, ctx().transport.device))


@functools.lru_cache(maxsize=None)
def _table_limbs(spec: FieldSpec, kind: str, n: int, device) -> FpArray:
    """`_table`'s values, made once per spec, length and device (a
    host-to-device copy on every call otherwise)."""
    p = spec.p
    if kind == "pow2":
        ints = [pow(2, i, p) for i in range(n)]
    else:
        ints = _int_bits({"p": p, "2^n-p": (1 << n) - p}[kind], n)
    return FpArray.from_int(spec, ints, device=device)


# ---------------------------------------------------------------------------
# randomness protocols
# ---------------------------------------------------------------------------


def bit_rand(generator, spec: FieldSpec, shape=(), raw=None) -> MpcFp:
    """Uniform shared random bits: the XOR of one private bit per party.

    Each party contributes a trivially shared private bit; a log-depth XOR
    tree of Beaver products combines them, so the result is uniform as long
    as one party is honest.  Party i's bits come from its own generator
    (`rand.bit_rows`).  ``raw``: optional injected bool tensor [P, *shape]
    of the parties' bits in place of the generators' draws (the reference
    draws party i's bits from ``fold_in(key, i)``).

    Under SPDZ the bits must be authenticated: they come from the <r> pool
    through the square-root trick (`bit_rand_sqrt`), every step of which
    keeps the MACs."""
    c = ctx()
    if c.backend == "spdz":
        if raw is not None:
            raise ValueError("spdz bits come from the <r> pool, not injected draws")
        return bit_rand_sqrt(generator, spec, shape)
    t = c.transport
    P_ = t.n_parties
    shape = tuple(shape)
    if raw is None:
        raw = R.bit_rows(generator, t, shape).to(t.device)          # [rows, ...]
    else:
        raw = torch.as_tensor(raw, dtype=torch.bool).to(t.device)
        assert tuple(raw.shape) == (P_,) + shape, raw.shape
        raw = t.own_rows(raw)
    one = spec.const("one_limbs", t.device)
    ids = t.party_index(len(shape))
    # contribution i: party i's row holds its bit, the other rows zero
    contribs = [MpcFp(FpArray(torch.where(((ids == i) & raw)[..., None], one,
                                          torch.zeros_like(one)), spec, 1), SHARED)
                for i in range(P_)]
    while len(contribs) > 1:
        nxt = [b_xor(contribs[j], contribs[j + 1])
               for j in range(0, len(contribs) - 1, 2)]
        if len(contribs) % 2:
            nxt.append(contribs[-1])
        contribs = nxt
    return contribs[0]


def sqrt_public(x: FpArray) -> FpArray:
    """Batched square root of public quadratic residues (undefined output
    for non-residues; 0 -> 0): constant-structure Tonelli-Shanks, the
    s - 1 rounds (s = the field's 2-adicity, 47 for BLS12-377 Fr) as a
    plain loop, each squaring t up to 2^i.  The select of a round compares
    canonical values."""
    spec = x.spec
    p = spec.p
    s = spec.two_adicity
    q = (p - 1) >> s
    z = pow(spec.generator % p, q, p)                 # an element of order 2^s

    def n2(f: FpArray) -> FpArray:
        f = f.tighten()
        return f if f.bound == 2 else FpArray(f.limbs, spec, 2)

    c = n2(FpArray.from_int(spec, z, device=x.device).broadcast_to(x.shape))
    t = n2(x.pow_const(q))
    r = n2(x.pow_const((q + 1) // 2))
    one = FpArray.ones(spec, x.shape, x.device)
    for i in range(s - 2, -1, -1):
        d = t
        for _ in range(i):
            d = n2(d.square())
        flag = ~d.equals(one) & ~t.equals(one)
        r2 = FpArray.select(flag, r * c, r)
        c = n2(c.square())
        t2 = FpArray.select(flag, t * c, t)
        r, t = n2(r2), n2(t2)
    return r


def bit_rand_sqrt(generator, spec: FieldSpec, shape=()) -> MpcFp:
    """The reference's square-root-trick bits (`boolean_field.rs:150-170`):
    a shared r, open r^2, b = (r / sqrt(r^2) + 1) / 2.  Every step keeps
    the MACs: r is authenticated, one Beaver square, one opening, then
    public scales and shifts."""
    r = rand_shared(generator, spec, shape)
    r2 = (r * r).reveal()
    # r = 0 (negligible) would leave sqrt and inverse undefined: use 1
    safe = FpArray.select(r2.is_zero(), FpArray.ones(spec, r2.shape, r2.device), r2)
    vinv = sqrt_public(safe).inv()
    pm1 = r * MpcFp(vinv, PUBLIC)                     # in {-1, +1}
    half = MpcFp.const(spec, pow(2, -1, spec.p))
    return (pm1 + MpcFp.const(spec, 1)) * half


def rand_number_bitwise(generator, spec: FieldSpec, shape=(), attempts: int = 16,
                        raw=None):
    """Bitwise-shared uniform value < p: returns (bits [.., nbits], value).

    ``attempts`` candidates are drawn batched; the first below p is selected
    obliviously (failure probability (1 - p/2^nbits)^attempts, after which
    the value is 0 and its bits all zero, still consistent).  ``raw``: the
    injected bits of `bit_rand`, [P, *shape, attempts, nbits]."""
    nbits = spec.p.bit_length()
    bits = bit_rand(generator, spec, tuple(shape) + (attempts, nbits), raw=raw)
    lt = bitwise_lt(bits, _table(spec, "p", nbits))              # [.., attempts]
    # selector_i = valid_i * prod_{j<i} invalid_j
    prefix = _prefix_products(b_not(lt))
    sel = lt * _shift_by(prefix, 1)
    chosen = _tree_sum_axis(_expand_last(sel, nbits) * bits)
    return chosen, _bits_to_field(chosen)


def _prefix_products(x: MpcFp) -> MpcFp:
    """Inclusive prefix products along the last axis (log-depth, batched)."""
    n = x.shape[-1]
    d = 1
    while d < n:
        x = x * _shift_by(x, d)
        d *= 2
    return x


# ---------------------------------------------------------------------------
# comparisons over bit-shared values
# ---------------------------------------------------------------------------


def bitwise_lt(a_bits: MpcFp, b_bits: MpcFp) -> MpcFp:
    """[a < b] for little-endian bit vectors [.., n] (shared or public):
    find the highest differing bit; the answer is b's bit there."""
    s = _suffix_or(b_xor(a_bits, b_bits))
    # leading-difference indicator: s_i - s_{i+1} is 1 only at the top diff
    e = s - _shift_down_zero(s)
    return _sum_last(e * b_bits)


def bitwise_lt_public_rhs(a_bits: MpcFp, b_bits_ints) -> MpcFp:
    """[a < b] where b is a public little-endian list of 0/1 ints."""
    return bitwise_lt(a_bits, MpcFp.const(a_bits.spec, b_bits_ints))


def _suffix_or(x: MpcFp) -> MpcFp:
    """s_i = OR_{j>=i} x_j along the last axis (log-depth)."""
    n = x.shape[-1]
    d = 1
    while d < n:
        x = b_or(x, _shift_down_zero(x, d))
        d *= 2
    return x


# ---------------------------------------------------------------------------
# equality-zero / bit decomposition / less-than
# ---------------------------------------------------------------------------


def equality_zero(x: MpcFp, generator, attempts: int = 16) -> MpcFp:
    """[x == 0] as a shared bit: open c = x + r with bitwise-shared r;
    x == 0 iff c == r bitwise; AND-tree the XNORs."""
    nbits = x.spec.p.bit_length()
    r_bits, r_val = rand_number_bitwise(generator, x.spec, x.shape, attempts)
    c = (x + r_val).reveal()
    return kary_and(_public_xnor(_public_bits(c, nbits), r_bits))


def _public_bits(c: FpArray, nbits: int) -> FpArray:
    """Public field values -> 0/1 field elements of their canonical bits."""
    limbs = c.int_limbs()
    shifts = torch.arange(LIMB_W, device=limbs.device)
    bits = (limbs[..., :, None] >> shifts) & 1
    bits = bits.reshape(tuple(bits.shape[:-2]) + (-1,))[..., :nbits]
    one = c.spec.const("one_limbs", limbs.device)
    return FpArray(torch.where(bits[..., None] > 0, one, torch.zeros_like(one)),
                   c.spec, 1)


def _public_xnor(c_bits: FpArray, r_bits: MpcFp) -> MpcFp:
    """XNOR of public bits with shared bits, affine per bit:
    1 - c - r + 2cr."""
    cb = MpcFp(c_bits, PUBLIC)
    return MpcFp.const(r_bits.spec, 1) - cb - r_bits + (cb * r_bits).smul(2)


def is_smaller_or_equal_than_mod_minus_one_div_two(x: MpcFp, generator,
                                                    attempts: int = 16) -> MpcFp:
    """[x <= (p-1)/2] (signed: [x >= 0]): x <= (p-1)/2 iff 2x mod p is even;
    LSB(y) through open c = y + r: lsb = c_0 xor r_0 xor [c < r]."""
    spec = x.spec
    nbits = spec.p.bit_length()
    r_bits, r_val = rand_number_bitwise(generator, spec, x.shape, attempts)
    c = (x.smul(2) + r_val).reveal()
    c_bits = _public_bits(c, nbits)
    wrap = bitwise_lt(MpcFp(c_bits, PUBLIC), r_bits)   # [c < r], shared
    c0 = MpcFp(FpArray(c_bits.limbs[..., 0, :], spec, c_bits.bound), PUBLIC)
    return b_not(_xor3(c0, _index_last(r_bits, 0), wrap))


def _xor3(a: MpcFp, b: MpcFp, c: MpcFp) -> MpcFp:
    return b_xor(b_xor(a, b), c)


def less_than(x: MpcFp, y: MpcFp, generator, attempts: int = 16) -> MpcFp:
    """[x < y] as a shared bit under the signed reading of field elements
    (values in (-p/2, p/2]), from three half-range tests a = [x >= 0],
    b = [y >= 0], c = [x - y >= 0]:
    [x < y] = a*b*(1-c) + (1-a)*b + (1-a)*(1-b)*(1-c)."""
    a = is_smaller_or_equal_than_mod_minus_one_div_two(x, generator, attempts)
    b = is_smaller_or_equal_than_mod_minus_one_div_two(y, generator, attempts)
    c = is_smaller_or_equal_than_mod_minus_one_div_two(x - y, generator, attempts)
    one = MpcFp.const(x.spec, 1)
    nc, na, nb = one - c, one - a, one - b
    return a * b * nc + na * b + na * nb * nc


def bit_decomposition(x: MpcFp, generator, attempts: int = 16) -> MpcFp:
    """Shared little-endian bits [.., nbits] of shared x.

    Open c = x - r (r bitwise-shared); then x = c + r mod p, so the bits of
    x are those of the integer sum c + r, less p where the sum wraps: a
    shared binary addition with carry lookahead, a bitwise comparison with
    p, and a second addition of the public 2^(nbits+1) - p, selected by the
    wrap bit."""
    spec = x.spec
    nbits = spec.p.bit_length()
    r_bits, r_val = rand_number_bitwise(generator, spec, x.shape, attempts)
    c_bits = _public_bits((x - r_val).reveal(), nbits)
    s_bits = bit_add(r_bits, MpcFp(c_bits, PUBLIC))               # [.., nbits+1]
    wrap = b_not(bitwise_lt(s_bits, _table(spec, "p", nbits + 1)))
    diff = bit_add(s_bits, _table(spec, "2^n-p", nbits + 1))       # [.., nbits+2]
    sel = _slice_last(diff, 0, nbits)
    uns = _slice_last(s_bits, 0, nbits)
    return uns + _expand_last(wrap, nbits) * (sel - uns)


def carries(a_bits: MpcFp, b_bits: MpcFp) -> MpcFp:
    """Carry-out bit of each position when adding two little-endian bit
    vectors: a log-depth parallel prefix over (generate, propagate),
    (g2, q2) o (g1, q1) = (g2 + q2*g1, q2*q1).  Both products of a level
    ride one batched Beaver round: [Q, Q] * [G shifted, Q shifted]."""
    G = b_and(a_bits, b_bits)
    Q = b_xor(a_bits, b_bits)
    n = G.shape[-1]
    d = 1
    while d < n:
        prod = _concat_last(Q, Q) * _concat_last(_shift_by_zero(G, d), _shift_by(Q, d))
        G = G + _slice_last(prod, 0, n)
        Q = _slice_last(prod, n, 2 * n)
        d *= 2
    return G


def bit_add(a_bits: MpcFp, b_bits: MpcFp) -> MpcFp:
    """Binary addition of two little-endian bit vectors of one length n
    (either side shared, or public), carry lookahead in log depth; the
    output has n+1 bits."""
    n = a_bits.shape[-1]
    G = carries(a_bits, b_bits)
    s = _xor3(a_bits, b_bits, _shift_by_zero(G, 1))     # carry into bit i
    return _concat_last(s, _slice_last(G, n - 1, n))
