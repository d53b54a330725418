"""Writes ``torch_uint8_3p.npz``: what the JAX package computes, at 3 parties
where it runs a protocol, for the port's byte and Edwards tests, in a
jax-free form they load.

- ``u8``: `MpcU8` xor, and, or and not of two 6-byte vectors from a numpy
  seed, each dealt by `king_share` from ``PRNGKey(11)`` and
  ``PRNGKey(12)``: the dealing draws and the output bits' limbs.
- ``conv``: `modulus_conversion` of 5 shared FR values below 2^250 (dealt
  from ``PRNGKey(21)``) to EDFR and FQ (``PRNGKey(22)``, ``(23)``), and
  of the public values to EDFR: the draws and the output limbs.
- ``mul``: `mul_chain` below over FR and FQ at 3 parties, on
  `mul_inputs`: every step's factors and opened limbs.
- ``gadget``: `byte_circuit` below, written once for both packages: a
  byte a and a byte b, shared by party 0 and party 1 through
  `inputs.input_share` (the masks from ``PRNGKey(1)`` and ``PRNGKey(2)``),
  allocated together with one ``UInt8.new_witness_vec``; a.xor(b) equal
  to a public byte, and, or, not, ``rotr``, ``shl``, ``from_bits_le`` /
  ``to_bits_le``, ``to_fp`` and two ``is_eq``.  Its bit protocols draw
  ``ATTEMPTS`` candidates.  The file holds the R1CS, the instance, the
  opened full assignment and the counts (as
  ``make_torch_pedersen_fixture.record``), every party's share of the full
  assignment, the input masks, and the raw bits each call of
  ``rand_number_bitwise`` drew, in order, as the JAX package draws them
  (party i's from ``fold_in(key, i)``), which the port's test injects.
- ``te``: the Edwards ops on 8 Ed-on-BLS12-377 points and 16-bit scalars
  from a numpy seed: ``te_add``, ``te_double``, ``te_neg``,
  ``te_scalar_mul``, ``te_tree_reduce`` of 5 points, ``te_msm`` over [8]
  and over [2, 7] scalars: the coordinates' limbs.
- ``sw``: ``sw_tree_reduce`` of 5 G1 points and 3 G2 points: the limbs
  and infinity masks.

Run from the repository root (a few minutes on a CPU: the JAX package
synthesizes the circuit eagerly, and compiles the tree reductions):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/fixtures/make_torch_uint8_fixture.py
"""

from __future__ import annotations

import importlib
import json
import os

import numpy as np

N_PARTIES = 3
#: candidates of the bit protocols on both sides
ATTEMPTS = 4
A_BYTES = [0xA5]
B_BYTES = [0x3C]
#: the fields of the `MpcMulFp` case
MUL_SPECS = ("bls12_377_fr", "bls12_377_fq")
#: the scalar bits of the Edwards cases
TE_BITS = 16
SEED = 10
#: the dealing draws the small cases inject, by name
DRAWS = ("u8_a", "u8_b", "conv_in", "conv_ed", "conv_fq")
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_uint8_3p.npz")


def _rotr(v, k):
    return ((v >> k) | (v << (8 - k))) & 0xFF


def byte_circuit(pkg, cs, a_wire, b_wire, rnds):
    """The byte case, written once for either package: ``pkg`` its name,
    a_wire and b_wire shared [1] field tensors of A_BYTES and B_BYTES,
    ``rnds`` three JAX keys or generators of the bit protocols."""
    U = importlib.import_module(f"{pkg}.snark.uint8_gadget").UInt8
    G = importlib.import_module(f"{pkg}.snark.gadgets")
    MpcFp = importlib.import_module(f"{pkg}.mpc.share").MpcFp
    # both strings in one batched allocation (one bit decomposition)
    a, b = U.new_witness_vec(cs, MpcFp.concat([a_wire, b_wire]), rnds[0])
    x, y = A_BYTES[0], B_BYTES[0]
    a.xor(b).enforce_equal(U.constant(cs, x ^ y))
    a.and_(b).enforce_equal(U.constant(cs, x & y))
    a.or_(b).enforce_equal(U.constant(cs, x | y))
    a.not_().enforce_equal(U.constant(cs, x ^ 0xFF))
    a.rotr(3).enforce_equal(U.constant(cs, _rotr(x, 3)))
    a.shl(2).enforce_equal(U.constant(cs, (x << 2) & 0xFF))
    U.from_bits_le(b.to_bits_le()).to_fp().enforce_equal(G.FpVar.constant(cs, y))
    a.xor(b).is_eq(U.constant(cs, x ^ y), rnds[1]).enforce_true()
    a.is_eq(b, rnds[2]).enforce_false()


def mul_chain(pkg, spec, factors, pub, k):
    """The `MpcMulFp` case, written once for either package, under a
    stacked MPC scope: from_shares, from_public, public, the local *,
    square, inv, pow_const (short and long exponents), scale of a shared
    and of a public wire, open, and x * x^-1.  Returns (factors or
    public values, opened) limbs of every step."""
    M = importlib.import_module(f"{pkg}.mpc.mul_share").MpcMulFp
    FpArray = importlib.import_module(f"{pkg}.ops.limbs").FpArray
    kw = {} if pkg == "zkmpc_tpu" else {"device": "cpu"}

    def fp(v):
        return FpArray.from_int(spec, np.asarray(v, dtype=object), **kw)
    x = M.from_shares(fp(factors))
    y = M.from_public(fp(pub))
    w = M.public(fp(pub))
    steps = [x, y, w, x * y, (x * y).square(), x.inv(), x.pow_const(5), x.pow_const(1 << 20),
             x.scale(fp(k)), w.scale(fp(k)), (x * w).open(), x * x.inv()]
    return [(s.value.limbs, s.reveal().limbs) for s in steps]


def mul_inputs(p):
    """Factors [3, 5], a public vector and a scale, below p."""
    rng = np.random.default_rng(1)

    def ints(n):
        return [int.from_bytes(rng.bytes(64), "little") % p for _ in range(n)]
    return [ints(5) for _ in range(N_PARTIES)], ints(5), ints(5)


def u8_inputs():
    """Two 6-byte vectors."""
    rng = np.random.default_rng(3)
    return ([int(v) for v in rng.integers(0, 256, 6)],
            [int(v) for v in rng.integers(0, 256, 6)])


def conv_inputs():
    """5 values below 2^250 (the last 2^250 - 1)."""
    rng = np.random.default_rng(7)
    return [int.from_bytes(rng.bytes(32), "little") >> 6 for _ in range(4)] + [(1 << 250) - 1]


def bit_ints(vals):
    return np.asarray([[(v >> j) & 1 for j in range(8)] for v in vals], dtype=object)


def te_inputs():
    """8 points k*G (affine ints) and the scalars: [8] and [2, 7]."""
    from zkmpc_tpu_torch.spec import curves as SC
    rng = np.random.default_rng(SEED)
    ks = [int(v) for v in rng.integers(2, 1 << 20, 8)]
    pts = [SC.te_scalar_mul(SC.TE_GEN, k) for k in ks]
    s1 = [int(v) for v in rng.integers(0, 1 << TE_BITS, 8)]
    s1[-1] = (1 << TE_BITS) - 1
    s2 = [[int(v) for v in row] for row in rng.integers(0, 1 << TE_BITS, (2, 7))]
    return pts, s1, s2


def sw_inputs():
    """5 G1 and 3 G2 points (affine ints), the last G1 point the negative
    of the first (a complete add's cancellation)."""
    from zkmpc_tpu_torch import params
    from zkmpc_tpu_torch.spec import curves as SC
    g1 = [SC.g1_mul(SC.G1_GEN, k) for k in (3, 5, 7, 11, params.FR_MODULUS - 3)]
    g2 = [SC.g2_mul(SC.G2_GEN, k) for k in (2, 9, 4)]
    return g1, g2


def _ints(x):
    return [int(v) for v in np.asarray(x).reshape(-1)]


def _limbs(fp):
    return np.asarray(fp.limbs, dtype=np.int64)


def generate_gadget() -> dict:
    """The byte circuit through the JAX package."""
    import jax
    from fixtures.make_torch_pedersen_fixture import record
    from zkmpc_tpu import inputs as IN
    from zkmpc_tpu.mpc import bits as B
    from zkmpc_tpu.mpc import rand as JR
    from zkmpc_tpu.mpc.share import MpcContext, mpc_scope
    from zkmpc_tpu.ops.limbs import FR, FpArray
    from zkmpc_tpu.parallel.transport import StackedTransport
    from zkmpc_tpu.snark.r1cs import ConstraintSystem

    raws = []
    orig = B.rand_number_bitwise

    def drawn(key, spec, shape=(), attempts=16):
        full = tuple(shape) + (ATTEMPTS, spec.p.bit_length())
        raws.append(np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i),
                                                              0.5, full))
                              for i in range(N_PARTIES)]))
        return orig(key, spec, shape, ATTEMPTS)

    B.rand_number_bitwise = drawn
    try:
        with mpc_scope(MpcContext(StackedTransport(N_PARTIES), backend="semi")):
            masks = [JR.uniform_fp(jax.random.PRNGKey(k), FR, (N_PARTIES - 1, len(A_BYTES)))
                     for k in (1, 2)]
            wires = [IN.input_share(FpArray.from_int(FR, np.asarray(v, dtype=object)), owner,
                                    jax.random.PRNGKey(owner + 1))
                     for owner, v in enumerate((A_BYTES, B_BYTES))]
            cs = ConstraintSystem(FR)
            byte_circuit("zkmpc_tpu", cs, wires[0], wires[1],
                         [jax.random.PRNGKey(k) for k in (3, 4, 5)])
            assert cs.is_satisfied_ints()
            z = cs.full_assignment()
            opened = np.asarray(z.reveal().to_ints())[0]
            shares = np.asarray(z.value.to_ints())
    finally:
        B.rand_number_bitwise = orig
    out = record(cs, opened)
    out["shares"] = [_ints(row) for row in shares]
    arrays = {"gadget_json": np.asarray(json.dumps(out)),
              "gadget_masks": np.stack([_limbs(m) for m in masks]),
              "gadget_mask_bounds": np.asarray([m.bound for m in masks]),
              "gadget_raw_count": np.asarray(len(raws))}
    for i, r in enumerate(raws):
        arrays[f"gadget_raw_{i}"] = np.packbits(r)
        arrays[f"gadget_raw_shape_{i}"] = np.asarray(r.shape)
    return arrays


def generate_small() -> dict:
    """The MpcU8, MpcMulFp and modulus-conversion cases through the JAX
    package, jitted."""
    import jax
    from zkmpc_tpu.mpc import rand as JR
    from zkmpc_tpu.mpc import share as JS
    from zkmpc_tpu.mpc import uint8 as JU
    from zkmpc_tpu.ops import limbs as JL
    from zkmpc_tpu.parallel.transport import StackedTransport

    def scope():
        return JS.mpc_scope(JS.MpcContext(StackedTransport(N_PARTIES), "semi"))

    a_vals, b_vals = u8_inputs()
    u8_keys = (jax.random.PRNGKey(11), jax.random.PRNGKey(12))
    vals = conv_inputs()
    k_in, k_ed, k_fq = (jax.random.PRNGKey(k) for k in (21, 22, 23))

    def u8():
        with scope():
            a, b = (JU.MpcU8(JS.king_share(JL.FpArray.from_int(JL.FR, bit_ints(v)), k))
                    for v, k in zip((a_vals, b_vals), u8_keys))
            return [u.bits.value.limbs for u in (a.xor(b), a.and_(b), a.or_(b), a.not_())]

    def conv():
        with scope():
            x = JS.king_share(JL.FpArray.from_int(JL.FR, np.asarray(vals, dtype=object)), k_in)
            pub = JS.MpcFp.const(JL.FR, vals)
            return [JS.modulus_conversion(x, JL.EDFR, k_ed).value.limbs,
                    JS.modulus_conversion(x, JL.FQ, k_fq).value.limbs,
                    JS.modulus_conversion(pub, JL.EDFR, k_ed).value.limbs]

    out = {f"u8_{i}": np.asarray(v, dtype=np.int64) for i, v in enumerate(jax.jit(u8)())}
    for name in MUL_SPECS:
        spec = next(s for s in (JL.FR, JL.FQ) if s.name == name)

        def mul(spec=spec):
            with scope():
                return mul_chain("zkmpc_tpu", spec, *mul_inputs(spec.p))
        for i, (val, opened) in enumerate(jax.jit(mul)()):
            out[f"mul_{name}_{i}"] = np.stack([np.asarray(val, dtype=np.int64),
                                               np.broadcast_to(np.asarray(opened, np.int64),
                                                               np.shape(val))])
    out.update({f"conv_{i}": np.asarray(v, dtype=np.int64)
                for i, v in enumerate(jax.jit(conv)())})
    for name, key, spec, shape in zip(DRAWS, u8_keys + (k_in, k_ed, k_fq),
                                      (JL.FR, JL.FR, JL.FR, JL.EDFR, JL.FQ),
                                      [(N_PARTIES, 6, 8)] * 2 + [(N_PARTIES, len(vals))] * 3):
        d = JR.uniform_fp(key, spec, shape)
        out[name] = _limbs(d)
        out[f"{name}_bound"] = np.asarray(d.bound)
    return out


def generate_curves() -> dict:
    """The Edwards ops and the SW tree reductions through the JAX package,
    each jitted."""
    import jax
    from zkmpc_tpu.ops import curve as C
    from zkmpc_tpu.ops import msm as M
    from zkmpc_tpu.ops.limbs import EDFR, FpArray

    pts, s1, s2 = te_inputs()

    def te():
        P = C.TEPoint.from_affine_ints(pts)
        k1 = FpArray.from_int(EDFR, np.asarray(s1, dtype=object))
        k2 = FpArray.from_int(EDFR, np.asarray(s2, dtype=object))
        return [jax.numpy.stack([c.limbs for c in (p.x, p.y, p.t, p.z)]) for p in (
            C.te_add(P[:4], P[4:]), C.te_double(P), C.te_neg(P),
            C.te_scalar_mul(P, k1, TE_BITS), C.te_tree_reduce(P[:5]),
            M.te_msm(P, k1, TE_BITS), M.te_msm(P[:7], k2, TE_BITS))]

    g1, g2 = sw_inputs()

    def sw():
        outs = []
        for mk, pts_ in ((C.SWPoint.g1_from_affine_ints, g1),
                         (C.SWPoint.g2_from_affine_ints, g2)):
            r = C.sw_tree_reduce(mk(pts_))
            leaves = jax.tree_util.tree_leaves((r.x, r.y, r.z))
            outs.append(([c.limbs if hasattr(c, "limbs") else c for c in leaves], r.inf))
        return outs

    te_out = jax.jit(te)()
    sw_out = jax.jit(sw)()
    out = {f"te_{i}": np.asarray(a, dtype=np.int64) for i, a in enumerate(te_out)}
    for name, (leaves, inf) in zip(("g1", "g2"), sw_out):
        out[f"sw_{name}"] = np.stack([np.asarray(v, dtype=np.int64) for v in leaves])
        out[f"sw_{name}_inf"] = np.asarray(inf)
    return out


def generate() -> dict:
    return {**generate_small(), **generate_gadget(), **generate_curves()}


def load(arrays) -> dict:
    """npz arrays -> {"gadget": record + "shares", "masks": [(limbs, bound)],
    "raws": [bool arrays], "te": [limb arrays], "sw_g1"/"sw_g2": (limbs,
    inf), "u8" and "conv": [output limbs], "mul": {field: [(factors,
    opened) limbs stacked]}, "draws": {name: (limbs, bound)}}."""
    raws = []
    for i in range(int(arrays["gadget_raw_count"])):
        shape = tuple(int(v) for v in arrays[f"gadget_raw_shape_{i}"])
        bits = np.unpackbits(arrays[f"gadget_raw_{i}"])[:int(np.prod(shape))]
        raws.append(bits.reshape(shape).astype(bool))
    return {"gadget": json.loads(str(arrays["gadget_json"])),
            "masks": list(zip(arrays["gadget_masks"], arrays["gadget_mask_bounds"])),
            "raws": raws,
            "te": [arrays[f"te_{i}"] for i in range(7)],
            "sw_g1": (arrays["sw_g1"], arrays["sw_g1_inf"]),
            "sw_g2": (arrays["sw_g2"], arrays["sw_g2_inf"]),
            "u8": [arrays[f"u8_{i}"] for i in range(4)],
            "mul": {name: [arrays[f"mul_{name}_{i}"] for i in range(12)] for name in MUL_SPECS},
            "conv": [arrays[f"conv_{i}"] for i in range(3)],
            "draws": {k: (arrays[k], int(arrays[f"{k}_bound"])) for k in DRAWS}}


if __name__ == "__main__":
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    np.savez_compressed(PATH, **generate())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
