"""Writes ``torch_xla.npz``: the JAX package's side of the port's
arithmetic parity tests, on the tests' own inputs, so that tier-1 reads it
instead of compiling (or eagerly dispatching) the JAX package on a CPU.

Each case is a list of arrays, the JAX package's limbs (int64), infinity
flags and bounds, in the order the test compares them:

- ``complete_add.g1`` / ``.g2``: ``ops.curve.sw_add_complete`` (the XLA
  formula the plain twin of K2/K3 keeps) on the lanes of
  ``tests/test_pallas_point.py`` (`test_torch_curve._all_cases`);
- ``double``, ``add_unsafe``, ``neg``: the other G1 point ops
  (`test_torch_curve._point_op_inputs`);
- ``mont_mul_xla.<field>``: ``limbs._mont_mul_limbs`` (K1's XLA path) on
  canonical, relaxed and constant operands (`test_torch_limbs._mont_cases`);
- ``mont_mul_pallas.<field>``: the Pallas kernel K1 in interpret mode;
- ``fparray_ops``, ``fp2_ops``: the FpArray and Fp2Array operations of
  `test_torch_limbs`, limbs and bounds;
- ``ntt``: ``Domain.fft``, ``coset_ifft`` and the vanishing-polynomial
  division of `test_torch_msm_ntt`, limbs and bounds;
- ``fp_from_digits.<src>.<dst>``: ``limbs.fp_from_digits`` of
  `test_torch_uint8`;
- ``beaver_mul``, ``uniform_fp``: a Beaver product (share and opened
  limbs) and a ``mpc.rand.uniform_fp`` draw with its raw bits, of
  `test_torch_mpc`;
- ``input_share``: ``inputs.input_share``'s share values and its mask
  draw, of `test_torch_online`;
- ``pedersen_params``: the Pedersen and CRH generators and a commitment
  and CRH value of `test_torch_pedersen`, as integer limbs;
- ``te_add``: an Edwards add of `test_torch_te`.

`ref` reads a case; ``test_torch_curve.py::test_xla_fixture_against_live_reference``
(``slow``) regenerates every case and holds the file against it.  Run from
the repository root (a minute or two on a CPU):

    PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/fixtures/make_torch_xla_fixture.py
"""

from __future__ import annotations

import functools
import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_xla.npz")
MONT_FIELDS = ("bls12_377_fr", "bls12_377_fq", "mnt4_753_fq")
PALLAS_FIELDS = ("bls12_377_fr", "bls12_377_fq")
DIGIT_PAIRS = (("bls12_377_fr", "mnt4_753_fq"), ("mnt4_753_fq", "bls12_377_fr"),
               ("bls12_377_fr", "ed_bls12_377_fr"), ("bls12_377_fq", "bls12_377_fr"))


def _np(x):
    return np.asarray(x).astype(np.int64) if np.asarray(x).dtype != bool else np.asarray(x)


def _fp(x) -> list:
    """A JAX FpArray: its limbs and its bound."""
    return [_np(x.limbs), np.asarray(x.bound)]


def _point(p) -> list:
    from torch_parity import point_leaves_np, point_to_torch
    return point_leaves_np(point_to_torch(p))


def _complete_add(gid):
    import test_torch_curve as TCU
    from torch_parity import point_to_jax
    from zkmpc_tpu.ops import curve as JC
    p, q, _ = TCU._all_cases(TCU.G1 if gid == "g1" else TCU.G2)
    return _point(JC.sw_add_complete(point_to_jax(p), point_to_jax(q)))


def _point_op(name):
    import test_torch_curve as TCU
    from torch_parity import point_to_jax
    from zkmpc_tpu.ops import curve as JC
    p, q = (point_to_jax(x) for x in TCU._point_op_inputs())
    return _point({"double": lambda: JC.sw_double(p),
                   "add_unsafe": lambda: JC.sw_add_unsafe(p, q),
                   "neg": lambda: JC.sw_neg(p)}[name]())


def _mont_xla(field):
    import jax

    import test_torch_limbs as TLI
    from torch_parity import SPECS
    from zkmpc_tpu.ops import limbs as JL
    js = SPECS[field][0]
    return [_np(jax.jit(JL._mont_mul_limbs, static_argnums=0)(js, la, lb))
            for la, lb in TLI._mont_cases(SPECS[field][1])]


def _mont_pallas(field):
    import test_torch_limbs as TLI
    from torch_parity import SPECS
    from zkmpc_tpu.ops.pallas_fp import mont_mul_pallas
    a2, b = TLI._pallas_inputs(SPECS[field][1])
    return [_np(mont_mul_pallas(SPECS[field][0], np.asarray(a2.limbs), np.asarray(b.limbs),
                                "interpret"))]


def _fparray_ops():
    import jax

    import test_torch_limbs as TLI
    a, b = TLI._fparray_inputs()
    want, big = jax.jit(TLI._fparray_ops)(a, b)
    out = [x for w in want for x in _fp(w)]
    return out + [_np(jax.jit(lambda x: x.canon_limbs())(big)),
                  _np(jax.jit(lambda x: x.int_limbs())(big)),
                  _np(jax.jit(lambda x: x.is_zero())(a))]


def _fp2_ops():
    import jax

    import test_torch_limbs as TLI
    from zkmpc_tpu.ops import fp2 as JF2
    arr, arr2 = TLI._fp2_inputs()
    ja, jb = JF2.Fp2Array.from_int(arr), JF2.Fp2Array.from_int(arr2)
    return [x for w in jax.jit(TLI._fp2_ops)(ja, jb) for c in (w.c0, w.c1) for x in _fp(c)]


def _ntt():
    import jax

    import test_torch_msm_ntt as TMN
    from zkmpc_tpu.ops import limbs as JL
    from zkmpc_tpu.ops import ntt as JN
    vals = TMN._ntt_inputs()
    n = vals.shape[-1]
    x = JL.FpArray.from_int(JL.FR, vals)
    jd = JN.Domain(JL.FR, n)
    return [v for r in (jax.jit(jd.fft)(x), jax.jit(jd.coset_ifft)(x),
                        jd.divide_by_vanishing_poly_on_coset(x)) for v in _fp(r)]


def _from_digits(src, dst):
    import jax

    import test_torch_uint8 as TU
    from torch_parity import SPECS
    from zkmpc_tpu.ops import limbs as JL
    jdst = SPECS[dst][0]
    _, digits, short = TU._digit_inputs(SPECS[src][1])
    want = jax.jit(lambda d, s: (JL.fp_from_digits(jdst, d).limbs,
                                 JL.fp_from_digits(jdst, s).limbs))(
        digits.astype(np.uint32), short.astype(np.uint32))
    return [_np(w) for w in want]


def _beaver_mul():
    import jax

    import test_torch_mpc as TM
    from zkmpc_tpu.mpc import share as JS
    from zkmpc_tpu.parallel import transport as JT
    _, _, jx, jy = TM._beaver_inputs()

    def prod(x, y):
        with JS.mpc_scope(JS.MpcContext(JT.StackedTransport(TM.NP), "semi")):
            z = JS.beaver_mul(JS.MpcFp(x, JS.SHARED), JS.MpcFp(y, JS.SHARED))
            return z.value, z.reveal()
    share, opened = jax.jit(prod)(jx, jy)
    return [_np(share.limbs), _np(opened.limbs)]


def _uniform_fp():
    """``mpc.rand.uniform_fp`` under ``PRNGKey(5)``: limbs, bound, and the
    raw bits of its two split keys (which the port's draw takes)."""
    import jax

    import test_torch_mpc as TM
    from zkmpc_tpu.mpc import rand as JR
    from zkmpc_tpu.ops import limbs as JL
    key = jax.random.PRNGKey(5)
    shape = TM.UNIFORM_SHAPE
    want = jax.jit(JR.uniform_fp, static_argnums=(1, 2))(key, JL.FR, shape)
    bits = [_np(jax.random.bits(k, shape + (JL.FR.nlimbs,), dtype=np.uint32))
            for k in jax.random.split(key)]
    return _fp(want) + bits


def _input_share():
    """``inputs.input_share`` of `test_torch_online.INPUT_SHARE_VALS` (owner
    1) under ``PRNGKey(4)``: the shares' values as 15-bit integer limbs,
    and the mask draw it made (limbs and bound)."""
    import jax

    import test_torch_online as TO
    from zkmpc_tpu import inputs as JIN
    from zkmpc_tpu.mpc import rand as JR
    from zkmpc_tpu.mpc.share import MpcContext, mpc_scope
    from zkmpc_tpu.ops.limbs import FR, FpArray
    from zkmpc_tpu.parallel.transport import StackedTransport
    from zkmpc_tpu_torch.ops.limbs import ints_to_limbs
    key = jax.random.PRNGKey(4)
    with mpc_scope(MpcContext(StackedTransport(TO.N_PARTIES), backend="semi")):
        sh = JIN.input_share(FpArray.from_int(FR, np.asarray(TO.INPUT_SHARE_VALS, dtype=object)),
                             1, key)
        vals = [int(v) for v in np.asarray(sh.value.to_ints()).reshape(-1)]
    return [ints_to_limbs(vals, FR.nlimbs)] + _fp(JR.uniform_fp(key, FR, (TO.N_PARTIES - 1, 2)))


def _affine_limbs(points) -> np.ndarray:
    """Affine (x, y) int pairs -> int64 integer limbs [len, 2, 26]."""
    from zkmpc_tpu_torch.ops.limbs import ints_to_limbs
    return ints_to_limbs([c for pt in points for c in pt], 26).reshape(len(points), 2, 26)


def _pedersen_params():
    """The JAX package's Pedersen generators and blinding base, a public
    commitment, the CRH generators and a CRH value, of
    `test_torch_pedersen.test_generators_and_public_commitment_match_reference`,
    as integer limbs [k, 2, 26]."""
    import test_torch_pedersen as TP
    from zkmpc_tpu.crypto import pedersen as JPD
    pp, cp = JPD.PedersenParams.sample(TP.PP_SEED), JPD.CrhParams.sample(TP.CRH_BITS)
    return [_affine_limbs(pts) for pts in (
        pp.generators, [pp.blind_base], [JPD.commit_public_ints(pp, TP.COM_M, TP.COM_R)],
        cp.generators, [JPD.crh_public_ints(cp, TP.CRH_INPUT)])]


def _te_add():
    """``ops.curve.te_add`` of `test_torch_te._carried_points` with itself:
    x, y, t, z limbs."""
    import test_torch_te as TT
    from zkmpc_tpu.ops import curve as JC
    jp = JC.TEPoint.from_affine_ints(TT._carried_points())
    out = JC.te_add(jp, jp)
    return [_np(c.limbs) for c in (out.x, out.y, out.t, out.z)]


def cases() -> dict:
    """Case name -> a function computing its arrays with the JAX package."""
    out = {f"complete_add.{g}": functools.partial(_complete_add, g) for g in ("g1", "g2")}
    out.update({name: functools.partial(_point_op, name)
                for name in ("double", "add_unsafe", "neg")})
    out.update({f"mont_mul_xla.{f}": functools.partial(_mont_xla, f) for f in MONT_FIELDS})
    out.update({f"mont_mul_pallas.{f}": functools.partial(_mont_pallas, f)
                for f in PALLAS_FIELDS})
    out.update(fparray_ops=_fparray_ops, fp2_ops=_fp2_ops, ntt=_ntt, beaver_mul=_beaver_mul,
               uniform_fp=_uniform_fp, input_share=_input_share,
               pedersen_params=_pedersen_params, te_add=_te_add)
    out.update({f"fp_from_digits.{s}.{d}": functools.partial(_from_digits, s, d)
                for s, d in DIGIT_PAIRS})
    return out


def generate() -> dict:
    """Every case with the JAX package; returns the npz arrays."""
    return {f"{name}.{i}": arr for name, fn in cases().items() for i, arr in enumerate(fn())}


def load(arrays) -> dict:
    """npz arrays -> {case name: [arrays in order]}."""
    out = {}
    for key in sorted(arrays, key=lambda k: (k.rsplit(".", 1)[0], int(k.rsplit(".", 1)[1]))):
        name, _ = key.rsplit(".", 1)
        out.setdefault(name, []).append(np.asarray(arrays[key]))
    return out


@functools.lru_cache(maxsize=None)
def _committed() -> dict:
    return load(np.load(PATH))


def ref(name: str) -> list:
    """The committed arrays of case ``name``."""
    return _committed()[name]


if __name__ == "__main__":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(PATH, **generate())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
