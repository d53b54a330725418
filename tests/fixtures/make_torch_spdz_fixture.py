"""Writes ``torch_spdz_3p.npz``: the JAX package's SPDZ online backend at 3
parties, in a jax-free form that the PyTorch port's SPDZ tests load.

The MAC key shares alpha_i are those of the dealer in
``torch_she_8s_3p.npz``.  Triples, inverse pairs and <r> shares come from
`FixedSource` below, written once for both packages: authenticated values
drawn with numpy from a seed, so both packages get the same inputs without
running SHE preprocessing.  The file holds, limbs as uint32 arrays with
their bounds, ints as JSON:

- ``field``: shared x, y [4] and a dealt value [4] (king_share, with the
  share draws the JAX package made); the value and MAC shares after x + y,
  x - y, x * 5, x + 7, 3x, the Beaver product x * y, the dealt wire and
  the shared inverse of x; the opened sums; the field residue share the
  openings accumulated, with the raw rho draws of every opening (the JAX
  package's ``uniform_fp`` bits under ``fold_in(mac_check_key, count)``);
  the residue count.
- ``sqrt``: ``sqrt_public`` of six squares (0 and 1 among them);
  ``bits``: ``bit_rand_sqrt`` at [6] on <r> and triples from the source,
  its value and MAC shares, the opened bits and the residue share since
  the field case's check (the rho draws run on across both).
- ``prove``: the 4-gate wide-mul circuit of
  ``make_torch_slice_fixture.py`` proved under SPDZ with shared, MAC'd
  gate inputs, every triple from the source and r and s its <r> shares
  holding the slice fixture's r and s: the opened proof (the slice's
  proof) and both residue counts, with the checks passed.

The JAX group-MAC queue keeps one accumulator for G1 and G2 points alike,
so its first G2 opening after a G1 one raises (``zkmpc_tpu/mpc/share.py``
``accumulate_group_mac_residue``): the prove below runs on a context that
keeps one queue per group, as the port does.

Run from the repository root (about 20 minutes on a CPU, most of it the
prove's ladders dispatched op by op):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/fixtures/make_torch_spdz_fixture.py
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import types

import numpy as np

N_PARTIES = 3
FR_P = 8444461749428370424248824938781546531375899335154063827935233455917409239041
SRC_SEED = 23
INPUT_SEED = 61
SQRT_SEED = 67
KING_VALUES = [5, 0, 11, FR_P - 2]
SQRT_N = 6
BITS_N = 6
RHO_SEED = 71
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_spdz_3p.npz")
HERE = os.path.dirname(os.path.abspath(__file__))


def rand_ints(rng: np.random.Generator, shape) -> np.ndarray:
    """Uniform ints below the Fr modulus (object array of ``shape``)."""
    n = int(np.prod(shape, dtype=np.int64))
    words = rng.integers(0, 2**63, size=(n, 5))
    vals = [sum(int(w) << (63 * i) for i, w in enumerate(row)) % FR_P for row in words]
    return np.asarray(vals, dtype=object).reshape(shape)


def alpha_ints(she_fx) -> list:
    """The MAC key shares of the SHE fixture's dealer, as ints."""
    node = she_fx["json"]["dealer"]["alpha_shares"]
    limbs = she_fx["arrays"][node[3]].astype(object)
    r_inv = pow(2 ** (15 * limbs.shape[-1]), -1, FR_P)
    return [sum(int(v) << (15 * i) for i, v in enumerate(row)) * r_inv % FR_P
            for row in limbs]


def _obj(x, shape) -> np.ndarray:
    """An object-int array of ``shape`` (numpy turns 0-d results to ints)."""
    return np.asarray(x, dtype=object).reshape(shape)


class FixedSource:
    """A triple source of authenticated values drawn with numpy: each
    request draws the values it serves, then the parties' shares and MAC
    shares (sum_i mac_i = alpha * value), all from one generator, so two
    packages making the same requests get the same wires.  ``rand_shares``
    serves ``fixed_r`` (party share lists of scalars) first.  Group triples
    map a field triple through the generator, as ``SheTripleSource`` does.
    ``pkg``: ``zkmpc_tpu`` or ``zkmpc_tpu_torch``; ``device``: the port's
    torch device."""

    def __init__(self, pkg, alphas, seed, device=None, fixed_r=()):
        self.S = importlib.import_module(f"{pkg}.mpc.share")
        self.L = importlib.import_module(f"{pkg}.ops.limbs")
        pp = importlib.import_module(f"{pkg}.she.preprocessing")
        self.kw = {} if device is None else {"device": device}
        self.alpha = sum(alphas) % FR_P
        self.rng = np.random.default_rng(seed)
        self.fixed_r = [list(r) for r in fixed_r]
        self.group_triples = types.MethodType(pp.SheTripleSource.group_triples, self)
        self.requests = []

    def fp(self, ints):
        return self.L.FpArray.from_int(self.L.FR, np.asarray(ints, dtype=object), **self.kw)

    def _split(self, total):
        """Party shares [P, *shape] of the object-int array ``total``."""
        rest = rand_ints(self.rng, (N_PARTIES - 1,) + total.shape)
        first = _obj((total - rest.sum(axis=0)) % FR_P, total.shape)
        return np.concatenate([first[None], rest], axis=0)

    def share(self, values, shares=None):
        """A MAC'd shared wire of ``values``; ``shares``: its value shares
        ([P, *shape] ints), else drawn."""
        vals = np.asarray(values, dtype=object)
        vals = _obj(vals % FR_P, vals.shape)
        sh = self._split(vals) if shares is None else np.asarray(shares, dtype=object)
        macs = self._split(_obj(vals * self.alpha % FR_P, vals.shape))
        return self.S.MpcFp(self.fp(sh), self.S.SHARED, self.fp(macs))

    def field_triples(self, spec, shape):
        self.requests.append(("triple", tuple(shape)))
        a, b = rand_ints(self.rng, tuple(shape)), rand_ints(self.rng, tuple(shape))
        return self.share(a), self.share(b), self.share(a * b % FR_P)

    def inv_pairs(self, spec, shape):
        self.requests.append(("inv_pair", tuple(shape)))
        r = rand_ints(self.rng, tuple(shape))
        r = np.where(r == 0, 1, r)
        rinv = np.vectorize(lambda v: pow(int(v), -1, FR_P), otypes=[object])(r)
        return self.share(r), self.share(np.asarray(rinv, dtype=object).reshape(r.shape))

    def rand_shares(self, spec, shape):
        self.requests.append(("pair", tuple(shape)))
        if self.fixed_r:
            sh = np.asarray(self.fixed_r.pop(0), dtype=object).reshape((N_PARTIES,) + tuple(shape))
            return self.share(sh.sum(axis=0) % FR_P, shares=sh)
        return self.share(rand_ints(self.rng, tuple(shape)))


def input_values():
    """x, y [4] values and the sqrt case's inputs (numpy seeds)."""
    rng = np.random.default_rng(INPUT_SEED)
    x, y = rand_ints(rng, (4,)), rand_ints(rng, (4,))
    roots = list(rand_ints(np.random.default_rng(SQRT_SEED), (SQRT_N - 2,))) + [0, 1]
    squares = [int(v) * int(v) % FR_P for v in roots]
    return x, y, squares


def slice_r_s() -> tuple:
    """The slice fixture's r and s shares as party int lists."""
    sys.path.insert(0, HERE)
    import make_torch_slice_fixture as MK
    fx = MK.load(np.load(MK.PATH))
    out = []
    for name in ("r", "s"):
        limbs = fx[name][0].astype(object)
        r_inv = pow(2 ** (15 * limbs.shape[-1]), -1, FR_P)
        out.append([sum(int(v) << (15 * i) for i, v in enumerate(row)) * r_inv % FR_P
                    for row in limbs])
    return tuple(out)


def field_ops(S, x, y, dealt):
    """The field case's wires, by name, in one order for both packages."""
    return {"add": x + y, "sub": x - y, "pmul": x * S.MpcFp.const(x.spec, 5),
            "padd": x + S.MpcFp.const(x.spec, 7), "smul": x.smul(3), "bmul": x * y,
            "dealt": dealt, "inv": S.beaver_inv(x)}


class _Writer:
    def __init__(self):
        self.arrays, self.meta = {}, {}

    def fp(self, name, x):
        import jax
        self.arrays[name] = np.asarray(jax.device_get(x.limbs)).astype(np.uint32)
        self.meta[name] = int(x.bound)

    def wire(self, name, w):
        self.fp(f"{name}.value", w.value)
        self.fp(f"{name}.mac", w.mac)


def generate() -> dict:
    """Run the JAX package; returns the npz arrays."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, HERE)
    import make_torch_she_fixture as SF
    import make_torch_slice_fixture as MK
    from zkmpc_tpu.mpc import bits as B
    from zkmpc_tpu.mpc import rand as JR
    from zkmpc_tpu.mpc import share as S
    from zkmpc_tpu.mpc.group import MpcSWPoint
    from zkmpc_tpu.ops.curve import sw_add_complete
    from zkmpc_tpu.ops.limbs import FR, FpArray, _resolve2
    from zkmpc_tpu.parallel.transport import StackedTransport
    from zkmpc_tpu.snark import driver, groth16
    from zkmpc_tpu.snark.r1cs import ConstraintSystem

    alphas = alpha_ints(SF.load(np.load(SF.PATH)))
    alpha_fp = FpArray.from_int(FR, np.asarray(alphas, dtype=object))
    out = _Writer()
    doc = {"alphas": alphas}

    class Ctx(S.MpcContext):
        """Records the raw rho draws of every opening; keeps one group-MAC
        queue per group."""

        def __init__(self, *a, record_rho=True, **k):
            super().__init__(*a, **k)
            self.rho = [] if record_rho else None
            self.groups = {}
            self.n_group = 0

        def accumulate_mac_residue(self, residue):
            if self.rho is not None:
                n = int(np.prod(residue.shape[1:], dtype=np.int64)) if residue.shape[1:] else 1
                k1, k2 = jax.random.split(jax.random.fold_in(self.mac_check_key,
                                                             self._mac_count))
                self.rho.append([np.asarray(jax.random.bits(k, (n, FR.nlimbs),
                                                            dtype=jnp.uint32))
                                 for k in (k1, k2)])
            super().accumulate_mac_residue(residue)

        def accumulate_group_mac_residue(self, residue):
            key = type(residue.x).__name__
            flat = residue.reshape((residue.shape[0], -1))
            while flat.shape[-1] > 1:
                half = flat.shape[-1] // 2
                folded = sw_add_complete(flat[..., :half], flat[..., half:2 * half])
                if flat.shape[-1] % 2:
                    from zkmpc_tpu.ops.curve import SWPoint
                    folded = SWPoint.concat([folded, flat[..., 2 * half:]], axis=-1)
                flat = folded
            flat = flat[..., 0]
            prev = self.groups.get(key)
            self.groups[key] = flat if prev is None else sw_add_complete(prev, flat)
            self.n_group += 1

    # ---- field: share ops, king_share, the residue under rho
    xv, yv, squares = input_values()
    src = FixedSource("zkmpc_tpu", alphas, SRC_SEED)
    c = Ctx(StackedTransport(N_PARTIES), "spdz", src, alpha_share=alpha_fp,
            mac_check_key=jax.random.PRNGKey(RHO_SEED))
    with S.mpc_scope(c):
        x, y = src.share(xv), src.share(yv)
        kkey = jax.random.PRNGKey(3)
        draws = JR.uniform_fp(kkey, FR, (N_PARTIES, len(KING_VALUES)))
        out.fp("dealt.draws", draws)
        dealt = S.king_share(FpArray.from_int(FR, np.asarray(KING_VALUES, dtype=object)), kkey)
        wires = field_ops(S, x, y, dealt)
        for name, w in wires.items():
            out.wire(f"field.{name}", w)
        doc["field_opened"] = {k: [int(v) for v in np.asarray(wires[k].reveal().to_ints())[0]]
                               for k in ("add", "dealt", "bmul")}
        out.fp("field.residue", c._mac_accum)
        doc["field_count"] = c.mac_residue_count
        assert c.assert_field_macs(require_nonempty=True)

        # ---- sqrt_public and bit_rand_sqrt (its <r> and triple from the source)
        root = jax.jit(B.sqrt_public)(FpArray.from_int(FR, np.asarray(squares, dtype=object)))
        out.fp("sqrt", root)
        b = B.bit_rand_sqrt(jax.random.PRNGKey(9), FR, (BITS_N,))
        out.wire("bits", b)
        doc["bits_opened"] = [int(v) for v in np.asarray(b.reveal().to_ints())[0]]
        out.fp("bits.residue", c._mac_accum)
        assert c.assert_field_macs(require_nonempty=True)
    for i, (hi, lo) in enumerate(c.rho):
        out.arrays[f"rho.{i}.hi"], out.arrays[f"rho.{i}.lo"] = hi, lo
    doc["rho_count"] = len(c.rho)
    doc["requests"] = src.requests
    assert all(pow(int(r), 2, FR_P) == s for r, s in
               zip(np.asarray(root.to_ints()), squares))

    # ---- prove: the 4-gate wide-mul circuit under SPDZ
    pk = driver.synthesize(MK.N_GATES, MK.N_PARTIES)
    dpk = pk.device()
    mats = groth16.device_matrices_from_pk(pk)
    r_sh, s_sh = slice_r_s()
    counts = {}

    def step():
        src = FixedSource("zkmpc_tpu", alphas, SRC_SEED + 1, fixed_r=(r_sh, s_sh))
        c = Ctx(StackedTransport(N_PARTIES), "spdz", src, alpha_share=alpha_fp,
                mac_check_key=jax.random.PRNGKey(RHO_SEED + 1), record_rho=False)
        with S.mpc_scope(c):
            cs = ConstraintSystem(FR)
            a = src.share([i + 2 for i in range(MK.N_GATES)])
            b = src.share([i + 5 for i in range(MK.N_GATES)])
            driver.build_wide_mul_circuit(cs, a, b)
            a_pt, b_pt, c_pt = groth16.prove(dpk, cs, jax.random.PRNGKey(7), matrices=mats)
            counts.update(field=c.mac_residue_count, group=c.n_group,
                          requests=list(src.requests))
            residue = c.drain_mac_check().tighten()
            opened = _resolve2(c.transport.psum(residue.limbs))[..., :FR.nlimbs]
            zero = FpArray(opened, FR, 2 * N_PARTIES).tighten().is_zero()
            inf = [MpcSWPoint(g, S.SHARED).reveal().inf for g in c.groups.values()]
        return (a_pt.x.limbs, a_pt.y.limbs, a_pt.z.limbs, a_pt.inf,
                b_pt.x.c0.limbs, b_pt.x.c1.limbs, b_pt.y.c0.limbs, b_pt.y.c1.limbs,
                b_pt.z.c0.limbs, b_pt.z.c1.limbs, b_pt.inf,
                c_pt.x.limbs, c_pt.y.limbs, c_pt.z.limbs, c_pt.inf), zero, inf

    # eagerly: XLA:CPU had not compiled the jitted prove after 45 minutes
    # and 16 GB, where the eager one runs in minutes
    outs, zero, inf = step()
    proof = driver.proof_arrays_to_ints(outs)
    assert bool(np.asarray(zero).all()), "SPDZ field MAC check failed"
    assert all(bool(np.asarray(i).all()) for i in inf), "SPDZ group MAC check failed"
    assert proof == MK.load(np.load(MK.PATH))["proof"]
    doc["prove"] = {"proof": MK._plain(proof), "field_count": counts["field"],
                    "group_count": counts["group"], "requests": counts["requests"]}
    doc["bounds"] = out.meta
    out.arrays["json"] = np.asarray(json.dumps(doc))
    return out.arrays


def load(arrays) -> dict:
    """npz arrays -> {"json": the JSON part, "fp": name -> (limbs, bound),
    "rho": [(hi, lo)] raw draws in opening order}."""
    doc = json.loads(str(arrays["json"]))
    fp = {name: (arrays[name], bound) for name, bound in doc["bounds"].items()}
    rho = [(arrays[f"rho.{i}.hi"], arrays[f"rho.{i}.lo"]) for i in range(doc["rho_count"])]
    return {"json": doc, "fp": fp, "rho": rho}


if __name__ == "__main__":
    np.savez_compressed(PATH, **generate())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
