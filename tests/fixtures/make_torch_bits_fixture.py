"""Writes ``torch_bits_3p.npz``: inputs and the JAX package's opened outputs
of the MPC comparison and decomposition protocols at 3 parties, for the
PyTorch port's bit-protocol test.

The JAX side of these protocols takes minutes to compile on a CPU, too
long for the tier-1 tests, so they read its results from here.  The
protocols' opened outputs do not depend on their random draws, so the port
must give the same values from its own.  The file also holds the
reference's side of the tests that compare shares and draws (`bit_rand`
and the boolean ops, `king_share`, `rand_number_bitwise`, the bit-vector
adders, the shared inverse and division: `generate_live`), with the raw
draws the port takes in their place.

Cases (``attempts`` = 8): ``eqz`` equality-zero of [0, 1, p-1, 0]; ``half``
the half-range test of [0, 1, h, h+1, p-1] (h = (p-1)/2); ``lt`` the signed
less-than of [3, 5, p-2, h] against [5, 3, 2, h]; ``bd`` the bit
decomposition of [0, 1, p-1, random].  The file holds, as JSON of plain
ints, the additive shares [3, n] of every input (numpy seed 42) and the
reference's opened outputs.

Run from the repository root (a few minutes on a CPU):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/fixtures/make_torch_bits_fixture.py
"""

from __future__ import annotations

import json
import os

import numpy as np

N_PARTIES = 3
ATTEMPTS = 8
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_bits_3p.npz")
PROTOCOLS = ("eqz", "half", "lt", "bd")


def inputs(p: int) -> dict:
    """name -> additive shares [3, n] (object ints) from numpy seed 42."""
    h = (p - 1) // 2
    rng = np.random.default_rng(42)

    def rand_ints(n):
        words = rng.integers(0, 2**63, size=(n, 5))
        return [int(sum(int(w) << (63 * i) for i, w in enumerate(row)) % p)
                for row in words]

    def shares(vals):
        rest = [rand_ints(len(vals)) for _ in range(N_PARTIES - 1)]
        first = [(v - sum(r[i] for r in rest)) % p for i, v in enumerate(vals)]
        return np.asarray([first] + rest, dtype=object)

    vals = {"eqz": [0, 1, p - 1, 0], "half": [0, 1, h, h + 1, p - 1],
            "lt_x": [3, 5, p - 2, h], "lt_y": [5, 3, 2, h],
            "bd": [0, 1, p - 1] + rand_ints(1)}
    return {k: shares(v) for k, v in vals.items()}


def generate() -> dict:
    """Run the JAX package's protocols; returns the npz arrays."""
    import jax

    from zkmpc_tpu.mpc import bits as B
    from zkmpc_tpu.mpc import share as S
    from zkmpc_tpu.ops.limbs import FR, FpArray
    from zkmpc_tpu.parallel.transport import StackedTransport

    ins = inputs(FR.p)

    def run(key, w):
        k = jax.random.split(key, 4)
        with S.mpc_scope(S.MpcContext(StackedTransport(N_PARTIES), "semi")):
            w = {n: S.MpcFp(v, S.SHARED) for n, v in w.items()}
            outs = {
                "eqz": B.equality_zero(w["eqz"], k[0], attempts=ATTEMPTS),
                "half": B.is_smaller_or_equal_than_mod_minus_one_div_two(
                    w["half"], k[1], attempts=ATTEMPTS),
                "lt": B.less_than(w["lt_x"], w["lt_y"], k[2], attempts=ATTEMPTS),
                "bd": B.bit_decomposition(w["bd"], k[3], attempts=ATTEMPTS),
            }
            return {n: o.reveal() for n, o in outs.items()}

    got = jax.jit(run)(jax.random.PRNGKey(7),
                       {n: FpArray.from_int(FR, v) for n, v in ins.items()})
    opened = {n: np.asarray(v.to_ints())[0].tolist() for n, v in got.items()}
    return {
        "inputs_json": np.asarray(json.dumps(
            {n: [[int(x) for x in row] for row in v] for n, v in ins.items()})),
        "opened_json": np.asarray(json.dumps(
            {n: _plain(v) for n, v in opened.items()})),
    }


def _plain(v):
    return [_plain(x) for x in v] if isinstance(v, list) else int(v)


def _ints(rng, p, n):
    """n uniform ints below p from a numpy generator (256-bit draws), as
    ``tests/torch_parity.rand_ints`` makes them."""
    words = rng.integers(0, 2**63, size=(n, (p.bit_length() + 62) // 63 + 1))
    out = []
    for row in words:
        x = 0
        for w in row:
            x = (x << 63) | int(w)
        out.append(x % p)
    return out


def _shares(rng, p, vals):
    """Additive shares [3, *shape] of host ints, as the tests make them."""
    vals = np.asarray(vals, dtype=object)
    flat = [int(v) % p for v in vals.reshape(-1)]
    rest = [_ints(rng, p, len(flat)) for _ in range(N_PARTIES - 1)]
    first = [(v - sum(r[i] for r in rest)) % p for i, v in enumerate(flat)]
    return np.asarray([first] + rest, dtype=object).reshape((N_PARTIES,) + vals.shape)


def _bits_of(v, n):
    return [(v >> i) & 1 for i in range(n)]


def live_inputs(p: int) -> dict:
    """The inputs of the bit-protocol tests that run the reference on the
    side: name -> object-int array (numpy seeds 40, 41, 43)."""
    rng = np.random.default_rng(40)
    out = {"bool_x": _shares(rng, p, [0, 0, 1, 1]), "bool_y": _shares(rng, p, [0, 1, 0, 1])}
    out["king_vals"] = np.asarray(_ints(np.random.default_rng(41), p, 3), dtype=object)
    rng = np.random.default_rng(43)
    nb = p.bit_length()
    a_int, b_int = _ints(rng, p, 3), _ints(rng, p, 3)
    inv_x, div_y = _ints(rng, p, 3), _ints(rng, p, 3)
    out.update(a_int=np.asarray(a_int, dtype=object), b_int=np.asarray(b_int, dtype=object),
               inv_x_int=np.asarray(inv_x, dtype=object),
               div_y_int=np.asarray(div_y, dtype=object))
    for k, v in (("a_bits", [_bits_of(v, nb) for v in a_int]),
                 ("b_bits", [_bits_of(v, nb) for v in b_int]),
                 ("inv_x", inv_x), ("div_y", div_y)):
        out[k] = _shares(rng, p, v)
    return out


def generate_live() -> dict:
    """The reference's side of the tests that compare shares or draws: the
    shares and openings of ``bit_rand`` (PRNGKey(0), 16 bits) and the
    boolean ops, ``king_share``'s shares and draws (PRNGKey(1)),
    ``rand_number_bitwise`` (PRNGKey(3), shape (2,), 8 attempts), the
    bit-vector adders and the shared inverse and division; with the raw
    bernoulli draws the port takes in their place."""
    import jax

    from zkmpc_tpu.mpc import bits as B
    from zkmpc_tpu.mpc import rand as R
    from zkmpc_tpu.mpc import share as S
    from zkmpc_tpu.ops.limbs import FR, FpArray
    from zkmpc_tpu.parallel.transport import StackedTransport

    p = FR.p
    ins = live_inputs(p)

    def scope():
        return S.mpc_scope(S.MpcContext(StackedTransport(N_PARTIES), "semi"))

    def bernoulli(key, shape):
        return np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i), 0.5,
                                                         shape)) for i in range(N_PARTIES)])

    def opened(fp):
        v = np.asarray(fp.to_ints())[0]
        return _plain(v.tolist() if isinstance(v, np.ndarray) else int(v))

    def bools(key, x, y):
        with scope():
            b = B.bit_rand(key, FR, (16,))
            x, y = S.MpcFp(x, S.SHARED), S.MpcFp(y, S.SHARED)
            ops = [B.b_and(x, y), B.b_or(x, y), B.b_xor(x, y), B.b_not(x),
                   B.kary_and(x), B.kary_or(x)]
            return b.value, b.reveal(), [o.reveal() for o in ops]

    k0 = jax.random.PRNGKey(0)
    share, bopen, ops = jax.jit(bools)(k0, FpArray.from_int(FR, ins["bool_x"]),
                                       FpArray.from_int(FR, ins["bool_y"]))
    out = {"bit_rand": {"raw": bernoulli(k0, (16,)).astype(int).tolist(),
                        "shares": _plain(np.asarray(share.to_ints()).tolist()),
                        "opened": opened(bopen), "ops": [opened(o) for o in ops]}}

    k1 = jax.random.PRNGKey(1)

    def king(key):
        with scope():
            return S.king_share(FpArray.from_int(FR, ins["king_vals"]), key).value

    want = jax.jit(king)(k1)
    draws = jax.jit(R.uniform_fp, static_argnums=(1, 2))(k1, FR, (N_PARTIES, 3))
    out["king_share"] = {"limbs": np.asarray(want.limbs).astype(int).tolist(),
                         "bound": int(want.bound),
                         "draws": np.asarray(draws.limbs).astype(int).tolist(),
                         "draws_bound": int(draws.bound)}

    k3 = jax.random.PRNGKey(3)

    def rnb(key):
        with scope():
            bits, val = B.rand_number_bitwise(key, FR, (2,), attempts=ATTEMPTS)
            return bits.reveal(), val.reveal()

    j_bits, j_val = jax.jit(rnb)(k3)
    out["rand_number_bitwise"] = {"raw": bernoulli(k3, (2, ATTEMPTS, p.bit_length()))
                                  .astype(int).tolist(),
                                  "bits": opened(j_bits), "val": opened(j_val)}

    def adders(w):
        with scope():
            w = {n: S.MpcFp(v, S.SHARED) for n, v in w.items()}
            outs = {
                "bitwise_lt": B.bitwise_lt(w["a_bits"], w["b_bits"]),
                "carries": B.carries(w["a_bits"], w["b_bits"]),
                "bit_add": B.bit_add(w["a_bits"], w["b_bits"]),
                "inv": S.beaver_inv(w["inv_x"]),
                "div": S.beaver_div(w["inv_x"], w["div_y"]),
            }
            return {n: o.reveal() for n, o in outs.items()}

    got = jax.jit(adders)({n: FpArray.from_int(FR, ins[n])
                           for n in ("a_bits", "b_bits", "inv_x", "div_y")})
    out["adders"] = {n: opened(v) for n, v in got.items()}
    return {"live_json": np.asarray(json.dumps(out))}


def load(arrays) -> dict:
    """npz arrays -> {"inputs": name -> shares [3, n], "opened": name -> ints,
    "live": the reference's side of the share- and draw-level tests}."""
    ins = json.loads(str(arrays["inputs_json"]))
    return {"inputs": {n: np.asarray(v, dtype=object) for n, v in ins.items()},
            "opened": json.loads(str(arrays["opened_json"])),
            "live": json.loads(str(arrays["live_json"])) if "live_json" in arrays else None}


if __name__ == "__main__":
    np.savez_compressed(PATH, **generate(), **generate_live())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
