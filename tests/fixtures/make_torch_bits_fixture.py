"""Writes ``torch_bits_3p.npz``: inputs and the JAX package's opened outputs
of the MPC comparison and decomposition protocols at 3 parties, for the
PyTorch port's bit-protocol test.

The JAX side of these protocols takes about two minutes to compile on a
CPU, too long for the tier-1 tests, so they read its results from here.
The protocols' opened outputs do not depend on their random draws, so the
port must give the same values from its own.

Cases (``attempts`` = 8): ``eqz`` equality-zero of [0, 1, p-1, 0]; ``half``
the half-range test of [0, 1, h, h+1, p-1] (h = (p-1)/2); ``lt`` the signed
less-than of [3, 5, p-2, h] against [5, 3, 2, h]; ``bd`` the bit
decomposition of [0, 1, p-1, random].  The file holds, as JSON of plain
ints, the additive shares [3, n] of every input (numpy seed 42) and the
reference's opened outputs.

Run from the repository root (about two minutes on a CPU):

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


def load(arrays) -> dict:
    """npz arrays -> {"inputs": name -> shares [3, n], "opened": name -> ints}."""
    ins = json.loads(str(arrays["inputs_json"]))
    return {"inputs": {n: np.asarray(v, dtype=object) for n, v in ins.items()},
            "opened": json.loads(str(arrays["opened_json"]))}


if __name__ == "__main__":
    np.savez_compressed(PATH, **generate())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
