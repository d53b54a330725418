"""Writes ``torch_marlin_3p.npz``: the JAX package's collaborative Marlin
prove of ``tests/test_marlin.py``'s 2-gate circuit at 3 parties
(semi-honest), in a jax-free form that the PyTorch port's Marlin tests load.

The circuit is ``test_marlin._build``: a = [3, 4] and b = [5, 6] dealt by
``king_share`` under ``PRNGKey(0)`` and ``PRNGKey(1)``, c = a * b public;
the index is ``marlin.setup_and_index(cs, seed=3)`` and the prove key
``PRNGKey(2)``.  The file holds, limbs as uint32 arrays with their bounds:

- ``king0``/``king1``: the share draws ``king_share`` made ([3, 2]);
- ``rand0`` .. ``rand4``: the five ``rand_shared`` draws of the prove, in
  order (the four v_H masks [3, 1] and the sum-zero mask [3, n + 1]),
  captured by wrapping ``zkmpc_tpu.mpc.share.rand_shared`` here;
- ``index_json``: the index's sizes and its matrix commitments;
- ``proof_json``: the opened proof dict (affine points as int pairs,
  None for infinity).

Run from the repository root (a few minutes on a CPU):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/fixtures/make_torch_marlin_fixture.py
"""

from __future__ import annotations

import json
import os

import numpy as np

N_PARTIES = 3
SRS_SEED = 3
PROVE_KEY = 2
KING_KEYS = (0, 1)
A_VALS = [3, 4]
B_VALS = [5, 6]
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_marlin_3p.npz")


def plain(x):
    """Proof values -> JSON-able ints, lists and dicts."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (np.integer, int)):
        return int(x)
    if x is None or isinstance(x, str):
        return x
    raise TypeError(type(x))


def generate() -> dict:
    """Run the JAX package's Marlin prove; returns the npz arrays."""
    import jax

    from zkmpc_tpu.mpc import rand as R
    from zkmpc_tpu.mpc import share as MS
    from zkmpc_tpu.mpc.share import MpcContext, MpcFp, mpc_scope
    from zkmpc_tpu.ops.limbs import FR, FpArray
    from zkmpc_tpu.parallel.transport import StackedTransport
    from zkmpc_tpu.snark import marlin
    from zkmpc_tpu.snark.r1cs import LC, ConstraintSystem

    arrays = {}

    def put(name, fp):
        arrays[f"{name}_limbs"] = np.asarray(fp.limbs, dtype=np.uint32)
        arrays[f"{name}_bound"] = np.asarray(fp.bound)

    def fr(vals):
        return FpArray.from_int(FR, np.asarray(vals, dtype=object))

    draws = []
    orig = MS.rand_shared

    def recording(key, spec, shape=()):
        out = orig(key, spec, shape)
        draws.append(out.value)
        return out

    with mpc_scope(MpcContext(StackedTransport(N_PARTIES), backend="semi")):
        cs = ConstraintSystem(FR)
        a = MS.king_share(fr(A_VALS), jax.random.PRNGKey(KING_KEYS[0]))
        b = MS.king_share(fr(B_VALS), jax.random.PRNGKey(KING_KEYS[1]))
        for i, k in enumerate(KING_KEYS):
            put(f"king{i}", R.uniform_fp(jax.random.PRNGKey(k), FR, (N_PARTIES, 2)))
        c_pub = MpcFp.const(FR, np.asarray([x * y for x, y in zip(A_VALS, B_VALS)],
                                           dtype=object))
        a_vars = cs.new_witness_vec(a)
        b_vars = cs.new_witness_vec(b)
        c_vars = cs.new_instance_vec(c_pub)
        for i in range(2):
            cs.enforce(LC.of(a_vars[i]), LC.of(b_vars[i]), LC.of(c_vars[i]))
        assert cs.is_satisfied_ints()
        index = marlin.setup_and_index(cs, seed=SRS_SEED)
        MS.rand_shared = recording
        try:
            proof = marlin.prove(index, cs, jax.random.PRNGKey(PROVE_KEY))
        finally:
            MS.rand_shared = orig
        assert marlin.verify(index, cs.instance_ints(), proof)
    assert len(draws) == 5, len(draws)
    for i, d in enumerate(draws):
        put(f"rand{i}", d)
    idx = dict(domain_n=index.domain_n, nx=index.nx, num_instance=index.num_instance,
               num_witness=index.num_witness, degree=len(index.srs.powers) - 1,
               perm=[int(v) for v in index.perm],
               comms=[dict(k=m.k_size, row=m.com_row, col=m.com_col, val=m.com_val)
                      for m in index.index_comms])
    arrays["index_json"] = np.asarray(json.dumps(plain(idx)))
    arrays["proof_json"] = np.asarray(json.dumps(plain(proof)))
    return arrays


def _point(t):
    return None if t is None else tuple(t)


def load(arrays) -> dict:
    """npz arrays -> {"king": [(limbs, bound)] * 2, "rand": [(limbs, bound)]
    * 5, "index": dict, "proof": the proof dict with points as tuples}."""
    def pair(name):
        return arrays[f"{name}_limbs"].astype(np.int64), int(arrays[f"{name}_bound"])
    proof = json.loads(str(arrays["proof_json"]))
    proof["coms"] = {k: _point(v) for k, v in proof["coms"].items()}
    for k in ("w_beta", "w_beta3"):
        proof[k] = _point(proof[k])
    for mp in proof["mat_proofs"]:
        for k in ("com_g3", "com_h3", "com_g3_shift"):
            mp[k] = _point(mp[k])
    index = json.loads(str(arrays["index_json"]))
    for m in index["comms"]:
        for k in ("row", "col", "val"):
            m[k] = _point(m[k])
    return {"king": [pair(f"king{i}") for i in range(2)],
            "rand": [pair(f"rand{i}") for i in range(5)],
            "index": index, "proof": proof}


if __name__ == "__main__":
    np.savez_compressed(PATH, **generate())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
