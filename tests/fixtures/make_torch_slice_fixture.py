"""Writes ``torch_slice_wide_mul_4g_3p.npz``: the JAX package's wide-mul
collaborative Groth16 prove at 4 gates and 3 parties, in a jax-free form
that the PyTorch port's slice test loads.

The file holds:

- the proving key: ``pk_json`` (the ``ProvingKey`` fields as plain ints and
  lists) and, per point batch of ``driver.dpk_to_host``, its coordinate limb
  arrays (uint32) and infinity flags;
- ``r``/``s``: the additive shares (uint32 limbs [3, 18] and their bound)
  that ``rand_shared`` draws under the split of ``PRNGKey(7)``, the key
  ``make_prove_fn`` passes to the prove;
- ``proof_json``: the opened proof's affine ints.

Run from the repository root (takes several minutes on a CPU):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/fixtures/make_torch_slice_fixture.py
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

N_GATES = 4
N_PARTIES = 3
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_slice_wide_mul_4g_3p.npz")


def _plain(x):
    """ProvingKey field values -> JSON-able plain ints and lists."""
    if isinstance(x, np.ndarray):
        return [_plain(v) for v in x.tolist()]
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.integer, int)):
        return int(x)
    if x is None:
        return None
    raise TypeError(type(x))


def pk_fields(pk) -> dict:
    out = {}
    for f in dataclasses.fields(pk):
        v = getattr(pk, f.name)
        out[f.name] = ({k: _plain(getattr(v, k)) for k in
                        ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "ic")}
                       if f.name == "vk" else _plain(v))
    return out


def generate() -> dict:
    """Run the JAX package's slice; returns the npz arrays."""
    import jax

    from zkmpc_tpu.mpc import share as MS
    from zkmpc_tpu.ops.limbs import FR
    from zkmpc_tpu.parallel.transport import StackedTransport
    from zkmpc_tpu.snark import driver

    pk = driver.synthesize(N_GATES, N_PARTIES)
    step, args = driver.make_prove_fn(pk, N_PARTIES)
    host = driver.dpk_to_host(pk.device())
    proof = driver.proof_arrays_to_ints(step(*args))

    k_r, k_s = jax.random.split(args[2])
    with MS.mpc_scope(MS.MpcContext(StackedTransport(N_PARTIES), "semi")):
        r = MS.rand_shared(k_r, FR).value
        s = MS.rand_shared(k_s, FR).value

    arrays = {
        "pk_json": np.asarray(json.dumps(pk_fields(pk))),
        "proof_json": np.asarray(json.dumps(_plain(proof))),
        "r_limbs": np.asarray(r.limbs, dtype=np.uint32),
        "r_bound": np.asarray(r.bound),
        "s_limbs": np.asarray(s.limbs, dtype=np.uint32),
        "s_bound": np.asarray(s.bound),
    }
    for name, pt in host["pts"].items():
        if pt is None:
            continue
        for axis, coord in zip("xyz", pt[:3]):
            if coord[0] == "fp2":
                arrays[f"pts.{name}.{axis}0"] = np.asarray(coord[1], np.uint32)
                arrays[f"pts.{name}.{axis}1"] = np.asarray(coord[2], np.uint32)
            else:
                arrays[f"pts.{name}.{axis}"] = np.asarray(coord[1], np.uint32)
        arrays[f"pts.{name}.inf"] = np.asarray(pt[3], dtype=bool)
    return arrays


def load(arrays) -> dict:
    """npz arrays -> {"doc": dpk_to_host-style doc with ``pk`` as plain
    fields, "r"/"s": (limbs, bound), "proof": affine ints}."""
    pts = {}
    names = {k.split(".")[1] for k in arrays if k.startswith("pts.")}
    for name in names:
        def coord(axis):
            key = f"pts.{name}.{axis}"
            if key + "0" in arrays:
                return ("fp2", arrays[key + "0"], arrays[key + "1"])
            return ("fp", arrays[key])
        pts[name] = (coord("x"), coord("y"), coord("z"),
                     arrays[f"pts.{name}.inf"])

    def proof_pt(t):
        if t is None:
            return None
        if isinstance(t[0], list):
            return (tuple(t[0]), tuple(t[1]))
        return tuple(t)
    proof = tuple(proof_pt(t) for t in json.loads(str(arrays["proof_json"])))
    return {
        "doc": {"pk": json.loads(str(arrays["pk_json"])), "pts": pts},
        "r": (arrays["r_limbs"], int(arrays["r_bound"])),
        "s": (arrays["s_limbs"], int(arrays["s_bound"])),
        "proof": proof,
    }


if __name__ == "__main__":
    np.savez_compressed(PATH, **generate())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
