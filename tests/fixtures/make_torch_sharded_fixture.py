"""Writes ``torch_sharded_3x2.npz``: the JAX package's chips axis
(``zkmpc_tpu/parallel/sharded.py``) on a CPU's virtual devices, in a
jax-free form that ``tests/test_torch_sharded.py`` loads.

The file holds:

- ``fft_<n>``: for n = 64 and 32 (the sizes of ``tests/test_sharded.py``)
  the coefficients, ``Domain(FR, n).fft`` of them, and the JAX package's
  ``sharded_fft`` and its ``sharded_ifft`` round trip at C = 2 and 4 chips;
- ``msm``: 16 G1 points and scalars (``sharded_sw_msm`` at C = 2 and 4),
  15 G1 and 15 G2 points and scalars (``replicated_sharded_sw_msm`` at
  C = 2, so the last chip's block pads), the scalars of `MSM_BITS` bits
  and every ladder that long (how the point range splits does not depend
  on the scalars' width): the JAX results and the host sums, as affine
  ints;
- ``prove``: the 4-gate wide-mul prove at 3 parties x 2 chips, the step of
  ``__graft_entry__.dryrun_multichip`` with ``chips_axis="chips"`` on the
  slice fixture's key (``make_torch_slice_fixture``): the parties' private
  seeds, the r and s shares each party draws from them in the port
  (``zkmpc_tpu_torch.mpc.rand.PartyGenerators``, the prove's first two
  draws), the JAX proof under those shares, which every one of the six
  program instances must give, and the port's stacked proof under the
  same seeds (``snark.driver.make_prove_fn`` on a ``StackedTransport``),
  which must be the same.

Run from the repository root (several minutes on a CPU):

    PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/fixtures/make_torch_sharded_fixture.py
"""

from __future__ import annotations

import json
import os
import random

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_sharded_3x2.npz")
N_PARTIES = 3
N_CHIPS = 2
N_GATES = 4
#: the mesh parties' 256-bit private seeds
SEEDS = [(1 << 255) + 1301, (1 << 254) + 1302, (1 << 253) + 1303]
FFT_SIZES = (64, 32)
FFT_CHIPS = (2, 4)
MSM_CHIPS = (2, 4)
#: bits of the MSM cases' scalars, and of their ladders
MSM_BITS = 64


def fft_inputs(n: int) -> list:
    """The coefficients of ``tests/test_sharded.py`` at size ``n``."""
    rng = np.random.RandomState({64: 0, 32: 1}[n])
    return [int(x) for x in rng.randint(1, 1 << 30, size=n)]


def msm_inputs() -> dict:
    """name -> (group, affine points, scalars): 16 G1 (``sharded``), 15 G1
    and 15 G2 (``replicated_g1``/``_g2``)."""
    from zkmpc_tpu_torch.spec import curves as SC
    out = {}
    for name, group, n, seed in (("sharded", "g1", 16, 2), ("replicated_g1", "g1", 15, 3),
                                 ("replicated_g2", "g2", 15, 4)):
        rng = random.Random(seed)
        mul, gen = (SC.g1_mul, SC.G1_GEN) if group == "g1" else (SC.g2_mul, SC.G2_GEN)
        pts = [mul(gen, rng.randrange(1, 500)) for _ in range(n)]
        out[name] = (group, pts, [rng.randrange(1 << MSM_BITS) for _ in range(n)])
    return out


def host_msm(group: str, pts, scalars):
    from zkmpc_tpu_torch.spec import curves as SC
    add, mul = (SC.g1_add, SC.g1_mul) if group == "g1" else (SC.g2_add, SC.g2_mul)
    acc = None
    for q, k in zip(pts, scalars):
        acc = add(acc, mul(q, k))
    return acc


def r_s_shares():
    """The r and s shares [P] the parties draw from `SEEDS` in the port's
    prove (its first two private draws): uint32 limbs [P, 18] and bound."""
    import torch

    from zkmpc_tpu_torch.mpc import rand as R
    from zkmpc_tpu_torch.mpc.share import MpcContext, mpc_scope, rand_shared
    from zkmpc_tpu_torch.ops.limbs import FR
    from zkmpc_tpu_torch.parallel.transport import StackedTransport
    cpu = torch.device("cpu")
    gen = R.PartyGenerators(range(N_PARTIES), SEEDS, cpu)
    with mpc_scope(MpcContext(StackedTransport(N_PARTIES, cpu), "semi")):
        r, s = rand_shared(gen, FR).value, rand_shared(gen, FR).value
    return [(x.limbs.numpy().astype(np.uint32), x.bound) for x in (r, s)]


def port_stacked_proof():
    """The port's stacked prove of the slice fixture's circuit under the
    parties' private `SEEDS`, on the CPU: the opened proof as affine ints."""
    import torch

    from fixtures import make_torch_slice_fixture as MK
    from zkmpc_tpu_torch.mpc import rand as R
    from zkmpc_tpu_torch.snark import driver
    cpu = torch.device("cpu")
    dpk = driver.dpk_from_host(MK.load(np.load(MK.PATH))["doc"], cpu)
    step, (a, b, _) = driver.make_prove_fn(dpk, N_PARTIES)
    return driver.proof_arrays_to_ints(step(a, b, R.PartyGenerators(range(N_PARTIES), SEEDS,
                                                                    cpu)))


def _plain(x):
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if x is None:
        return None
    return int(x)


def _jax_fft(n: int, chips: int):
    """``sharded_fft`` and the ``sharded_ifft`` round trip of `fft_inputs`."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as PS

    from zkmpc_tpu.ops.limbs import FR, FpArray
    from zkmpc_tpu.parallel import sharded
    mesh = Mesh(np.asarray(jax.devices()[:chips]), ("chips",))
    x = FpArray.from_int(FR, np.asarray(fft_inputs(n), dtype=object))

    def step(limbs):
        ev = sharded.sharded_fft(FR, n, FpArray(limbs, FR, 2), "chips", n_chips=chips)
        back = sharded.sharded_ifft(FR, n, ev, "chips", n_chips=chips)
        return ev.tighten().limbs, back.tighten().limbs
    f = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=PS("chips"),
                              out_specs=(PS("chips"), PS("chips"))))
    ev, back = f(x.limbs)
    return ([int(v) % FR.p for v in FpArray(ev, FR, 2).to_ints()],
            [int(v) % FR.p for v in FpArray(back, FR, 2).to_ints()])


def _jax_points(group: str, pts):
    from zkmpc_tpu.ops import curve as C
    return (C.SWPoint.g1_from_affine_ints(pts) if group == "g1"
            else C.SWPoint.g2_from_affine_ints(pts))


def _jax_msm(group: str, pts, scalars, chips: int, replicated: bool):
    """The JAX package's sharded MSM of ``pts`` by ``scalars`` on ``chips``
    virtual devices: the points and scalars split across the chips
    (``sharded_sw_msm``) or replicated (``replicated_sharded_sw_msm``)."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as PS

    from zkmpc_tpu.ops.limbs import FR, FpArray
    from zkmpc_tpu.parallel import sharded
    mesh = Mesh(np.asarray(jax.devices()[:chips]), ("chips",))
    p = _jax_points(group, pts)
    s = FpArray.from_int(FR, np.asarray(scalars, dtype=object))
    leaves, tree = jax.tree_util.tree_flatten(p)
    out_tree = None

    def step(s_limbs, *pleaves):
        nonlocal out_tree
        pt = jax.tree_util.tree_unflatten(tree, pleaves)
        sc = FpArray(s_limbs, FR, s.bound)
        out = (sharded.replicated_sharded_sw_msm(pt, sc, "chips", chips, nbits=MSM_BITS)
               if replicated else sharded.sharded_sw_msm(pt, sc, "chips", nbits=MSM_BITS))
        out_leaves, out_tree = jax.tree_util.tree_flatten(out)
        return out_leaves
    spec = PS() if replicated else PS("chips")
    # the fold after the all_gather is replicated in value; JAX's static
    # varying-axis checker cannot prove it (as in tests/test_sharded.py)
    f = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(spec,) + (spec,) * len(leaves),
                              out_specs=PS(), check_vma=False))
    res = f(s.limbs, *leaves)
    return jax.tree_util.tree_unflatten(out_tree, res).to_affine_ints()[0]


def _jax_prove(r_s):
    """The JAX package's 3 x 2 shard_map prove of the 4-gate circuit (the
    step of ``dryrun_multichip``), with ``rand_shared`` giving each party
    its row of the injected r and s shares; returns the six instances'
    proofs as affine ints."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as PS

    from zkmpc_tpu.mpc import share as MS
    from zkmpc_tpu.mpc.share import SHARED, MpcContext, MpcFp, mpc_scope
    from zkmpc_tpu.ops.limbs import FR, FpArray
    from zkmpc_tpu.parallel.transport import MeshTransport
    from zkmpc_tpu.snark import driver, groth16
    from zkmpc_tpu.snark.r1cs import ConstraintSystem
    pk = driver.synthesize(N_GATES, N_PARTIES)
    dpk = pk.device()
    mats = groth16.device_matrices_from_pk(pk)
    mesh = Mesh(np.asarray(jax.devices()[:N_PARTIES * N_CHIPS]).reshape(N_PARTIES, N_CHIPS),
                ("parties", "chips"))
    t = MeshTransport(N_PARTIES, "parties")
    injected = iter([])

    def rand_shared(key, spec, shape=()):
        limbs, bound = next(injected)
        row = jnp.asarray(limbs)[jax.lax.axis_index("parties")]
        return MpcFp(FpArray(row, spec, bound), SHARED)

    def step(a_limbs, b_limbs, key):
        nonlocal injected
        injected = iter(r_s)
        a_limbs = a_limbs.reshape(a_limbs.shape[1:])
        b_limbs = b_limbs.reshape(b_limbs.shape[1:])
        with mpc_scope(MpcContext(t, backend="semi", chips_axis="chips", n_chips=N_CHIPS)):
            cs2 = ConstraintSystem(FR)
            driver.build_wide_mul_circuit(cs2, MpcFp(FpArray(a_limbs, FR, 2), SHARED),
                                          MpcFp(FpArray(b_limbs, FR, 2), SHARED))
            a_pt, b_pt, c_pt = groth16.prove(dpk, cs2, key, matrices=mats)
        return tuple(x[None] for x in (
            a_pt.x.limbs, a_pt.y.limbs, a_pt.z.limbs, a_pt.inf,
            b_pt.x.c0.limbs, b_pt.x.c1.limbs, b_pt.y.c0.limbs, b_pt.y.c1.limbs,
            b_pt.z.c0.limbs, b_pt.z.c1.limbs, b_pt.inf,
            c_pt.x.limbs, c_pt.y.limbs, c_pt.z.limbs, c_pt.inf))

    def deal(vals):
        arr = np.zeros((N_PARTIES, len(vals)), dtype=object)
        arr[0, :] = vals
        return FpArray.from_int(FR, arr).limbs

    a = deal([(i + 2) for i in range(N_GATES)])
    b = deal([(i + 5) for i in range(N_GATES)])
    orig = MS.rand_shared
    MS.rand_shared = rand_shared
    try:
        f = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(PS("parties"), PS("parties"), PS()),
                                  out_specs=PS(("parties", "chips"))))
        outs = [np.asarray(o) for o in f(a, b, jax.random.PRNGKey(0))]
    finally:
        MS.rand_shared = orig
    return pk, [_plain(driver.proof_arrays_to_ints([o[i] for o in outs]))
                for i in range(N_PARTIES * N_CHIPS)]


def generate() -> dict:
    """Run the JAX package's sharded functions and 3 x 2 prove (on 8
    virtual CPU devices); returns the npz arrays."""
    from fixtures import make_torch_slice_fixture as MK
    from zkmpc_tpu.ops import ntt as JN
    from zkmpc_tpu.ops.limbs import FR, FpArray
    doc = {"fft": {}, "msm": {}}
    for n in FFT_SIZES:
        coeffs = fft_inputs(n)
        want = [int(v) for v in JN.Domain(FR, n).fft(
            FpArray.from_int(FR, np.asarray(coeffs, dtype=object))).to_ints()]
        doc["fft"][str(n)] = {"coeffs": coeffs, "domain_fft": want,
                              "sharded": {str(c): _jax_fft(n, c) for c in FFT_CHIPS}}
    for name, (group, pts, sc) in msm_inputs().items():
        replicated = name != "sharded"
        chips = (N_CHIPS,) if replicated else MSM_CHIPS
        doc["msm"][name] = {"group": group, "host": _plain(host_msm(group, pts, sc)),
                            "jax": {str(c): _plain(_jax_msm(group, pts, sc, c, replicated))
                                    for c in chips}}
    r_s = r_s_shares()
    pk, proofs = _jax_prove(r_s)
    slice_pk = json.loads(str(np.load(MK.PATH)["pk_json"]))
    if json.loads(json.dumps(MK.pk_fields(pk))) != slice_pk:
        raise AssertionError("the JAX key differs from the slice fixture's")
    if any(p != proofs[0] for p in proofs):
        raise AssertionError("the JAX program instances disagree on the proof")
    stacked = _plain(port_stacked_proof())
    if stacked != proofs[0]:
        raise AssertionError("the port's stacked proof differs from the JAX 3 x 2 proof")
    doc["prove"] = {"seeds": [hex(s) for s in SEEDS], "proof": proofs[0],
                    "stacked_proof": stacked, "bounds": [b for _, b in r_s]}
    return {"json": np.asarray(json.dumps(doc)),
            "r_limbs": r_s[0][0], "s_limbs": r_s[1][0]}


def load(arrays) -> dict:
    """npz arrays -> the document, with the prove's ``seeds`` as ints,
    ``proof`` as affine-int tuples and ``r``/``s`` as (limbs, bound)."""
    doc = json.loads(str(arrays["json"]))
    pr = doc["prove"]
    pr["seeds"] = [int(s, 16) for s in pr["seeds"]]

    def pt(t):
        if t is None:
            return None
        return (tuple(t[0]), tuple(t[1])) if isinstance(t[0], list) else tuple(t)
    pr["proof"] = tuple(pt(t) for t in pr["proof"])
    pr["stacked_proof"] = tuple(pt(t) for t in pr["stacked_proof"])
    pr["r"] = (arrays["r_limbs"], pr["bounds"][0])
    pr["s"] = (arrays["s_limbs"], pr["bounds"][1])
    return doc


if __name__ == "__main__":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(PATH, **generate())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
