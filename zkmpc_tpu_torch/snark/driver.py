"""Collaborative-prove driver for the wide multiplication circuit.

Port of the wide-mul half of ``zkmpc_tpu/snark/driver.py``: a synthetic
circuit of n independent gates a_i*b_i = c_i, allocated as vector wires so
all Beaver multiplications batch into one round, plus one instance pinning
sum(c).  `synthesize` sets it up once (host setup + device scalar muls);
`make_prove_fn` returns the prove step on raw share limb tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mpc.share import SHARED, MpcContext, MpcFp, _promote_to_shared, \
    _sum_last_axis, mpc_scope
from ..ops.curve import SWPoint
from ..ops.fp2 import Fp2Array
from ..ops.limbs import FQ, FR, FpArray
from ..parallel import transport as T
from . import groth16
from .r1cs import LC, ConstraintSystem


def build_wide_mul_circuit(cs: ConstraintSystem, a: MpcFp, b: MpcFp):
    """n independent mul gates a_i * b_i = c_i (c witness), plus one
    instance pinning sum(c) so the proof binds a public output."""
    (n,) = a.shape
    c = a * b                      # ONE batched Beaver round for all n gates
    a_vars = cs.new_witness_vec(a)
    b_vars = cs.new_witness_vec(b)
    c_vars = cs.new_witness_vec(c)
    for i in range(n):
        cs.enforce(LC.of(a_vars[i]), LC.of(b_vars[i]), LC.of(c_vars[i]))
    out = MpcFp(_sum_last_axis(c.value), c.visibility)
    out_pub = out.open()
    out_var = cs.new_instance(out_pub)
    cs.enforce(LC({v: 1 for v in c_vars}), LC.constant(1), LC.of(out_var))
    return out_pub


def synthesize_cs(n_gates: int, n_parties: int, device="cuda") -> ConstraintSystem:
    """Build the wide-mul circuit structure (dummy public assignment)."""
    t = T.StackedTransport(n_parties, device)
    with mpc_scope(MpcContext(t, backend="semi")):
        cs = ConstraintSystem(FR)
        vals_a = np.asarray([(i + 2) for i in range(n_gates)], dtype=object)
        vals_b = np.asarray([(i + 5) for i in range(n_gates)], dtype=object)
        a = _promote_to_shared(MpcFp.from_public(FpArray.from_int(FR, vals_a, device=device)))
        b = _promote_to_shared(MpcFp.from_public(FpArray.from_int(FR, vals_b, device=device)))
        build_wide_mul_circuit(cs, a, b)
    return cs


def synthesize(n_gates: int, n_parties: int, seed: int = 1, device="cuda"):
    """One-time synthesis + setup (host setup_params, device scalar muls).
    Returns the device proving key."""
    cs = synthesize_cs(n_gates, n_parties, device)
    return groth16.device_setup(cs, seed=seed, device=device)


def expected_instance(n_gates: int):
    """Host ints: [1, sum_i (i+2)(i+5) mod p] for the wide-mul circuit."""
    s = sum((i + 2) * (i + 5) for i in range(n_gates)) % FR.p
    return [1, s]


def deal(vals, n_parties: int, device="cuda"):
    """Additive shares on the host: party 0 holds the values, the rest 0."""
    arr = np.zeros((n_parties, len(vals)), dtype=object)
    arr[0, :] = vals
    return FpArray.from_int(FR, arr, device=device).limbs


def make_prove_fn(dpk: groth16.DeviceProvingKey, n_parties: int):
    """Returns (fn, example_args): fn(a_limbs, b_limbs, generator, r=None,
    s=None) -> proof arrays.  a_limbs/b_limbs: [P, n, nlimbs] additive
    shares of the gate inputs; r/s: optional injected share tensors."""
    pk = dpk.pk
    dev = dpk.device
    n_gates = pk.num_witness // 3
    mats = groth16.device_matrices_from_pk(pk, dev)

    def step(a_limbs, b_limbs, generator, r=None, s=None):
        t = T.StackedTransport(n_parties, dev)
        with mpc_scope(MpcContext(t, backend="semi")):
            cs2 = ConstraintSystem(FR)
            a = MpcFp(FpArray(a_limbs, FR, 2), SHARED)
            b = MpcFp(FpArray(b_limbs, FR, 2), SHARED)
            build_wide_mul_circuit(cs2, a, b)
            a_pt, b_pt, c_pt = groth16.prove(dpk, cs2, generator, matrices=mats,
                                             r=r, s=s)
            return (a_pt.x.limbs, a_pt.y.limbs, a_pt.z.limbs, a_pt.inf,
                    b_pt.x.c0.limbs, b_pt.x.c1.limbs,
                    b_pt.y.c0.limbs, b_pt.y.c1.limbs,
                    b_pt.z.c0.limbs, b_pt.z.c1.limbs, b_pt.inf,
                    c_pt.x.limbs, c_pt.y.limbs, c_pt.z.limbs, c_pt.inf)

    vals_a = [(i + 2) for i in range(n_gates)]
    vals_b = [(i + 5) for i in range(n_gates)]
    return step, (deal(vals_a, n_parties, dev), deal(vals_b, n_parties, dev),
                  torch.Generator().manual_seed(7))


def proof_arrays_to_ints(outs):
    """Decode step() outputs back into ((ax,ay),(bx,by),(cx,cy)) host ints."""
    (ax, ay, az, ainf, bx0, bx1, by0, by1, bz0, bz1, binf,
     cx, cy, cz, cinf) = outs

    def fq(x):
        return FpArray(x, FQ, 2)

    def fp2(c0, c1):
        return Fp2Array(fq(c0), fq(c1))
    a = SWPoint(fq(ax), fq(ay), fq(az), ainf)
    b = SWPoint(fp2(bx0, bx1), fp2(by0, by1), fp2(bz0, bz1), binf)
    c = SWPoint(fq(cx), fq(cy), fq(cz), cinf)
    return groth16.proof_to_ints((a, b, c))


def _ints(x):
    return [int(v) for v in x]


def pk_from_host(fields: dict) -> groth16.ProvingKey:
    """The port's ProvingKey from plain ints and lists (the fields of the
    reference's ``ProvingKey`` with points as affine int tuples, None for
    infinity, and ``matrices_coo`` as three (rows, cols, coeffs) lists)."""
    def pt(t):
        if t is None:
            return None
        if isinstance(t[0], (list, tuple)):
            return (tuple(_ints(t[0])), tuple(_ints(t[1])))
        return (int(t[0]), int(t[1]))

    def pts(ts):
        return None if ts is None else [pt(t) for t in ts]
    vkd = fields["vk"]
    vk = groth16.VerifyingKey(pt(vkd["alpha_g1"]), pt(vkd["beta_g2"]),
                              pt(vkd["gamma_g2"]), pt(vkd["delta_g2"]),
                              pts(vkd["ic"]))
    mats = None
    if fields.get("matrices_coo") is not None:
        mats = tuple((np.asarray(r, dtype=np.int32), np.asarray(c, dtype=np.int32),
                      np.asarray(_ints(v), dtype=object))
                     for r, c, v in fields["matrices_coo"])
    return groth16.ProvingKey(
        vk=vk, alpha_g1=pt(fields["alpha_g1"]), beta_g1=pt(fields["beta_g1"]),
        beta_g2=pt(fields["beta_g2"]), delta_g1=pt(fields["delta_g1"]),
        delta_g2=pt(fields["delta_g2"]),
        a_query=pts(fields.get("a_query")), b_g1_query=pts(fields.get("b_g1_query")),
        b_g2_query=pts(fields.get("b_g2_query")), h_query=pts(fields.get("h_query")),
        l_query=pts(fields.get("l_query")),
        num_instance=int(fields["num_instance"]),
        num_constraints=int(fields["num_constraints"]),
        domain_n=int(fields["domain_n"]), num_witness=int(fields["num_witness"]),
        matrices_coo=mats)


def dpk_from_host(doc, device="cuda") -> groth16.DeviceProvingKey:
    """The port's DeviceProvingKey on ``device`` from the host layout of the
    reference's ``dpk_to_host``: ``doc["pts"][name]`` = (coord, coord, coord,
    inf) with coord ("fp", uint32 limbs) or ("fp2", c0 limbs, c1 limbs), and
    ``doc["pk"]`` the ProvingKey fields as plain ints and lists."""
    def limbs(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    def coord(c):
        if c[0] == "fp2":
            return Fp2Array(FpArray(limbs(c[1]), FQ, 2), FpArray(limbs(c[2]), FQ, 2))
        return FpArray(limbs(c[1]), FQ, 2)

    def pt(t):
        if t is None:
            return None
        inf = torch.as_tensor(np.asarray(t[3], dtype=bool), device=device)
        return SWPoint(coord(t[0]), coord(t[1]), coord(t[2]), inf)
    pk = doc["pk"]
    if not isinstance(pk, groth16.ProvingKey):
        pk = pk_from_host(pk)
    dpk = groth16.DeviceProvingKey.__new__(groth16.DeviceProvingKey)
    dpk.pk = pk
    dpk.device = torch.device(device)
    for k in groth16.DeviceProvingKey.POINTS:
        setattr(dpk, k, pt(doc["pts"].get(k)))
    return dpk
