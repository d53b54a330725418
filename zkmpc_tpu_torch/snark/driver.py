"""Collaborative-prove drivers: the wide multiplication circuit and the
PedersenComCircuit.

Port of ``zkmpc_tpu/snark/driver.py``.  The wide-mul circuit is synthetic:
n independent gates a_i*b_i = c_i, allocated as vector wires so all Beaver
multiplications batch into one round, plus one instance pinning sum(c).
The PedersenComCircuit proves that a public point commits to a shared
message under shared randomness bits: the MPC bit decomposition, window
lookups and a tree of Edwards adds, in circuit.  `synthesize` /
`synthesize_pedersen_cs` build a circuit once for the setup;
`make_prove_fn` / `make_pedersen_prove_fn` return the prove step on raw
share limb tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..circuits.pedersen_gadget import pedersen_com_circuit
from ..crypto import pedersen as PD
from ..mpc import bits as B
from ..mpc.share import SHARED, MpcContext, MpcFp, _promote_to_shared, \
    _sum_last_axis, king_share, mpc_scope
from ..ops.curve import SWPoint
from ..ops.fp2 import Fp2Array
from ..ops.limbs import FQ, FR, FpArray
from ..parallel import transport as T
from . import groth16
from .gadgets import Boolean, FpVar
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
    out = c.map(_sum_last_axis)
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
    """Additive shares on the host: party 0 holds the values (an int or an
    array of ints), the rest 0."""
    vals = np.asarray(vals, dtype=object)
    arr = np.zeros((n_parties,) + vals.shape, dtype=object)
    arr[0, ...] = vals
    return FpArray.from_int(FR, arr, device=device).limbs


def make_prove_fn(dpk: groth16.DeviceProvingKey, n_parties: int):
    """Returns (fn, example_args): fn(a_limbs, b_limbs, generator, r=None,
    s=None, transport=None) -> proof arrays.  a_limbs/b_limbs: [P, n,
    nlimbs] additive shares of the gate inputs (every party's; a transport
    that plays one party takes its own rows); r/s: optional injected share
    tensors.  ``transport``: the transport to run on (a fresh
    StackedTransport by default)."""
    pk = dpk.pk
    dev = dpk.device
    n_gates = pk.num_witness // 3
    mats = groth16.device_matrices_from_pk(pk, dev)

    def step(a_limbs, b_limbs, generator, r=None, s=None, transport=None):
        t = transport or T.StackedTransport(n_parties, dev)
        with mpc_scope(MpcContext(t, backend="semi")):
            cs2 = ConstraintSystem(FR)
            a = MpcFp(FpArray(t.own_rows(a_limbs), FR, 2), SHARED)
            b = MpcFp(FpArray(t.own_rows(b_limbs), FR, 2), SHARED)
            build_wide_mul_circuit(cs2, a, b)
            return _proof_arrays(groth16.prove(dpk, cs2, generator, matrices=mats,
                                               r=r, s=s))

    vals_a = [(i + 2) for i in range(n_gates)]
    vals_b = [(i + 5) for i in range(n_gates)]
    return step, (deal(vals_a, n_parties, dev), deal(vals_b, n_parties, dev),
                  torch.Generator().manual_seed(7))


def _proof_arrays(proof):
    a_pt, b_pt, c_pt = proof
    return (a_pt.x.limbs, a_pt.y.limbs, a_pt.z.limbs, a_pt.inf,
            b_pt.x.c0.limbs, b_pt.x.c1.limbs,
            b_pt.y.c0.limbs, b_pt.y.c1.limbs,
            b_pt.z.c0.limbs, b_pt.z.c1.limbs, b_pt.inf,
            c_pt.x.limbs, c_pt.y.limbs, c_pt.z.limbs, c_pt.inf)


# --- the PedersenComCircuit prove (the reference's headline circuit:
# MPC proving 6.572 s at 3 parties on its own hardware, BASELINE.md) --------

PED_M_INT = 123456789
PED_R_INT = 0x5A5A5A5A5A
PED_NBITS = 253


@functools.lru_cache(maxsize=None)
def _pedersen_fixture(nbits: int = PED_NBITS):
    """(params, m, r, commitment) of the circuit at ``nbits`` message and
    randomness bits.  m and r are the reference's values cut to nbits bits,
    so a narrower circuit stays satisfiable; at 253 bits they are whole."""
    pp = PD.PedersenParams.sample(7)
    m = PED_M_INT % (1 << nbits)
    r = PED_R_INT % (1 << nbits)
    return pp, m, r, PD.commit_public_ints(pp, m, r)


def _build_pedersen_cs(cs, x_wire, r_bits_wire, generator, nbits: int):
    pp, _, _, com = _pedersen_fixture(nbits)
    x = FpVar.new_witness(cs, x_wire)
    r_bools = [Boolean.new_witness(cs, B._index_last(r_bits_wire, i))
               for i in range(nbits)]
    pedersen_com_circuit(cs, x, r_bools, com, pp, generator, nbits=nbits)


def synthesize_pedersen_cs(n_parties: int, nbits: int = PED_NBITS,
                           device="cuda") -> ConstraintSystem:
    """Synthesize the PedersenComCircuit through the MPC (the leader deals m
    and the bits of r; the bit decomposition and the point tree run as
    protocols) on ``device``; its matrices feed the setup."""
    _, m, r, _ = _pedersen_fixture(nbits)
    gen = torch.Generator().manual_seed(3)
    t = T.StackedTransport(n_parties, device)
    with mpc_scope(MpcContext(t, backend="semi")):
        cs = ConstraintSystem(FR)
        x = king_share(FpArray.from_int(FR, m, device=device), gen)
        rb = king_share(FpArray.from_int(FR, [(r >> i) & 1 for i in range(nbits)],
                                         device=device), gen)
        _build_pedersen_cs(cs, x, rb, gen, nbits)
    return cs


def make_pedersen_prove_fn(dpk: groth16.DeviceProvingKey, n_parties: int,
                           nbits: int = PED_NBITS):
    """Returns (fn, example_args) for the full prove of the
    PedersenComCircuit: MPC witness synthesis (batched bit decomposition and
    the log-depth point tree), the QAP, the Groth16 MSMs and the opening.

    fn(m_limbs, r_limbs, generator, r=None, s=None, transport=None) -> proof
    arrays, with m_limbs [P, nlimbs] shares of the message, r_limbs
    [P, nbits, nlimbs] shares of the randomness bits; the generator's draws
    go first to the bit protocols, then to the prover's r and s (or r/s:
    injected shares).  ``transport``: the StackedTransport to run on (a
    fresh one by default), whose ``stats`` then count the prove's openings."""
    pk = dpk.pk
    dev = dpk.device
    mats = groth16.device_matrices_from_pk(pk, dev)
    _, m, r_int, _ = _pedersen_fixture(nbits)

    def step(m_limbs, r_limbs, generator, r=None, s=None, transport=None):
        t = transport or T.StackedTransport(n_parties, dev)
        with mpc_scope(MpcContext(t, backend="semi")):
            cs2 = ConstraintSystem(FR)
            x = MpcFp(FpArray(m_limbs, FR, 2), SHARED)
            rb = MpcFp(FpArray(r_limbs, FR, 2), SHARED)
            _build_pedersen_cs(cs2, x, rb, generator, nbits)
            assert len(cs2.constraints) == pk.num_constraints, \
                "the circuit differs from the proving key's"
            return _proof_arrays(groth16.prove(dpk, cs2, generator, matrices=mats,
                                               r=r, s=s))

    r_bits = [(r_int >> i) & 1 for i in range(nbits)]
    return step, (deal(m, n_parties, dev), deal(r_bits, n_parties, dev),
                  torch.Generator().manual_seed(11))


def expected_pedersen_instance(nbits: int = PED_NBITS):
    """Host ints [1, commitment x, commitment y] of the PedersenComCircuit."""
    _, _, _, com = _pedersen_fixture(nbits)
    return [1, int(com[0]), int(com[1])]


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


def dpk_to_host(dpk: groth16.DeviceProvingKey) -> dict:
    """The device proving key in the reference's picklable host layout
    (``zkmpc_tpu/snark/driver.py:dpk_to_host``): ``pts[name]`` = (x, y, z,
    inf) with each coordinate ("fp", limbs) or ("fp2", c0 limbs, c1 limbs)
    as numpy int64, and ``pk`` the ProvingKey; `dpk_from_host` inverts it."""
    def coord(c):
        if isinstance(c, Fp2Array):
            return ("fp2", c.c0.limbs.cpu().numpy(), c.c1.limbs.cpu().numpy())
        return ("fp", c.limbs.cpu().numpy())

    def pt(p):
        if p is None:
            return None
        return (coord(p.x), coord(p.y), coord(p.z), p.inf.cpu().numpy())
    return dict(pk=dpk.pk, pts={k: pt(getattr(dpk, k))
                                for k in groth16.DeviceProvingKey.POINTS})


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
