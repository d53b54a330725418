"""Groth16: setup, collaborative prover, vanilla verifier.

Port of ``zkmpc_tpu/snark/groth16.py``:

- `setup_params` runs on the host over plain ints; `device_setup` batches
  the query scalar multiplications on the device.
- `prove` works over MPC wires: QAP witness map (NTT + one batched Beaver
  round), the fused G1 MSM and the G2 MSM over shared scalars, group-Beaver
  products for s*A and r*B1, and the final proof reveal.
- `verify` is the standard pairing check on the opened proof, on the
  host pairing (`spec.pairing`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import params
from ..compat import ark as A_
from ..mpc import share as MS
from ..mpc.group import MpcSWPoint, mpc_msm, mpc_msm_many, scale_sum
from ..mpc.share import MpcFp
from ..ops import curve as OC
from ..ops import msm as OM
from ..ops.curve import SWPoint
from ..ops.limbs import FR, FpArray
from ..ops.ntt import Domain
from ..spec import curves as SC
from ..spec import field as SF
from ..spec import pairing as SP
from .qap import DeviceMatrix, witness_map
from .r1cs import ConstraintSystem

R = params.FR_MODULUS


@dataclasses.dataclass
class VerifyingKey:
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    ic: list  # [(x, y) or None] per instance variable


@dataclasses.dataclass
class ProvingKey:
    vk: VerifyingKey
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    a_query: list | None
    b_g1_query: list | None
    b_g2_query: list | None
    h_query: list | None
    l_query: list | None
    num_instance: int
    num_constraints: int
    domain_n: int
    num_witness: int = 0
    matrices_coo: tuple | None = None


class DeviceProvingKey:
    """Proving key with the MSM bases on ``device`` as point batches."""

    POINTS = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query",
              "alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2")

    def __init__(self, pk: ProvingKey, device="cuda"):
        self.pk = pk
        self.device = torch.device(device)
        g1 = lambda pts: SWPoint.g1_from_affine_ints(pts, device)  # noqa: E731
        g2 = lambda pts: SWPoint.g2_from_affine_ints(pts, device)  # noqa: E731
        self.a_query = g1(pk.a_query)
        self.b_g1_query = g1(pk.b_g1_query)
        self.b_g2_query = g2(pk.b_g2_query)
        self.h_query = g1(pk.h_query)
        self.l_query = g1(pk.l_query) if pk.l_query else None
        self._set_constant_points(pk)

    def _set_constant_points(self, pk: ProvingKey):
        dev = self.device
        self.alpha_g1 = SWPoint.g1_from_affine_ints([pk.alpha_g1], dev)[0]
        self.beta_g1 = SWPoint.g1_from_affine_ints([pk.beta_g1], dev)[0]
        self.beta_g2 = SWPoint.g2_from_affine_ints([pk.beta_g2], dev)[0]
        self.delta_g1 = SWPoint.g1_from_affine_ints([pk.delta_g1], dev)[0]
        self.delta_g2 = SWPoint.g2_from_affine_ints([pk.delta_g2], dev)[0]


def _domain_size(cs: ConstraintSystem) -> int:
    need = len(cs.constraints) + cs.num_instance
    n = 1
    while n < need:
        n <<= 1
    return n


def _toxic_waste(seed: int):
    """alpha, beta, gamma, delta, tau via ark `Fp::rand` on a ChaCha12
    StdRng stream (`compat.ark`)."""
    rng = A_.seeded_rng(seed)
    return tuple(A_.fr_rand(rng) for _ in range(5))


def setup_params(cs: ConstraintSystem, seed: int = 0):
    """Host part of setup: toxic waste + QAP evaluations u/v/w at tau (ints)."""
    alpha, beta, gamma, delta, tau = _toxic_waste(seed)
    n = _domain_size(cs)
    m = cs.num_vars
    nc = len(cs.constraints)
    ninst = cs.num_instance
    omega = SF.root_of_unity(R, FR.generator, FR.two_adicity, n)
    z_tau = (pow(tau, n, R) - 1) % R
    n_inv = pow(n, -1, R)
    # Lagrange coefficients L_i(tau) over the size-n radix-2 domain
    ws = []
    w_i = 1
    for _ in range(n):
        ws.append(w_i)
        w_i = w_i * omega % R
    invs = SF.batch_inv([(tau - w) % R for w in ws], R)
    lag = [z_tau * w % R * iv % R * n_inv % R for w, iv in zip(ws, invs)]
    u = [0] * m
    v = [0] * m
    w = [0] * m
    matA, matB, matC = cs.matrices()
    for (rows, cols, coeffs), dst in ((matA, u), (matB, v), (matC, w)):
        for r_i, c_i, coef in zip(rows.tolist(), cols.tolist(), coeffs):
            dst[c_i] = (dst[c_i] + int(coef) * lag[r_i]) % R
    for j in range(ninst):  # input consistency rows (ark convention)
        u[j] = (u[j] + lag[nc + j]) % R
    return dict(alpha=alpha, beta=beta, gamma=gamma, delta=delta, tau=tau,
                u=u, v=v, w=w, z_tau=z_tau, n=n, m=m, nc=nc, ninst=ninst,
                matrices=(matA, matB, matC))


def _fixed_base_muls(gen_affine, g2: bool, scalars, device):
    """[k * G for k in scalars] as a device point batch (batched ladder)."""
    make = SWPoint.g2_from_affine_ints if g2 else SWPoint.g1_from_affine_ints
    base = make([gen_affine], device)
    s = FpArray.from_int(FR, np.asarray(scalars, dtype=object), device=device)
    return OC.sw_scalar_mul(OM._bcast_sw(base[0], s.shape), s)


def device_setup(cs: ConstraintSystem, seed: int = 0, device="cuda"
                 ) -> DeviceProvingKey:
    """Full setup with the query scalar-muls batched on ``device``."""
    sp = setup_params(cs, seed)
    alpha, beta, gamma, delta, tau = (sp[k] for k in
                                      ("alpha", "beta", "gamma", "delta", "tau"))
    u, v, w, z_tau, n, m, ninst = (sp[k] for k in
                                   ("u", "v", "w", "z_tau", "n", "m", "ninst"))
    ginv = pow(gamma, -1, R)
    dinv = pow(delta, -1, R)

    h_scalars = []
    acc = z_tau * dinv % R
    for _ in range(n - 1):
        h_scalars.append(acc)
        acc = acc * tau % R
    l_scalars = [(beta * u[j] + alpha * v[j] + w[j]) % R * dinv % R
                 for j in range(ninst, m)]

    def e1(k):
        return SC.g1_mul(SC.G1_GEN, k % R)

    def e2(k):
        return SC.g2_mul(SC.G2_GEN, k % R)
    ic = [e1((beta * u[j] + alpha * v[j] + w[j]) % R * ginv % R)
          for j in range(ninst)]
    vk = VerifyingKey(e1(alpha), e2(beta), e2(gamma), e2(delta), ic)
    pk = ProvingKey(
        vk=vk, alpha_g1=e1(alpha), beta_g1=e1(beta), beta_g2=e2(beta),
        delta_g1=e1(delta), delta_g2=e2(delta),
        a_query=None, b_g1_query=None, b_g2_query=None,
        h_query=None, l_query=None,
        num_instance=ninst, num_constraints=sp["nc"], domain_n=n,
        num_witness=m - ninst, matrices_coo=sp["matrices"])
    dpk = DeviceProvingKey.__new__(DeviceProvingKey)
    dpk.pk = pk
    dpk.device = torch.device(device)
    dpk.a_query = _fixed_base_muls(SC.G1_GEN, False, u, device)
    dpk.b_g1_query = _fixed_base_muls(SC.G1_GEN, False, v, device)
    dpk.b_g2_query = _fixed_base_muls(SC.G2_GEN, True, v, device)
    dpk.h_query = _fixed_base_muls(SC.G1_GEN, False, h_scalars, device)
    dpk.l_query = (_fixed_base_muls(SC.G1_GEN, False, l_scalars, device)
                   if l_scalars else None)
    dpk._set_constant_points(pk)
    return dpk


def device_matrices_from_pk(pk: ProvingKey, device="cuda"):
    A, B, C = pk.matrices_coo
    n = pk.domain_n
    return tuple(DeviceMatrix.from_coo(FR, mat, n, device) for mat in (A, B, C))


def prove(dpk: DeviceProvingKey, cs: ConstraintSystem, generator=None,
          matrices=None, r=None, s=None):
    """Collaborative prove under the ambient MPC scope.  Returns the opened
    proof points (a, b, c), party-shaped.

    ``generator``: torch.Generator for the r and s shares; ``r``/``s``:
    optional injected share tensors (FpArray [P]) in place of the draws."""
    pk = dpk.pk
    dev = dpk.device
    dom = Domain(FR, pk.domain_n, dev)
    mats = matrices if matrices is not None else \
        device_matrices_from_pk(pk, dev)
    z = cs.full_assignment()
    h = witness_map(FR, mats, z, dom, pk.num_instance, pk.num_constraints)

    if generator is None and (r is None or s is None):
        generator = torch.Generator().manual_seed(0)
    r = MS.rand_shared(generator, FR, shares=r)
    s = MS.rand_shared(generator, FR, shares=s)

    alpha = MpcSWPoint.from_public(dpk.alpha_g1)
    beta1 = MpcSWPoint.from_public(dpk.beta_g1)
    beta2 = MpcSWPoint.from_public(dpk.beta_g2)

    # every delta multiple rides a query MSM as one extra (point, scalar)
    # pair -- delta1*r the a_query MSM, delta1*s the b_g1 MSM, delta2*s the
    # b_g2 MSM, -delta1*rs the h MSM -- and the G1 MSMs fuse into one call
    rs = r * s

    def ext(base_pts, extra_pt):
        return SWPoint.concat([base_pts, extra_pt.reshape((1,))], axis=0)

    def exts(scal, extra):
        return MpcFp.concat([scal, extra.reshape(1)], axis=0)

    g1_bases = [ext(dpk.a_query, dpk.delta_g1),
                ext(dpk.b_g1_query, dpk.delta_g1),
                ext(dpk.h_query, dpk.delta_g1)]
    g1_scal = [exts(z, r), exts(z, s), exts(h, -rs)]
    if dpk.l_query is not None:
        g1_bases.append(dpk.l_query)
        g1_scal.append(z[pk.num_instance:])
    g1_msms = mpc_msm_many(g1_bases, g1_scal)

    a_pt = alpha + g1_msms[0]
    b1_pt = beta1 + g1_msms[1]
    b2_pt = beta2 + mpc_msm(ext(dpk.b_g2_query, dpk.delta_g2), exts(z, s))

    # C = h-msm + l-msm + s*A + r*B1 in one group-Beaver scale + one fold
    extras = [g1_msms[2]]
    if dpk.l_query is not None:
        extras.append(g1_msms[3])
    c_pt = scale_sum([(a_pt, s), (b1_pt, r)], extra_shared=extras)
    return a_pt.reveal(), b2_pt.reveal(), c_pt.reveal()


def proof_to_ints(proof):
    """Opened proof points -> host affine ints ((ax,ay),(bx,by),(cx,cy))."""
    return tuple((p[0:1] if p.shape else p.reshape((1,))).to_affine_ints()[0]
                 for p in proof)


def verify(vk: VerifyingKey, instance_ints, proof_ints) -> bool:
    """Vanilla Groth16 verification over the opened proof (host pairing).

    e(A, B) == e(alpha, beta) * e(IC(x), gamma) * e(C, delta)
    """
    a, b, c = proof_ints
    if a is None or b is None or c is None:
        return False
    assert len(instance_ints) == len(vk.ic)
    acc = None
    for x_j, ic_j in zip(instance_ints, vk.ic):
        acc = SC.g1_add(acc, SC.g1_mul(ic_j, x_j % R) if ic_j else None)
    return SP.product_pairing_is_one([
        (SC.g1_neg(a), b),
        (vk.alpha_g1, vk.beta_g2),
        (acc, vk.gamma_g2),
        (c, vk.delta_g2),
    ])
