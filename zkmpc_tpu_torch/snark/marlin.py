"""Collaborative Marlin: KZG commitments to a holographic AHP, proved over
secret shares.

Port of ``zkmpc_tpu/snark/marlin.py`` (the reference's `src/marlin.rs`,
`arkworks/marlin/src/lib.rs:152-324`).  Witness polynomials stay shared;
each round's commitments are opened before they are absorbed into the
Fiat-Shamir transcript, so every party derives the same challenges; the
evaluations and two batched KZG openings are opened and checked by a plain
verifier.

- H of size n holds the assignment in the input-domain layout (instance on
  the subgroup X, witness on H \\ X); the prover commits w_hat =
  (z - x_poly) / v_X, z_A, z_B, z_C and a sum-zero mask m, each witness
  polynomial masked by a shared multiple of v_H.
- Rowcheck z_A z_B - z_C = h_0 v_H (one batched Beaver product on the 2n
  coset); lincheck for the eta-combined matrices at alpha by the univariate
  sumcheck p(X) = X g(X) + v_H(X) q(X), deg(g) <= n - 2 enforced by a
  shifted commitment.
- Holographic round 3: per matrix, a sumcheck over the index domain K for
  (M^T r_alpha)(beta) against the indexer's commitments to row, col and
  val, so the verifier never reads the matrices.
- All challenges come from one chained `compat.ark.FiatShamirRng`.

Unlike the reference's, `verify` returns False on a malformed proof
(missing keys, wrong types, points off the curve or outside the group, a
wrong matrix size) instead of raising.  The prove batches what the
reference does one at a time: each round's commitments are one fused MSM
call and one opening, the evaluations at beta one opening, and the host
inverses of the O(n) and O(nnz) loops one batch inversion each; the values
are the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import params
from ..compat import ark as A_
from ..mpc import share as MS
from ..mpc.group import MpcSWPoint, _stack_points_last
from ..mpc.share import SHARED, MpcFp
from ..ops.limbs import FR, FpArray
from ..ops.msm import sw_msm, sw_msm_multi
from ..ops.ntt import Domain
from ..spec import curves as SC
from ..spec import field as SF
from . import kzg
from .kzg import _apply, _pad_to, _place, _slice
from .qap import DeviceMatrix
from .r1cs import ConstraintSystem

R = params.FR_MODULUS

#: fixed order of the polynomials batch-opened at beta (transcript and
#: combination order); "w" is w_hat of the x/w split: z itself is never
#: committed (z = x_poly + v_X * w_hat, `ahp/prover.rs:243`)
_BETA_ORDER = ("w", "za", "zb", "zc", "m", "h0", "g", "q")
#: fixed order of the per-matrix polynomials batch-opened at beta3
_BETA3_ORDER = ("row", "col", "val", "g3", "h3")


@dataclasses.dataclass
class MatrixIndexComms:
    """Holographic index of one matrix: commitments to the low-degree
    extensions of its entries' (row point, col point, value) over an index
    domain K (the AHP indexer, `marlin/src/ahp/indexer.rs`; row and col
    hold the H-points omega^r, omega^c)."""
    k_size: int
    com_row: tuple
    com_col: tuple
    com_val: tuple
    # prover-side data (public): coefficient arrays and the entries' ints
    row_poly: FpArray = None
    col_poly: FpArray = None
    val_poly: FpArray = None
    entries: tuple = None          # (row_pts, col_pts, vals) int lists


@dataclasses.dataclass
class MarlinIndex:
    srs: kzg.KzgSrs
    domain_n: int
    num_instance: int
    matrices: tuple          # host COO (A, B, C), columns in H-slot order
    dev_matrices: tuple      # DeviceMatrix per matrix, n_rows = n
    index_comms: tuple       # MatrixIndexComms per matrix
    nx: int = 1              # |X| = next_pow2(num_instance), X a subgroup of H
    num_witness: int = 0
    perm: object = None      # [n] H slot -> index into [instance..., witness..., 0]
    device: torch.device | str = "cuda"


def _omega(n: int) -> int:
    return SF.root_of_unity(R, FR.generator, FR.two_adicity, n)


def _fr(vals, device) -> FpArray:
    return FpArray.from_int(FR, np.asarray(vals, dtype=object), device=device)


def _matrix_entries(coo, n: int):
    """(row points, col points, vals) of one matrix, padded to k = the next
    power of two of nnz (at least 2) with val 0 at row = col = omega^0."""
    rows, cols, coeffs = coo
    w = _omega(n)
    cache = {}

    def pt(i):
        i = int(i)
        if i not in cache:
            cache[i] = pow(w, i, R)
        return cache[i]
    row_pts = [pt(r) for r in rows]
    col_pts = [pt(c) for c in cols]
    vals = [int(v) % R for v in coeffs]
    k = max(2, 1 << (max(1, len(vals) - 1)).bit_length())
    pad = k - len(vals)
    return row_pts + [1] * pad, col_pts + [1] * pad, vals + [0] * pad, k


def _index_polys(coo, n: int, device):
    """The row, col and val polynomials over K of one matrix."""
    row_pts, col_pts, vals, k = _matrix_entries(coo, n)
    domK = Domain(FR, k, device)
    polys = [domK.ifft(_fr(xs, device)) for xs in (row_pts, col_pts, vals)]
    return k, polys, (row_pts, col_pts, vals)


def _public_commits(dsrs: kzg.DeviceKzgSrs, items) -> list:
    """[(public coefficients FpArray, shift)] -> host affine points, every
    MSM in one fused call and one conversion to affine."""
    outs = sw_msm_multi([dsrs.powers[s:s + c.shape[-1]] for c, s in items],
                        [c for c, _ in items])
    return _stack_points_last(outs).to_affine_ints()


def _domain_sizes(cs: ConstraintSystem) -> tuple[int, int]:
    """(n, nx): |H| and |X|.  X = next_pow2(num_instance) must be a
    subgroup of H, and H must hold the padded instance (nx slots) and every
    witness (`marlin/src/ahp/mod.rs` domain sizing)."""
    nx = 1
    while nx < cs.num_instance:
        nx <<= 1
    n = 1
    need = max(len(cs.constraints), nx + cs.num_witness, 2, nx)
    while n < need:
        n <<= 1
    return n, nx


def _h_layout(n: int, nx: int, ninst: int, nwit: int):
    """H-slot layout of the x/w split: instance i at H-index i * (n / nx)
    (the subgroup X = <omega^(n/nx)>), witnesses filling the complement in
    order.  Returns (perm [n] -> source index, sentinel ninst + nwit for an
    empty slot; col_map [ninst + nwit] -> H-index)."""
    stride = n // nx
    in_x = np.zeros(n, dtype=bool)
    in_x[[i * stride for i in range(nx)]] = True
    wit_pos = np.nonzero(~in_x)[0]
    assert nwit <= len(wit_pos)
    nvars = ninst + nwit
    perm = np.full(n, nvars, dtype=np.int64)
    perm[np.arange(ninst) * stride] = np.arange(ninst)
    perm[wit_pos[:nwit]] = ninst + np.arange(nwit)
    col_map = np.empty(nvars, dtype=np.int64)
    col_map[:ninst] = stride * np.arange(ninst)
    col_map[ninst:] = wit_pos[:nwit]
    return perm, col_map


def srs_degree_for(cs: ConstraintSystem) -> int:
    """Smallest SRS degree that can index and prove this circuit."""
    n, _ = _domain_sizes(cs)
    kmax = 2
    for m in cs.matrices():
        kmax = max(kmax, 1 << (max(1, len(m[2])) - 1).bit_length())
    return max(n + 1, 2 * kmax - 1)


def universal_setup(max_degree: int, seed: int = 0, device="cuda") -> kzg.KzgSrs:
    """One circuit-independent KZG SRS for every circuit whose
    `srs_degree_for` fits (the reference's `Marlin::universal_setup`,
    `src/marlin.rs:36`)."""
    return kzg.setup(max_degree, seed=seed, device=device)


def _remapped(cs: ConstraintSystem, n: int, nx: int):
    perm, col_map = _h_layout(n, nx, cs.num_instance, cs.num_witness)
    mats = tuple((rows, col_map[np.asarray(cols, dtype=np.int64)], coeffs)
                 for rows, cols, coeffs in cs.matrices())
    return perm, mats


def index_with_srs(srs: kzg.KzgSrs, cs: ConstraintSystem, device="cuda") -> MarlinIndex:
    """Holographic index under a universal SRS (the reference's `index`,
    AHP indexer `marlin/src/ahp/indexer.rs`): the matrices' columns move to
    the H-slot layout and each matrix's row, col and val polynomials are
    committed, the nine MSMs in one call."""
    need = srs_degree_for(cs)
    assert len(srs.powers) - 1 >= need, \
        f"universal SRS degree {len(srs.powers) - 1} < required {need}"
    dev = torch.device(device)
    n, nx = _domain_sizes(cs)
    perm, mats = _remapped(cs, n, nx)
    built = [_index_polys(m, n, dev) for m in mats]
    pts = _public_commits(srs.device(dev), [(p, 0) for _, polys, _ in built for p in polys])
    comms = tuple(MatrixIndexComms(k, *pts[3 * j:3 * j + 3], *polys, entries)
                  for j, (k, polys, entries) in enumerate(built))
    return _index(srs, cs, n, nx, perm, mats, comms, dev)


def _index(srs, cs, n, nx, perm, mats, comms, dev) -> MarlinIndex:
    return MarlinIndex(srs, n, cs.num_instance, mats,
                       tuple(DeviceMatrix.from_coo(FR, m, n, dev) for m in mats), comms,
                       nx=nx, num_witness=cs.num_witness, perm=perm, device=dev)


def index_from_host(srs: kzg.KzgSrs, cs: ConstraintSystem, comms, device="cuda") -> MarlinIndex:
    """A `MarlinIndex` whose matrix commitments are given as plain ints
    (``comms``: per matrix a dict with k, row, col, val affine points, as
    another implementation's indexer made them); the prover's polynomials
    are recomputed from ``cs``."""
    dev = torch.device(device)
    n, nx = _domain_sizes(cs)
    perm, mats = _remapped(cs, n, nx)
    out = []
    for m, c in zip(mats, comms):
        k, polys, entries = _index_polys(m, n, dev)
        if k != c["k"]:
            raise ValueError(f"the matrix index has k = {c['k']}, the circuit needs {k}")
        out.append(MatrixIndexComms(k, c["row"], c["col"], c["val"], *polys, entries))
    return _index(srs, cs, n, nx, perm, mats, tuple(out), dev)


def setup_and_index(cs: ConstraintSystem, seed: int = 0, device="cuda") -> MarlinIndex:
    """A universal setup of the degree this circuit needs, then its index."""
    return index_with_srs(universal_setup(srs_degree_for(cs), seed=seed, device=device),
                          cs, device)


# ------------------------------------------------------------ transcript


def _pt_bytes(pt) -> bytes:
    return A_.g1_affine_to_bytes(pt)


def _fs_start(index: MarlinIndex, instance_ints):
    """One chained Fiat-Shamir transcript for the whole proof
    (`arkworks/marlin/src/rng.rs:40-70`; init order `marlin/src/lib.rs:
    163,346`: PROTOCOL_NAME || index_vk || public_input): every challenge
    binds everything absorbed before it."""
    buf = b"MARLIN-2019"
    buf += int(index.domain_n).to_bytes(8, "little")
    buf += int(index.nx).to_bytes(8, "little")
    buf += int(index.num_instance).to_bytes(8, "little")
    for mic in index.index_comms:
        buf += int(mic.k_size).to_bytes(8, "little")
        for pt in (mic.com_row, mic.com_col, mic.com_val):
            buf += _pt_bytes(pt)
    for v in instance_ints:
        buf += int(v).to_bytes(32, "little")
    return A_.FiatShamirRng(buf)


def _fs_absorb(fs, *, points=(), ints=()):
    buf = b"".join(_pt_bytes(pt) for pt in points)
    buf += b"".join(int(v).to_bytes(32, "little") for v in ints)
    fs.absorb(buf)


def _fs_round3_absorb(fs, mat_proofs):
    """The holographic round-3 messages (sigma and the commitments) in
    matrix order."""
    buf = b""
    for mp in mat_proofs:
        buf += int(mp["sigma"]).to_bytes(32, "little")
        for pt in (mp["com_g3"], mp["com_h3"], mp["com_g3_shift"]):
            buf += _pt_bytes(pt)
    fs.absorb(buf)


def _fs_evals_absorb(fs, evals, mat_proofs):
    """Every published evaluation (beta evals in _BETA_ORDER, then each
    matrix's beta3 evals in _BETA3_ORDER) before the opening challenges
    (`marlin/src/lib.rs:296`)."""
    buf = b"".join(int(evals[name]).to_bytes(32, "little") for name in _BETA_ORDER)
    for mp in mat_proofs:
        buf += b"".join(int(mp["evals"][name]).to_bytes(32, "little")
                        for name in _BETA3_ORDER)
    fs.absorb(buf)


def _open_points(pts) -> list:
    """Open shared commitment points (each of batch shape ()) in one opening
    -> host affine ints."""
    mac = None if pts[0].mac is None else _stack_points_last([p.mac for p in pts])
    stacked = MpcSWPoint(_stack_points_last([p.point for p in pts]), SHARED, mac)
    return stacked.reveal()[0].to_affine_ints()


# ------------------------------------------------------------------ prover


def prove(index: MarlinIndex, cs: ConstraintSystem, generator=None, masks=None) -> dict:
    """Collaborative prove under the ambient MPC scope; returns the opened
    proof dict (commitments, evaluations, two batched opening witnesses,
    the challenges and the transcript digest).

    ``generator``: the torch.Generator of the five masks (the four v_H
    multiples [1] and the sum-zero mask [n + 1]); ``masks``: optional
    injected share tensors (FpArray [P, 1] x 4, [P, n + 1]) in place of the
    draws (semi-honest only: under SPDZ they come from the <r> pool).
    One of the two is required: the masks are what make the proof
    zero-knowledge, so none is drawn from a fixed seed.

    Zero-knowledge: each witness polynomial gets a fresh shared multiple
    of v_H (its evaluations on H unchanged, its published evaluation
    hidden), and the sumcheck a random sum-zero mask m (the reference's
    zk_bound and mask_poly, `ahp/prover.rs:280,371-376`).  Soundness:
    deg(g) <= n - 2 and deg(g3) <= k - 2 are enforced by shifted
    commitments folded into the batched openings at beta and beta3."""
    if masks is None:
        if generator is None:
            raise ValueError("prove needs a generator or injected masks")
        masks = [None] * 5
    dev = index.device
    dsrs = index.srs.device(dev)
    n, nx = index.domain_n, index.nx
    D = len(index.srs.powers) - 1
    dom, big = Domain(FR, n, dev), Domain(FR, 2 * n, dev)

    instance_ints = cs.instance_ints()
    z_evals = _layout_assignment(index, cs)
    # z_A, z_B, z_C over H in one batch: [P, 3, n]
    zabc = MpcFp.concat([m.matvec(z_evals).reshape(1, n) for m in index.dev_matrices], axis=0)
    polys = _apply(MpcFp.concat([z_evals.reshape(1, n), zabc], axis=0), dom.ifft)
    z_poly, za_poly, zb_poly, zc_poly = (
        _mask_vh(polys[i], generator, n, masks[i]) for i in range(4))
    m_poly = _sum_zero_mask(generator, n, masks[4])

    x_poly = _x_poly(index, instance_ints)
    w_poly = _div_by_vx(z_poly, x_poly, nx, big)

    # round 1: commit w, zA, zB, zC, m; open; absorb -> alpha, eta
    com_w, com_za, com_zb, com_zc, com_m = _open_points(kzg.commit_many(
        dsrs, [(p, 0) for p in (w_poly, za_poly, zb_poly, zc_poly, m_poly)]))
    fs = _fs_start(index, instance_ints)
    _fs_absorb(fs, points=(com_w, com_za, com_zb, com_zc, com_m))
    alpha = fs.fr_challenge()
    eta = [fs.fr_challenge() for _ in range(3)]

    # rowcheck quotient h0 = (zA zB - zC) / v_H on the 2n coset (the masked
    # polynomials have degree n), one batched Beaver product
    abc_big = _apply(_pad_to(MpcFp.concat([p.reshape(1, n + 1) for p in
                                           (za_poly, zb_poly, zc_poly)], axis=0), 2 * n),
                     big.coset_fft)
    prod = abc_big[0] * abc_big[1]
    h0_big = _scale(prod - abc_big[2], _vanish_n_inv_on_coset(big, n))
    h0_poly = _slice(_apply(h0_big, big.coset_ifft), n + 2)

    # lincheck: p(X) = u_H(alpha, X) (sum eta_M zM)(X) - (sum eta_M M^T r_alpha)(X) z(X)
    # + m(X), both products public x shared, on the size-2n domain, split by
    # v_H = X^n - 1: p = (p_low + p_high) + v_H p_high
    u_alpha = _u_H_row(alpha, dom)
    eta_fp = [_fr(e, dev) for e in eta]
    zm_poly = _lincomb([za_poly, zb_poly, zc_poly], eta_fp)
    rstar = _rstar_evals(index, u_alpha, eta, n)
    up = big.fft(_pad_to(dom.ifft(FpArray.stack([u_alpha, rstar], 0)), 2 * n))
    zz_big = _apply(_pad_to(MpcFp.concat([zm_poly.reshape(1, n + 1), z_poly.reshape(1, n + 1)],
                                         axis=0), 2 * n), big.fft)
    p_big = _scale(zz_big[0], up[0]) - _scale(zz_big[1], up[1])
    p_coeffs = _apply(p_big, big.ifft) + _place(m_poly, 0, 2 * n)
    p_high = _slice(_shift_block(p_coeffs, n), n)
    q_poly = p_high
    r_poly = _slice(p_coeffs, n) + p_high
    # sum over H is zero, so r's constant coefficient is zero: g = r >> 1,
    # deg(g) <= n - 2 enforced by the shifted commitment
    g_poly = _slice(_shift_down(r_poly), n - 1)
    shift_g = D - (n - 2)

    com_h0, com_g, com_q, com_g_shift = _open_points(kzg.commit_many(
        dsrs, [(h0_poly, 0), (g_poly, 0), (q_poly, 0), (g_poly, shift_g)]))
    _fs_absorb(fs, points=(com_h0, com_g, com_q, com_g_shift))
    beta = fs.fr_challenge()
    beta_fp = _fr(beta, dev)

    # round 3 (holographic matrix sumcheck): public data only, no openings
    mat_proofs = _matrix_sumcheck_prove(dsrs, index.index_comms, alpha, beta, D)
    _fs_round3_absorb(fs, mat_proofs)
    beta3 = fs.fr_challenge()
    b3_fp = _fr(beta3, dev)
    polys3 = [p for mic, mp in zip(index.index_comms, mat_proofs)
              for p in (mic.row_poly, mic.col_poly, mic.val_poly,
                        mp.pop("g3_poly"), mp.pop("h3_poly"))]
    vals3 = _eval_public(polys3, b3_fp)
    items3 = []
    for j, (mic, mp) in enumerate(zip(index.index_comms, mat_proofs)):
        mine = polys3[5 * j:5 * j + 5]
        mp["evals"] = dict(zip(_BETA3_ORDER, vals3[5 * j:5 * j + 5]))
        items3 += [(p, 0, _fr(v, dev)) for p, v in zip(mine, vals3[5 * j:5 * j + 5])]
        # degree bound: deg(g3) <= k - 2
        items3.append((mine[3], D - (mic.k_size - 2), _fr(mp["evals"]["g3"], dev)))

    # open every evaluation at beta, absorb them all, then draw the two
    # batched opening challenges
    proof_polys = dict(w=w_poly, za=za_poly, zb=zb_poly, zc=zc_poly,
                       m=m_poly, h0=h0_poly, g=g_poly, q=q_poly)
    evals = dict(zip(_BETA_ORDER, _eval_shared([proof_polys[k] for k in _BETA_ORDER],
                                               beta_fp)))
    items = [(proof_polys[k], 0, MpcFp.const(FR, evals[k])) for k in _BETA_ORDER]
    items.append((g_poly, shift_g, MpcFp.const(FR, evals["g"])))
    coms = dict(w=com_w, za=com_za, zb=com_zb, zc=com_zc, m=com_m,
                h0=com_h0, g=com_g, q=com_q, g_shift=com_g_shift)
    _fs_evals_absorb(fs, evals, mat_proofs)
    xi = fs.fr_challenge()
    xi3 = fs.fr_challenge()
    n_open = kzg._next_pow2(D + 1)
    w = kzg.batch_open_coeffs(items, beta_fp, xi, domain_n=n_open)
    w_pt, w3_pt = _commit_shared_and_public(
        dsrs, w, kzg.batch_open_coeffs(items3, b3_fp, xi3, domain_n=n_open))
    w_beta3 = w3_pt.to_affine_ints()[0]
    w_beta = _open_points([w_pt])[0]
    return dict(coms=coms, evals=evals, w_beta=w_beta, alpha=alpha, eta=eta, beta=beta,
                mat_proofs=mat_proofs, beta3=beta3, w_beta3=w_beta3,
                fs_digest=fs.seed.hex())


def _commit_shared_and_public(dsrs: kzg.DeviceKzgSrs, shared: MpcFp, public: FpArray):
    """Commitments to a shared and a public coefficient vector of one length
    in one MSM: the public vector rides as one more row of the scalar
    batch.  Returns (MpcSWPoint, SWPoint)."""
    p = shared.value.shape[0]
    rows = [shared.value] + ([] if shared.mac is None else [shared.mac]) + [public[None]]
    out = sw_msm(dsrs.powers[0:public.shape[-1]], FpArray.concat(rows, axis=0))
    mac = None if shared.mac is None else out[p:2 * p]
    return MpcSWPoint(out[:p], SHARED, mac), out[-1]


def _eval_shared(polys, z: FpArray) -> list:
    """Open p_i(z) for shared polynomials of different lengths: one
    evaluation over the stacked, zero-padded coefficients and one opening."""
    L = max(p.shape[-1] for p in polys)
    stacked = MpcFp.concat([_pad_to(p, L).reshape(1, L) for p in polys], axis=0)
    v = kzg.evaluate(stacked, z)
    opened = v.reveal() if v.visibility == SHARED else v.value
    return [int(x) for x in opened[0].to_ints().reshape(-1)]


def _eval_public(polys, z: FpArray) -> list:
    """p_i(z) for public coefficient arrays (no MPC)."""
    L = max(p.shape[-1] for p in polys)
    stacked = FpArray.stack([_pad_to(p, L) for p in polys], 0)
    v = MS._sum_last_axis(stacked * kzg._pow_vector(z, L))
    return [int(x) for x in v.to_ints().reshape(-1)]


# ---------------------------------------------------------------- verifier


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, bool)


def _is_g1(pt) -> bool:
    """None (infinity) or an affine pair of canonical ints on G1, in the
    prime-order subgroup."""
    if pt is None:
        return True
    if not isinstance(pt, (tuple, list)) or len(pt) != 2 or \
            not all(_is_int(c) and 0 <= c < SC.P for c in pt):
        return False
    x, y = (int(c) for c in pt)
    if (y * y - x * x * x - 1) % SC.P:
        return False
    return A_.g1_in_subgroup((x, y))


def _well_formed(index: MarlinIndex, instance_ints, proof) -> bool:
    """The proof's shape: every key present with the right type, points on
    G1, field elements canonical, one round-3 message per indexed matrix
    with its size k."""
    def fe(v):
        return _is_int(v) and 0 <= v < R
    if not isinstance(proof, dict) or not isinstance(instance_ints, (list, tuple)) or \
            not all(_is_int(v) for v in instance_ints):
        return False
    coms, ev = proof.get("coms"), proof.get("evals")
    if not isinstance(coms, dict) or not isinstance(ev, dict):
        return False
    if any(k not in coms or not _is_g1(coms[k]) for k in _BETA_ORDER + ("g_shift",)):
        return False
    if any(k not in ev or not fe(ev[k]) for k in _BETA_ORDER):
        return False
    eta = proof.get("eta")
    if not isinstance(eta, (list, tuple)) or len(eta) != 3 or \
            not all(fe(v) for v in (proof.get("alpha"), proof.get("beta"), *eta)):
        return False
    if "w_beta" not in proof or not _is_g1(proof["w_beta"]):
        return False
    mps = proof.get("mat_proofs")
    if not isinstance(mps, (list, tuple)) or len(mps) != len(index.index_comms):
        return False
    if not fe(proof.get("beta3")) or "w_beta3" not in proof or not _is_g1(proof["w_beta3"]):
        return False
    for mic, mp in zip(index.index_comms, mps):
        if not isinstance(mp, dict) or not _is_int(mp.get("k")) or mp["k"] != mic.k_size:
            return False
        if not fe(mp.get("sigma")) or not isinstance(mp.get("evals"), dict):
            return False
        if any(k not in mp or not _is_g1(mp[k]) for k in ("com_g3", "com_h3", "com_g3_shift")):
            return False
        if any(k not in mp["evals"] or not fe(mp["evals"][k]) for k in _BETA3_ORDER):
            return False
    return True


def verify(index: MarlinIndex, instance_ints, proof) -> bool:
    """The Marlin verifier on the opened proof (host).  False on a
    malformed proof as on a wrong one."""
    if not _well_formed(index, instance_ints, proof):
        return False
    n, nx = index.domain_n, index.nx
    D = len(index.srs.powers) - 1
    coms, ev = proof["coms"], proof["evals"]
    if len(instance_ints) != index.num_instance or instance_ints[0] % R != 1:
        return False
    # replay the chained transcript: every challenge binds everything
    # absorbed before it
    fs = _fs_start(index, instance_ints)
    _fs_absorb(fs, points=(coms["w"], coms["za"], coms["zb"], coms["zc"], coms["m"]))
    alpha = fs.fr_challenge()
    eta = [fs.fr_challenge() for _ in range(3)]
    _fs_absorb(fs, points=(coms["h0"], coms["g"], coms["q"], coms["g_shift"]))
    beta = fs.fr_challenge()
    if alpha != proof["alpha"] or beta != proof["beta"] or eta != list(proof["eta"]):
        return False
    mat_proofs = proof["mat_proofs"]
    _fs_round3_absorb(fs, mat_proofs)
    beta3 = fs.fr_challenge()
    if proof["beta3"] != beta3:
        return False
    _fs_evals_absorb(fs, ev, mat_proofs)
    xi = fs.fr_challenge()
    xi3 = fs.fr_challenge()
    # one batched opening at beta, with the degree bound on g: the g_shift
    # entry's value is beta^(D-(n-2)) * g(beta)
    shift_g = D - (n - 2)
    batch_coms = [coms[name] for name in _BETA_ORDER] + [coms["g_shift"]]
    batch_vals = [ev[name] for name in _BETA_ORDER] + [pow(beta, shift_g, R) * ev["g"] % R]
    if not kzg.verify_batch_open(index.srs, batch_coms, batch_vals, beta, xi,
                                 proof["w_beta"]):
        return False
    v_H_beta = (pow(beta, n, R) - 1) % R
    if (ev["za"] * ev["zb"] - ev["zc"]) % R != ev["h0"] * v_H_beta % R:   # rowcheck
        return False
    # the x/w split: z(beta) from the public inputs
    x_beta = _x_poly_eval_host(index, instance_ints, beta)
    z_beta = (x_beta + (pow(beta, nx, R) - 1) * ev["w"]) % R
    u_ab = _u_H_point(alpha, beta, n)
    # one batched opening at beta3 across the matrices, each
    # deg(g3) <= k - 2 folded in; r*(beta) from the matrix sumchecks
    items_coms, items_vals = [], []
    for mic, mp in zip(index.index_comms, mat_proofs):
        ev3 = mp["evals"]
        index_coms = dict(row=mic.com_row, col=mic.com_col, val=mic.com_val,
                          g3=mp["com_g3"], h3=mp["com_h3"])
        for name in _BETA3_ORDER:
            items_coms.append(index_coms[name])
            items_vals.append(ev3[name] % R)
        items_coms.append(mp["com_g3_shift"])
        items_vals.append(pow(beta3, D - (mic.k_size - 2), R) * ev3["g3"] % R)
    if not kzg.verify_batch_open(index.srs, items_coms, items_vals, beta3, xi3,
                                 proof["w_beta3"]):
        return False
    acc = 0
    for mic, mp, e in zip(index.index_comms, mat_proofs, eta):
        if not _matrix_sumcheck_identity(mic, mp, alpha, beta, beta3):
            return False
        acc = (acc + e * int(mp["sigma"])) % R
    vh_a = (pow(alpha, n, R) - 1) % R
    rstar_b = vh_a * v_H_beta % R * pow(n, -1, R) % R * acc % R
    p_beta = (sum(e * zv for e, zv in zip(eta, (ev["za"], ev["zb"], ev["zc"]))) % R * u_ab
              - rstar_b * z_beta + ev["m"]) % R
    return p_beta == (beta * ev["g"] + v_H_beta * ev["q"]) % R


# ------------------------------------------------- holographic round 3


def _layout_assignment(index: MarlinIndex, cs: ConstraintSystem) -> MpcFp:
    """The full assignment scattered into H slots by ``index.perm``
    (instance on X, witness on H \\ X, the sentinel's zero elsewhere): one
    gather on the limb rows."""
    z = cs.full_assignment()
    z_ext = MpcFp.concat([z, z[0:1].smul(0)], axis=0)
    perm = torch.as_tensor(index.perm, dtype=torch.int64, device=z.value.device)
    return z_ext.map(lambda f: FpArray(f.limbs.index_select(-2, perm), f.spec, f.bound))


def _x_poly(index: MarlinIndex, instance_ints) -> FpArray:
    """Public x-polynomial interpolating [instance..., 0-pad] over X
    (omega_X = omega_H^(n/nx), so X is the subgroup the layout uses)."""
    vals = [int(v) % R for v in instance_ints] + [0] * (index.nx - len(instance_ints))
    return Domain(FR, index.nx, index.device).ifft(_fr(vals, index.device))


def _div_by_vx(z_poly: MpcFp, x_poly: FpArray, nx: int, big: Domain) -> MpcFp:
    """w_hat = (z_poly - x_poly) / v_X, exact (the numerator vanishes on X),
    pointwise on the 2n coset, where v_X(g w^i) = g^nx w^(i nx) - 1 is never
    zero."""
    n2 = big.n
    zx = _apply(_pad_to(z_poly, n2), big.coset_fft) - \
        MpcFp.from_public(big.coset_fft(_pad_to(x_poly, n2)))
    gnx, wnx = pow(big.coset_gen, nx, R), pow(big.omega, nx, R)
    vx, acc = [], gnx
    for _ in range(n2):
        vx.append((acc - 1) % R)
        acc = acc * wnx % R
    w_evals = _scale(zx, _fr(SF.batch_inv(vx, R), big.device))
    # deg(z_poly) = n (the zk mask), so deg(w_hat) = n - nx
    return _slice(_apply(w_evals, big.coset_ifft), n2 // 2 - nx + 1)


def _x_poly_eval_host(index: MarlinIndex, instance_ints, beta: int) -> int:
    """x_poly(beta) from the public inputs (host):
    sum_i x_i * v_X(beta) * omega_X^i / (nx * (beta - omega_X^i))."""
    nx = index.nx
    omega_x = _omega(nx)
    vx_b = (pow(beta, nx, R) - 1) % R
    if vx_b == 0:
        # beta on X (probability ~ nx/p): the matching instance value
        w = 1
        for i in range(nx):
            if w == beta % R:
                xs = list(instance_ints) + [0] * (nx - len(instance_ints))
                return int(xs[i]) % R
            w = w * omega_x % R
        return 0
    total, nx_inv, w = 0, pow(nx, -1, R), 1
    for v in instance_ints:
        li = vx_b * w % R * nx_inv % R * pow((beta - w) % R, -1, R) % R
        total = (total + int(v) * li) % R
        w = w * omega_x % R
    return total


def _mask_vh(poly: MpcFp, generator, n: int, shares=None) -> MpcFp:
    """poly + c * v_H for a fresh shared c: the evaluations on H unchanged,
    an evaluation outside H hidden (`ahp/prover.rs:280`)."""
    c = MS.rand_shared(generator, FR, (1,), shares=shares)
    return _pad_to(poly, n + 1) + _place(c, n, n + 1) - _place(c, 0, n + 1)


def _sum_zero_mask(generator, n: int, shares=None) -> MpcFp:
    """Random shared polynomial of degree n with sum_H m = 0 (the sumcheck
    mask, `ahp/prover.rs:371-376`): sum_H m = n (m_0 + m_n), so m_n = -m_0."""
    m = MS.rand_shared(generator, FR, (n + 1,), shares=shares)
    return MpcFp.concat([m[0:1], m[1:n], -m[0:1]], axis=0)


def _vanish_n_inv_on_coset(big: Domain, n: int) -> FpArray:
    """1 / v_{H_n}(x) on the coset of the 2n domain: x = g w_{2n}^i gives
    x^n = g^n (-1)^i, so the values alternate between two constants."""
    gn = pow(big.coset_gen, n, R)
    even, odd = pow((gn - 1) % R, -1, R), pow((R - gn - 1) % R, -1, R)
    return _fr([even, odd] * n, big.device)


def _matrix_sumcheck_prove(dsrs: kzg.DeviceKzgSrs, mics, alpha: int, beta: int,
                           D: int) -> list:
    """For each matrix, the univariate sumcheck over its index domain K of
    sigma = sum_K val * col / ((alpha - row)(beta - col)): the committed
    identity val col - (alpha - row)(beta - col)(X g3 + sigma/|K|) =
    h3 v_K.  Public data only; the nine commitments in one MSM call."""
    out, items = [], []
    for mic in mics:
        k = mic.k_size
        dev = mic.row_poly.device
        row_pts, col_pts, vals = mic.entries
        dens = SF.batch_inv([(alpha - rw) % R * ((beta - cl) % R) % R
                             for rw, cl in zip(row_pts, col_pts)], R)
        f_evals = [v * cl % R * d % R for v, cl, d in zip(vals, col_pts, dens)]
        sigma = sum(f_evals) % R
        f_poly = Domain(FR, k, dev).ifft(_fr(f_evals, dev))     # f_0 = sigma / |K|
        g3 = f_poly[1:k]                                          # (f - f_0) / X
        dom4 = Domain(FR, 4 * k, dev)
        rcvf = dom4.fft(_pad_to(FpArray.stack(
            [mic.row_poly, mic.col_poly, mic.val_poly, f_poly], 0), 4 * k))
        rowb, colb, valb, fb = (rcvf[i] for i in range(4))
        a_ev = valb * colb
        b_ev = (_fr(alpha, dev) - rowb) * (_fr(beta, dev) - colb)
        q = dom4.ifft(a_ev - b_ev * fb)          # deg <= 3k - 3, vanishes on K
        # divide by v_K = X^k - 1: q = q0 + X^k q1 + X^2k q2 + X^3k q3 ->
        # h = (q1 + q2 + q3) + X^k (q2 + q3) + X^2k q3; q3 = 0, so
        # deg h <= 2k - 3 and 2k - 1 coefficients are kept
        q1, q2, q3 = q[k:2 * k], q[2 * k:3 * k], q[3 * k:]
        h1 = q2 + q3
        h3 = FpArray.concat([q1 + h1, h1], 0)[:2 * k - 1]
        out.append(dict(sigma=sigma, g3_poly=g3, h3_poly=h3, k=k))
        items += [(g3, 0), (h3, 0), (g3, D - (k - 2))]
    pts = _public_commits(dsrs, items)
    for j, mp in enumerate(out):
        mp["com_g3"], mp["com_h3"], mp["com_g3_shift"] = pts[3 * j:3 * j + 3]
    return out


def _matrix_sumcheck_identity(mic: MatrixIndexComms, mp: dict, alpha: int, beta: int,
                              beta3: int) -> bool:
    """The committed sumcheck identity at beta3 from the published
    evaluations (the openings are checked in the batched check)."""
    k = mic.k_size
    ev3 = mp["evals"]
    sigma = int(mp["sigma"]) % R
    vk_b3 = (pow(beta3, k, R) - 1) % R
    lhs = (ev3["val"] * ev3["col"]
           - (alpha - ev3["row"]) % R * ((beta - ev3["col"]) % R) % R
           * ((beta3 * ev3["g3"] + sigma * pow(k, -1, R)) % R)) % R
    return lhs == ev3["h3"] * vk_b3 % R


# ---------------------------------------------------------------- internals


def _shift_block(x: MpcFp, k: int) -> MpcFp:
    """Drop the first k coefficients: out_i = x_{i+k}."""
    return _apply(x, lambda fp: FpArray(fp.limbs[..., k:, :], fp.spec, fp.bound))


def _shift_down(x: MpcFp) -> MpcFp:
    def f(fp: FpArray):
        return FpArray(torch.cat([fp.limbs[..., 1:, :], torch.zeros_like(fp.limbs[..., :1, :])],
                                 dim=-2), fp.spec, fp.bound)
    return _apply(x, f)


def _scale(x: MpcFp, c: FpArray) -> MpcFp:
    return _apply(x, lambda f: f * c)


def _lincomb(xs, coeffs) -> MpcFp:
    acc = None
    for x, c in zip(xs, coeffs):
        term = _scale(x, c)
        acc = term if acc is None else acc + term
    return acc


def _u_H_row(alpha: int, dom: Domain) -> FpArray:
    """Evaluations over H of u_H(alpha, X) = (v_H(alpha) - v_H(X)) / (alpha
    - X): on H, v_H(X) = 0, so u_H(alpha, h) = v_H(alpha) / (alpha - h)."""
    n = dom.n
    vh_a = (pow(alpha, n, R) - 1) % R
    ws, w = [], 1
    for _ in range(n):
        ws.append((alpha - w) % R)
        w = w * dom.omega % R
    return _fr([vh_a * iv % R for iv in SF.batch_inv(ws, R)], dom.device)


def _u_H_point(alpha: int, beta: int, n: int) -> int:
    if alpha == beta:
        return n * pow(alpha, n - 1, R) % R
    va = (pow(alpha, n, R) - 1) % R
    vb = (pow(beta, n, R) - 1) % R
    return (va - vb) * pow((alpha - beta) % R, -1, R) % R


def _rstar_evals(index: MarlinIndex, u_alpha: FpArray, eta, n) -> FpArray:
    """Public evaluations over H of sum_M eta_M (M^T r_alpha): r*(h) =
    sum_rows u_alpha[row] * M[row, h] (host; the matrices are public)."""
    ua = [int(x) for x in u_alpha.to_ints().reshape(-1)]
    out = [0] * n
    for (rows, cols, coeffs), e in zip(index.matrices, eta):
        for r_i, c_i, coef in zip(rows.tolist(), cols.tolist(), coeffs):
            out[c_i] = (out[c_i] + e * ua[r_i] % R * int(coef)) % R
    return _fr(out, u_alpha.device)

