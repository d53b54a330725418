"""R1CS -> QAP witness map (the Groth16 prover's field-side hot path).

Port of ``zkmpc_tpu/snark/qap.py``: evaluate the constraint rows (sparse
matvec on shares), iFFT -> coset FFT, one batched Beaver multiplication for
a*b, divide by the vanishing polynomial on the coset (a constant scale),
coset iFFT.  The sparse matvec is a gather + ``index_add_`` segment sum on
int64 limbs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mpc.share import SHARED, MpcFp
from ..ops.limbs import FpArray, _resolve2
from ..ops.ntt import Domain


class DeviceMatrix:
    """COO sparse matrix with field coefficients on ``device``."""

    # max entries in one raw-limb segment sum: CHUNK * 2^15 < 2^26 keeps the
    # columns inside the carry-resolution headroom
    CHUNK = 1024

    def __init__(self, spec, rows, cols, coeffs_int, n_rows, max_row_nnz,
                 device="cuda"):
        self.spec = spec
        self.device = torch.device(device)
        self.rows = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=device)
        self.cols = torch.as_tensor(np.asarray(cols, dtype=np.int64), device=device)
        self.coeffs = FpArray.from_int(spec, np.asarray(coeffs_int, dtype=object),
                                       device=device)
        self.n_rows = n_rows
        self.max_row_nnz = max_row_nnz

    @classmethod
    def from_coo(cls, spec, coo, n_rows, device="cuda"):
        rows, cols, coeffs = coo
        rows = np.asarray(rows, dtype=np.int64)
        max_nnz = int(np.bincount(rows).max()) if len(rows) else 1
        assert 2 * max_nnz <= spec.mul_bound_budget, "row too dense for field"
        self = cls(spec, rows, cols, coeffs, n_rows, max_nnz, device)
        # occurrence index of each entry within its row -> chunk ids for the
        # two-level accumulation of dense rows
        occ = np.zeros(len(rows), dtype=np.int64)
        if len(rows):
            order = np.argsort(rows, kind="stable")
            sorted_rows = rows[order]
            starts = np.searchsorted(sorted_rows, sorted_rows, side="left")
            occ[order] = np.arange(len(rows)) - starts
        self.nchunks = max(1, -(-max_nnz // cls.CHUNK))
        self.seg1 = torch.as_tensor(rows * self.nchunks + occ // cls.CHUNK,
                                    device=device)
        return self

    def matvec(self, z: MpcFp) -> MpcFp:
        """A @ z for a shared assignment z [m] -> shared [n_rows]."""
        assert z.visibility == SHARED
        return z.map(lambda f: _gather_scale_segsum(self, f.tighten()))


def _gather_scale_segsum(mat: DeviceMatrix, zv: FpArray) -> FpArray:
    """Two-level segmented accumulation: raw limb sums stay within carry
    headroom per chunk (<= CHUNK entries), then the chunk partials
    (carry-resolved limbs) combine per row."""
    spec = mat.spec
    gathered = FpArray(zv.limbs.index_select(-2, mat.cols), spec, zv.bound)
    scaled = gathered * mat.coeffs                  # [..., nnz] bound 2
    limbs = torch.movedim(scaled.limbs, -2, 0)      # [nnz, ..., nl]
    part = torch.zeros((mat.n_rows * mat.nchunks,) + tuple(limbs.shape[1:]),
                       dtype=limbs.dtype, device=limbs.device)
    part.index_add_(0, mat.seg1, limbs)
    part = torch.movedim(part, 0, -2)               # [..., rows*chunks, nl]
    part = _resolve2(part)[..., :spec.nlimbs]       # limbs <= B
    if mat.nchunks > 1:
        shape = part.shape[:-2] + (mat.n_rows, mat.nchunks, spec.nlimbs)
        part = _resolve2(part.reshape(shape).sum(dim=-2))[..., :spec.nlimbs]
    return FpArray(part, spec, 2 * mat.max_row_nnz)


def witness_map(spec, matrices, z: MpcFp, domain: Domain, num_instance: int,
                num_constraints: int):
    """-> h coefficients [domain.n - 1] as a shared MpcFp.

    ``matrices`` = (A, B, C) DeviceMatrix with n_rows = domain.n.  A also
    gets rows a[num_constraints + j] = z[j] for instance j (input
    consistency, the ark/libsnark convention).
    """
    A, Bm, Cm = matrices
    az = A.matvec(z)
    bz = Bm.matvec(z)
    cz = Cm.matvec(z)
    az = _set_rows(az, z, num_constraints, num_instance)

    a_coset = _to_coset(az, domain)
    b_coset = _to_coset(bz, domain)
    c_coset = _to_coset(cz, domain)

    ab = a_coset * b_coset          # batched Beaver mul (one comms round)
    hv = ab - c_coset
    h_evals = hv.map(lambda f: f * domain._vanish_inv_fp)
    h = h_evals.map(domain.coset_ifft)
    return h[:domain.n - 1]


def _set_rows(az: MpcFp, z: MpcFp, offset: int, count: int) -> MpcFp:
    """az[offset + j] = z[j] for j < count (a slice copy)."""
    def upd(dst: FpArray, src: FpArray) -> FpArray:
        limbs = dst.limbs.clone()
        limbs[..., offset:offset + count, :] = src.limbs[..., :count, :]
        return FpArray(limbs, dst.spec, max(dst.bound, src.bound))
    mac = None if az.mac is None else upd(az.mac, z.mac)
    return MpcFp(upd(az.value, z.value), SHARED, mac)


def _to_coset(x: MpcFp, domain: Domain) -> MpcFp:
    return x.map(lambda f: domain.coset_fft(domain.ifft(f)))
