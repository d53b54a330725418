"""The port's collaborative Groth16 prove (the wide-mul slice at 3 parties)
against the JAX package.

A live JAX prove takes minutes on a CPU, so the tier-1 test uses a fixture
the JAX package wrote (`fixtures/make_torch_slice_fixture.py`): its proving
key, the r/s shares it drew and its opened proof.  Given the same key and
shares the port must produce the same proof, exactly.
"""

import numpy as np
import pytest
import torch

from fixtures import make_torch_slice_fixture as MK
from torch_parity import CPU
from zkmpc_tpu.ops import limbs as JL
from zkmpc_tpu.snark import qap as JQ
from zkmpc_tpu_torch.ops.limbs import FR, FpArray
from zkmpc_tpu_torch.snark import driver, groth16
from zkmpc_tpu_torch.snark import qap as TQ

torch.set_num_threads(1)


def _prove_fixture(fx):
    dpk = driver.dpk_from_host(fx["doc"], CPU)
    step, args = driver.make_prove_fn(dpk, MK.N_PARTIES)

    def share(name):
        limbs, bound = fx[name]
        return FpArray(torch.as_tensor(limbs.astype(np.int64)), FR, bound)
    outs = step(*args, r=share("r"), s=share("s"))
    return dpk, driver.proof_arrays_to_ints(outs)


def _check_slice(fx):
    dpk, proof = _prove_fixture(fx)
    assert proof == fx["proof"]
    inst = driver.expected_instance(MK.N_GATES)
    assert groth16.verify(dpk.pk.vk, inst, proof)
    bad = [inst[0], (inst[1] + 1) % FR.p]
    assert not groth16.verify(dpk.pk.vk, bad, proof)


def test_slice_proof_equals_reference_proof():
    _check_slice(MK.load(np.load(MK.PATH)))


@pytest.mark.slow
def test_slice_against_live_reference_prove():
    """Regenerates the fixture from the JAX package (minutes on a CPU) and
    holds the port against it again."""
    _check_slice(MK.load(MK.generate()))


def test_device_matrix_segments_match_reference():
    """The sparse matvec's two-level segment ids (dense rows split into
    1024-entry chunks) equal the reference's."""
    rng = np.random.default_rng(31)
    rows = np.concatenate([np.zeros(2500, np.int64), rng.integers(1, 40, 300)])
    rng.shuffle(rows)
    cols = rng.integers(0, 50, rows.size)
    coeffs = np.asarray([int(c) for c in rng.integers(1, 1000, rows.size)], dtype=object)
    ref = JQ.DeviceMatrix.from_coo(JL.FR, (rows, cols, coeffs), 64)
    got = TQ.DeviceMatrix.from_coo(FR, (rows, cols, coeffs), 64, CPU)
    assert got.nchunks == ref.nchunks == 3
    assert got.max_row_nnz == ref.max_row_nnz
    np.testing.assert_array_equal(got.seg1.numpy(), ref.seg1)


def test_proving_key_from_plain_fields():
    """pk_from_host rebuilds the key from the fixture's plain ints."""
    fx = MK.load(np.load(MK.PATH))
    pk = driver.pk_from_host(fx["doc"]["pk"])
    assert isinstance(pk, groth16.ProvingKey)
    assert pk.domain_n == 8 and pk.num_instance == 2      # 5 constraints + 2 inputs
    assert pk.num_witness == 3 * MK.N_GATES
    assert len(pk.a_query) == pk.num_instance + pk.num_witness
    assert isinstance(pk.vk.beta_g2[0], tuple)
