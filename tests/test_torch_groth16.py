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
from zkmpc_tpu_torch.snark.r1cs import ConstraintSystem

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


def test_toxic_waste_redraws_degenerate_elements(monkeypatch):
    """A normal seed gives the JAX package's trapdoor; a stream whose draws
    are 0, or a tau on the domain's roots of unity, is redrawn from."""
    from zkmpc_tpu.compat import ark as JA
    from zkmpc_tpu.snark import groth16 as JG
    from zkmpc_tpu_torch.compat import ark as TA
    for seed in (0, 1, 7):
        assert groth16._toxic_waste(seed, 8) == JG._toxic_waste(seed)
    rng = TA.seeded_rng(3)
    real = [TA.fr_rand(rng) for _ in range(5)]
    assert JA.fr_rand(JA.seeded_rng(3)) == real[0]
    omega = pow(FR.generator, (FR.p - 1) // 8, FR.p)             # order 8
    stream = iter([0, real[0], real[1], 0, real[2], real[3], 1, omega, 0, real[4]])
    monkeypatch.setattr(groth16.A_, "fr_rand", lambda rng: next(stream))
    assert groth16._toxic_waste(3, 8) == tuple(real)
    assert next(stream, None) is None


def test_proving_key_from_plain_fields():
    """pk_from_host rebuilds the key from the fixture's plain ints."""
    fx = MK.load(np.load(MK.PATH))
    pk = driver.pk_from_host(fx["doc"]["pk"])
    assert isinstance(pk, groth16.ProvingKey)
    assert pk.domain_n == 8 and pk.num_instance == 2      # 5 constraints + 2 inputs
    assert pk.num_witness == 3 * MK.N_GATES
    assert len(pk.a_query) == pk.num_instance + pk.num_witness
    assert isinstance(pk.vk.beta_g2[0], tuple)


def test_prove_needs_a_generator_or_r_and_s():
    """No blinding is drawn from a fixed seed: a prove given neither a
    generator nor both injected r and s shares raises before any work."""
    fx = MK.load(np.load(MK.PATH))
    dpk = driver.dpk_from_host(fx["doc"], CPU)
    r = FpArray(torch.as_tensor(fx["r"][0].astype(np.int64)), FR, fx["r"][1])
    for kw in ({}, {"r": r}, {"s": r}):
        with pytest.raises(ValueError, match="generator or injected r and s"):
            groth16.prove(dpk, ConstraintSystem(FR), **kw)
