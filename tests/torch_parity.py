"""Helpers for the parity tests of the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; values
cross between them as numpy arrays (uint32 limbs on the JAX side, int64 on
the port's).
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from zkmpc_tpu.ops import curve as JC
from zkmpc_tpu.ops import fp2 as JF2
from zkmpc_tpu.ops import limbs as JL
from zkmpc_tpu_torch.mpc import bits as TB
from zkmpc_tpu_torch.ops import curve as TC
from zkmpc_tpu_torch.ops import fp2 as TF2
from zkmpc_tpu_torch.ops import limbs as TL

# the port's entry points default to the CUDA card; the CPU tests name the CPU
CPU = torch.device("cpu")

SPECS = {s.name: (getattr(JL, k), s) for k, s in
         (("FR", TL.FR), ("FQ", TL.FQ), ("EDFR", TL.EDFR), ("MNT4Q", TL.MNT4Q))}


def jspec(tspec):
    return SPECS[tspec.name][0]


def rand_ints(rng: np.random.Generator, p: int, n: int) -> list:
    """n uniform ints below p from a numpy generator (256-bit draws)."""
    words = rng.integers(0, 2**63, size=(n, (p.bit_length() + 62) // 63 + 1))
    out = []
    for row in words:
        x = 0
        for w in row:
            x = (x << 63) | int(w)
        out.append(x % p)
    return out


def limbs_np(limbs) -> np.ndarray:
    """Either package's limb array -> int64 numpy."""
    if isinstance(limbs, torch.Tensor):
        return limbs.numpy()
    return np.array(limbs, dtype=np.int64)


def fp_to_torch(x) -> TL.FpArray:
    """JAX FpArray -> port FpArray (same limbs, spec and bound)."""
    spec = SPECS[x.spec.name][1]
    return TL.FpArray(torch.as_tensor(limbs_np(x.limbs)), spec, x.bound)


def fp_to_jax(x: TL.FpArray):
    return JL.FpArray(limbs_np(x.limbs).astype(np.uint32), jspec(x.spec), x.bound)


def coord_to_torch(c):
    if isinstance(c, JF2.Fp2Array):
        return TF2.Fp2Array(fp_to_torch(c.c0), fp_to_torch(c.c1))
    return fp_to_torch(c)


def coord_to_jax(c):
    if isinstance(c, TF2.Fp2Array):
        return JF2.Fp2Array(fp_to_jax(c.c0), fp_to_jax(c.c1))
    return fp_to_jax(c)


def point_to_torch(p) -> TC.SWPoint:
    return TC.SWPoint(coord_to_torch(p.x), coord_to_torch(p.y),
                      coord_to_torch(p.z), torch.as_tensor(np.array(p.inf)))


def point_to_jax(p: TC.SWPoint):
    import jax.numpy as jnp
    return JC.SWPoint(coord_to_jax(p.x), coord_to_jax(p.y), coord_to_jax(p.z),
                      jnp.asarray(p.inf.numpy()))


def te_point_to_torch(p) -> TC.TEPoint:
    """JAX TEPoint -> port TEPoint (the same limbs and bounds)."""
    return TC.TEPoint(*(fp_to_torch(c) for c in (p.x, p.y, p.t, p.z)))


def te_point_to_jax(p: TC.TEPoint):
    return JC.TEPoint(*(fp_to_jax(c) for c in p.coords()))


def point_leaves_np(p) -> list:
    """Coordinate limbs (int64 numpy) and the infinity mask of a port point."""
    return [limbs_np(leaf) if leaf.dtype != torch.bool else leaf.numpy()
            for leaf in p.leaves()]


def check_circuit(cs, fx, n_parties=3):
    """A port ConstraintSystem against one circuit the JAX package recorded
    (``fixtures/make_torch_pedersen_fixture.record``): counts, matrices,
    instance and the opened full assignment, and that it is satisfied."""
    from zkmpc_tpu_torch.mpc.share import MpcContext, mpc_scope
    from zkmpc_tpu_torch.parallel.transport import StackedTransport
    assert fx["counts"] == {"num_instance": cs.num_instance,
                            "num_witness": cs.num_witness,
                            "constraints": len(cs.constraints)}
    for got, want in zip(cs.matrices(), fx["matrices"]):
        assert [got[0].tolist(), got[1].tolist(), [int(v) for v in got[2]]] == want
    with mpc_scope(MpcContext(StackedTransport(n_parties, CPU), "semi")):
        assert cs.instance_ints() == fx["instance"]
        z = [int(v) for v in cs.full_assignment().reveal().to_ints()[0]]
        assert z == fx["assignment"]
        assert cs.is_satisfied_ints()


#: candidates of `mpc.bits.rand_number_bitwise` in the tests' circuits (the
#: library's default is 16): the matrices, instance and opened assignment
#: of a circuit, and every opened output, do not depend on them, and the
#: prefix-product loop over the candidates still runs two levels
ATTEMPTS = 4


@contextlib.contextmanager
def fewer_attempts(n: int = ATTEMPTS):
    """Within the block, the bit protocols draw ``n`` candidates for each
    random bitwise-shared value, whatever their callers ask for."""
    orig = TB.rand_number_bitwise

    def draw(generator, spec, shape=(), attempts=16, raw=None):
        return orig(generator, spec, shape, n, raw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TB, "rand_number_bitwise", draw)
        yield
