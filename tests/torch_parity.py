"""Helpers for the parity tests of the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; values
cross between them as numpy arrays (uint32 limbs on the JAX side, int64 on
the port's).
"""

from __future__ import annotations

import numpy as np
import torch

from zkmpc_tpu.ops import curve as JC
from zkmpc_tpu.ops import fp2 as JF2
from zkmpc_tpu.ops import limbs as JL
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


def point_leaves_np(p) -> list:
    """Coordinate limbs (int64 numpy) and the infinity mask of a port point."""
    return [limbs_np(leaf) if leaf.dtype != torch.bool else leaf.numpy()
            for leaf in p.leaves()]
