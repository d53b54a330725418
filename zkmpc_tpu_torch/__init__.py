"""PyTorch/CUDA port of the collaborative zk-SNARK + MPC engine.

Mirrors the layout of ``zkmpc_tpu`` (``ops/``, ``mpc/``, ``parallel/``,
``snark/``): each module here sits at the same relative path as the JAX
module it is held against.  Limb tensors are ``int64``; the hot field and
point kernels are hand-written CUDA (``csrc/``) with plain PyTorch twins
that run on the CPU.  The package never imports ``jax``; the pure-Python
modules ``zkmpc_tpu.params``, ``zkmpc_tpu.spec.*`` and ``zkmpc_tpu.compat.*``
are imported directly.
"""

__version__ = "0.1.0"
