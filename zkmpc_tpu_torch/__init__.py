"""PyTorch/CUDA port of the collaborative zk-SNARK + MPC engine.

Mirrors the layout of ``zkmpc_tpu`` (``ops/``, ``mpc/``, ``parallel/``,
``snark/``): each module here sits at the same relative path as the JAX
module it is held against.  Limb tensors are ``int64``; the hot field and
point kernels are hand-written CUDA (``csrc/``) with plain PyTorch twins
that run on the CPU.  The package imports neither ``jax`` nor anything of
``zkmpc_tpu``: ``params``, ``spec/`` and ``compat/`` are its own copies of
the pure-Python modules it needs.  Entry points that take ``device=`` run on
the CUDA card unless the caller names another device.
"""

__version__ = "0.1.0"
