"""The rank runner: one OS process a party in a ``torch.distributed``
process group, each with a `transport.MeshTransport` in scope (the
counterpart of the JAX package's ``shard_map`` over a "parties" mesh
axis), and a rank's part of the wide-mul Groth16 prove over it (the
counterpart of ``__graft_entry__.dryrun_multichip`` with one chip a
party): the parent writes the key with `write_key`, then runs
`prove_rank` in every rank.

`run_parties` spawns the ranks (start method ``spawn``), joins them
through a ``TCPStore`` that the parent serves on a free localhost port,
and returns each rank's result.  The backend is named by the caller:
``"gloo"`` (collectives through the host, any number of ranks on one
device or on the CPU) or ``"nccl"`` (one CUDA device a rank; ranks that
share one are refused).  A rank that raises, exits or outlives
``timeout_s`` makes the parent kill the others and raise `RankFailed`
with the rank's traceback: nothing hangs.  On a CUDA device the parent
builds the kernels before it spawns; the ranks only load them
(`ops.build.LOAD_ONLY`).  No rank may import JAX or the JAX package: a
rank that did fails.

    results = run_parties(fn, 3, device="cuda:0", backend="gloo", timeout_s=300)

calls ``fn(transport, *args)`` in each rank and returns the results by
rank (picklable values; tensors come back on the CPU).
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from . import transport as T

#: top-level modules no rank may load
FORBIDDEN = ("jax", "jaxlib", "zkmpc_tpu")
#: seconds between the parent's looks at its ranks
POLL_S = 0.05


class RankFailed(RuntimeError):
    """A rank raised, died or timed out; the message holds its traceback."""


def forbidden_modules() -> list:
    """The loaded modules of `FORBIDDEN` (a rank must have none)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _write(path: str, obj) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def _rank_main(rank, n, port, backend, device, timeout_s, fn, args, outdir):
    """A rank: join the group, run fn under its MeshTransport, write the
    result (or, at once, the traceback) into ``outdir``."""
    import torch.distributed as dist
    try:
        from ..ops import build
        build.LOAD_ONLY = True
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        timeout = datetime.timedelta(seconds=timeout_s)
        store = dist.TCPStore("127.0.0.1", port, n, is_master=False, timeout=timeout)
        dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                                timeout=timeout)
        t = T.MeshTransport(None, dev)
        with T.scope(t):
            out = fn(t, *args)
        bad = forbidden_modules()
        if bad:
            raise AssertionError(f"rank {rank} imported JAX or the JAX package: {bad[:5]}")
        _write(os.path.join(outdir, f"rank{rank}.pkl"), _to_cpu(out))
    except BaseException:
        # written before the group goes down, the time first: the parent
        # reports the rank that failed first, not the peers that lost it
        with open(os.path.join(outdir, f"rank{rank}.err"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _first_failure(outdir: str, procs, failed: int, where: str) -> str:
    """The report of the rank that failed first (by the time its traceback
    was written; a rank that died without one counts as ``failed``),
    naming the others that failed."""
    errs = {}
    for r in range(len(procs)):
        path = os.path.join(outdir, f"rank{r}.err")
        if os.path.exists(path):
            when, _, tb = open(path).read().partition("\n")
            errs[r] = (float(when), tb)
    first = min(errs, key=lambda r: errs[r][0]) if errs else failed
    tb = errs[first][1] if first in errs else "(no traceback: the process died)"
    others = sorted(set(errs) - {first})
    return (f"rank {first} of {len(procs)} failed first, exit code {procs[first].exitcode} "
            f"({where})" + (f"; ranks {others} failed after it" if others else "")
            + f":\n{tb}")


def run_parties(fn, n_parties: int, device="cuda", backend: str | None = None,
                timeout_s: float = 600.0, args=()) -> list:
    """Run ``fn(transport, *args)`` in ``n_parties`` ranks, one process a
    party, each with a `MeshTransport` over ``backend`` on ``device`` in
    scope; returns the results by rank.  ``fn`` and ``args`` must be
    picklable (a module-level function).  Raises `RankFailed`, after
    killing every rank still alive, when a rank fails or the ranks do not
    all finish within ``timeout_s`` seconds."""
    if backend is None:
        raise ValueError("run_parties needs its backend named: 'gloo' or 'nccl'")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device()
                           if torch.cuda.is_available() else 0)
    T.check_backend(backend, [dev] * n_parties)
    if dev.type == "cuda":
        from ..ops import build
        build.build()                    # the ranks only load the library
    import torch.distributed as dist
    import torch.multiprocessing as mp
    store = dist.TCPStore("127.0.0.1", 0, n_parties, is_master=True,
                          timeout=datetime.timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="zkmpc_mesh_") as outdir:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n_parties, store.port, backend, str(dev), timeout_s,
                                   fn, tuple(args), outdir))
                 for r in range(n_parties)]
        for p in procs:
            p.start()
        t_end = time.time() + timeout_s
        failed = None
        try:
            while True:
                codes = [p.exitcode for p in procs]
                failed = next((r for r, c in enumerate(codes) if c not in (None, 0)), None)
                if failed is not None or all(c == 0 for c in codes):
                    break
                if time.time() > t_end:
                    alive = [r for r, c in enumerate(codes) if c is None]
                    raise RankFailed(f"ranks {alive} of {n_parties} did not finish within "
                                     f"{timeout_s} s ({backend} on {dev})")
                time.sleep(POLL_S)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join()
        if failed is not None:
            raise RankFailed(_first_failure(outdir, procs, failed, f"{backend} on {dev}"))
        out = []
        for r in range(n_parties):
            with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


# ------------------------------------------------------- the wide-mul prove


def write_key(dpk, path: str) -> None:
    """The proving key in its host layout (`snark.driver.dpk_to_host`) to
    ``path``, written under another name and renamed into place."""
    from ..snark import driver
    _write(path, driver.dpk_to_host(dpk))


def prove_rank(t: T.Transport, key_path: str, a_limbs, b_limbs, seed=None, r=None,
               s=None) -> dict:
    """One party's share of the wide-mul prove, in a rank: load the key
    from ``key_path`` onto ``t.device``, take this rank's rows of the gate
    inputs ``a_limbs``/``b_limbs`` (every party's shares, [P, n, nlimbs]
    int64 limbs) and prove with this party's private ``seed``
    (`mpc.rand.PartyGenerators`), or with injected r and s shares
    ((limbs [P, nlimbs], bound) each).  Returns the opened proof as
    affine ints and the rank's seconds, openings and bytes."""
    from ..mpc import rand as R
    from ..ops.limbs import FR, FpArray
    from ..snark import driver
    dev = t.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    t0 = time.time()
    with open(key_path, "rb") as f:
        dpk = driver.dpk_from_host(pickle.load(f), dev)
    step, _ = driver.make_prove_fn(dpk, t.n_parties)
    sync()
    t1 = time.time()

    def limbs(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int64)).to(dev)

    def shares(x):
        return None if x is None else FpArray(limbs(x[0]), FR, x[1])
    gen = None if seed is None else R.PartyGenerators(t.row_ids, [seed], dev)
    rounds, nbytes = t.stats.rounds, t.stats.bytes_moved
    outs = step(limbs(a_limbs), limbs(b_limbs), gen, r=shares(r), s=shares(s), transport=t)
    proof = driver.proof_arrays_to_ints(outs)
    sync()
    return dict(proof=proof, load_s=t1 - t0, prove_s=time.time() - t1,
                openings=t.stats.rounds - rounds, bytes=t.stats.bytes_moved - nbytes,
                on_device=all(x.device.type == dev.type for x in outs))

