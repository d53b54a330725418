"""The port's field layer (`zkmpc_tpu_torch.ops.limbs`, `cuda_fp`, `fp2`)
against the JAX package on the same inputs.

Tolerance is exact everywhere: this is modular integer arithmetic, and the
port keeps the reference's limb algorithm and bound rules, so the limbs
themselves must match (not only the values they stand for).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from torch_parity import CPU, fp_to_torch, jspec, limbs_np, rand_ints
from zkmpc_tpu.ops import fp2 as JF2
from zkmpc_tpu.ops import limbs as JL
from zkmpc_tpu.ops.pallas_fp import mont_mul_pallas
from zkmpc_tpu_torch.ops import build as K
from zkmpc_tpu_torch.ops import cuda_fp
from zkmpc_tpu_torch.ops import fp2 as TF2
from zkmpc_tpu_torch.ops import limbs as TL

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = [TL.FR, TL.FQ, TL.MNT4Q]
IDS = [s.name for s in FIELDS]


def _pair(spec, n, seed):
    rng = np.random.default_rng(seed)
    xs, ys = rand_ints(rng, spec.p, n), rand_ints(rng, spec.p, n)
    js = jspec(spec)
    a = JL.FpArray.from_int(js, np.asarray(xs, dtype=object))
    b = JL.FpArray.from_int(js, np.asarray(ys, dtype=object))
    return xs, ys, a, b


@pytest.mark.parametrize("spec", [TL.FR, TL.FQ, TL.EDFR, TL.MNT4Q],
                         ids=lambda s: s.name)
def test_field_spec_tables_match(spec):
    ref = jspec(spec)
    assert spec.nlimbs == ref.nlimbs and spec.R == ref.R
    for name in ("p_limbs", "pprime_limbs", "one_limbs", "int_one_limbs",
                 "r2_limbs"):
        np.testing.assert_array_equal(getattr(spec, name), getattr(ref, name))
    assert spec.mul_bound_budget == ref.mul_bound_budget
    assert spec.max_bound == ref.max_bound
    for bound in (1, 2, 3, 6, 16, 40):
        d, k = spec.sub_digits(bound)
        rd, rk = ref.sub_digits(bound)
        assert k == rk
        np.testing.assert_array_equal(d, rd)


@pytest.mark.parametrize("spec", FIELDS, ids=IDS)
def test_mont_mul_plain_matches_xla_path(spec):
    """Canonical, relaxed (bound 2) and constant-b operands: the plain twin
    of K1 gives the XLA path's limbs bit for bit."""
    xs, ys, a, b = _pair(spec, 37, seed=1)
    js = jspec(spec)
    a2 = a + a                                        # relaxed limbs, bound 2
    cases = [(a.limbs, b.limbs), (a2.limbs, b.limbs),
             (a2.limbs, np.asarray(b.limbs)[5])]      # 1-D constant b
    for la, lb in cases:
        want = np.asarray(jax.jit(JL._mont_mul_limbs, static_argnums=0)(js, la, lb))
        got = cuda_fp.mont_mul(spec, torch.as_tensor(limbs_np(la)),
                               torch.as_tensor(limbs_np(lb)))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    got = TL.FpArray(cuda_fp.mont_mul_plain(
        spec, fp_to_torch(a2).limbs, fp_to_torch(b).limbs), spec, 2).to_ints()
    assert list(got) == [2 * x * y % spec.p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("spec", [TL.FR, TL.FQ], ids=["bls12_377_fr", "bls12_377_fq"])
def test_mont_mul_plain_matches_pallas_interpret(spec):
    _, _, a, b = _pair(spec, 9, seed=2)
    a2 = a + a
    want = np.asarray(mont_mul_pallas(jspec(spec), np.asarray(a2.limbs),
                                      np.asarray(b.limbs), "interpret"))
    got = cuda_fp.mont_mul_plain(spec, fp_to_torch(a2).limbs, fp_to_torch(b).limbs)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("spec", [TL.FR, TL.MNT4Q], ids=["bls12_377_fr", "mnt4_753_fq"])
def test_mont_mul_plain_chunks_equal_one_pass(spec):
    """Past PLAIN_CHUNK rows the plain twin runs in chunks on a CPU: the
    same limbs as one pass over the whole batch, for operands of one shape
    and for a row of constants broadcast against a [3, k] batch."""
    k = cuda_fp.PLAIN_CHUNK // 2 + 7                  # 3k rows: a full chunk and a part
    rng = np.random.default_rng(4)
    a = TL.FpArray.from_int(spec, np.asarray(rand_ints(rng, spec.p, 3 * k), dtype=object)
                            .reshape(3, k), device=CPU)
    b = TL.FpArray.from_int(spec, np.asarray(rand_ints(rng, spec.p, k), dtype=object),
                            device=CPU)
    a2 = a + a                                        # relaxed limbs, bound 2
    for la, lb in ((a2.limbs, (a + a).limbs), (a2.limbs, b.limbs)):
        got = cuda_fp.mont_mul_plain(spec, la, lb)
        assert got.shape == (3, k, spec.nlimbs)
        assert torch.equal(got, cuda_fp._mont_mul_rows(spec, la, lb))


def test_wrappers_use_plain_twin_on_cpu_and_refuse_cpu_tensors_for_kernel():
    spec = TL.FQ
    _, _, a, b = _pair(spec, 4, seed=3)
    ta, tb = fp_to_torch(a).limbs, fp_to_torch(b).limbs
    K.reset_launches()
    assert torch.equal(cuda_fp.mont_mul(spec, ta, tb),
                       cuda_fp.mont_mul_plain(spec, ta, tb))
    assert sum(K.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        cuda_fp.mont_mul_cuda(spec, ta, tb)


def test_fparray_ops_match_reference():
    """+, -, *, smul, neg, tighten, inv (scanned pow), canonical limbs,
    integer limbs and zero tests give the reference's limbs and bounds."""
    spec = TL.FR
    xs, ys, a, b = _pair(spec, 6, seed=4)
    xs[2] = 0
    a = JL.FpArray.from_int(JL.FR, np.asarray(xs, dtype=object))
    ta, tb = fp_to_torch(a), fp_to_torch(b)

    def same(t, j):
        assert t.bound == j.bound
        np.testing.assert_array_equal(t.limbs.numpy(), limbs_np(j.limbs))

    def ops(a, b, grow=lambda a, b: a + a + b):
        big = a
        grown = []
        for _ in range(5):                  # grow the bound past the budget
            big = grow(big, b)
            grown.append(big)
        return grown + [a - b, big - a, a * b, big * big, big.smul(7), -a,
                        big.tighten(), a.inv(), a.pow_const(5)], big

    # (the reference under jit: one compile instead of many eager ones)
    (want, jbig), (got, tbig) = jax.jit(ops)(a, b), ops(ta, tb)
    for t, j in zip(got, want):
        same(t, j)
    np.testing.assert_array_equal(tbig.canon_limbs().numpy(),
                                  limbs_np(jax.jit(lambda x: x.canon_limbs())(jbig)))
    np.testing.assert_array_equal(tbig.int_limbs().numpy(),
                                  limbs_np(jax.jit(lambda x: x.int_limbs())(jbig)))
    np.testing.assert_array_equal(ta.is_zero().numpy(),
                                  np.asarray(jax.jit(lambda x: x.is_zero())(a)))
    assert list(ta.to_ints()) == [x % spec.p for x in xs]
    assert list((ta * tb).to_ints()) == [x * y % spec.p for x, y in zip(xs, ys)]


def test_fp2_ops_match_reference():
    spec = TL.FQ
    rng = np.random.default_rng(5)
    arr = np.empty(8, dtype=object)
    arr2 = np.empty(8, dtype=object)
    for i in range(8):
        arr[i] = tuple(rand_ints(rng, spec.p, 2))
        arr2[i] = tuple(rand_ints(rng, spec.p, 2))
    ja, jb = JF2.Fp2Array.from_int(arr), JF2.Fp2Array.from_int(arr2)
    ta, tb = TF2.Fp2Array.from_int(arr, device=CPU), TF2.Fp2Array.from_int(arr2, device=CPU)

    def same(t, j):
        for tc, jc in ((t.c0, j.c0), (t.c1, j.c1)):
            assert tc.bound == jc.bound
            np.testing.assert_array_equal(tc.limbs.numpy(), limbs_np(jc.limbs))

    def ops(a, b):
        return a * b, a.square(), a - b.smul(3)

    for t, j in zip(ops(ta, tb), jax.jit(ops)(ja, jb)):
        same(t, j)
    # inv is FpArray.inv (held against the reference above) on the norm
    assert [tuple(v) for v in (ta * ta.inv()).to_ints()] == [(1, 0)] * 8


def test_ints_to_limbs_roundtrip():
    rng = np.random.default_rng(6)
    for spec in (TL.FR, TL.MNT4Q):
        xs = rand_ints(rng, spec.p, 50) + [0, spec.p - 1]
        limbs = TL.ints_to_limbs(xs, spec.nlimbs)
        assert limbs.dtype == np.int64 and limbs.max() < TL.B
        np.testing.assert_array_equal(
            limbs, np.stack([TL.int_to_limbs(x, spec.nlimbs) for x in xs]))
        assert TL.limbs_to_ints(limbs) == xs


def test_port_never_imports_jax():
    """Importing every module of the port and ``chip_smoke``, in a fresh
    interpreter, loads no part of JAX and no module of the JAX package; the
    modules include the SHE layer, the run configuration, the hex-JSON
    files, the ark blob, the committed-input circuit, the `main` binary,
    KZG and Marlin, the inputs, ElGamal, MyCircuit, the online binary, the
    socket transport, the multiplicative shares, the shared bytes and their
    gadget, the timer, and the mesh transport's rank runner."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import zkmpc_tpu_torch as P\n"
        "mods = [m.name for m in pkgutil.walk_packages(P.__path__, 'zkmpc_tpu_torch.')]\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'zkmpc_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'zkmpc_tpu.')))\n"
        "assert len(mods) >= 57, mods\n"
        "new = {'she.ring', 'she.bgv', 'she.preprocessing', 'config', 'utils.serialize',\n"
        "       'circuits.input_circuit', 'cli.main', 'compat.ark', 'snark.kzg',\n"
        "       'snark.marlin', 'inputs', 'crypto.elgamal', 'circuits.my_circuit',\n"
        "       'cli.online', 'parallel.native_net', 'mpc.mul_share', 'mpc.uint8',\n"
        "       'snark.uint8_gadget', 'utils.timer', 'parallel.mesh'}\n"
        "assert {'zkmpc_tpu_torch.' + m for m in new} <= set(mods), mods\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_default_to_the_card():
    """Every function or method of the port that takes ``device`` defaults
    to the CUDA card; without a card, a call that names no device raises
    rather than running on the CPU."""
    import importlib
    import inspect
    import pkgutil

    import zkmpc_tpu_torch as P
    seen = []
    for info in pkgutil.walk_packages(P.__path__, "zkmpc_tpu_torch."):
        mod = importlib.import_module(info.name)
        for _, obj in inspect.getmembers(mod):
            if getattr(obj, "__module__", None) != info.name:
                continue
            members = [obj] if inspect.isfunction(obj) else \
                list(vars(obj).values()) if inspect.isclass(obj) else []
            for f in members:
                f = getattr(f, "__func__", f)       # classmethod, staticmethod
                if not callable(f):
                    continue
                try:
                    dev = inspect.signature(f).parameters.get("device")
                except (TypeError, ValueError):
                    continue
                if dev is not None and dev.default is not inspect.Parameter.empty:
                    seen.append(f.__qualname__)
                    assert dev.default == "cuda", f.__qualname__
    assert len(seen) >= 20, seen
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            TL.FpArray.zeros(TL.FR, (1,))
