"""Writes ``torch_she_8s_3p.npz``: the JAX package's SHE layer, SPDZ
preprocessing and committed-input circuit at 8 slots and 3 parties, in a
jax-free form that the PyTorch port's tests load.

XLA:CPU takes minutes to compile the package's 51-limb graphs (its own SHE
tests are ``slow``), so the tier-1 tests read the results from here.  The
file holds, limbs as uint32 arrays with their bounds, ints as JSON:

- ``ring``: negacyclic products of two random R_q pairs [2, 8]; encode of
  random Fr slots [2, 8] and decode of random Fr coefficients [2, 8]; the
  centered lift of Fr values and the centered reduction of R_q values, edge
  cases (0, 1, p-1, (p-1)/2, (p+1)/2, q-1, (q-1)/2, (q+1)/2, small +-)
  and random ones; gaussian coefficients [2, 8] with the rounded normals
  drawn; uniform R_q elements [2, 8] with their raw limb draws.
- ``dealer``: a dealer at n = 8 and 3 parties after ``initialize``, as the
  package's ``dealer_to_host`` gives it (keys, alpha and beta shares,
  Enc(alpha), Enc(beta_j), bracket(alpha)).
- ``ct``: Enc(slots) of 8 Fr slots under that dealer's key, with its
  ``EncRandomness``; ``popk``: a ZKPoPK of it (commitments, challenge,
  responses), with the masks y and s the prover drew.
- ``triple``: one ``triple`` batch (a, b, c and their MAC shares, [3, 8]).
- ``input``: ``MySecretInputCircuit`` at x = 4, the CLI's bounds 3 <= x < 7,
  ``PedersenParams.sample(0)`` and R_INT over N_R_BITS bits: its matrices,
  instance, opened assignment and counts (the layout of
  ``make_torch_pedersen_fixture.record``).  N_R_BITS is the CLI's 16: the
  JAX synthesis takes minutes on a CPU.

Run from the repository root (tens of minutes on a CPU):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/fixtures/make_torch_she_fixture.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

N_SLOTS = 8
N_PARTIES = 3
X_INT, LOWER, UPPER = 4, 3, 7
N_R_BITS = 16
R_INT = 0xA5C3
PEDERSEN_SEED = 0
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_she_8s_3p.npz")


def _ints(rng, p, shape):
    """Uniform ints below p from a numpy generator (object array)."""
    n = int(np.prod(shape))
    words = rng.integers(0, 2**63, size=(n, p.bit_length() // 63 + 2))
    vals = [int(sum(int(w) << (63 * i) for i, w in enumerate(row)) % p) for row in words]
    return np.asarray(vals, dtype=object).reshape(shape)


def ring_inputs(fr_p: int, q: int) -> dict:
    """The ring cases' inputs as object-int arrays (numpy seed 50)."""
    rng = np.random.default_rng(50)
    hp, hq = (fr_p - 1) // 2, (q - 1) // 2
    lift = [0, 1, 2, fr_p - 1, fr_p - 2, hp, hp + 1, hp - 1] + list(_ints(rng, fr_p, (8,)))
    red = ([0, 1, 5, q - 1, q - 5, hq, hq + 1, hq - 1, fr_p, q - fr_p, fr_p + 3]
           + list(_ints(rng, q, (5,))))
    return {"mul_a": _ints(rng, q, (2, N_SLOTS)), "mul_b": _ints(rng, q, (2, N_SLOTS)),
            "enc_slots": _ints(rng, fr_p, (2, N_SLOTS)),
            "dec_coeffs": _ints(rng, fr_p, (2, N_SLOTS)),
            "lift": np.asarray(lift, dtype=object), "reduce": np.asarray(red, dtype=object),
            "ct_slots": _ints(rng, fr_p, (N_SLOTS,))}


class _Writer:
    """Collects limb arrays and JSON into npz arrays."""

    def __init__(self):
        self.arrays, self.meta = {}, {}

    def fp(self, name, x):
        import jax
        self.arrays[name] = np.asarray(jax.device_get(x.limbs)).astype(np.uint32)
        self.meta[name] = {"spec": x.spec.name, "bound": int(x.bound)}
        return name

    def node(self, prefix, d):
        """A ``dealer_to_host`` node with its limb arrays moved out."""
        if d is None:
            return None
        if d[0] == "fp":
            _, name, bound, limbs = d
            self.arrays[prefix] = np.asarray(limbs).astype(np.uint32)
            return ["fp", name, int(bound), prefix]
        if d[0] == "ct":
            return ["ct"] + [self.node(f"{prefix}.{k}", c) for k, c in zip("012", d[1:])]
        return ["seq", bool(d[1]), [self.node(f"{prefix}.{i}", v) for i, v in enumerate(d[2])]]


def _log(msg, t0):
    print(f"[{time.time() - t0:7.1f} s] {msg}", flush=True)


def generate() -> dict:
    """Run the JAX package; returns the npz arrays."""
    import jax

    from zkmpc_tpu.circuits import input_circuit
    from zkmpc_tpu.crypto import pedersen
    from zkmpc_tpu.mpc import rand as JR
    from zkmpc_tpu.mpc.share import MpcContext, MpcFp, king_share, mpc_scope
    from zkmpc_tpu.ops.limbs import FR, MNT4Q, FpArray
    from zkmpc_tpu.parallel.transport import StackedTransport
    from zkmpc_tpu.she import bgv, ring
    from zkmpc_tpu.she import preprocessing as PP
    from zkmpc_tpu.snark.r1cs import ConstraintSystem

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from make_torch_pedersen_fixture import record

    t0 = time.time()
    w = _Writer()
    ins = ring_inputs(FR.p, MNT4Q.p)
    fq = lambda v: FpArray.from_int(MNT4Q, v)       # noqa: E731
    fr = lambda v: FpArray.from_int(FR, v)          # noqa: E731
    out = {}

    # -- ring, encode/decode, lift/reduce, sampling
    w.fp("mul", jax.jit(ring.negacyclic_mul)(fq(ins["mul_a"]), fq(ins["mul_b"])))
    w.fp("encode", jax.jit(bgv.encode)(fr(ins["enc_slots"])))
    w.fp("decode", jax.jit(bgv.decode)(fr(ins["dec_coeffs"])))
    w.fp("lift", jax.jit(ring.lift_centered_p_to_q)(fr(ins["lift"])))
    w.fp("reduce", jax.jit(ring.reduce_centered_q_to_p)(fq(ins["reduce"])))
    key = jax.random.PRNGKey(51)
    g = jax.random.normal(key, (2, N_SLOTS)) * 3.2
    w.arrays["gauss_draws"] = np.asarray(jax.numpy.round(g).astype(np.int32))
    w.fp("gauss", ring.gaussian_coeffs(key, N_SLOTS, (2,)))
    key = jax.random.PRNGKey(52)
    w.fp("uniform", ring.uniform_rq(key, N_SLOTS, (2,)))
    for name, k in zip(("uniform_hi", "uniform_lo"), jax.random.split(key)):
        w.arrays[name] = np.asarray(jax.random.bits(k, (2, N_SLOTS, MNT4Q.nlimbs),
                                                    dtype=np.uint32))
    _log("ring cases", t0)

    # -- the dealer after initialize
    params = bgv.SheParams(N_SLOTS)
    ctx = PP.make_dealer(params, N_PARTIES, jax.random.PRNGKey(100))
    PP.initialize(ctx, jax.random.PRNGKey(101))
    doc = PP.dealer_to_host(ctx)
    out["dealer"] = {k: (w.node(f"dealer.{k}", v) if isinstance(v, tuple) else v)
                     for k, v in doc.items()}
    _log("dealer initialized", t0)

    # -- a ciphertext, its randomness and a ZKPoPK
    slots = fr(ins["ct_slots"])
    r = bgv.sample_enc_randomness(params, jax.random.PRNGKey(102))
    ct = bgv.encrypt_slots(ctx.pk, params, slots, r)
    ct = bgv.Ciphertext(PP._n2q(ct.c0), PP._n2q(ct.c1), ct.c2)
    for k in ("v", "e0", "e1"):
        w.fp(f"ct_r.{k}", getattr(r, k))
    for k in ("c0", "c1", "c2"):
        w.fp(f"ct.{k}", getattr(ct, k))
    kp = jax.random.PRNGKey(103)
    proof = PP.zkpopk_prove(ctx, slots, r, ct, kp)
    assert PP.zkpopk_verify(ctx, ct, proof)
    y = JR.uniform_fp(jax.random.fold_in(kp, 1), FR, (PP._SEC, N_SLOTS))
    s = bgv.sample_enc_randomness(params, jax.random.fold_in(kp, 2), (PP._SEC,))
    w.fp("popk_y", y)
    for k in ("v", "e0", "e1"):
        w.fp(f"popk_s.{k}", getattr(s, k))
    for k in ("c0", "c1", "c2"):
        w.fp(f"popk_cm.{k}", FpArray.stack([getattr(c, k) for c in proof.commitments]))
    w.arrays["popk_challenge"] = np.frombuffer(proof.challenge, dtype=np.uint8)
    w.fp("popk_z", proof.z)
    for k in ("v", "e0", "e1"):
        w.fp(f"popk_t.{k}", FpArray.stack([getattr(t, k) for t in proof.t]))
    _log("ciphertext and ZKPoPK", t0)

    # -- one triple batch
    (a, ma), (b, mb), (c, mc) = PP.triple(ctx, jax.random.PRNGKey(104))
    for name, x in zip(("a", "ma", "b", "mb", "c", "mc"), (a, ma, b, mb, c, mc)):
        w.fp(f"triple.{name}", x)
    _log("triple batch", t0)

    # -- the committed-input circuit
    pp = pedersen.PedersenParams.sample(PEDERSEN_SEED)
    com = pedersen.commit_public_ints(pp, X_INT, R_INT)
    with mpc_scope(MpcContext(StackedTransport(N_PARTIES), backend="semi")):
        cs = ConstraintSystem(FR)
        xw = king_share(fr(np.asarray([X_INT], dtype=object)), jax.random.PRNGKey(105))
        xw = MpcFp(FpArray(xw.value.limbs[..., 0, :], FR, xw.value.bound), xw.visibility)
        rb = king_share(fr(np.asarray([(R_INT >> i) & 1 for i in range(N_R_BITS)],
                                      dtype=object)), jax.random.PRNGKey(106))
        input_circuit.build(cs, xw, rb, com, pp, lower=LOWER, upper=UPPER,
                            key=jax.random.PRNGKey(107), n_r_bits=N_R_BITS)
        assert cs.is_satisfied_ints()
        out["input"] = record(cs, np.asarray(cs.full_assignment().reveal().to_ints())[0])
        out["input"]["commitment"] = [int(com[0]), int(com[1])]
    _log("input circuit", t0)

    out["meta"] = w.meta
    out["ring_inputs"] = {k: [int(x) for x in v.reshape(-1)] for k, v in ins.items()}
    arrays = dict(w.arrays)
    arrays["json"] = np.asarray(json.dumps(out))
    return arrays


def load(arrays) -> dict:
    """npz arrays -> {"json": the JSON part, "arrays": name -> uint32 limbs}."""
    doc = json.loads(str(arrays["json"]))
    return {"json": doc, "arrays": {k: arrays[k] for k in arrays.files if k != "json"}
            if hasattr(arrays, "files") else {k: v for k, v in arrays.items() if k != "json"}}


def dealer_doc(fx) -> dict:
    """The fixture's dealer in ``dealer_to_host``'s layout (numpy limbs)."""
    arrays = fx["arrays"]

    def node(d):
        if d is None:
            return None
        if d[0] == "fp":
            return ("fp", d[1], d[2], arrays[d[3]])
        if d[0] == "ct":
            return ("ct",) + tuple(node(c) for c in d[1:])
        return ("seq", d[1], [node(v) for v in d[2]])
    return {k: (node(v) if isinstance(v, list) else v)
            for k, v in fx["json"]["dealer"].items()}


if __name__ == "__main__":
    np.savez_compressed(PATH, **generate())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
