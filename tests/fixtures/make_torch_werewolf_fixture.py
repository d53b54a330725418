"""Writes ``torch_werewolf_3p.npz``: the werewolf circuits and game phases
synthesized by the JAX package at 3 players, in a jax-free form that the
PyTorch port's werewolf tests load.

Small parameters: ElGamal randomness of ``RAND_BITS`` bits and Pedersen
commitment checks of ``COM_NBITS`` message bits.  The file holds one JSON
document with:

- ``circuits``: per case of `CASES` below (built by `build`, written once
  for either package), the R1CS (A, B, C) as [rows, cols, coeffs], the
  instance, the opened full assignment and the counts
  (`make_torch_pedersen_fixture.record`), and the case's opened outputs.
  Nothing recorded depends on the protocols' random draws;
- ``game``: the JAX game binary's ``init``, ``role_assignment``, ``vote``
  and ``judgment`` modes in one game directory (``--seed 0``, ``--votes
  2,2,0``): the state files they write and the circuits of the last three.
  ``init``'s SHE preprocessing is not run here: its draws are each
  package's own, and the port's tests check its shares by shape and MACs;
- ``vote_proof``: the ``vote`` phase's Groth16 proof (setup seed 41), its
  verifying key, and the values of the r and s the prove drew; ``r``/``s``
  hold the shares as uint32 limbs for injection into the port's prove.

Run from the repository root.  The cases and the game take some 20
minutes in five processes; the eager JAX prove of the vote circuit took
about two hours on an eight-core CPU (its bucketed MSM construct alone
compiles for tens of minutes a shape):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/fixtures/make_torch_werewolf_fixture.py
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_pedersen_fixture as PF  # noqa: E402
from make_torch_marlin_fixture import plain  # noqa: E402

N_PARTIES = 3
RAND_BITS = 8
COM_NBITS = 4
SEED = 0
VOTES = "2,2,0"
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_werewolf_3p.npz")

#: the cases `build` makes: the werewolf circuits with their commitment
#: checks, the protocol circuits and the short-Weierstrass gadget
CASES = ("key_publicize", "divination", "vote_commit",
         "eq_zero", "neq_zero_5", "neq_zero_0", "bit_decomposition", "smaller_than",
         "smaller_than_eq", "smaller_eq_than",
         "sw_add", "sw_witness", "sw_scalar_mul")
#: the game's phases recorded, in order; the last three are proved
MODES = ("init", "role_assignment", "vote", "judgment")
STATE_FILES = {"init": ["role_0.json", "role_1.json", "role_2.json", "public.json",
                        "shuffles.json"],
               "role_assignment": ["role_commitments.json"],
               "vote": ["vote.json"], "judgment": ["judgment.json"]}
#: the toy short-Weierstrass curve of ``tests/test_sw_gadget.py``:
#: y^2 = x^3 + 5x - 9 over Fr, through G = (2, 3)
SW_A, SW_B, SW_G = 5, -9, (2, 3)


class Draws:
    """The randomness handed to a package's protocols: a fresh JAX key a
    call (``fold_in`` of a counter), or one torch.Generator on the CPU."""

    def __init__(self, pkg: str, seed: int):
        self.pkg = pkg
        if pkg == "zkmpc_tpu":
            import jax
            self.key, self.n = jax.random.PRNGKey(seed), 0
        else:
            import torch
            self.gen = torch.Generator(torch.device("cpu")).manual_seed(seed)

    def __call__(self):
        if self.pkg != "zkmpc_tpu":
            return self.gen
        import jax
        self.n += 1
        return jax.random.fold_in(self.key, self.n)


def _fr(pkg, vals):
    L = importlib.import_module(f"{pkg}.ops.limbs")
    kw = {} if pkg == "zkmpc_tpu" else {"device": "cpu"}
    return L.FpArray.from_int(L.FR, np.asarray(vals, dtype=object), **kw)


def shared_vec(pkg, vals, rnd):
    """The leader deals a vector of values: a shared [n] wire."""
    S = importlib.import_module(f"{pkg}.mpc.share")
    return S.king_share(_fr(pkg, list(vals)), rnd())


def shared_scalar(pkg, v, rnd):
    """The leader deals one value: a shared wire of shape ()."""
    L = importlib.import_module(f"{pkg}.ops.limbs")
    S = importlib.import_module(f"{pkg}.mpc.share")
    x = shared_vec(pkg, [v], rnd)

    def f(fp):
        return L.FpArray(fp.limbs[..., 0, :], fp.spec, fp.bound)
    return S.MpcFp(f(x.value), x.visibility, None if x.mac is None else f(x.mac))


def _bits(v, n):
    return [(v >> i) & 1 for i in range(n)]


def build(pkg, name, rnd):
    """Synthesize case ``name`` with package ``pkg`` (``zkmpc_tpu`` or
    ``zkmpc_tpu_torch``) under the ambient MPC scope; ``rnd``: a `Draws`.
    Returns (cs, {output name: opened point}) (outputs of the SW cases)."""
    L = importlib.import_module(f"{pkg}.ops.limbs")
    R1 = importlib.import_module(f"{pkg}.snark.r1cs")
    PD = importlib.import_module(f"{pkg}.crypto.pedersen")
    cs = R1.ConstraintSystem(L.FR)
    out = {}
    if name in ("key_publicize", "divination", "vote_commit"):
        WC = importlib.import_module(f"{pkg}.circuits.werewolf")
        pp = PD.PedersenParams.sample(1)
        kw = "key" if pkg == "zkmpc_tpu" else "generator"
    if name == "key_publicize":
        xs, ys = (5, 0, 0), (6, 0, 0)
        rs = list(range(10, 16))
        WC.key_publicize_circuit(
            cs, [shared_scalar(pkg, v, rnd) for v in xs],
            [shared_scalar(pkg, v, rnd) for v in ys],
            [shared_scalar(pkg, v, rnd) for v in (1, 0, 0)], 5, 6, pedersen_pp=pp,
            xy_randomness=[shared_vec(pkg, _bits(r, COM_NBITS), rnd) for r in rs],
            xy_commitments=[PD.commit_public_ints(pp, v, r) for v, r in zip(xs + ys, rs)],
            com_nbits=COM_NBITS, **{kw: rnd()})
    elif name == "divination":
        EG = importlib.import_module(f"{pkg}.crypto.elgamal")
        SC = importlib.import_module(f"{pkg}.spec.curves")
        keys = EG.keygen(3)
        r_int = 0b10110101
        c1, c2 = EG.encrypt_ints(keys.pk, SC.TE_GEN, r_int)
        flags = (0, 1, 0)
        rs = list(range(2, 8))
        WC.divination_circuit(
            cs, [shared_scalar(pkg, v, rnd) for v in flags],
            [shared_scalar(pkg, v, rnd) for v in flags],
            shared_vec(pkg, _bits(r_int, RAND_BITS), rnd), keys.pk, c1, c2, rnd(),
            pedersen_pp=pp,
            wire_randomness=[shared_vec(pkg, _bits(r, COM_NBITS), rnd) for r in rs],
            wire_commitments=[PD.commit_public_ints(pp, v, r)
                              for v, r in zip(flags + flags, rs)],
            com_nbits=COM_NBITS)
    elif name == "vote_commit":
        # the MPC winner of these votes is 2 (the game's `vote` phase
        # computes it with `calculate_voting_output`)
        votes = [[0, 0, 1], [0, 0, 1], [1, 0, 0]]
        wires = [[shared_scalar(pkg, v, rnd) for v in row] for row in votes]
        secrets = (3, 9, 12)
        WC.anonymous_voting_circuit(
            cs, wires, 2, rnd(), pedersen_pp=pp,
            player_randomness=[shared_scalar(pkg, v, rnd) for v in secrets],
            player_commitments=[PD.commit_public_ints(pp, v, 0) for v in secrets],
            com_nbits=COM_NBITS)
    elif name.startswith(("eq_zero", "neq_zero", "bit_dec", "smaller")):
        PC = importlib.import_module(f"{pkg}.circuits.protocol_circuits")
        if name == "eq_zero":
            PC.equality_zero_circuit(cs, shared_scalar(pkg, 0, rnd), rnd())
        elif name.startswith("neq_zero"):
            PC.not_equality_zero_circuit(cs, shared_scalar(pkg, int(name[-1]), rnd), rnd())
        elif name == "bit_decomposition":
            PC.bit_decomposition_circuit(cs, shared_scalar(pkg, 0b110101, rnd), rnd())
        elif name == "smaller_eq_than":
            PC.smaller_eq_than_circuit(cs, shared_vec(pkg, _bits(11, 8), rnd), 13)
        else:
            a, b = (17, 42) if name == "smaller_than" else (17, 17)
            PC.smaller_than_circuit(cs, shared_scalar(pkg, a, rnd), shared_scalar(pkg, b, rnd),
                                    shared_scalar(pkg, 1, rnd), rnd(),
                                    check_eq=name == "smaller_than_eq")
    else:
        out = _sw_case(pkg, name, cs, rnd)
    return cs, out


def _sw_case(pkg, name, cs, rnd):
    """The cases of ``tests/test_sw_gadget.py``; returns the opened points."""
    L = importlib.import_module(f"{pkg}.ops.limbs")
    G = importlib.import_module(f"{pkg}.snark.gadgets")
    SW = importlib.import_module(f"{pkg}.circuits.sw_gadget")
    curve = SW.SWCurveParams(SW_A, SW_B, L.FR.p)
    V = SW.SWNonZeroAffineVar
    g = V.constant(cs, SW_G, curve)
    if name == "sw_add":
        g2 = g.double()
        pts = {"2G": g2, "3G": g2.add_unchecked(g), "5G": g2.double_and_add(g)}
    elif name == "sw_witness":
        g5 = curve.mul(SW_G, 5)
        pt = V.new_witness(cs, shared_scalar(pkg, g5[0], rnd), shared_scalar(pkg, g5[1], rnd),
                           curve)
        pts = {"6G": pt.add_unchecked(g)}
    else:
        bits = [G.Boolean.new_witness(cs, shared_scalar(pkg, b, rnd)) for b in _bits(11, 5)]
        pts = {"11G": g.scalar_mul_le(bits, curve.mul(SW_G, 1000))}

    def opened(v):
        val = v.value
        if val.visibility == "shared":
            val = val.open()
        return int(np.asarray(val.value.to_ints()).reshape(-1)[0]) % L.FR.p
    return {k: [opened(p.x), opened(p.y)] for k, p in pts.items()}


def game_args(gamedir, **kw):
    """The game binary's arguments of the recorded run."""
    base = dict(players=N_PARTIES, gamedir=gamedir, seed=SEED, slots=8, target=None,
                votes=VOTES, rand_bits=RAND_BITS, zksnark="groth16", srs_degree=None)
    base.update(kw)
    return argparse.Namespace(**base)


def read_state(gamedir, mode) -> dict:
    return {f: json.load(open(os.path.join(gamedir, f))) for f in STATE_FILES[mode]}


def _proof_record(dpk, cs, key, setup_seed):
    """The JAX vote prove: proof, verifying key and the r, s it drew."""
    import jax

    from zkmpc_tpu.mpc import share as MS
    from zkmpc_tpu.ops.limbs import FR
    from zkmpc_tpu.snark import groth16
    proof = groth16.proof_to_ints(groth16.prove(dpk, cs, key))
    vk = dpk.pk.vk
    assert groth16.verify(vk, cs.instance_ints(), proof)
    k_r, k_s = jax.random.split(key)
    r = MS.rand_shared(k_r, FR).value
    s = MS.rand_shared(k_s, FR).value
    doc = {"proof": plain(proof), "setup_seed": setup_seed,
           "vk": plain([vk.alpha_g1, vk.beta_g2, vk.gamma_g2, vk.delta_g2, vk.ic])}
    arrays = {"r_limbs": np.asarray(r.limbs, np.uint32), "r_bound": np.asarray(r.bound),
              "s_limbs": np.asarray(s.limbs, np.uint32), "s_bound": np.asarray(s.bound)}
    return doc, arrays


def _fewer_attempts():
    """The JAX bit protocols draw one candidate for each bitwise-shared
    random value (the library's default is 16): nothing recorded depends
    on the draws, and the eager JAX synthesis is some 16 times cheaper."""
    from zkmpc_tpu.mpc import bits as JB
    orig = JB.rand_number_bitwise
    JB.rand_number_bitwise = lambda key, spec, shape=(), attempts=16: orig(key, spec, shape, 1)


def _case(name):
    """One case of `CASES`, synthesized by the JAX package."""
    from zkmpc_tpu.mpc.share import MpcContext, mpc_scope
    from zkmpc_tpu.parallel.transport import StackedTransport
    _fewer_attempts()
    with mpc_scope(MpcContext(StackedTransport(N_PARTIES), backend="semi")):
        cs, out = build("zkmpc_tpu", name, Draws("zkmpc_tpu", CASES.index(name)))
        assert cs.is_satisfied_ints(), name
        rec = PF.record(cs, np.asarray(cs.full_assignment().reveal().to_ints())[0])
    print(f"{name}: {rec['counts']}", flush=True)
    return dict(rec, outputs=out)


def _game(prove_vote: bool):
    """The JAX game binary's modes, SHE preprocessing stubbed out and every
    prove replaced by a record of its circuit; with ``prove_vote`` only
    ``init`` and ``vote``, whose prove runs.  Returns (doc, arrays)."""
    from zkmpc_tpu.cli import werewolf_game as WG
    from zkmpc_tpu.she import preprocessing as PP
    from zkmpc_tpu.snark import groth16
    from zkmpc_tpu.utils import serialize as SER
    _fewer_attempts()
    doc, arrays, captured = {}, {}, {}

    def record_pv(args, cs, key, setup_seed):
        captured["circuit"] = PF.record(
            cs, np.asarray(cs.full_assignment().reveal().to_ints())[0])
        if prove_vote:
            doc["vote_proof"], proof_arrays = _proof_record(
                groth16.device_setup(cs, seed=setup_seed), cs, key, setup_seed)
            arrays.update(proof_arrays)
        return True
    PP.make_dealer = PP.initialize = PP.triple = lambda *a, **k: None
    PP.pair = lambda *a, **k: (([None] * N_PARTIES, [None] * N_PARTIES), None)
    SER.write_online_setup = lambda *a, **k: None
    SER.fparray_to_hex = lambda x: []
    WG._prove_and_verify = record_pv
    modes = ("init", "vote") if prove_vote else MODES
    with tempfile.TemporaryDirectory() as gamedir:
        for mode in modes:
            captured.clear()
            assert WG.MODES[mode](game_args(gamedir))
            doc[mode] = {"state": read_state(gamedir, mode), **captured}
            print(f"game {mode}{' (proved)' if prove_vote else ''}: done", flush=True)
    return doc, arrays


def generate(workers: int = 5) -> dict:
    """Synthesize every case and run the game with the JAX package, in
    ``workers`` processes; returns the npz arrays."""
    import concurrent.futures as CF
    import multiprocessing as mp
    with CF.ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as ex:
        proved = ex.submit(_game, True)
        game = ex.submit(_game, False)
        cases = {name: ex.submit(_case, name) for name in CASES}
        (game_doc, _), (proof_doc, arrays) = game.result(), proved.result()
        doc = {"circuits": {name: f.result() for name, f in cases.items()}, "game": game_doc,
               "vote_proof": proof_doc["vote_proof"]}
    assert proof_doc["vote"] == game_doc["vote"]
    arrays["json"] = np.asarray(json.dumps(doc))
    return arrays


def load(arrays) -> dict:
    """npz arrays -> the JSON document, with ``r``/``s`` as (uint32 limbs,
    bound) beside it."""
    doc = json.loads(str(arrays["json"]))
    for k in ("r", "s"):
        doc[k] = (arrays[f"{k}_limbs"], int(arrays[f"{k}_bound"]))
    return doc


if __name__ == "__main__":
    np.savez_compressed(PATH, **generate())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
