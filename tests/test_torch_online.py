"""The port's online binary and what it imports against the JAX package.

- The input protocol (`cli.online.input_with_r`) on ``online_setup.json``
  files the port's `utils.serialize` wrote: its shares and opened values
  are the ones the JAX binary's formula (``zkmpc_tpu/cli/online.py:98-113``)
  gives on the files as the JAX package reads them; a tampered bracket MAC
  or r share fails the bracket check, and mixed bracket and legacy files
  are refused.
- `inputs.py` (the cases of ``tests/test_inputs.py``, and `input_share`'s
  shares under the JAX package's mask draws) and `crypto.elgamal` (the case
  of ``tests/test_crypto.py::test_elgamal_roundtrip``).
- MyCircuit at ``com_nbits=4``: matrices, instance and opened assignment of
  the JAX package's (``fixtures/torch_online_4b_3p.npz``,
  `fixtures/make_torch_online_fixture.py`).
- `slow`: `cli.online.run` on the CPU, Marlin and Groth16.
"""

import json
import os
import random as pyrandom

import numpy as np
import pytest
import torch

from fixtures import make_torch_online_fixture as OF
from torch_parity import CPU, check_circuit, fewer_attempts, fp_to_torch
from zkmpc_tpu_torch import inputs as IN
from zkmpc_tpu_torch.circuits import my_circuit
from zkmpc_tpu_torch.cli import online as ON
from zkmpc_tpu_torch.crypto import elgamal, pedersen
from zkmpc_tpu_torch.mpc import te as TE
from zkmpc_tpu_torch.mpc.share import MpcContext, MpcFp, king_share, mpc_scope
from zkmpc_tpu_torch.ops.limbs import FR, FpArray
from zkmpc_tpu_torch.parallel.transport import StackedTransport
from zkmpc_tpu_torch.snark.r1cs import ConstraintSystem
from zkmpc_tpu_torch.spec import curves as SC
from zkmpc_tpu_torch.utils import serialize as SER

torch.set_num_threads(1)

P = FR.p
N_PARTIES = 3
SLOTS = 4


def _fr(vals):
    return FpArray.from_int(FR, np.asarray(vals, dtype=object), device=CPU)


def _scope():
    return mpc_scope(MpcContext(StackedTransport(N_PARTIES, CPU), "semi"))


def _opened(w) -> list:
    return [int(v) for v in np.asarray(w.reveal().to_ints()[0]).reshape(-1)]


def write_setups(outdir, seed=5, bracket=True):
    """Per-party online_setup.json files as the `main` binary writes them:
    r-shares and alpha-MAC shares, and (``bracket``) each party's MAC
    shares under every key beta_j, sum_i gamma_j(r)_i = beta_j * r."""
    rng = pyrandom.Random(seed)
    r = [[rng.randrange(P) for _ in range(SLOTS)] for _ in range(N_PARTIES)]
    opened = [sum(r[i][s] for i in range(N_PARTIES)) % P for s in range(SLOTS)]
    betas = [rng.randrange(1, P) for _ in range(N_PARTIES)]
    gamma = [[[rng.randrange(P) for _ in range(SLOTS)] for _ in range(N_PARTIES)]
             for _ in range(N_PARTIES)]                     # [key j][holder i][slot]
    for j in range(N_PARTIES):
        for s in range(SLOTS):
            rest = sum(gamma[j][i][s] for i in range(1, N_PARTIES))
            gamma[j][0][s] = (betas[j] * opened[s] - rest) % P
    for i in range(N_PARTIES):
        def hx(vals):
            return [SER.field_to_hex(v, FR) for v in vals]
        with_br = bracket is True or (bracket == "mixed" and i != 2)
        SER.write_online_setup(
            os.path.join(outdir, str(i), "online_setup.json"), i, hx(r[i]),
            hx([rng.randrange(P) for _ in range(SLOTS)]),
            r_bracket_hex=[hx(gamma[j][i]) for j in range(N_PARTIES)] if with_br else None,
            beta_hex=SER.field_to_hex(betas[i], FR) if with_br else None)
    return r, betas


def _jax_formula(outdir, x_int, slot, owner):
    """``zkmpc_tpu/cli/online.py:98-113`` (stacked transport), on the files
    as the JAX package reads them: the owner's bracket check, then the
    shares."""
    from zkmpc_tpu.utils import serialize as JSER
    r_rows, br_rows, betas = [], [], []
    for i in range(N_PARTIES):
        fp = os.path.join(outdir, str(i), "online_setup.json")
        r_rows.append(JSER.read_online_setup(fp)[1])
        beta_i, br_i = JSER.read_online_setup_bracket(fp)
        br_rows.append(br_i)
        betas.append(beta_i)
    r_open = sum(r_rows[i][slot] for i in range(N_PARTIES)) % P
    mac_sum = sum(br_rows[i][owner][slot] for i in range(N_PARTIES)) % P
    assert mac_sum == betas[owner] * r_open % P
    eps = (x_int - r_open) % P
    return [(r_rows[i][slot] + (eps if i == owner else 0)) % P for i in range(N_PARTIES)]


def test_input_protocol_matches_reference_formula(tmp_path):
    write_setups(str(tmp_path))
    setups = ON.read_setups(str(tmp_path), N_PARTIES)
    with _scope():
        for x_int, slot, owner in ((3, 0, 0), (5, 1, 1), (P - 1, 3, 2), (0, 2, 0)):
            sh = ON.input_with_r(x_int, slot, owner, *setups, device=CPU)
            assert [int(v) for v in sh.value.to_ints().reshape(-1)] == \
                _jax_formula(str(tmp_path), x_int, slot, owner)
            assert _opened(sh) == [x_int]
    # a tampered bracket MAC share, or a tampered r share, fails the check
    r_rows, betas, br_rows = setups
    bad_br = [[list(row) for row in br] for br in br_rows]
    bad_br[2][0][1] = (bad_br[2][0][1] + 1) % P
    with pytest.raises(AssertionError, match="bracket MAC"):
        ON.input_with_r(3, 1, 0, r_rows, betas, bad_br, device=CPU)
    bad_r = [list(r) for r in r_rows]
    bad_r[1][0] = (bad_r[1][0] + 1) % P
    with pytest.raises(AssertionError, match="bracket MAC"):
        ON.input_with_r(3, 0, 0, bad_r, betas, br_rows, device=CPU)
    # files of both kinds at once are refused, not half-checked
    mixed = tmp_path / "mixed"
    write_setups(str(mixed), bracket="mixed")
    with pytest.raises(ValueError, match="mixed"):
        ON.input_with_r(3, 0, 0, *ON.read_setups(str(mixed), N_PARTIES), device=CPU)
    # legacy files (no bracket MACs at all): no check, the same shares
    legacy = tmp_path / "legacy"
    r, _ = write_setups(str(legacy), bracket=False)
    with _scope():
        sh = ON.input_with_r(9, 2, 1, *ON.read_setups(str(legacy), N_PARTIES), device=CPU)
        assert _opened(sh) == [9]
    # socket mode needs the address file beside the party id
    with pytest.raises(ValueError, match="--addrs"):
        ON.run("unused.json", party_id=0, device=CPU)


def test_inputs_match_reference():
    """The cases of ``tests/test_inputs.py``; `input_share` under the JAX
    package's mask draws gives its shares."""
    import jax
    from zkmpc_tpu import inputs as JIN
    from zkmpc_tpu.mpc import rand as JR
    from zkmpc_tpu.mpc.share import MpcContext as JCtx
    from zkmpc_tpu.mpc.share import mpc_scope as jscope
    from zkmpc_tpu.ops.limbs import FR as JFR
    from zkmpc_tpu.ops.limbs import FpArray as JFp
    from zkmpc_tpu.parallel.transport import StackedTransport as JST
    key = jax.random.PRNGKey(4)
    vals = [11, P - 3]
    with jscope(JCtx(JST(N_PARTIES), backend="semi")):
        want = JIN.input_share(JFp.from_int(JFR, np.asarray(vals, dtype=object)), 1, key)
        want = [int(v) for v in np.asarray(want.value.to_ints()).reshape(-1)]
    mask = fp_to_torch(JR.uniform_fp(key, JFR, (N_PARTIES - 1, 2)))
    gen = torch.Generator().manual_seed(2)
    with _scope():
        sh = IN.input_share(_fr(vals), 1, None, mask=mask)
        assert [int(v) for v in sh.value.to_ints().reshape(-1)] == want
        for owner in range(N_PARTIES):
            assert _opened(IN.input_share(_fr(123 + owner), owner, gen)) == [123 + owner]
        # a party-shaped value shares the owner's row
        assert _opened(IN.input_share(_fr([[10], [20], [30]]), 1, gen)) == [20]
        pp = pedersen.PedersenParams.sample()
        iwc = IN.InputWithCommit.generate(9, 2, pp, gen, r_int=0b101)
        assert _opened(iwc.input) == [9]
        assert iwc.commitment == pedersen.commit_public_ints(pp, 9, 0b101)
        assert _opened(iwc.randomness_bits) == [1, 0, 1] + [0] * 13
        mi = IN.SampleMpcInput()
        mi.set_public_input(pyrandom.Random(0))
        mi.set_private_input((3, 4))
        mi.generate_input(gen)
        assert mi.mode == "shared" and _opened(mi.peculiar["a"].input) == [3]
        assert _opened(mi.peculiar["b"].input) == [4] and mi.peculiar["a"].commitment
        mi = IN.WerewolfKeyInput()
        mi.set_public_input(pyrandom.Random(0), pp)
        mi.set_private_input(([5, 0, 0], [6, 0, 0], [1, 0, 0]))
        mi.generate_input(gen)
        xs = mi.peculiar["pub_key_or_dummy_x"]
        assert mi.mode == "shared" and len(xs) == 3 and _opened(xs[0].input) == [5]
        mi = IN.WerewolfMpcInput()
        mi.set_public_input(pyrandom.Random(0), {"pedersen_param": pp})
        mi.set_private_input(([1, 0, 0], [0, 1, 0]))
        mi.generate_input(gen, n_rand_bits=4)
        assert _opened(mi.peculiar["is_target"][1].input) == [1]
        assert set(_opened(mi.peculiar["randomness_bits"])) <= {0, 1}


def test_elgamal_and_my_circuit_match_reference():
    from zkmpc_tpu.crypto import elgamal as JEG
    keys = elgamal.keygen(5)
    assert (keys.sk, keys.pk) == (JEG.keygen(5).sk, JEG.keygen(5).pk)
    msg = SC.te_scalar_mul(SC.TE_GEN, 424242)
    gen = torch.Generator().manual_seed(6)
    with _scope():
        r_int = 0b10110
        r_bits = king_share(_fr([(r_int >> i) & 1 for i in range(5)]), gen)
        m_pt = TE._index(TE.MpcTEPoint.from_public_affine([msg]), 0)
        c1, c2 = elgamal.encrypt_shared(keys.pk, m_pt, r_bits)
        c1_xy, c2_xy = c1.reveal_affine_ints()[0], c2.reveal_affine_ints()[0]
    assert (c1_xy, c2_xy) == elgamal.encrypt_ints(keys.pk, msg, r_int) == \
        JEG.encrypt_ints(keys.pk, msg, r_int)
    assert elgamal.decrypt_ints(keys, c1_xy, c2_xy) == msg
    # MyCircuit at 4 bits against the JAX package's
    fx = OF.load(np.load(OF.PATH))
    pp = pedersen.PedersenParams.sample(OF.PP_SEED)
    with fewer_attempts(1), _scope():
        iwcs = [IN.InputWithCommit(i, king_share(_fr(x), gen),
                                   MpcFp.const(FR, [(r >> j) & 1 for j in range(OF.NBITS)]),
                                   pedersen.commit_public_ints(pp, x, r))
                for i, (x, r) in enumerate(((OF.A_INT, OF.RA_INT), (OF.B_INT, OF.RB_INT)))]
        cs = ConstraintSystem(FR)
        my_circuit.build(cs, iwcs[0], iwcs[1], OF.A_INT * OF.B_INT, pp, gen,
                         com_nbits=OF.NBITS)
    check_circuit(cs, fx)
    with _scope():
        simple = my_circuit.build_simple(ConstraintSystem(FR), king_share(_fr(3), gen),
                                         king_share(_fr(5), gen), 15)
        assert len(simple.constraints) == 6 and simple.is_satisfied_ints()


@pytest.mark.slow
@pytest.mark.parametrize("zksnark", ["marlin", "groth16"])
def test_online_runs_on_the_cpu(zksnark, tmp_path, monkeypatch):
    """`cli.online.run` on the CPU on setup files like the `main` binary's:
    MyCircuit at 16 commitment bits proved, verified, a wrong instance
    rejected.  The MSMs take the ladder (minutes on a CPU, where the
    bucketed MSM takes far longer)."""
    from zkmpc_tpu_torch.ops import msm
    monkeypatch.setattr(msm, "MIN_BUCKETED_POINTS", 1 << 30)
    write_setups(str(tmp_path))
    inputs = tmp_path / "inputs.json"
    inputs.write_text(json.dumps({"x": 3, "y": 5}))
    report = {}
    with fewer_attempts():
        assert ON.run(str(inputs), str(tmp_path), zksnark=zksnark, device=CPU, report=report)
    assert report["c"] == 15 and report["verified"] and report["wrong_instance_rejected"]
