"""The port's SPDZ online backend at 3 parties against the JAX package.

The MAC key shares are those of the SHE fixture's dealer.  Triples,
inverse pairs and <r> shares come from `make_torch_spdz_fixture.FixedSource`,
written once for both packages, so both get the same authenticated inputs;
the JAX side's results are read from ``fixtures/torch_spdz_3p.npz``
(`fixtures/make_torch_spdz_fixture.py`, minutes of XLA compiles on a CPU),
which a `slow` test regenerates.

- Field wires: the value and MAC shares after +, -, a public product and
  sum, a small multiple, a Beaver product, a dealt value (the JAX draws
  injected) and a shared inverse, limb for limb; the field residue share
  the openings accumulated under the JAX rho draws, limb for limb; the
  check passes, and fails after a party adds 1 to its share.
- ``sqrt_public`` and ``bit_rand_sqrt`` (the SPDZ bits), limb for limb.
- Group wires (the cases of ``tests/test_group_mac.py`` and
  ``tests/test_spdz_e2e.py``): MAC'd points through adds, public scaling,
  ``mpc_msm`` and the group-Beaver ``scale``, opened against the spec
  oracle with every party's MAC share against alpha_i times the point
  (the product's MAC shares against alpha times the point less its public
  offset); a tampered share fails the check, and so do two tampered
  shares whose errors cancel in a plain sum (+G and -G, in one batch and
  across two openings); a MAC'd plus a MAC-less share raises.
- The 4-gate wide-mul prove under SPDZ gives the JAX package's proof,
  which verifies, with both MAC queues non-empty and passing.
- Tampers weighted to cancel under the rhos that the public run seed
  would predict fail both checks, whose rhos come from the parties'
  commit-then-open coin toss after the openings.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from fixtures import make_torch_she_fixture as SF
from fixtures import make_torch_slice_fixture as MK
from fixtures import make_torch_spdz_fixture as ZF
from torch_parity import CPU
from zkmpc_tpu_torch import config as CFG
from zkmpc_tpu_torch.mpc import bits as B
from zkmpc_tpu_torch.mpc import group as G
from zkmpc_tpu_torch.mpc import rand as R
from zkmpc_tpu_torch.mpc import share as S
from zkmpc_tpu_torch.mpc.group import MpcSWPoint
from zkmpc_tpu_torch.mpc.share import SHARED, MpcContext, MpcFp, king_share, mpc_scope
from zkmpc_tpu_torch.ops.curve import SWPoint, sw_add_complete, sw_neg
from zkmpc_tpu_torch.ops.limbs import FR, FpArray
from zkmpc_tpu_torch.ops.msm import _bcast_sw
from zkmpc_tpu_torch.parallel.transport import StackedTransport
from zkmpc_tpu_torch.she import preprocessing as PP
from zkmpc_tpu_torch.snark import driver, groth16
from zkmpc_tpu_torch.snark.r1cs import ConstraintSystem
from zkmpc_tpu_torch.spec import curves as SC

torch.set_num_threads(1)

P = FR.p


def _fr(vals):
    return FpArray.from_int(FR, np.asarray(vals, dtype=object), device=CPU)


def _alphas():
    return ZF.alpha_ints(SF.load(np.load(SF.PATH)))


def _ctx(src, alphas, **kw):
    return MpcContext(StackedTransport(ZF.N_PARTIES, CPU), "spdz", src,
                      alpha_share=_fr(alphas), **kw)


def _same(got: FpArray, fx, name):
    """Exact limbs and bound against the JAX package's."""
    limbs, bound = fx["fp"][name]
    np.testing.assert_array_equal(got.limbs.numpy(), limbs.astype(np.int64), err_msg=name)
    assert got.bound == bound, name


def _opened(w) -> list:
    return [int(v) for v in w.reveal().to_ints()[0].reshape(-1)]


def _tamper(x: MpcFp) -> MpcFp:
    """Party 1 adds 1 to its share and keeps its MAC share."""
    bump = np.zeros((ZF.N_PARTIES,) + tuple(x.shape), dtype=object)
    bump[1] = 1
    return MpcFp(x.value + _fr(bump), SHARED, x.mac)


def _check(fx, ctx, src):
    """The field, sqrt and bit cases of the fixture, on ``ctx``."""
    doc = fx["json"]
    xv, yv, squares = ZF.input_values()
    x, y = src.share(xv), src.share(yv)
    dealt = king_share(_fr(ZF.KING_VALUES), None,
                       shares=FpArray(torch.as_tensor(fx["fp"]["dealt.draws"][0].astype(np.int64)),
                                      FR, fx["fp"]["dealt.draws"][1]))
    wires = ZF.field_ops(S, x, y, dealt)
    for name, w in wires.items():
        _same(w.value, fx, f"field.{name}.value")
        _same(w.mac, fx, f"field.{name}.mac")
    assert {k: _opened(wires[k]) for k in ("add", "dealt", "bmul")} == doc["field_opened"]
    assert doc["field_opened"]["dealt"] == [v % P for v in ZF.KING_VALUES]
    _same(ctx._mac_accum, fx, "field.residue")
    assert ctx.mac_residue_count == doc["field_count"]
    assert ctx.assert_field_macs(require_nonempty=True)

    _same(B.sqrt_public(_fr(squares)), fx, "sqrt")
    bits = B.bit_rand_sqrt(None, FR, (ZF.BITS_N,))
    _same(bits.value, fx, "bits.value")
    _same(bits.mac, fx, "bits.mac")
    assert _opened(bits) == doc["bits_opened"] and set(doc["bits_opened"]) <= {0, 1}
    _same(ctx._mac_accum, fx, "bits.residue")
    assert ctx.assert_field_macs(require_nonempty=True)
    assert json.loads(json.dumps(src.requests)) == doc["requests"]


def test_field_wires_bits_and_residues_match_reference():
    fx = ZF.load(np.load(ZF.PATH))
    alphas = fx["json"]["alphas"]
    assert alphas == _alphas()
    src = ZF.FixedSource("zkmpc_tpu_torch", alphas, ZF.SRC_SEED, device=CPU)
    ctx = _ctx(src, alphas, rho_bits=fx["rho"])
    with mpc_scope(ctx):
        _check(fx, ctx, src)
    assert ctx.mac_residue_count == len(fx["rho"])
    # a party that adds 1 to its share but keeps its MAC share is caught
    ctx = _ctx(src, alphas)
    with mpc_scope(ctx):
        x = king_share(_fr([5]), torch.Generator().manual_seed(3))
        assert _opened(_tamper(x)) == [6]
        with pytest.raises(AssertionError, match="field MAC"):
            ctx.assert_field_macs(require_nonempty=True)
        with pytest.raises(ValueError, match="MAC"):
            MpcFp.from_shares(x.value)
        # every party holds the same bits of an opened value, not of a share
        assert S.check_eq(x.open())
        with pytest.raises(AssertionError, match="disagree"):
            S.check_eq(x.value)


def _g1(k):
    return SC.g1_mul(SC.G1_GEN, k % P)


def _mac_points(w: MpcSWPoint) -> list:
    return [pt for pt in w.mac.reshape((ZF.N_PARTIES, -1)).to_affine_ints()]


def _group_cases(doc, gen):
    alphas = doc["alphas"]
    alpha = sum(alphas) % P
    src = ZF.FixedSource("zkmpc_tpu_torch", alphas, ZF.SRC_SEED + 2, device=CPU)
    ctx = _ctx(src, alphas)
    with mpc_scope(ctx):
        g = SWPoint.g1_from_affine_ints([SC.G1_GEN], CPU)[0]
        pt = G.with_mac_from_public(g)
        assert _mac_points(pt) == [_g1(a) for a in alphas]
        # + a public G moves the MAC offset, which the ladder scales too
        q = (pt + MpcSWPoint.from_public(g)).scale_public(MpcFp.const(FR, 5)) - pt   # 9 G
        assert q.offset is not None
        assert q.reveal()[0:1].to_affine_ints() == [_g1(9)]
        # MSM of public bases with dealt scalars: the MAC MSM rides along
        bases_aff = [_g1(i + 1) for i in range(4)]
        ks = [2, 3, 4, 5]
        out = G.mpc_msm(SWPoint.g1_from_affine_ints(bases_aff, CPU),
                        king_share(_fr(ks), gen))
        want = _g1(sum(k * (i + 1) for i, k in enumerate(ks)))
        assert out.reveal()[0:1].to_affine_ints() == [want]
        # the dealt scalars' MAC shares are alpha_i * k: so are the MSM's
        assert _mac_points(out) == [_g1(a * sum(k * (i + 1) for i, k in enumerate(ks)))
                                    for a in alphas]
        # a shared point scaled by a shared scalar through a group triple
        x = king_share(_fr(3), gen)
        y = king_share(_fr(5), gen)
        shared = MpcSWPoint.from_public(g).scale(x)
        assert shared.mac is not None
        prod = shared.scale(y)
        assert prod.reveal()[0:1].to_affine_ints() == [_g1(15)]
        # the public d*E of the product rides as the MAC offset Q: the MAC
        # shares sum to alpha * (15 G - Q)
        q = prod.offset[0:1].to_affine_ints()[0]
        mac_sum = MpcSWPoint(prod.mac, SHARED).reveal()[0:1].to_affine_ints()
        assert mac_sum == [SC.g1_add(_g1(15 * alpha), SC.g1_neg(SC.g1_mul(q, alpha)))]
        assert ctx.group_mac_residue_count == 4
        assert ctx.assert_field_macs(require_nonempty=True)
        assert ctx.assert_group_macs(require_nonempty=True)
        # tampered group shares fail the check: party 1 adds G to its share
        for w in (pt, shared):
            bumped = sw_add_complete(w.point, _bcast_sw(g, w.point.shape))
            mask = (torch.arange(ZF.N_PARTIES) == 1).reshape(
                (ZF.N_PARTIES,) + (1,) * (len(w.point.shape) - 1)).expand(w.point.shape)
            MpcSWPoint(SWPoint.select(mask, bumped, w.point), SHARED, w.mac).reveal()
            with pytest.raises(AssertionError, match="group MAC"):
                ctx.assert_group_macs(require_nonempty=True)
        # a MAC'd share plus a MAC-less one would drop authentication
        with pytest.raises(ValueError, match="MAC"):
            shared + MpcSWPoint(shared.point, SHARED)


def _cancelling_cases(doc, gen):
    """Tampered group shares whose errors cancel in a plain sum: party 1
    adds +G to one point and -G to another, in one opened batch and
    across two openings.  The opened points still sum to the honest sum
    and the MAC shares are untouched, so a check that weighs every point
    alike would pass; the check weighs each point by its own rho and must
    fail."""
    alphas = doc["alphas"]
    src = ZF.FixedSource("zkmpc_tpu_torch", alphas, ZF.SRC_SEED + 3, device=CPU)
    ctx = _ctx(src, alphas)
    with mpc_scope(ctx):
        g = SWPoint.g1_from_affine_ints([SC.G1_GEN], CPU)[0]
        pts = G.with_mac_from_public(SWPoint.g1_from_affine_ints(
            [_g1(k) for k in (1, 2, 3, 4)], CPU))                  # [P, 4]

        def bumped(w, party, sign):
            """Party ``party`` adds sign * G to its share of ``w``."""
            gg = _bcast_sw(g if sign > 0 else sw_neg(g), w.point.shape)
            mask = (torch.arange(ZF.N_PARTIES) == party).reshape(
                (ZF.N_PARTIES,) + (1,) * (len(w.point.shape) - 1)).expand(w.point.shape)
            return MpcSWPoint(SWPoint.select(mask, sw_add_complete(w.point, gg), w.point),
                              SHARED, w.mac)

        def part(w, a, b):
            return MpcSWPoint(w.point[:, a:b], SHARED, w.mac[:, a:b])
        # one batch: +G on the first point, -G on the second
        pair = part(pts, 0, 2)
        sign = torch.tensor([1, -1])
        one_batch = MpcSWPoint(SWPoint.select(sign.reshape(1, 2).expand(3, 2) > 0,
                                              bumped(pair, 1, 1).point,
                                              bumped(pair, 1, -1).point), SHARED, pair.mac)
        opened = one_batch.reveal()[0].to_affine_ints()
        assert opened == [_g1(2), _g1(1)]
        assert SC.g1_add(*opened) == _g1(3)            # the plain sum is the honest one
        with pytest.raises(AssertionError, match="group MAC"):
            ctx.assert_group_macs(require_nonempty=True)
        # two openings: party 1 +G on one point, party 2 -G on another
        a = bumped(part(pts, 2, 3), 1, 1).reveal()[0].to_affine_ints()
        b = bumped(part(pts, 3, 4), 2, -1).reveal()[0].to_affine_ints()
        assert SC.g1_add(a[0], b[0]) == _g1(7) and a != [_g1(3)]
        assert ctx.group_mac_residue_count == 2
        with pytest.raises(AssertionError, match="group MAC"):
            ctx.assert_group_macs(require_nonempty=True)
        # the same openings untampered pass
        part(pts, 2, 3).reveal()
        part(pts, 3, 4).reveal()
        assert ctx.assert_group_macs(require_nonempty=True)


def _spdz_prove(doc, gen):
    """The 4-gate wide-mul prove under SPDZ: r and s are the slice's, so
    the proof is the slice's, as the JAX package's was."""
    alphas = doc["alphas"]
    fxs = MK.load(np.load(MK.PATH))
    dpk = driver.dpk_from_host(fxs["doc"], CPU)
    mats = groth16.device_matrices_from_pk(dpk.pk, CPU)
    src = ZF.FixedSource("zkmpc_tpu_torch", alphas, ZF.SRC_SEED + 1, device=CPU,
                         fixed_r=ZF.slice_r_s())
    ctx = _ctx(src, alphas)
    with mpc_scope(ctx):
        cs = ConstraintSystem(FR)
        driver.build_wide_mul_circuit(cs, src.share([i + 2 for i in range(MK.N_GATES)]),
                                      src.share([i + 5 for i in range(MK.N_GATES)]))
        # under SPDZ r and s are the source's <r> shares (the slice's);
        # the generator is required but draws nothing
        proof = groth16.proof_to_ints(groth16.prove(dpk, cs, gen, matrices=mats))
        counts = (ctx.mac_residue_count, ctx.group_mac_residue_count)
        assert ctx.assert_field_macs(require_nonempty=True)
        assert ctx.assert_group_macs(require_nonempty=True)
    want = doc["prove"]
    assert json.loads(json.dumps(MK._plain(proof))) == want["proof"]
    assert proof == fxs["proof"]
    assert counts == (want["field_count"], want["group_count"]) and min(counts) > 0
    assert json.loads(json.dumps(src.requests)) == want["requests"]
    inst = driver.expected_instance(MK.N_GATES)
    assert groth16.verify(dpk.pk.vk, inst, proof)
    assert not groth16.verify(dpk.pk.vk, [1, (inst[1] + 1) % P], proof)


@pytest.mark.parametrize("case", ["group", "cancelling", "prove"])
def test_group_macs_and_spdz_prove_match_reference(case):
    doc = ZF.load(np.load(ZF.PATH))["json"]
    run = {"group": _group_cases, "cancelling": _cancelling_cases, "prove": _spdz_prove}[case]
    run(doc, torch.Generator().manual_seed(4))


def _config_context(seed):
    """The SPDZ context `config.build_mpc_context` makes for a run with
    ``--seed seed``, over the SHE fixture's dealer."""
    dealer = PP.dealer_from_host(SF.dealer_doc(SF.load(np.load(SF.PATH))), CPU)
    return CFG.build_mpc_context(CFG.RunConfig(backend="spdz", seed=seed),
                                 StackedTransport(ZF.N_PARTIES, CPU), dealer=dealer)


@pytest.mark.parametrize("case", ["field", "group"])
def test_seed_predicted_rho_tamper_is_caught(case):
    """Party 1 tampers two openings with errors weighted to cancel under
    the rhos the public seed predicts: e_1 = rho_2 and e_2 = -rho_1 (on
    field shares), rho_2*G and -rho_1*G (on two group shares of one
    opening).  Under seed-derived weights the weighted residue is 0 and the
    check passes; the rhos of the coin toss are drawn after the openings,
    so the check fails."""
    seed = 11
    ctx = _config_context(seed)
    party1 = torch.arange(ZF.N_PARTIES) == 1
    with mpc_scope(ctx):
        if case == "field":
            # each one-element opening drew one rho: rho_1 then rho_2
            gen = torch.Generator(CPU).manual_seed(((seed + 0x517D) << 1) | 1)
            rho = [int(R.uniform_fp(gen, FR, (1,), device=CPU).to_ints()[0]) for _ in range(2)]
            for k, err in enumerate((rho[1], -rho[0])):
                x = king_share(_fr([5 + k]), torch.Generator().manual_seed(3 + k))
                bump = np.zeros((ZF.N_PARTIES, 1), dtype=object)
                bump[1] = err % P
                assert _opened(MpcFp(x.value + _fr(bump), SHARED, x.mac)) == [(5 + k + err) % P]
            with pytest.raises(AssertionError, match="field MAC"):
                ctx.assert_field_macs(require_nonempty=True)
        else:
            # one opening of two points: one rho per point, [rho_1, rho_2]
            gen = torch.Generator(CPU).manual_seed(((seed + 0x517D) << 1) | 1)
            rho = [int(v) for v in R.uniform_fp(gen, FR, (2,), device=CPU).to_ints()]
            pts = G.with_mac_from_public(SWPoint.g1_from_affine_ints([_g1(1), _g1(2)], CPU))
            errs = SWPoint.g1_from_affine_ints([_g1(rho[1]), _g1(-rho[0])], CPU)
            moved = sw_add_complete(pts.point, _bcast_sw(errs, pts.point.shape))
            mask = party1.reshape(-1, 1).expand(ZF.N_PARTIES, 2)
            opened = MpcSWPoint(SWPoint.select(mask, moved, pts.point), SHARED,
                                pts.mac).reveal()[0].to_affine_ints()
            assert opened == [_g1(1 + rho[1]), _g1(2 - rho[0])]
            with pytest.raises(AssertionError, match="group MAC"):
                ctx.assert_group_macs(require_nonempty=True)


def test_coin_toss_commits_then_opens():
    """The MAC checks' coin toss: one round of commitments and one of
    openings; injected seeds give the hash of their concatenation; a party
    whose opening does not match its commitment is caught; each toss
    draws fresh private seeds."""
    t = StackedTransport(ZF.N_PARTIES, CPU)
    seeds = [bytes([i]) * 32 for i in range(ZF.N_PARTIES)]
    want = int.from_bytes(hashlib.sha256(b"".join(seeds)).digest()[:8], "little") >> 1
    assert R.coin_toss(t, seeds) == want and t.stats.rounds == 2
    with pytest.raises(AssertionError, match="party 2's opening"):
        R.coin_toss(t, seeds, openings=seeds[:2] + [bytes(32)])
    assert R.coin_toss(t) != R.coin_toss(t)


@pytest.mark.slow
def test_against_live_reference():
    """Regenerates the fixture with the JAX package (minutes on a CPU) and
    holds the port's field, sqrt and bit cases against it."""
    fx = ZF.load(ZF.generate())
    src = ZF.FixedSource("zkmpc_tpu_torch", fx["json"]["alphas"], ZF.SRC_SEED, device=CPU)
    ctx = _ctx(src, fx["json"]["alphas"], rho_bits=fx["rho"])
    with mpc_scope(ctx):
        _check(fx, ctx, src)
