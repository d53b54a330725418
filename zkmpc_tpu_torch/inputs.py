"""MPC input subsystem: the init -> set_public -> set_private -> generate
lifecycle of the reference (`src/input.rs:149-160`).

Port of ``zkmpc_tpu/inputs.py``.  An `InputWithCommit` bundles a
party-owned scalar, its sharing, shared Pedersen randomness bits and the
public commitment (`input.rs:57-105`).  `generate` mirrors the reference's
`generate_input`: the owner's value is re-shared so every party holds an
additive share (`generate_share`, `input.rs:808-830`), then the commitment
is computed from the opened value with the common randomness and published,
as the reference does (`input.rs:86-100`).

The batched werewolf inputs (`WerewolfKeyInput`, `input.rs:305-515`;
`WerewolfMpcInput`, `input.rs:517-789`) carry one vector per field.
Private draws come from the parties' own generators
(`mpc.rand.PartyGenerators`), or from one replicated ``torch.Generator``
where one process plays every party; `input_share`'s mask draws can be
injected.
"""

from __future__ import annotations

import dataclasses
import random as pyrandom

import numpy as np
import torch

from . import params
from .crypto import pedersen as PD
from .mpc import bits as B
from .mpc import rand as R
from .mpc.share import SHARED, MpcFp, _rebroadcast, _sum_axis0, ctx, deal_fp
from .ops.limbs import FR, FpArray


def input_share(value: FpArray | None, owner: int, generator, mask: FpArray | None = None,
                shape=None) -> MpcFp:
    """Additive sharing where party ``owner`` contributes the value and a
    zero-sum mask (the re-randomized form of `generate_share`,
    `input.rs:808-830`): the owner draws P-1 uniform masks from its own
    generator, parties 0..P-2 hold them, the last minus their sum, the
    owner adds the value, and the owner deals each party its row in one
    round (`share.deal_fp`).  Only a process that plays the owner passes
    ``value``; on a socket every other party passes None and the batch
    ``shape``.  On the stacked transport ``value`` may be party-shaped
    [P, ...]: the owner's row is the one shared.  ``mask``: optional
    injected draws [P-1, *batch] in place of the generator's."""
    c = ctx()
    t = c.transport
    if (value is None) == t.holds(owner):
        raise ValueError(f"input_share: the owner (party {owner}) and only the owner passes "
                         f"the value (this process plays {t.row_ids})")
    if value is None:
        spec, batch = FR, tuple(shape or ())
    else:
        spec = value.spec
        value = value.to(t.device)
        if t.holds_all_rows and value.ndim and value.shape[0] == t.n_parties:
            value = value[owner]
        batch = tuple(value.shape)
    if mask is None:
        mask = R.dealer_draw(generator, spec, t, owner, (t.n_parties - 1,) + batch)
    rows = None
    if value is not None:
        mask = mask.to(t.device)
        assert mask.shape == (t.n_parties - 1,) + batch, mask.shape
        last = -_sum_axis0(mask)
        base = FpArray.concat([mask, last.reshape((1,) + batch)], axis=0)
        zeros = FpArray.zeros(spec, base.shape, t.device)
        ids = torch.arange(t.n_parties, device=t.device).reshape((-1,) + (1,) * len(batch))
        add = FpArray.select((ids == owner).expand(base.shape),
                             value.broadcast_to(base.shape), zeros)
        rows = base + add
    mac = None
    if c.backend == "spdz":
        mac = FpArray(_rebroadcast(t, value.limbs), spec, value.bound) * c.alpha_for(len(batch))
    return MpcFp(deal_fp(t, rows, owner, spec, batch), SHARED, mac)


@dataclasses.dataclass
class InputWithCommit:
    """`input.rs:57-105`."""

    allocation: int                    # owner party id
    input: MpcFp                       # shared scalar (after generate)
    randomness_bits: MpcFp | None      # shared Pedersen randomness bits
    commitment: tuple | None           # public affine TE point

    @classmethod
    def generate(cls, value_ints, allocation: int, pp: PD.PedersenParams, generator,
                 n_r_bits: int = 16, r_int: int | None = None):
        """Share the owner's value and publish its Pedersen commitment; the
        common randomness ``r_int`` is drawn from ``generator`` below
        2^16 unless given."""
        t = ctx().transport
        ints = np.asarray(value_ints, dtype=object)
        val = FpArray.from_int(FR, ints, device=t.device) if t.holds(allocation) else None
        shared = input_share(val, allocation, generator, shape=ints.shape)
        if r_int is None:
            r_int = int(torch.randint(0, 1 << 16, (), generator=generator,
                                      device=generator.device))
        r_bits = MpcFp.const(FR, [(r_int >> i) & 1 for i in range(n_r_bits)])
        opened = int(shared.reveal().to_ints().reshape(-1)[0])
        return cls(allocation, shared, r_bits, PD.commit_public_ints(pp, opened, r_int))


class MpcInput:
    """`MpcInputTrait` (`input.rs:149-160`): subclasses fill `set_*`."""

    def __init__(self):
        self.mode = "init"
        self.common = None
        self.peculiar = None

    def set_public_input(self, rng: pyrandom.Random, inp=None):
        raise NotImplementedError

    def set_private_input(self, inp=None):
        raise NotImplementedError

    def generate_input(self, generator):
        raise NotImplementedError


def _pedersen_param(rng: pyrandom.Random, inp):
    return inp or PD.PedersenParams.sample(rng.randrange(1 << 30))


class SampleMpcInput(MpcInput):
    """(a, b) pair of committed inputs (`input.rs:36-47,162-241`)."""

    def set_public_input(self, rng, inp=None):
        self.common = dict(pedersen_param=_pedersen_param(rng, inp))
        self.mode = "public_set"

    def set_private_input(self, inp=None):
        a, b = inp if inp is not None else (0, 0)
        self.peculiar = dict(a_val=a, b_val=b)
        self.mode = "private_set"

    def generate_input(self, generator):
        assert self.mode == "private_set"
        pp = self.common["pedersen_param"]
        for owner, name in enumerate("ab"):
            self.peculiar[name] = InputWithCommit.generate(
                self.peculiar[f"{name}_val"], owner, pp, generator)
        self.mode = "shared"


class WerewolfKeyInput(MpcInput):
    """Per-player (pk_x, pk_y, is_fortune_teller) vectors
    (`input.rs:305-515`): player i owns slot i of each vector."""

    FIELDS = (("pub_key_or_dummy_x", "x_vals"), ("pub_key_or_dummy_y", "y_vals"),
              ("is_fortune_teller", "ft_vals"))

    def set_public_input(self, rng, inp=None):
        self.common = dict(pedersen_param=_pedersen_param(rng, inp))
        self.mode = "public_set"

    def set_private_input(self, inp=None):
        xs, ys, fts = inp
        self.peculiar = dict(x_vals=xs, y_vals=ys, ft_vals=fts)
        self.mode = "private_set"

    def generate_input(self, generator):
        assert self.mode == "private_set"
        pp = self.common["pedersen_param"]
        for name, field in self.FIELDS:
            self.peculiar[name] = [InputWithCommit.generate(int(v), i, pp, generator)
                                   for i, v in enumerate(self.peculiar[field])]
        self.mode = "shared"


class WerewolfMpcInput(MpcInput):
    """Divination inputs: is_werewolf / is_target vectors and shared ElGamal
    randomness bits (`input.rs:517-789`)."""

    def set_public_input(self, rng, inp=None):
        inp = inp or {}
        self.common = dict(pedersen_param=_pedersen_param(rng, inp.get("pedersen_param")),
                           elgamal_pubkey=inp.get("elgamal_pubkey"))
        self.mode = "public_set"

    def set_private_input(self, inp=None):
        is_werewolf, is_target = inp
        self.peculiar = dict(wolf_vals=is_werewolf, target_vals=is_target)
        self.mode = "private_set"

    def generate_input(self, generator, n_rand_bits: int | None = None):
        assert self.mode == "private_set"
        pp = self.common["pedersen_param"]
        nbits = n_rand_bits or params.ED_FR_MODULUS.bit_length()
        for name, field in (("is_werewolf", "wolf_vals"), ("is_target", "target_vals")):
            self.peculiar[name] = [InputWithCommit.generate(int(v), i, pp, generator)
                                   for i, v in enumerate(self.peculiar[field])]
        self.peculiar["randomness_bits"] = B.bit_rand(generator, FR, (nbits,))
        self.mode = "shared"
