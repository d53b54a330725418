"""Typed run configuration.

Port of ``zkmpc_tpu/config.py``.  The reference scatters its knobs across
cargo features (`honest` vs `malicious`, `Cargo.toml:51-54`), CLI flags and
hardcoded protocol parameters; here they are one JSON round-trippable
dataclass, and `build_mpc_context` turns it into an `MpcContext`.  Only
the semi-honest backend is ported: ``backend="spdz"`` raises.
"""

from __future__ import annotations

import dataclasses
import json

import torch

SPDZ_NOT_PORTED = ("the SPDZ backend (MACs on field and group shares, the "
                   "MAC-checked prove) is not ported yet: ROADMAP.md, Queue 1, "
                   "the SPDZ online backend")


@dataclasses.dataclass(frozen=True)
class ZkPoPKParams:
    """DPSZ Fig. 10 knobs (reference `zkpopk::Parameters::new`,
    `main.rs:99-106`)."""
    v: int = 1
    sec: int = 8            # soundness bits per run
    rho: int = 64           # randomness infinity-norm bound


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """End-to-end run parameters for the preprocessing and online binaries."""
    n_parties: int = 3
    backend: str = "semi"            # "semi" (honest) | "spdz" (malicious)
    zksnark: str = "groth16"         # "groth16" | "marlin"
    slots: int = 8                   # SHE SIMD slots per ciphertext batch
    seed: int = 0
    outdir: str = "outputs"
    addrs: str | None = None         # party address file (multi-process)
    srs_size: int | None = None      # override Marlin/KZG SRS degree
    srs_path: str | None = None      # load/save the SRS here if set
    zkpopk: ZkPoPKParams = dataclasses.field(default_factory=ZkPoPKParams)

    def __post_init__(self):
        assert self.backend in ("semi", "spdz"), self.backend
        assert self.zksnark in ("groth16", "marlin"), self.zksnark
        assert self.n_parties >= 2
        assert self.slots >= 1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @classmethod
    def from_json(cls, text: str) -> "RunConfig":
        doc = json.loads(text)
        zp = doc.pop("zkpopk", None)
        return cls(**doc, **({"zkpopk": ZkPoPKParams(**zp)} if zp else {}))


def build_mpc_context(cfg: RunConfig, transport, dealer=None, generator=None,
                      ciphertexts: int = 1):
    """The MpcContext of a run: the semi-honest backend, with Beaver triples
    from a preprocessing dealer's `SheTripleSource` when a dealer is given
    (drawing from ``generator``, by default one seeded from ``cfg.seed`` on
    the transport's device; ``ciphertexts`` ciphertexts a triple batch),
    else the dummy source."""
    from .mpc.share import MpcContext

    if cfg.backend == "spdz":
        raise NotImplementedError(SPDZ_NOT_PORTED)
    src = None
    if dealer is not None:
        from .she.preprocessing import SheTripleSource
        if generator is None:
            generator = torch.Generator(transport.device).manual_seed(cfg.seed + 0x517D)
        src = SheTripleSource(dealer, generator, ciphertexts)
    return MpcContext(transport, backend="semi", triple_source=src)
