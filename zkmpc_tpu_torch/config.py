"""Typed run configuration.

Port of ``zkmpc_tpu/config.py``.  The reference scatters its knobs across
cargo features (`honest` vs `malicious`, `Cargo.toml:51-54`), CLI flags and
hardcoded protocol parameters; here they are one JSON round-trippable
dataclass, and `build_mpc_context` turns it into an `MpcContext`.
"""

from __future__ import annotations

import dataclasses
import json

import torch

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
    """The MpcContext of a run.

    semi: Beaver triples from a preprocessing dealer's `SheTripleSource`
    when a dealer is given, else the dummy source.  spdz: needs a dealer
    after ``initialize`` (the alpha MAC-key shares and the SHE pools); the
    source serves authenticated triples, inverse pairs and <r> shares; the
    MAC checks draw their weights from the parties' coin toss at check
    time, never from the run's seed.  The source draws from ``generator``,
    by default one seeded from ``cfg.seed`` on the transport's device,
    ``ciphertexts`` ciphertexts a triple batch."""
    from .mpc.share import MpcContext

    def source():
        from .she.preprocessing import SheTripleSource
        gen = generator
        if gen is None:
            gen = torch.Generator(transport.device).manual_seed(cfg.seed + 0x517D)
        return SheTripleSource(dealer, gen, ciphertexts)

    if cfg.backend == "semi":
        return MpcContext(transport, backend="semi",
                          triple_source=source() if dealer is not None else None)
    assert dealer is not None and dealer.alpha_shares is not None, \
        "the spdz backend needs preprocessing (run initialize first)"
    return MpcContext(transport, backend="spdz", triple_source=source(),
                      alpha_share=dealer.alpha_shares.to(transport.device))
