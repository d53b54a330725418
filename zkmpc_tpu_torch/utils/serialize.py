"""Hex-JSON serialization in the reference's interop convention.

Port of ``zkmpc_tpu/utils/serialize.py``.  The reference writes every
persisted value as ``"0x" + hex(CanonicalSerialize bytes)`` inside JSON
files (`src/serialize.rs:23-75`), e.g. the preprocessing -> online handoff
``outputs/<i>/online_setup.json`` (`serialize.rs:101-147`).  ark's
CanonicalSerialize of a prime-field element is its canonical integer in
little-endian bytes, so the files are byte-compatible with the reference's
and with the JAX package's.
"""

from __future__ import annotations

import json
import os

from ..ops.limbs import FieldSpec, FpArray


def field_to_hex(value: int, spec: FieldSpec) -> str:
    nbytes = (spec.p.bit_length() + 7) // 8
    return "0x" + int(value % spec.p).to_bytes(nbytes, "little").hex()


def hex_to_field(s: str) -> int:
    assert s.startswith("0x")
    return int.from_bytes(bytes.fromhex(s[2:]), "little")


def fparray_to_hex(x: FpArray) -> list:
    return [field_to_hex(int(v), x.spec) for v in x.to_ints().reshape(-1)]


def write_online_setup(path: str, party_id: int, r_share_hex: list,
                       r_mac_hex: list | None = None,
                       r_bracket_hex: list | None = None,
                       beta_hex: str | None = None):
    """Per-party preprocessing output (the reference's `write_r`,
    `serialize.rs:101-147`): the angle share of r (and its alpha-MAC share)
    and the bracket share ([r]: this party's MAC share under every party's
    key, ``r_bracket_hex[j][slot]``, and its own MAC key beta)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    doc = {"party": party_id, "r": r_share_hex}
    if r_mac_hex is not None:
        doc["r_mac"] = r_mac_hex
    if r_bracket_hex is not None:
        doc["r_bracket"] = r_bracket_hex
    if beta_hex is not None:
        doc["beta"] = beta_hex
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def read_online_setup(path: str):
    """-> (party, r, mac): the angle representation."""
    with open(path) as f:
        doc = json.load(f)
    r = [hex_to_field(h) for h in doc["r"]]
    mac = [hex_to_field(h) for h in doc.get("r_mac", [])] or None
    return doc["party"], r, mac


def read_online_setup_bracket(path: str):
    """-> (beta, bracket_macs[j][slot]): the [r] representation, or
    (None, None) for a file without it."""
    with open(path) as f:
        doc = json.load(f)
    if "r_bracket" not in doc:
        return None, None
    beta = hex_to_field(doc["beta"]) if "beta" in doc else None
    br = [[hex_to_field(h) for h in row] for row in doc["r_bracket"]]
    return beta, br
