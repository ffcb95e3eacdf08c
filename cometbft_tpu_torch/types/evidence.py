"""The evidence list hash a header commits to (twin of
`cometbft_tpu/types/evidence.py::evidence_list_hash`; reference
types/evidence.go EvidenceList.Hash: merkle over each evidence's
oneof-wrapped proto bytes).

Only the hash is here. The evidence types wait for the evidence slice:
`types/block.py::Block.decode` refuses a block that carries evidence
(`UnsupportedEvidence`), so the port's blocks hash an empty list.
"""

from __future__ import annotations

from ..crypto import merkle


def evidence_list_hash(evidence: list) -> bytes:
    return merkle.hash_from_byte_slices([ev.wrapped() for ev in evidence])
