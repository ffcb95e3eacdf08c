"""Light-block provider over the node RPC (reference
light/provider/http/http.go).

Fetches signed headers via /commit and validator sets via /validators,
rebuilds the core types through rpc/codec.py, and sanity-checks that the
reported validator set hashes to the header's validators_hash before
handing the LightBlock to the verifier (the verifier re-checks
everything; this just fails fast on a lying provider). Also carries
report_evidence: the detector submits attack evidence back to providers
through the broadcast_evidence route (reference
light/provider/http ReportEvidence).

Transport failures are retried with exponential backoff (reference
http.go's retry loop around signedHeader/validatorSet) and each request
carries the provider's timeout. Only TRANSPORT faults retry — a
response that decodes but fails the validator-hash sanity check is a
lying provider, re-asking cannot fix it, and it raises immediately.

Twin of `cometbft_tpu/light/provider_http.py`.
"""

from __future__ import annotations

import time

from ..rpc.client import HTTPClient
from ..rpc.codec import commit_from_json, header_from_json, validator_set_from_json
from .client import Provider, ProviderError
from .types import LightBlock, SignedHeader


class HTTPProvider(Provider):
    def __init__(self, chain_id: str, base_url: str, timeout_s: float = 10.0,
                 retries: int = 3, backoff_s: float = 0.05,
                 backoff_factor: float = 2.0):
        self._chain_id = chain_id
        self.client = HTTPClient(base_url, timeout=timeout_s)
        self.base_url = base_url
        self.timeout_s = timeout_s
        self.retries = max(0, int(retries))
        self.backoff_s = backoff_s
        self.backoff_factor = backoff_factor

    def __repr__(self):
        return f"HTTPProvider({self.base_url})"

    def chain_id(self) -> str:
        return self._chain_id

    def _call(self, method: str, params: dict):
        """One RPC with retry-with-backoff on transport/RPC failure."""
        delay = self.backoff_s
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            try:
                return self.client.call(method, params, timeout=self.timeout_s)
            except Exception as e:  # noqa: BLE001 — network/RPC failure
                last = e
                if attempt < self.retries:
                    time.sleep(delay)
                    delay *= self.backoff_factor
        raise ProviderError(
            f"{self.base_url}: {method} failed after "
            f"{self.retries + 1} attempts: {last}"
        ) from last

    def light_block(self, height: int) -> LightBlock | None:
        c = self._call("commit", {"height": str(height)})
        v = self._call("validators", {"height": str(height)})
        sh = c.get("signed_header") or {}
        header = header_from_json(sh.get("header") or {})
        commit = commit_from_json(sh.get("commit") or {})
        if header.height == 0:
            return None
        vals = validator_set_from_json(v)
        if vals.hash() != header.validators_hash:
            raise ProviderError(
                f"{self.base_url}: validator set does not hash to header "
                f"validators_hash at height {height}"
            )
        return LightBlock(SignedHeader(header, commit), vals)

    def report_evidence(self, ev) -> None:
        # wrapped(): the tagged oneof form decode_evidence expects
        self._call("broadcast_evidence", {"evidence": ev.wrapped().hex()})
