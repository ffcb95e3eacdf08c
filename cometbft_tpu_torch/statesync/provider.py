"""Twin of `cometbft_tpu/statesync/provider.py`. Light-client-backed state provider for state sync.

Behavior parity: reference internal/statesync/stateprovider.go:203 —
the trust anchor for a restored snapshot comes from light-client
verification, never from the snapshot's senders:

- app_hash(H) verifies the light block at H+1 (whose header carries the
  app hash of H) and pre-fetches H and H+2 for State().
- commit(H) is the verified commit at H.
- state(H) assembles the sm.State the node boots from: snapshot height
  maps to last block = H, current = H+1 (first block processed after
  restore), next = H+2 (validator changes at H take effect then).

The port keeps each light block it verified, as verified, and builds
State() from those. The reference reads them back from the light
client's store, whose encoding keeps each validator's priority but not
the set's proposer, so when priorities tie the restored sets name
another proposer than the chain's (the one the last increment chose);
the port's restored State equals the source's in every validator set.
The light client itself takes `device=`.
"""

from __future__ import annotations

from ..light.client import LightClient
from ..state.types import ConsensusParams, State
from ..types.basic import Timestamp


class LightStateProvider:
    def __init__(
        self,
        light_client: LightClient,
        chain_id: str,
        initial_height: int = 1,
        params_provider=None,
        now: Timestamp | None = None,
    ):
        """params_provider(height) -> ConsensusParams; defaults to the
        genesis defaults (the reference fetches them over RPC with
        light-client proof — rpc seam kept injectable here)."""
        self._lc = light_client
        self._chain_id = chain_id
        self._initial_height = max(initial_height, 1)
        self._params = params_provider or (lambda h: ConsensusParams())
        self._now = now
        self._verified: dict = {}  # height -> the LightBlock as verified

    def _verify(self, height: int):
        lb = self._verified.get(height)
        if lb is not None:
            return lb
        now = self._now
        if now is None:
            import time

            now = Timestamp.from_unix_ns(time.time_ns())
        lb = self._verified[height] = self._lc.verify_to_height(height, now)
        return lb

    def app_hash(self, height: int) -> bytes:
        # ascending order: the light client verifies forward from its
        # trusted root, and each verified block lands in its store for
        # the later State()/Commit() lookups
        self._verify(height)
        nxt = self._verify(height + 1)
        self._verify(height + 2)
        return nxt.signed_header.header.app_hash

    def commit(self, height: int):
        return self._verify(height).signed_header.commit

    def state(self, height: int) -> State:
        last = self._verify(height)
        cur = self._verify(height + 1)
        nxt = self._verify(height + 2)
        return State(
            chain_id=self._chain_id,
            initial_height=self._initial_height,
            last_block_height=last.height,
            last_block_id=last.signed_header.commit.block_id,
            last_block_time=last.signed_header.header.time,
            validators=cur.validators,
            last_validators=last.validators,
            next_validators=nxt.validators,
            last_height_validators_changed=nxt.height,
            consensus_params=self._params(cur.height),
            last_height_params_changed=cur.height,
            last_results_hash=cur.signed_header.header.last_results_hash,
            app_hash=cur.signed_header.header.app_hash,
        )
