"""Boot-time ABCI handshake: catch the app up to the stored chain.

Behavior parity: reference internal/consensus/replay.go —
- Handshake (:241): ABCI Info -> compare the app's last height/hash with
  the block store -> ReplayBlocks (:283);
- InitChain on a fresh app (:307-338) with the genesis validators;
- blocks the app is missing are re-executed through FinalizeBlock+Commit
  (:505 replayBlock); blocks the *state* is missing go through the full
  executor (signatures were verified before they were stored, so the
  LastCommit re-verification is elided like the batched replay path);
- the final app hash must match the replayed state's app hash (:413).

Twin of `cometbft_tpu/state/handshake.py`; the executor it builds takes
the node's `device=` ("cuda" by default) where the reference's takes
`backend=`.
"""

from __future__ import annotations

from dataclasses import replace

from ..abci.types import FinalizeBlockRequest, InitChainRequest, ValidatorUpdate
from ..types.block import block_id_for
from .execution import BlockExecutor, build_last_commit_info


class HandshakeError(Exception):
    pass


class Handshaker:
    def __init__(self, state_store, block_store, genesis_state,
                 device="cuda"):
        self.state_store = state_store
        self.block_store = block_store
        self.genesis_state = genesis_state
        self.device = device
        self.blocks_replayed = 0

    def handshake(self, app_conns):
        """Returns the post-replay sm.State."""
        info = app_conns.query.info()
        app_height = info.last_block_height
        app_hash = info.last_block_app_hash

        state = self.state_store.load()
        if state is None:
            # bootstrap: persist genesis validators for heights 1 and 2
            # (reference internal/state/store.go Bootstrap)
            state = self.genesis_state.copy()
            self.state_store.save(state)

        if app_height == 0:
            # fresh app: InitChain with the genesis validator set
            res = app_conns.consensus.init_chain(
                InitChainRequest(
                    time=self.genesis_state.last_block_time,
                    chain_id=self.genesis_state.chain_id,
                    validators=[
                        ValidatorUpdate(
                            pub_key_bytes=v.pub_key.bytes(), power=v.voting_power
                        )
                        for v in self.genesis_state.validators.validators
                    ],
                    initial_height=self.genesis_state.initial_height,
                )
            )
            if state.last_block_height == 0 and res.app_hash:
                state = replace(state, app_hash=res.app_hash)
                app_hash = res.app_hash

        store_height = self.block_store.height()
        if app_height > store_height:
            raise HandshakeError(
                f"app height {app_height} ahead of store {store_height}"
            )
        if app_height > state.last_block_height:
            raise HandshakeError(
                f"app height {app_height} ahead of state "
                f"{state.last_block_height}"
            )

        executor = BlockExecutor(
            app_conns, state_store=self.state_store, device=self.device
        )
        for h in range(app_height + 1, store_height + 1):
            block = self.block_store.load_block(h)
            if block is None:
                raise HandshakeError(f"store missing block {h}")
            if h <= state.last_block_height:
                # app behind state: execute into the app only (:505)
                resp = app_conns.consensus.finalize_block(
                    FinalizeBlockRequest(
                        txs=block.data.txs,
                        decided_last_commit=build_last_commit_info(
                            block, self.state_store.load_validators(h - 1)
                            if h > 1 else None
                        ),
                        hash=block.hash() or b"",
                        height=h,
                        time=block.header.time,
                        next_validators_hash=block.header.next_validators_hash,
                        proposer_address=block.header.proposer_address,
                    )
                )
                app_conns.consensus.commit()
                app_hash = resp.app_hash
            else:
                # both state and app need the block: full apply, signature
                # re-verification elided (stored blocks were verified)
                state = executor.apply_block(
                    state, block_id_for(block), block,
                    last_commit_preverified=True,
                )
                app_hash = state.app_hash
            self.blocks_replayed += 1

        if state.last_block_height > 0 and app_hash != state.app_hash:
            raise HandshakeError(
                f"app hash {app_hash.hex()[:12]} != state "
                f"{state.app_hash.hex()[:12]} after replay"
            )
        return state
