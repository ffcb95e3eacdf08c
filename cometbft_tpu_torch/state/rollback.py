"""Twin of `cometbft_tpu/state/rollback.py`. One-height state rollback (`rollback` CLI command).

Behavior parity: reference internal/state/rollback.go — overwrites the
latest persisted state (height n) with the state as of height n-1 so a
node can re-apply block n (e.g. after an app-hash divergence from a
faulty upgrade). Application state is NOT touched; the app must roll
back itself (or replay via handshake). With remove_block=True the
pending block n is also deleted when the block store ran ahead of the
state store.
"""

from __future__ import annotations

from dataclasses import replace


class RollbackError(Exception):
    pass


def rollback(block_store, state_store, remove_block: bool = False):
    """Returns (new_height, app_hash) after rolling back one height."""
    invalid_state = state_store.load()
    if invalid_state is None:
        raise RollbackError("no state found")

    height = block_store.height()

    # state/block saves aren't atomic: the block store may be one ahead
    # (block n+1 saved, state not yet updated) — just drop that block.
    if height == invalid_state.last_block_height + 1:
        if remove_block:
            block_store.delete_latest_block()
        return invalid_state.last_block_height, invalid_state.app_hash

    if height != invalid_state.last_block_height:
        raise RollbackError(
            f"state height ({invalid_state.last_block_height}) is not one "
            f"below or equal to blockstore height ({height})"
        )

    rollback_height = invalid_state.last_block_height - 1
    rollback_block = block_store.load_block(rollback_height)
    if rollback_block is None:
        raise RollbackError(f"block at height {rollback_height} not found")
    # app hash / last results hash for height n-1 live in block n's header
    latest_block = block_store.load_block(invalid_state.last_block_height)
    if latest_block is None:
        raise RollbackError(
            f"block at height {invalid_state.last_block_height} not found"
        )

    prev_last_vals = state_store.load_validators(rollback_height)
    if prev_last_vals is None:
        raise RollbackError(f"no validators stored for height {rollback_height}")

    val_change = min(
        invalid_state.last_height_validators_changed, rollback_height + 1
    )
    params_change = min(
        invalid_state.last_height_params_changed, rollback_height + 1
    )
    # restore the params as of validating block rollback_height+1 — a
    # params change that landed at the rolled-back height must not
    # survive the rollback (reference internal/state/rollback.go
    # LoadConsensusParams(rollbackHeight+1))
    prev_params = state_store.load_consensus_params(rollback_height + 1)

    rolled = replace(
        invalid_state,
        last_block_height=rollback_block.header.height,
        last_block_id=latest_block.header.last_block_id,
        last_block_time=rollback_block.header.time,
        next_validators=invalid_state.validators,
        validators=invalid_state.last_validators,
        last_validators=prev_last_vals,
        last_height_validators_changed=val_change,
        last_height_params_changed=params_change,
        last_results_hash=latest_block.header.last_results_hash,
        app_hash=latest_block.header.app_hash,
        **(
            {"consensus_params": prev_params} if prev_params is not None else {}
        ),
    )
    state_store.save(rolled)
    if remove_block:
        block_store.delete_latest_block()
    return rolled.last_block_height, rolled.app_hash
