"""Block sync: catch-up replay of stored chains (twin of
`cometbft_tpu/blocksync/`'s replay engine; the block pool and the p2p
reactor are not here yet)."""

from .replay import ReplayEngine, ReplayStats  # noqa: F401
