"""Block sync: catch-up replay of stored chains (`replay.py`) and of chains
fetched from peers (`pool.py`, `reactor.py`); twin of
`cometbft_tpu/blocksync/`."""

from .replay import ReplayEngine, ReplayStats  # noqa: F401
