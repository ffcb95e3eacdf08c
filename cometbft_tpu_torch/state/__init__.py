"""Execution state and the block executor (ABCI driving loop).

Twin of `cometbft_tpu/state/`: `types.py`, `execution.py`, `pruner.py`
and `rollback.py`. The handshake comes with the node.
"""

from .types import State, ConsensusParams  # noqa: F401
from .execution import BlockExecutor  # noqa: F401
