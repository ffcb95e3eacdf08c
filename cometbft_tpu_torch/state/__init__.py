"""Execution state and the block executor (ABCI driving loop).

Twin of `cometbft_tpu/state/` for block execution: `types.py` and
`execution.py`. The handshake, pruner and rollback are not here yet.
"""

from .types import State, ConsensusParams  # noqa: F401
from .execution import BlockExecutor  # noqa: F401
