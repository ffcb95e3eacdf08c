"""State sync (twin of `cometbft_tpu/statesync/`): the snapshot pool, the
chunk queue, the light-client state provider, the syncer and the p2p
reactor with its light-block provider."""

from .chunks import ChunkQueue  # noqa: F401
from .provider import LightStateProvider  # noqa: F401
from .reactor import StateSyncReactor  # noqa: F401
from .snapshots import SnapshotPool  # noqa: F401
from .syncer import (  # noqa: F401
    ErrAbort,
    ErrNoSnapshots,
    ErrRejectSnapshot,
    Syncer,
)
