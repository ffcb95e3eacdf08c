"""Light client verification: the port's twin of `cometbft_tpu/light/`
without its serving surface (the types, the pure verifier functions, the
client with its trusted store and providers, and the MMR accumulator;
`serve.py`, `provider_http.py` and `proxy.py` come with the RPC)."""

from .types import LightBlock, SignedHeader
from .verifier import (
    ErrHeaderExpired,
    ErrInvalidHeader,
    ErrNewValSetCantBeTrusted,
    verify,
    verify_adjacent,
    verify_non_adjacent,
    verify_stream,
)
from .client import (
    ErrConflictingHeaders,
    ErrNoWitnesses,
    LightClient,
    Provider,
    ProviderError,
    StoreProvider,
    verify_ancestry,
)
from .mmr import MMR, MMRProof
from .store import LightStore, MMRStore

__all__ = [
    "ErrConflictingHeaders",
    "ErrNoWitnesses",
    "ProviderError",
    "LightBlock",
    "SignedHeader",
    "ErrHeaderExpired",
    "ErrInvalidHeader",
    "ErrNewValSetCantBeTrusted",
    "verify",
    "verify_adjacent",
    "verify_non_adjacent",
    "verify_stream",
    "verify_ancestry",
    "LightClient",
    "Provider",
    "StoreProvider",
    "LightStore",
    "MMR",
    "MMRProof",
    "MMRStore",
]
