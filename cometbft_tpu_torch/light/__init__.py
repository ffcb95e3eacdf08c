"""Light client verification: the port's twin of the part of
`cometbft_tpu/light/` that verifies headers (types and the pure
verifier functions). The client, its store, serving and MMR are not here
yet."""

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

__all__ = [
    "LightBlock",
    "SignedHeader",
    "ErrHeaderExpired",
    "ErrInvalidHeader",
    "ErrNewValSetCantBeTrusted",
    "verify",
    "verify_adjacent",
    "verify_non_adjacent",
    "verify_stream",
]
