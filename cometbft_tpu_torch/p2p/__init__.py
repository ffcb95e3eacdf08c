"""Peer-to-peer: node keys, the secret connection, MConnection, the TCP
transport, the switch, the address book and PEX (twin of
`cometbft_tpu/p2p/`; the fuzzing connection, which only the end-to-end
runner uses, is not ported yet)."""

from .key import NodeKey
from .secret_connection import SecretConnection
from .conn import ChannelDescriptor, MConnection
from .switch import Switch, Reactor
from .transport import Transport, NodeInfo

__all__ = [
    "NodeKey",
    "SecretConnection",
    "ChannelDescriptor",
    "MConnection",
    "Switch",
    "Reactor",
    "Transport",
    "NodeInfo",
]
