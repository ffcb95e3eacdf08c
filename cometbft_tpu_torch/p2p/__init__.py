"""Peer-to-peer: node keys, the secret connection, MConnection, the TCP
transport and the switch (twin of `cometbft_tpu/p2p/`; the address book,
PEX and the fuzzing connection are not ported yet)."""

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
