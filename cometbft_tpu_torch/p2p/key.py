"""Node identity keys (reference p2p/key.go; twin of
`cometbft_tpu/p2p/key.py`).

A node's identity is an Ed25519 key; its ID is the hex of the pubkey's
address (20-byte truncated SHA-256, reference p2p/key.go:120 PubKeyToID).
The key signs through the port's `Ed25519PrivKey`, that is through the
native engine (there is no Python fallback).
"""

from __future__ import annotations

import json
import os

from ..crypto.ed25519 import Ed25519PrivKey


class NodeKey:
    def __init__(self, priv_key: Ed25519PrivKey):
        self.priv_key = priv_key

    @classmethod
    def generate(cls) -> "NodeKey":
        return cls(Ed25519PrivKey.generate())

    @classmethod
    def load_or_generate(cls, path: str) -> "NodeKey":
        if os.path.exists(path):
            with open(path) as f:
                d = json.load(f)
            return cls(Ed25519PrivKey(bytes.fromhex(d["priv_key"])))
        nk = cls.generate()
        with open(path, "w") as f:
            json.dump({"priv_key": nk.priv_key.bytes().hex()}, f)
        return nk

    def node_id(self) -> str:
        return self.priv_key.pub_key().address().hex()
