"""Batch generation of valid Ed25519 signatures using the device kernels.

Twin of `cometbft_tpu/crypto/testgen.py:generate_signed_batch`: the
device fixed-base ladder computes every A = [a]B and R = [r]B in one
batch (through the field mul and sq kernels on a GPU), and the host
finishes S = r + k*a (mod L). For the same arguments the output is
byte-identical to the reference's, because both draw the same numbers
from `numpy.random.default_rng(seed)` in the same order. Signatures made
this way are standard RFC 8032 signatures with a random r.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..ops import curve as C
from . import ed25519_ref as ref


def generate_signed_batch(
    n: int, seed: int = 0, msg_len: int = 120, vote_shaped: bool = False,
    device="cuda",
):
    """Returns a list of (pubkey32, msg, sig64) with distinct keys/messages.

    vote_shaped=True mirrors canonical precommit sign bytes (reference
    types/canonical.go): a commit-invariant prefix, ~8 bytes of per-vote
    timestamp in the middle, and a shared chain-id suffix."""
    rng = np.random.default_rng(seed)
    a_sc = [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(n)]
    r_sc = [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(n)]
    if vote_shaped:
        mid_len = 8
        sfx_len = 16
        pfx = rng.bytes(msg_len - mid_len - sfx_len)
        sfx = rng.bytes(sfx_len)
        msgs = [pfx + rng.bytes(mid_len) + sfx for _ in range(n)]
    else:
        msgs = [rng.bytes(msg_len) for _ in range(n)]

    def fixed_base_compress(scalars):
        digs = torch.from_numpy(C.scalar_digits(scalars)).to(device)
        return C.compress(C.fixed_base(digs)).cpu().numpy()

    a_enc = fixed_base_compress(a_sc)
    r_enc = fixed_base_compress(r_sc)

    out = []
    for i in range(n):
        pub = a_enc[i].tobytes()
        r_b = r_enc[i].tobytes()
        k = int.from_bytes(hashlib.sha512(r_b + pub + msgs[i]).digest(), "little") % ref.L
        s = (r_sc[i] + k * a_sc[i]) % ref.L
        out.append((pub, bytes(msgs[i]), r_b + s.to_bytes(32, "little")))
    return out
