"""The forward step of the port's flagship data plane, with its example batch.

Twin of `__graft_entry__.py::entry` and `_example_batch`: batched ZIP-215
Ed25519 verification with SHA-512, the reduction mod L, decompression and
the ladder all on the device (`ops.ed25519_verify.verify_batch`). The
reference's `dryrun_multichip` has no twin until the mesh is ported.
"""

from __future__ import annotations

import numpy as np
import torch


def _example_batch(n: int, device="cuda"):
    """Deterministic valid signature batch packed for the device: a handful
    of distinct signatures from the pure-Python oracle, tiled to n lanes.
    Returns (a, r, s, words, two_blocks, live) as tensors on `device`."""
    from .crypto import ed25519_ref as ref
    from .ops.sha512 import pad_messages

    base = []
    for i in range(min(n, 4)):
        seed = bytes([i]) * 32
        msg = b"graft-entry-%d" % i
        pub = ref.pubkey_from_seed(seed)
        sig = ref.sign(seed, msg)
        base.append((pub, sig[:32], sig[32:], sig[:32] + pub + msg))
    rows = [base[i % len(base)] for i in range(n)]
    a = np.frombuffer(b"".join(p for p, _, _, _ in rows), np.uint8).reshape(n, 32)
    r = np.frombuffer(b"".join(rb for _, rb, _, _ in rows), np.uint8).reshape(n, 32)
    s = np.frombuffer(b"".join(sb for _, _, sb, _ in rows), np.uint8).reshape(n, 32)
    words, two_blocks = pad_messages([pre for _, _, _, pre in rows])
    arrays = (a, r, s, words.view(np.int32), two_blocks, np.ones(n, bool))
    return tuple(torch.from_numpy(np.array(x)).to(device) for x in arrays)


def entry(n: int = 256, device="cuda"):
    """(fn, example_args): fn(*example_args) verifies the batch on `device`
    and returns the (n,) bool validity bitmap, left on the device."""
    from .ops.ed25519_verify import verify_batch

    def fwd(a, r, s, m, tb, live):
        bits, _all_ok = verify_batch(a, r, s, m, tb, live)
        return bits

    return fwd, _example_batch(n, device)
