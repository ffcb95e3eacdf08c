"""The forward step of the port's flagship data plane, with its example batch.

Twin of `__graft_entry__.py::entry` and `_example_batch`: batched ZIP-215
Ed25519 verification with SHA-512, the reduction mod L, decompression and
the ladder all on the device (`ops.ed25519_verify.verify_batch`); and
`dryrun_multichip`, the twin of `__graft_entry__.py::dryrun_multichip`,
which runs that step sharded over a mesh of GPUs (`parallel.mesh`).
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


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Shard the example batch over an n-device mesh and run one step: the
    batch axis cut over the mesh, each shard verified on its device, the
    bad-lane counts summed onto the first device. The mesh is the first n
    GPUs, or n logical shards of one device when fewer exist (of the CPU
    for device="cpu"); it prints which. With an even n the (host, sig)
    grid of 2 rows runs too."""
    from .parallel.mesh import gather_bits, make_mesh, make_mesh_2d, sharded_verify_fn

    dev = torch.device(device)
    have = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is false")
    if have >= n_devices:
        devices, what = [torch.device("cuda", i) for i in range(n_devices)], f"{n_devices} GPUs"
    else:
        devices, what = [dev] * n_devices, f"{n_devices} logical shards of {dev}"
    batch = _example_batch(8 * n_devices, "cpu")
    layouts = [("1-D", make_mesh(devices))]
    if n_devices >= 2 and n_devices % 2 == 0:
        layouts.append(("(host, sig) 2 x %d" % (n_devices // 2), make_mesh_2d(devices, hosts=2)))
    for name, mesh in layouts:
        all_ok, bits = sharded_verify_fn(mesh)(*batch)
        assert bool(all_ok.item()), "dryrun batch must verify"
        assert bool(gather_bits(bits).all())
        print(f"dryrun_multichip({n_devices}): ok - {name} sharded verify ran on {what}")
