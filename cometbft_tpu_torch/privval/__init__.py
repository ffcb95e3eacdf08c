"""Private validators (twin of `cometbft_tpu/privval/`): the file-backed
signer. The remote signer (`signer.py`, sockets) comes with the node."""

from .file_pv import DoubleSignError, FilePV, SignStep

__all__ = ["FilePV", "SignStep", "DoubleSignError"]
