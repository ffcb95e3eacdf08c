"""PyTorch/CUDA twin of the cometbft_tpu Ed25519 commit-verify path and
the consumers that verify commits through it (`types/`, `light/`,
`crypto/sched.py`).

The package mirrors `cometbft_tpu`'s module tree (`ops/field.py` is the twin
of `cometbft_tpu/ops/field.py`, and so on) and keeps the reference's
(22, B) int32 limb layout at every public function. Its device code is
PyTorch plus hand-written CUDA kernels for Hopper (`csrc/`), built with
`nvcc` on first use (`ops/kernels.py`).

It imports torch, numpy and the standard library only: never jax and
never `cometbft_tpu`. Entry points take `device=` and default to "cuda";
a CUDA tensor always goes through the kernels, a CPU tensor through their
plain PyTorch versions.
"""

__version__ = "0.3.0"  # the reference's version: the node and CLI report it
