"""Batched edwards25519 device code: PyTorch around hand-written CUDA kernels.

Layout convention (the reference's): field elements are int32 tensors of
shape (NLIMBS, B) with the batch on the trailing axis.

Kernels are built from `cometbft_tpu_torch/csrc/*.cu` on first use into
`build/cometbft_tpu_torch/<source hash>/` beside the package (see
`kernels.build_dir`); nothing is built at import time.
"""
