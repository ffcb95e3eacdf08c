"""The multi-device verify mesh (twin of `cometbft_tpu/parallel/`)."""
