"""The part of `chip_smoke.py`'s logic that runs without a card."""

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from cometbft_tpu_torch.crypto import ed25519 as E  # noqa: E402


def test_rlc_submit_is_repeated_while_the_layout_declines(monkeypatch):
    """A declined layout sends the commit to the ladder: the smoke run
    hands that result to its check and submits again, so a decline (about
    one 10,000-signature commit in sixteen) does not fail the run; the
    submits are counted for the per-commit launch figures."""
    rlc = object.__new__(E.PendingRLC)
    ladder = [object(), object()]
    results = iter(ladder + [rlc])
    monkeypatch.setattr(chip_smoke, "submit_commit", lambda cols, dev: next(results))
    seen = []
    assert chip_smoke.submit_through_rlc(None, "cpu", seen.append) == (rlc, 3)
    assert seen == ladder


def test_rlc_submit_gives_up_after_repeated_declines(monkeypatch):
    monkeypatch.setattr(chip_smoke, "submit_commit", lambda cols, dev: object())
    seen = []
    with pytest.raises(AssertionError, match="declined the commit 5 times"):
        chip_smoke.submit_through_rlc(None, "cpu", seen.append)
    assert len(seen) == 5


def test_sources_name_every_kernel_and_the_function_it_replaces():
    """`SOURCES` lists the nine kernels, the same names as the launch
    counts; each source exists; each kernel's first `file:line` of the JAX
    package is the `def` of the function it computes (a Pallas kernel, or
    a plain-XLA function for `region_sum`, `window_combine`,
    `sha512_blocks` and `reduce512`); the device-SHA routes' kernels are
    in it."""
    from cometbft_tpu_torch.ops import kernels as K

    assert list(chip_smoke.SOURCES) == list(K.launches) and len(K.launches) == 9
    for name, (source, replaces) in chip_smoke.SOURCES.items():
        assert (chip_smoke.ROOT / source).is_file(), source
        path, line = replaces.split(",")[0].split()[0].split(":")
        text = (chip_smoke.ROOT / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith("def "), (name, text)
    assert set(chip_smoke.SHA_KERNELS) <= set(chip_smoke.SOURCES)


def test_bound_counts():
    """The operation counts behind the two new kernels' bounds: a SHA-512
    block's 32-bit instructions and `reduce512`'s wide multiplies."""
    assert chip_smoke.SHA_INT_OPS_PER_BLOCK == 3696
    assert chip_smoke.REDUCE_WIDE_MULS == 81 + 44
