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
