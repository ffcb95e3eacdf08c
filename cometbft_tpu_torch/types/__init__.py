"""Core consensus datatypes: blocks, votes, commits, validator sets.

The port's own copy of the part of `cometbft_tpu/types/` that commit
verification needs. Wire-compatible with the reference's proto encodings
(canonical sign-bytes are bit-exact; tests/test_torch_types.py holds them
against the JAX package's), the evidence types (`types/evidence.py`),
proposals and vote sets (`types/proposal.py`, `types/vote_set.py`). Not
here yet: genesis and certificate-native commits.
"""

from .basic import BlockID, PartSetHeader, Timestamp, ZERO_TIME  # noqa: F401
from .vote import Vote, SignedMsgType  # noqa: F401
from .proposal import Proposal  # noqa: F401
from .block import Block, Commit, CommitSig, Data, Header, BlockIDFlag  # noqa: F401
from .validator_set import Validator, ValidatorSet  # noqa: F401
from .vote_set import VoteSet  # noqa: F401
from .validation import (  # noqa: F401
    verify_commit,
    verify_commit_light,
    verify_commit_light_trusting,
)
