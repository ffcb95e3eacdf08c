"""Wire encodings: the port's own copy of `cometbft_tpu/encoding/proto.py`,
the minimal protobuf writer/reader that canonical sign bytes and every
consensus type's encode/decode are built on."""
