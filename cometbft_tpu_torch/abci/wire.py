"""ABCI wire encoding for the socket protocol.

Varint-length-delimited framing like the reference's socket protocol
(reference internal/protoio + abci/client/socket_client.go). Message
schema: Request/Response = {1: method id (varint), 2: payload (bytes)};
payloads are per-method proto encodings of the dataclasses in
abci/types.py. The schema is this framework's own (the reference uses its
generated Request/Response oneofs); the framing and pipelining semantics
are the parity target, not the byte layout.

Twin of `cometbft_tpu/abci/wire.py`, byte for byte.
"""

from __future__ import annotations

from ..encoding import proto as pb
from ..types import Timestamp
from . import types as T

# method ids
ECHO = 1
FLUSH = 2
INFO = 3
INIT_CHAIN = 4
QUERY = 5
CHECK_TX = 6
PREPARE_PROPOSAL = 7
PROCESS_PROPOSAL = 8
FINALIZE_BLOCK = 9
COMMIT = 10
EXTEND_VOTE = 11
VERIFY_VOTE_EXTENSION = 12
LIST_SNAPSHOTS = 13
OFFER_SNAPSHOT = 14
LOAD_SNAPSHOT_CHUNK = 15
APPLY_SNAPSHOT_CHUNK = 16


def frame(method: int, payload: bytes) -> bytes:
    body = pb.f_varint(1, method, emit_zero=True) + pb.f_bytes(2, payload)
    return pb.length_prefixed(body)


def read_frame(read_exact) -> tuple[int, bytes]:
    """read_exact(n) -> bytes; returns (method, payload)."""
    # varint length
    shift, ln = 0, 0
    while True:
        b = read_exact(1)[0]
        ln |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 63:
            raise ValueError("frame length varint too long")
    body = read_exact(ln)
    d = pb.fields_to_dict(body)
    return int(d.get(1, 0)), pb.as_bytes(d.get(2, b""))


# ---------------------------------------------------------------- requests
def enc_tx_list(txs: list[bytes]) -> bytes:
    return b"".join(pb.f_bytes(1, t, emit_empty=True) for t in txs)


def dec_tx_list(buf: bytes) -> list[bytes]:
    return [pb.as_bytes(v) for f, _, v in pb.parse_fields(buf) if f == 1]


def enc_finalize_req(req: T.FinalizeBlockRequest) -> bytes:
    ci = pb.f_varint(1, req.decided_last_commit.round)
    for addr, power, signed in req.decided_last_commit.votes:
        ci += pb.f_embedded(
            2,
            pb.f_bytes(1, addr)
            + pb.f_varint(2, power)
            + pb.f_varint(3, 1 if signed else 0),
        )
    mb = b""
    for m in req.misbehavior:
        mb += pb.f_embedded(
            1,
            pb.f_varint(1, m.type)
            + pb.f_bytes(2, m.validator_address)
            + pb.f_varint(3, m.validator_power)
            + pb.f_varint(4, m.height)
            + pb.f_embedded(5, m.time.encode())
            + pb.f_varint(6, m.total_voting_power),
        )
    return (
        pb.f_embedded(1, enc_tx_list(req.txs))
        + pb.f_embedded(2, ci)
        + pb.f_embedded(3, mb)
        + pb.f_bytes(4, req.hash)
        + pb.f_varint(5, req.height)
        + pb.f_embedded(6, req.time.encode())
        + pb.f_bytes(7, req.next_validators_hash)
        + pb.f_bytes(8, req.proposer_address)
    )


def dec_finalize_req(buf: bytes) -> T.FinalizeBlockRequest:
    d = pb.fields_to_dict(buf)
    ci = T.CommitInfo()
    if 2 in d:
        cd = pb.parse_fields(pb.as_bytes(d[2]))
        for f, _, v in cd:
            if f == 1:
                ci.round = pb.to_i64(v)
            elif f == 2:
                vd = pb.fields_to_dict(pb.as_bytes(v))
                ci.votes.append(
                    (pb.as_bytes(vd.get(1, b"")), pb.to_i64(vd.get(2, 0)),
                     bool(vd.get(3, 0)))
                )
    mbs = []
    if 3 in d:
        for f, _, v in pb.parse_fields(pb.as_bytes(d[3])):
            if f == 1:
                md = pb.fields_to_dict(pb.as_bytes(v))
                mbs.append(T.Misbehavior(
                    type=int(md.get(1, 0)),
                    validator_address=pb.as_bytes(md.get(2, b"")),
                    validator_power=pb.to_i64(md.get(3, 0)),
                    height=pb.to_i64(md.get(4, 0)),
                    time=Timestamp.decode(pb.as_bytes(md.get(5, b""))),
                    total_voting_power=pb.to_i64(md.get(6, 0)),
                ))
    return T.FinalizeBlockRequest(
        txs=dec_tx_list(pb.as_bytes(d.get(1, b""))),
        decided_last_commit=ci,
        misbehavior=mbs,
        hash=pb.as_bytes(d.get(4, b"")),
        height=pb.to_i64(d.get(5, 0)),
        time=Timestamp.decode(pb.as_bytes(d.get(6, b""))),
        next_validators_hash=pb.as_bytes(d.get(7, b"")),
        proposer_address=pb.as_bytes(d.get(8, b"")),
    )


def enc_finalize_resp(r: T.FinalizeBlockResponse) -> bytes:
    out = b""
    for tr in r.tx_results:
        out += pb.f_embedded(
            1,
            pb.f_varint(1, tr.code)
            + pb.f_bytes(2, tr.data)
            + pb.f_string(3, tr.log)
            + pb.f_varint(5, tr.gas_wanted)
            + pb.f_varint(6, tr.gas_used),
        )
    for vu in r.validator_updates:
        out += pb.f_embedded(
            2,
            pb.f_bytes(1, vu.pub_key_bytes)
            + pb.f_string(2, vu.pub_key_type)
            + pb.f_varint(3, vu.power),
        )
    out += pb.f_bytes(3, r.app_hash)
    return out


def dec_finalize_resp(buf: bytes) -> T.FinalizeBlockResponse:
    resp = T.FinalizeBlockResponse()
    for f, _, v in pb.parse_fields(buf):
        if f == 1:
            td = pb.fields_to_dict(pb.as_bytes(v))
            resp.tx_results.append(T.ExecTxResult(
                code=int(td.get(1, 0)),
                data=pb.as_bytes(td.get(2, b"")),
                log=pb.as_bytes(td.get(3, b"")).decode("utf-8", "replace"),
                gas_wanted=pb.to_i64(td.get(5, 0)),
                gas_used=pb.to_i64(td.get(6, 0)),
            ))
        elif f == 2:
            vd = pb.fields_to_dict(pb.as_bytes(v))
            resp.validator_updates.append(T.ValidatorUpdate(
                pub_key_bytes=pb.as_bytes(vd.get(1, b"")),
                pub_key_type=pb.as_bytes(vd.get(2, b"ed25519")).decode(),
                power=pb.to_i64(vd.get(3, 0)),
            ))
        elif f == 3:
            resp.app_hash = pb.as_bytes(v)
    return resp


def enc_info_resp(r: T.InfoResponse) -> bytes:
    return (
        pb.f_string(1, r.data)
        + pb.f_string(2, r.version)
        + pb.f_varint(3, r.app_version)
        + pb.f_varint(4, r.last_block_height)
        + pb.f_bytes(5, r.last_block_app_hash)
    )


def dec_info_resp(buf: bytes) -> T.InfoResponse:
    d = pb.fields_to_dict(buf)
    return T.InfoResponse(
        data=pb.as_bytes(d.get(1, b"")).decode("utf-8", "replace"),
        version=pb.as_bytes(d.get(2, b"")).decode("utf-8", "replace"),
        app_version=pb.to_i64(d.get(3, 0)),
        last_block_height=pb.to_i64(d.get(4, 0)),
        last_block_app_hash=pb.as_bytes(d.get(5, b"")),
    )


def enc_check_tx_resp(r: T.CheckTxResult) -> bytes:
    return (
        pb.f_varint(1, r.code)
        + pb.f_bytes(2, r.data)
        + pb.f_string(3, r.log)
        + pb.f_varint(4, r.gas_wanted)
    )


def dec_check_tx_resp(buf: bytes) -> T.CheckTxResult:
    d = pb.fields_to_dict(buf)
    return T.CheckTxResult(
        code=int(d.get(1, 0)),
        data=pb.as_bytes(d.get(2, b"")),
        log=pb.as_bytes(d.get(3, b"")).decode("utf-8", "replace"),
        gas_wanted=pb.to_i64(d.get(4, 0)),
    )


def enc_query_req(path: str, data: bytes, height: int) -> bytes:
    return pb.f_string(1, path) + pb.f_bytes(2, data) + pb.f_varint(3, height)


def dec_query_req(buf: bytes) -> tuple[str, bytes, int]:
    d = pb.fields_to_dict(buf)
    return (
        pb.as_bytes(d.get(1, b"")).decode("utf-8", "replace"),
        pb.as_bytes(d.get(2, b"")),
        pb.to_i64(d.get(3, 0)),
    )


def enc_query_resp(r: T.QueryResponse) -> bytes:
    return (
        pb.f_varint(1, r.code)
        + pb.f_bytes(2, r.key)
        + pb.f_bytes(3, r.value)
        + pb.f_varint(4, r.height)
        + pb.f_string(5, r.log)
    )


def dec_query_resp(buf: bytes) -> T.QueryResponse:
    d = pb.fields_to_dict(buf)
    return T.QueryResponse(
        code=int(d.get(1, 0)),
        key=pb.as_bytes(d.get(2, b"")),
        value=pb.as_bytes(d.get(3, b"")),
        height=pb.to_i64(d.get(4, 0)),
        log=pb.as_bytes(d.get(5, b"")).decode("utf-8", "replace"),
    )


def enc_init_chain_req(req: T.InitChainRequest) -> bytes:
    vals = b""
    for vu in req.validators:
        vals += pb.f_embedded(
            1,
            pb.f_bytes(1, vu.pub_key_bytes)
            + pb.f_string(2, vu.pub_key_type)
            + pb.f_varint(3, vu.power),
        )
    return (
        pb.f_embedded(1, req.time.encode())
        + pb.f_string(2, req.chain_id)
        + pb.f_embedded(3, vals)
        + pb.f_bytes(4, req.app_state_bytes)
        + pb.f_varint(5, req.initial_height)
    )


def dec_init_chain_req(buf: bytes) -> T.InitChainRequest:
    d = pb.fields_to_dict(buf)
    vals = []
    if 3 in d:
        for f, _, v in pb.parse_fields(pb.as_bytes(d[3])):
            if f == 1:
                vd = pb.fields_to_dict(pb.as_bytes(v))
                vals.append(T.ValidatorUpdate(
                    pub_key_bytes=pb.as_bytes(vd.get(1, b"")),
                    pub_key_type=pb.as_bytes(vd.get(2, b"ed25519")).decode(),
                    power=pb.to_i64(vd.get(3, 0)),
                ))
    return T.InitChainRequest(
        time=Timestamp.decode(pb.as_bytes(d.get(1, b""))),
        chain_id=pb.as_bytes(d.get(2, b"")).decode("utf-8", "replace"),
        validators=vals,
        app_state_bytes=pb.as_bytes(d.get(4, b"")),
        initial_height=pb.to_i64(d.get(5, 1)),
    )


def enc_init_chain_resp(r: T.InitChainResponse) -> bytes:
    vals = b""
    for vu in r.validators:
        vals += pb.f_embedded(
            1,
            pb.f_bytes(1, vu.pub_key_bytes)
            + pb.f_string(2, vu.pub_key_type)
            + pb.f_varint(3, vu.power),
        )
    return pb.f_embedded(1, vals) + pb.f_bytes(2, r.app_hash)


def dec_init_chain_resp(buf: bytes) -> T.InitChainResponse:
    d = pb.fields_to_dict(buf)
    vals = []
    if 1 in d:
        for f, _, v in pb.parse_fields(pb.as_bytes(d[1])):
            if f == 1:
                vd = pb.fields_to_dict(pb.as_bytes(v))
                vals.append(T.ValidatorUpdate(
                    pub_key_bytes=pb.as_bytes(vd.get(1, b"")),
                    pub_key_type=pb.as_bytes(vd.get(2, b"ed25519")).decode(),
                    power=pb.to_i64(vd.get(3, 0)),
                ))
    return T.InitChainResponse(validators=vals, app_hash=pb.as_bytes(d.get(2, b"")))
