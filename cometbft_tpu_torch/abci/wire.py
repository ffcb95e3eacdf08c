"""ABCI wire encoding of the FinalizeBlock response.

The per-method proto encoding the reference writes for a block's ABCI
responses (`state/execution.py::apply_block` stores it in the state
store): this framework's own schema, not the reference's generated
oneofs.

The port's part of `cometbft_tpu/abci/wire.py`, byte for byte: the
socket framing and the other methods' codecs come with the ABCI socket
client.
"""

from __future__ import annotations

from ..encoding import proto as pb
from . import types as T


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
