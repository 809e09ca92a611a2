"""Wire codec for per-session recurrent state rows (a copy of
``sheeprl_tpu/serve/session_codec.py``: a blob one package encodes decodes in
the other).

The gateway externalizes DreamerV3 session latents — each a host-side pytree
of ``[1, ...]`` numpy arrays — as opaque base64 blobs that ride JSON request
and response bodies between the gateway's :class:`SessionBroker` and the
replica PolicyServers. The encoding is zlib-compressed pickle, but decoding
goes through a **restricted unpickler** that only reconstructs numpy arrays
and the plain containers (tuple/list/dict) session trees are made of: a blob
is data, and a replica must not execute whatever a confused or hostile
client managed to wedge into one.

Blobs are versioned by the broker, not here — the codec is content-only and
deliberately has no schema: any numpy pytree a policy's ``init_state``
produces round-trips unchanged.
"""
from __future__ import annotations

import base64
import io
import pickle
import zlib
from typing import Any

__all__ = ["encode_state", "decode_state", "StateDecodeError"]


class StateDecodeError(ValueError):
    """The blob is not a valid encoded session state."""


# modules whose classes the restricted unpickler may reconstruct: numpy's
# array machinery and nothing else (builtin containers never hit find_class)
_ALLOWED_MODULE_ROOTS = ("numpy",)


class _NumpyOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        if module.split(".")[0] in _ALLOWED_MODULE_ROOTS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"session blob references {module}.{name}: only numpy trees are decodable"
        )


def encode_state(row: Any) -> str:
    """Session state row (numpy pytree) -> transportable base64 string."""
    raw = pickle.dumps(row, protocol=pickle.HIGHEST_PROTOCOL)
    return base64.b64encode(zlib.compress(raw)).decode("ascii")


def decode_state(blob: str) -> Any:
    """Inverse of :func:`encode_state`; raises :class:`StateDecodeError` on
    anything that is not a well-formed numpy-only blob."""
    try:
        raw = zlib.decompress(base64.b64decode(blob.encode("ascii"), validate=True))
        return _NumpyOnlyUnpickler(io.BytesIO(raw)).load()
    except (ValueError, zlib.error, pickle.UnpicklingError, EOFError, TypeError) as e:
        raise StateDecodeError(f"undecodable session state blob: {e}") from e
