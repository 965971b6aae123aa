"""exhook: the gRPC HookProvider contract, both directions, on the
port's own gRPC stack (`grpc_util.py` over `h2.py`).

`pb` is the package's own copy of ``exhook.proto`` compiled by the
port's proto3 parser (`protobuf.load`): no protoc, no generated module,
no ``google.protobuf``.  `ExhookServer` serves HookProvider backed by
the broker; `client.ExhookClient` calls out to an external provider.
"""

from __future__ import annotations

import os

from ..protobuf import load

PROTO_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "exhook.proto")

with open(PROTO_PATH, encoding="utf-8") as _f:
    pb = load(_f.read(), "exhook.proto")

from .server import ExhookServer  # noqa: E402,F401
