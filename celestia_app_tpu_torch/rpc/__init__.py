"""The serving plane: JSON-RPC over HTTP (sockets, multi-process).

The reference runs gRPC/API/RPC servers around the app even in tests
(app/app.go:712-735, test/util/testnode/network.go:38-43); its RPC plane is
JSON-RPC over HTTP. This package is that wire for the TPU framework:

  * `rpc.server.ServingNode` — a node (App + mempool + proposer loop) that
    serves broadcast/query/proof endpoints and replicates blocks to peer
    validators over sockets;
  * `rpc.client.RemoteNode` — the client-side handle presenting the same
    node surface TxClient/txsim consume in-process, but over HTTP;
  * `rpc.gossip.ConsensusDriver` — the round machine over flood gossip
    between ServingNodes (`ServingNode.enable_gossip_consensus`);
  * `rpc.devnet` — a multi-process devnet: N validator processes with a
    rotating proposer exchanging proposals over the wire.

The port's copy of celestia_app_tpu/rpc/, whole: `server` (with its GET
face and state sync), `client`, `gossip`, `transport`, `codec`, `devnet`, the
gRPC plane `grpc_plane` (grpcio imported only where a server or a channel is
made) and the REST gateway `api_gateway`.  The three serving planes mount
the same observability handler (trace/exposition.py), so /metrics, /healthz
and /das/* serve the same bytes on each.
"""

# Lazy exports: ServingNode pulls in the full app stack; the client and
# the codec import without it.
__all__ = ["RemoteNode", "ServingNode", "serve"]


def __getattr__(name: str):
    if name == "RemoteNode":
        from celestia_app_tpu_torch.rpc.client import RemoteNode

        return RemoteNode
    if name in ("ServingNode", "serve"):
        from celestia_app_tpu_torch.rpc import server

        return getattr(server, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
