"""Network layer of the port (``repro/runtime/net``): real sockets and a
network model, behind the ``Transport`` interface the party-local
protocols are written against.

  * ``framing``          -- length-prefixed, tagged wire format for ring
                            words (the JAX package's bytes);
  * ``SocketTransport``  -- each party in its own OS process, full TCP mesh,
                            the same per-link / per-phase accounting as
                            ``LocalTransport``, outgoing messages coalesced
                            into one frame per (link, round);
  * ``NetModel`` / ``NetModelTransport`` -- per-directed-link latency and
                            bandwidth over either backend, reporting modeled
                            time per phase (the paper's LAN / WAN presets);
  * ``cluster.PartyCluster`` -- the four parties as long-lived daemons on
                            one machine, serving submitted programs (with a
                            PrepBank loaded at start-up or streamed in live
                            by ``offline.live.DealerDaemon``);
                            ``run_four_parties`` is the one-shot wrapper.
"""
from .cluster import (ClusterPoisoned, PartyCluster, PartyResult,
                      TaskHandle, run_four_parties)
from .framing import FramingError, recv_frame, send_frames
from .model import LAN, WAN, LinkSpec, NetModel, NetModelTransport
from .socket_transport import SocketTransport, TransportTimeout

__all__ = [
    "ClusterPoisoned", "FramingError", "LAN", "WAN", "LinkSpec", "NetModel",
    "NetModelTransport", "PartyCluster", "PartyResult", "SocketTransport",
    "TaskHandle", "TransportTimeout", "recv_frame", "run_four_parties",
    "send_frames",
]
