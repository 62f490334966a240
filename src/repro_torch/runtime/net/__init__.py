"""Network layer of the port: the LAN/WAN network model for modeled wire
times.  Sockets and the multi-process cluster are not ported yet."""
from .model import LAN, WAN, LinkSpec, NetModel, NetModelTransport

__all__ = ["LAN", "WAN", "LinkSpec", "NetModel", "NetModelTransport"]
