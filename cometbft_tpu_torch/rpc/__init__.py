from .server import RPCServer
from .client import HTTPClient

__all__ = ["RPCServer", "HTTPClient"]
