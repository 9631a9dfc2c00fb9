"""Serving: the SmartConf-governed continuous-batching engine on paged KV."""

from .engine import (Admission, Request, RejectReason, ServeEngine,
                     TICK_STATS_KEYS)
from .options import ServeOptions

__all__ = ["Admission", "Request", "RejectReason", "ServeEngine",
           "ServeOptions", "TICK_STATS_KEYS"]
