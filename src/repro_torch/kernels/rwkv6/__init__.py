from .ops import rwkv6_op, rwkv6_state_op
from .ref import rwkv6_ref, rwkv6_ref_state
from .rwkv6 import rwkv6_scan, rwkv6_scan_state

__all__ = ["rwkv6_op", "rwkv6_state_op", "rwkv6_ref", "rwkv6_ref_state",
           "rwkv6_scan", "rwkv6_scan_state"]
