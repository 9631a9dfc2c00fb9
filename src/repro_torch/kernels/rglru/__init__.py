from .ops import rglru_op, rglru_state_op
from .ref import rglru_ref, rglru_ref_state
from .rglru import rglru_scan, rglru_scan_state

__all__ = ["rglru_op", "rglru_state_op", "rglru_ref", "rglru_ref_state",
           "rglru_scan", "rglru_scan_state"]
