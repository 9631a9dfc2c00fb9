from .flash_attention import (TENSOR_CORE_HEAD_DIMS, flash_attention,
                              flash_attention_fwd_lse, fwd_route,
                              library_fwd_route)
from .flash_attention_bwd import (bwd_route, dkv_split,
                                  flash_attention_bwd, flash_attention_dkv,
                                  flash_attention_dq, library_bwd_route)
from .ops import attention_op
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref
from .vjp import FlashAttention, flash_attention_grad

__all__ = ["flash_attention", "flash_attention_fwd_lse",
           "flash_attention_bwd", "flash_attention_dq",
           "flash_attention_dkv", "flash_attention_grad", "FlashAttention",
           "attention_op", "attention_ref", "attention_lse_ref",
           "attention_bwd_ref", "bwd_route", "library_bwd_route",
           "fwd_route", "library_fwd_route", "TENSOR_CORE_HEAD_DIMS",
           "dkv_split"]
