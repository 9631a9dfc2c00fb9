"""Hand-written CUDA kernels for Hopper (``sm_90a``), one family per
package, each beside the plain PyTorch version of the same function.

Dispatch is by the tensors' device alone (:func:`use_plain`):

  * tensors on the CPU run the plain PyTorch version (``ref.py``);
  * tensors on a CUDA device launch the kernel, or raise;
  * tensors all on ``meta`` (:func:`on_meta`; what the dry-run's step
    runs on) go to the flash attention and dense decode wrappers, which
    launch nothing: they return ``meta`` outputs of the kernel's shapes
    and charge the kernel's count to :mod:`repro_torch.roofline.op_cost`.
    Every other kernel raises there (its dispatch through
    :func:`use_plain`, its wrapper naming itself).  The plain version
    never runs on ``meta``: it would allocate what the kernel does not
    (the flash forward's ``[B, H, S, S]`` scores).

There is no environment variable that picks an implementation and no
fallback: a kernel that fails to build or launch is an error.  Each family
has a ``csrc/`` directory with its CUDA source (plain ``extern "C"``
interface, built by :mod:`repro_torch.kernels._build` at first use), a
wrapper that checks its operands and counts its launches, and an ``ops.py``
that dispatches.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["HEAD_DIMS", "KERNEL_DTYPES", "check_operand", "on_meta",
           "sm_count", "use_plain"]

# head dims the kernels are instantiated for: 16 = reduced() configs,
# 64 = rwkv6, 120 = h2o-danube-3-4b, 128 = yi-6b and most GQA archs,
# 256 = gemma3 and recurrentgemma
HEAD_DIMS = (16, 64, 120, 128, 256)
# dtype code passed across the C interface
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_operand(name: str, t: torch.Tensor, *, dtype: torch.dtype,
                  ndim: int, device: torch.device, align: int = 16,
                  contiguous: bool = True) -> None:
    """Raise unless ``t`` is a tensor of the given dtype, rank and device
    whose base address is ``align``-byte aligned (the kernels read tiles
    with 16-byte vector loads), and contiguous.  With ``contiguous=False``
    a strided view is taken instead, as long as its last dimension is
    contiguous and every other stride keeps rows ``align``-byte aligned
    (a kernel that takes the strides reads it in place)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: rank {t.dim()}, expected {ndim}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if not contiguous and (t.stride(-1) != 1 or any(
            st * t.element_size() % align for st in t.stride()[:-1])):
        raise ValueError(f"{name}: strides {t.stride()} need a contiguous "
                         f"last dimension and {align}-byte aligned rows")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: base address not {align}-byte aligned")


def use_plain(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (run the plain version), False
    when every tensor lies on one CUDA device (launch the kernel).  Anything
    else — mixed devices, another backend — raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def on_meta(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on ``meta``: a reckoning, which the
    flash and dense decode wrappers take without launching."""
    return all(t.device.type == "meta" for t in tensors)
