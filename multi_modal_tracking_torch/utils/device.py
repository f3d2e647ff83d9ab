"""Device and precision policy of the port's entry points."""
from __future__ import annotations

import logging

import torch

log = logging.getLogger(__name__)


def resolve_device(device="cuda") -> torch.device:
    """The entry points run on the GPU unless the caller passes "cpu". With
    no GPU present a CUDA device raises: nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multi_modal_tracking_torch: no CUDA device is available; "
                               "pass device='cpu' to run the plain PyTorch versions "
                               "on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def set_f32_precision(dtype: torch.dtype) -> None:
    """Only float32 is ported so far. For it, turn TF32 off for matmuls and
    for cuDNN: cuDNN would otherwise run the patch-embed and head
    convolutions in TF32 (about three decimal digits). This sets
    process-wide PyTorch flags."""
    if dtype != torch.float32:
        raise NotImplementedError(f"dtype {dtype} is not ported yet (float32 is; "
                                  f"ROADMAP.md: bf16 comes after f32 parity)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log.info("float32 mode: TF32 disabled for CUDA matmuls and cuDNN convolutions")
