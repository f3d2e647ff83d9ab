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


def set_precision(dtype: torch.dtype) -> None:
    """Check that `dtype` is a compute dtype of the port (float32 or
    bfloat16; anything else raises) and turn TF32 off for matmuls and cuDNN,
    for both: in float32 cuDNN would otherwise run the patch-embed and head
    convolutions in TF32 (about three decimal digits); in bfloat16 the flags
    keep whatever float32 product is left exact. This sets process-wide
    PyTorch flags."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"dtype {dtype} is not ported (float32 and bfloat16 are)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log.info("%s mode: TF32 disabled for CUDA matmuls and cuDNN convolutions", dtype)


#: what raises for bf16 on a training path (and for bf16 under autograd)
TRAINING_BF16 = ("bf16 training is not ported yet (ROADMAP.md queue 1 item 4b: the bf16 "
                 "backward kernels K2-bf16 and K4-bf16, TRAIN.AMP, f32 master weights)")


def require_float32_params(model: torch.nn.Module, what: str) -> None:
    """Training paths take float32 parameters only; a model cast to bf16
    (eval.evaltracker.create_tracker(dtype=torch.bfloat16)) raises."""
    bad = sorted({str(p.dtype) for p in model.parameters() if p.dtype != torch.float32})
    if bad:
        raise NotImplementedError(f"{what}: parameters of dtype {bad}; {TRAINING_BF16}")
