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


#: the compute dtypes of the port, by the names the command lines take
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def set_precision(dtype: torch.dtype) -> None:
    """Check that `dtype` is a compute dtype of the port (float32 or
    bfloat16; anything else raises) and set the process-wide PyTorch flags
    of its matmuls and convolutions. TF32 goes off for matmuls and cuDNN,
    for both: in float32 cuDNN would otherwise run the patch-embed and head
    convolutions in TF32 (about three decimal digits); in bfloat16 the flags
    keep whatever float32 product is left exact. For bfloat16, cuBLAS may no
    longer reduce split-K partial sums in bf16
    (`allow_bf16_reduced_precision_reduction`, True by default): XLA
    accumulates a bf16 product in f32 and rounds once, the rounding point
    of `models/layers.py`, and training's weight gradients reduce over
    B * N rows, where cuBLAS picks split-K."""
    if dtype not in DTYPES.values():
        raise NotImplementedError(f"dtype {dtype} is not ported (float32 and bfloat16 are)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dtype == torch.bfloat16:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log.info("%s mode: TF32 disabled for CUDA matmuls and cuDNN convolutions", dtype)


def require_float32_params(model: torch.nn.Module, what: str) -> None:
    """Training paths keep float32 parameters (the master weights), whatever
    the model's compute dtype, as the JAX package's flax modules do
    (param_dtype float32). A model whose parameters were cast to bf16 for
    serving (eval.evaltracker.create_tracker) raises: train the float32
    model with compute dtype bf16 instead (`models.build.build_model(...,
    dtype=torch.bfloat16)`)."""
    bad = sorted({str(p.dtype) for p in model.parameters() if p.dtype != torch.float32})
    if bad:
        raise NotImplementedError(f"{what}: parameters of dtype {bad}; training keeps float32 "
                                  f"parameters and computes in the model's compute dtype")
