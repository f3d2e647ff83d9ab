"""multi_modal_tracking_torch: the PyTorch / CUDA (NVIDIA H100) port of
multi_modal_tracking_tpu.

A package of its own beside the JAX package, with the same layout
(config/, ops/, models/, tracking/, eval/, train/, utils/). It imports
torch and never jax, flax, cv2 or anything of multi_modal_tracking_tpu; the
JAX package is its reference, and only the tests import both.

What it covers so far, for every RGB-T script (the `asymmetric_shared*`
flagship family and the `mixformer_vit_rgbt*` family: two-stream,
shared-LN, unibackbone, two-stream online) with any FUSION_CLASS of the
JAX package's table, in bf16 by default and in float32:
  * tracking: eval.evaltracker.create_tracker, the tracker classes in
    tracking.tracker and their lockstep twins in tracking.batched;
  * training: train.trainer.Trainer (epoch loop, CE keep-rate schedule),
    train.train_step.make_train_step, the regime AdamW of train.optimizer,
    and the numpy data pipeline of train.data on the synthetic RGB-T set.

The entry points (create_tracker, the trackers, models.build.build_model,
Trainer, make_train_step) run on the GPU unless the caller passes
device="cpu", and raise when there is no GPU. The kernels that replace the
JAX package's four Pallas kernels (mixed-attention forward and backward,
MSDA forward and backward) are hand-written CUDA in csrc/, built with nvcc
on first use (ops/_build.py) and differentiable through
torch.autograd.Function; on CPU tensors their wrappers run the plain
PyTorch versions. On the GPU the trackers' per-frame step and the
Trainer's step run as CUDA graphs (tracking/graphs.py).

Several GPUs (parallel/): one process a GPU, the group formed from
torchrun's environment or explicit flags (parallel/distributed.py); the
Trainer then trains data-parallel (synced BatchNorm, gradients averaged in
one NCCL collective captured in the step's graphs), optionally FSDP-sharded
with sharded checkpoints (parallel/mesh.py), and eval.running.run_dataset
spreads its worker threads over the given cards.
"""

__version__ = "0.2.0"
