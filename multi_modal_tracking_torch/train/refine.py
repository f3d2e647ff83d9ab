"""Alpha-Refine (box -> mask) training: the port's counterpart of the JAX
package's `train/refine.py` and of `tracking/train_refine.py` (`main`).

A step draws a batch of (reference crop + box, test crop + mask), runs
both branches of `AlphaRefineNet.forward_train`, takes binary
cross-entropy plus soft IoU on the mask logits (`mask_losses`) and
updates with AdamW, as the JAX step does: every leaf of the network,
the FrozenBatchNorm statistics and affine included (the JAX step
differentiates and updates its whole variables tree, `batch_stats` too),
weight decay on every leaf, optax's defaults otherwise. The update is
the port's fused AdamW kernel (`ops/adamw.py adamw_fused`, one launch per
step on the card; its plain version on the CPU).

Batches are host numpy, built from box-annotated samples
(`batch_from_box_dataset`): anisotropic SE crops of both frames at factor
2 (the inference wrapper's window), ImageNet normalisation, and a mask
target rasterised from the box or cut from a real mask with the image's
window.

Command line (full width: input 256, batch 16; runs on the card unless
--device cpu):

  python -m multi_modal_tracking_torch.train.refine --datasets SyntheticVideo \\
      --epochs 2 --samples_per_epoch 64 --batch_size 16 --save_dir <dir>
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multi_modal_tracking_torch.models.alpha_refine import (AlphaRefineNet, RefineSpec,
                                                            build_alpha_refine, normalise,
                                                            sample_target_se,
                                                            transform_box_to_crop_se)
from multi_modal_tracking_torch.ops.adamw import B1, B2, adamw_fused


def box_to_mask(box_xywh: np.ndarray, h: int, w: int) -> np.ndarray:
    """Rectangle mask of a box (AR's box2seg bootstrap for box-only data)."""
    m = np.zeros((h, w), np.float32)
    x0 = int(round(max(box_xywh[0], 0)))
    y0 = int(round(max(box_xywh[1], 0)))
    x1 = int(round(min(box_xywh[0] + box_xywh[2], w)))
    y1 = int(round(min(box_xywh[1] + box_xywh[3], h)))
    if x1 > x0 and y1 > y0:
        m[y0:y1, x0:x1] = 1.0
    return m


def mask_losses(logits: torch.Tensor, target: torch.Tensor, bce_weight: float = 1.0,
                iou_weight: float = 1.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Binary cross-entropy (optax.sigmoid_binary_cross_entropy's form)
    plus soft IoU on (B, H, W, 1) logits against {0, 1} targets, in f32.
    Returns (loss, {"mask_bce", "mask_soft_iou"})."""
    x = logits.float()
    t = target.float()
    bce = (-t * F.logsigmoid(x) - (1.0 - t) * F.logsigmoid(-x)).mean()
    p = torch.sigmoid(x)
    inter = (p * t).sum(dim=(1, 2, 3))
    union = (p + t - p * t).sum(dim=(1, 2, 3))
    soft_iou = 1.0 - (inter / torch.clamp(union, min=1e-6)).mean()
    return bce_weight * bce + iou_weight * soft_iou, {"mask_bce": bce, "mask_soft_iou": soft_iou}


def resize_target(target: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """A (B, H, W, 1) {0, 1} target at the logits' size: the bilinear
    resize with antialias of `jax.image.resize`'s default, then > 0.5."""
    t = F.interpolate(target.permute(0, 3, 1, 2).float(), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=True)
    return (t > 0.5).float().permute(0, 2, 3, 1)


def train_leaves(net: torch.nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every floating leaf the step trains: the
    parameters and the FrozenBatchNorm buffers (which get requires_grad),
    in state_dict order."""
    leaves = []
    for name, t in net.state_dict(keep_vars=True).items():
        if t.is_floating_point():
            t.requires_grad_(True)
            leaves.append((name, t))
    return leaves


class RefineTrainer:
    """AdamW training of an AlphaRefineNet, the JAX refine step's
    semantics. `step(batch)` takes the host batch of
    `batch_from_box_dataset` and returns its metrics as floats
    {"loss", "mask_bce", "mask_soft_iou"}. The leaves stay float32 (master
    weights); the net computes in its compute dtype (bfloat16 with
    `build_alpha_refine(dtype=torch.bfloat16)`, the JAX
    `build_refine_trainer(dtype=)`), the loss in f32."""

    def __init__(self, net: AlphaRefineNet, lr: float = 1e-3, weight_decay: float = 1e-4):
        for p in net.parameters():
            if p.dtype != torch.float32:
                raise NotImplementedError("RefineTrainer: training keeps float32 parameters")
        self.net = net
        self.spec = net.spec
        self.lr, self.weight_decay = lr, weight_decay
        self.device = next(net.parameters()).device
        named = train_leaves(net)
        self.names = [n for n, _ in named]
        self.leaves = [t for _, t in named]
        self.mu = [torch.zeros_like(t) for t in self.leaves]
        self.nu = [torch.zeros_like(t) for t in self.leaves]
        # static gradients, bound as .grad: backward accumulates into them, so
        # the kernel's device tables are built once
        self.grads = [torch.zeros_like(t) for t in self.leaves]
        for t, g in zip(self.leaves, self.grads):
            t.grad = g
        self.count = 0
        self._neg_lr = torch.full((1,), -lr, dtype=torch.float32, device=self.device)
        self._bc = torch.ones(2, dtype=torch.float32, device=self.device)
        self._table = None

    def upload(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(self.device)
                for k, v in batch.items()}

    def step(self, batch) -> Dict[str, float]:
        """One update from a host (numpy) or device batch; the gradients
        stay in `self.grads` until the next step."""
        if not isinstance(next(iter(batch.values())), torch.Tensor):
            batch = self.upload(batch)
        self.net.train()
        torch._foreach_zero_(self.grads)
        logits = self.net.forward_train(batch["ref_images"], batch["ref_boxes"],
                                        batch["test_images"])
        target = batch["test_masks"]
        if target.shape[1:3] != logits.shape[1:3]:
            # the net's masks are spec.mask_sz, the sampler's crops input_sz
            target = resize_target(target, logits.shape[1:3])
        loss, metrics = mask_losses(logits, target)
        loss.backward()
        self.count += 1
        self._bc[0].fill_(1.0 - B1 ** self.count)
        self._bc[1].fill_(1.0 - B2 ** self.count)
        with torch.no_grad():
            self._table = adamw_fused([(self.leaves, self.grads, self.mu, self.nu)],
                                      self._neg_lr, self._bc, self.weight_decay, self._table)
        out = dict(metrics, loss=loss)
        return {k: float(v.detach()) for k, v in out.items()}

    def state_dict(self) -> Dict[str, object]:
        """The network's weights, the moments and the update count, on the CPU."""
        return {"net": {n: t.detach().cpu() for n, t in zip(self.names, self.leaves)},
                "mu": [m.cpu() for m in self.mu], "nu": [v.cpu() for v in self.nu],
                "count": self.count}


def build_refine_trainer(input_sz: int = 256, lr: float = 1e-3, weight_decay: float = 1e-4,
                         seed: int = 0, device="cuda", dtype: torch.dtype = torch.float32
                         ) -> Tuple[AlphaRefineNet, RefineSpec, RefineTrainer]:
    """A randomly initialised AlphaRefineNet (from `seed`) computing in
    `dtype` on float32 parameters, and its trainer, on `device` (CUDA
    unless "cpu"; raises without a card)."""
    net, spec = build_alpha_refine(input_sz=input_sz, device=device, seed=seed, dtype=dtype)
    return net, spec, RefineTrainer(net, lr=lr, weight_decay=weight_decay)


def batch_from_box_dataset(samples, input_sz: int, rng: Optional[np.random.Generator] = None
                           ) -> Dict[str, np.ndarray]:
    """Host batch of samples (ref_img, ref_box, test_img, test_box_or_mask)
    in full-frame coordinates: both frames cropped 2x around their box with
    the anisotropic SE window (the inference wrapper's), normalised, and
    the target mask rasterised from the box or, for a real (H, W) mask, cut
    with the image's window (float64 x 255, then > 127). `rng` is unused
    (the JAX function's signature)."""
    ref_images, ref_boxes, test_images, test_masks = [], [], [], []
    for ref_img, ref_box, test_img, test_tgt in samples:
        crop_r, hf_r, wf_r = sample_target_se(ref_img, ref_box, 2.0, input_sz)
        ref_boxes.append(transform_box_to_crop_se(ref_box, hf_r, wf_r, input_sz))
        ref_images.append(normalise(crop_r))
        if isinstance(test_tgt, np.ndarray) and test_tgt.ndim == 2:
            box = _mask_box(test_tgt)
            crop_t, _, _ = sample_target_se(test_img, box, 2.0, input_sz)
            m, _, _ = sample_target_se(test_tgt[..., None].repeat(3, -1) * 255.0, box, 2.0,
                                       input_sz)
            mask = (m[..., :1] > 127).astype(np.float32)
        else:
            box = np.asarray(test_tgt, np.float32)
            crop_t, hf_t, wf_t = sample_target_se(test_img, box, 2.0, input_sz)
            bic = transform_box_to_crop_se(box, hf_t, wf_t, input_sz)
            mask = box_to_mask(bic, input_sz, input_sz)[..., None]
        test_images.append(normalise(crop_t))
        test_masks.append(mask)
    return {"ref_images": np.stack(ref_images), "ref_boxes": np.stack(ref_boxes),
            "test_images": np.stack(test_images), "test_masks": np.stack(test_masks)}


def _mask_box(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return np.asarray([0.0, 0.0, mask.shape[1], mask.shape[0]], np.float32)
    return np.asarray([xs.min(), ys.min(), xs.max() - xs.min() + 1, ys.max() - ys.min() + 1],
                      np.float32)


def sampler_batch(sampler, lo: int, batch_size: int) -> List[tuple]:
    """Samples lo .. lo + batch_size - 1 of a TrackingSampler as
    (ref_img, ref_box, test_img, test_box) tuples."""
    samples = []
    for k in range(batch_size):
        d = sampler[lo + k]
        ref = d["template_images"][0]
        ref = ref[0] if isinstance(ref, list) else ref
        test = d["search_images"][0]
        test = test[0] if isinstance(test, list) else test
        rb = np.asarray(d["template_anno"][0], np.float32).reshape(-1)[-4:]
        tb = np.asarray(d["search_anno"][0], np.float32).reshape(-1)[-4:]
        samples.append((ref, rb, test, tb))
    return samples


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m multi_modal_tracking_torch.train.refine",
                                description="Train the Alpha-Refine box-to-mask network.")
    p.add_argument("--datasets", type=str, nargs="+", default=["SyntheticVideo"])
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--samples_per_epoch", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--input_sz", type=int, default=256)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--save_dir", type=str, default="output/refine")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="weights to start from (a strict load)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from multi_modal_tracking_torch.train.builders import names2datasets
    from multi_modal_tracking_torch.train.data.sampler import TrackingSampler
    from multi_modal_tracking_torch.utils.checkpoint import load_variables, save_checkpoint

    net, spec, trainer = build_refine_trainer(input_sz=args.input_sz, lr=args.lr,
                                              device=args.device)
    if args.checkpoint:
        load_variables(args.checkpoint, net, strict=True)
    sampler = TrackingSampler(names2datasets(args.datasets), None,
                              samples_per_epoch=args.samples_per_epoch, max_gap=50,
                              num_search_frames=1, num_template_frames=1,
                              processing=lambda data, rng, out=None: dict(data, valid=True),
                              rgbt=False,
                              seed=0)
    rng = np.random.default_rng(0)
    os.makedirs(args.save_dir, exist_ok=True)
    for epoch in range(1, args.epochs + 1):
        losses = []
        for lo in range(0, args.samples_per_epoch, args.batch_size):
            batch = batch_from_box_dataset(sampler_batch(sampler, lo, args.batch_size),
                                           args.input_sz, rng)
            losses.append(trainer.step(batch)["loss"])
        print(f"epoch {epoch}: loss {np.mean(losses):.4f}", flush=True)
        save_checkpoint(args.save_dir, "AlphaRefine", epoch, dict(trainer.state_dict(),
                                                                  epoch=epoch))


if __name__ == "__main__":
    main()
