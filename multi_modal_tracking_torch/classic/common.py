"""Helpers shared by ATOM and DiMP: the port's counterpart of the JAX
package's `classic/common.py`.

Both keep pytracking's protected-ring sample memory (update_memory /
update_sample_weights): the augmented init samples are never overwritten,
the ring wraps over the remaining slots, weights decay exponentially with
the new sample entering at the learning rate (boosted on hard negatives),
and slot 0 stays at 0.25 or more. The insert runs on the device: the slot
and the gate are tensors, nothing is read back.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from multi_modal_tracking_torch.classic.dcf import (FLAG_HARD_NEGATIVE, FLAG_NORMAL,
                                                    FLAG_NOT_FOUND, FLAG_UNCERTAIN)

FLAG_NAMES = {FLAG_NORMAL: "normal", FLAG_NOT_FOUND: "not_found",
              FLAG_UNCERTAIN: "uncertain", FLAG_HARD_NEGATIVE: "hard_negative"}


def protected_ring_insert(mem_ptr: torch.Tensor, update_ok: torch.Tensor, flag: torch.Tensor,
                          pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                          weights: torch.Tensor, *, memory_size: int, n_protected: int,
                          learning_rate: float, hard_negative_learning_rate: float
                          ) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """One gated memory insert.

    mem_ptr   : int32 0-d, the monotone insert counter
    update_ok : bool 0-d; False makes the whole insert a no-op
    flag      : int32 0-d localisation flag (a hard negative boosts lr)
    pairs     : [(stored (M, ...), new (...)), ...] payloads
    weights   : (M,) sample weights

    Returns (new payloads, new weights, new mem_ptr)."""
    M, A = memory_size, n_protected
    ptr = torch.where(mem_ptr < M, mem_ptr, A + torch.remainder(mem_ptr - M, M - A))
    idx = ptr.to(torch.int64).reshape(1)
    outs = []
    for stored, new in pairs:
        upd = stored.index_copy(0, idx, new[None].to(stored.dtype))
        outs.append(torch.where(update_ok, upd, stored))
    lr = torch.where(flag == FLAG_HARD_NEGATIVE,
                     torch.full((), hard_negative_learning_rate, device=weights.device),
                     torch.full((), learning_rate, device=weights.device))
    w = (weights * (1.0 - lr)).index_copy(0, idx, lr.reshape(1))
    first = torch.clamp(w[:1], min=0.25)               # the anchored init slot
    w = torch.cat([first, w[1:]])
    w = torch.where(update_ok, w, weights)
    return outs, w, mem_ptr + update_ok.to(torch.int32)


def upload_image(image, device: torch.device) -> torch.Tensor:
    """A frame (H, W, 3) numpy array (uint8 or float) as a tensor on
    `device`, its dtype kept (crops cast to float32 on the device)."""
    arr = np.ascontiguousarray(np.asarray(image))
    return torch.from_numpy(arr).to(device)


def fetch(*tensors: torch.Tensor) -> List[float]:
    """The values of a frame's small outputs (flag, score, centre, size) in
    ONE copy to the host: the step's only read back."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    return flat.cpu().tolist()


def box_xywh(center: Sequence[float], size: Sequence[float]) -> List[float]:
    """(cy, cx), (h, w) -> [x, y, w, h] as the host API reports it, in
    float32 arithmetic as the JAX package's numpy does it."""
    c, s = np.asarray(center, np.float32), np.asarray(size, np.float32)
    return [float(c[1] - s[1] / 2), float(c[0] - s[0] / 2), float(s[1]), float(s[0])]


def down2(n: int) -> int:
    """The output extent of a stride-2 3x3 (or 7x7, pad 3) conv or max
    pool with 'half' padding: ceil(n / 2)."""
    return (n - 1) // 2 + 1


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along dim 0 for a 0-d index tensor on x's device, without a
    read back to the host."""
    return x.index_select(0, idx.reshape(1).to(torch.int64))[0]


def center_box(center: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """(cy, cx), (h, w) -> xywh (4,) on the device."""
    return torch.stack([center[1] - size[1] / 2.0, center[0] - size[0] / 2.0, size[1], size[0]])


def init_state(box) -> Tuple[torch.Tensor, torch.Tensor]:
    """An init box [x, y, w, h] (device tensor) -> centre (cy, cx) and size
    (h, w)."""
    center = torch.stack([box[1] + box[3] / 2.0, box[0] + box[2] / 2.0])
    return center, torch.stack([box[3], box[2]])
