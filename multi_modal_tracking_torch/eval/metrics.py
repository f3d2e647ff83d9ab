"""Per-sequence tracking error measures (pure numpy).

The port's own copy of the JAX package's `eval/metrics.py`, equal to it
exactly. Parity target of both: lib/test/analysis/extract_results.py —
calc_err_center (:16-25), calc_iou_overlap (:28-39, the +1/-1 pixel
convention), calc_seq_err_robust (:42-103) and the RGBT variant
calc_seq_err_robust_rgbt (:106-201): IoU vs both modal GTs -> max,
center error -> min; VTUAV sparse GT -> predictions subsampled [::10];
VOT off-by-one repair; first frame forced to GT.
"""
from __future__ import annotations

import numpy as np


def calc_err_center(pred_bb: np.ndarray, anno_bb: np.ndarray,
                    normalized: bool = False) -> np.ndarray:
    pred_center = pred_bb[:, :2] + 0.5 * (pred_bb[:, 2:] - 1.0)
    anno_center = anno_bb[:, :2] + 0.5 * (anno_bb[:, 2:] - 1.0)
    # zero-size annotations produce inf/nan here; those frames are masked as
    # invalid by the callers, matching the reference's silent torch division
    with np.errstate(divide="ignore", invalid="ignore"):
        if normalized:
            pred_center = pred_center / anno_bb[:, 2:]
            anno_center = anno_center / anno_bb[:, 2:]
        return np.sqrt(((pred_center - anno_center) ** 2).sum(1))


def calc_iou_overlap(pred_bb: np.ndarray, anno_bb: np.ndarray) -> np.ndarray:
    tl = np.maximum(pred_bb[:, :2], anno_bb[:, :2])
    br = np.minimum(pred_bb[:, :2] + pred_bb[:, 2:] - 1.0,
                    anno_bb[:, :2] + anno_bb[:, 2:] - 1.0)
    sz = np.clip(br - tl + 1.0, 0.0, None)
    intersection = sz.prod(axis=1)
    union = pred_bb[:, 2:].prod(axis=1) + anno_bb[:, 2:].prod(axis=1) - intersection
    return intersection / union


def _align_lengths(pred_bb: np.ndarray, n_anno: int, dataset: str,
                   first_anno_rect: np.ndarray,
                   vot_repair: bool = False) -> np.ndarray:
    """Length-mismatch repairs (extract_results.py:129-154). The
    prepend-GT VOT-toolkit repair (pred == n_anno-1) exists only in the
    RGBT variant (extract_results.py:136-138); the unimodal path
    (extract_results.py:60-77) zero-pads short results at the END —
    prepending there would shift every prediction by one frame."""
    if pred_bb.shape[0] == n_anno:
        return pred_bb
    if dataset == "lasot":
        if pred_bb.shape[0] > n_anno:
            return pred_bb[:n_anno]
        raise ValueError("Mis-match in tracker prediction and GT lengths")
    if vot_repair and pred_bb.shape[0] == n_anno - 1:
        # VOT-toolkit results drop the init frame; restore it from GT.
        return np.concatenate([first_anno_rect[None], pred_bb], axis=0)
    if pred_bb.shape[0] > n_anno:
        return pred_bb[:n_anno]
    pad = np.zeros((n_anno - pred_bb.shape[0], 4), dtype=pred_bb.dtype)
    return np.concatenate([pred_bb, pad], axis=0)


def calc_seq_err_robust(pred_bb: np.ndarray, anno_bb: np.ndarray, dataset: str,
                        target_visible=None):
    """Unimodal per-frame errors. Returns (overlap, center, center_norm, valid)."""
    pred_bb = np.array(pred_bb, dtype=np.float64, copy=True)
    anno_bb = np.asarray(anno_bb, dtype=np.float64)
    if np.isnan(pred_bb).any() or (pred_bb[:, 2:] < 0.0).any():
        raise ValueError("Invalid results (NaN or negative size)")
    if np.isnan(anno_bb).any() and dataset != "uav":
        raise ValueError("NaNs in annotation")

    # zero-size predictions -> carry previous frame (extract_results.py:55-58;
    # the reference indexes anno_bb[i] with i from the PRED range, a latent
    # IndexError when a results file is longer than the GT — bound the loop
    # to the overlap, the excess rows are trimmed by _align_lengths anyway)
    bad = (pred_bb[:, 2:] == 0.0).any(axis=1)
    if bad.any():
        for i in range(1, min(pred_bb.shape[0], anno_bb.shape[0])):
            if bad[i] and not np.isnan(anno_bb[i]).any():
                pred_bb[i] = pred_bb[i - 1]
                bad[i] = False

    pred_bb = _align_lengths(pred_bb, anno_bb.shape[0], dataset, anno_bb[0])
    pred_bb[0] = anno_bb[0]

    if target_visible is not None:
        target_visible = np.asarray(target_visible).astype(bool)
        valid = ((anno_bb[:, 2:] > 0.0).sum(1) == 2) & target_visible
    else:
        valid = (anno_bb[:, 2:] > 0.0).sum(1) == 2

    err_center = calc_err_center(pred_bb, anno_bb)
    err_center_norm = calc_err_center(pred_bb, anno_bb, normalized=True)
    err_overlap = calc_iou_overlap(pred_bb, anno_bb)

    # Reference quirk kept for metric parity (extract_results.py:90-95 with
    # analysis thresholds `err <= t`): the -1.0 invalid markers count as
    # precision/norm-precision HITS (uav pixel precision, every dataset's
    # norm precision) while -1.0 overlap counts as a success MISS.
    err_center[~valid] = -1.0 if dataset == "uav" else np.inf
    err_center_norm[~valid] = -1.0
    err_overlap[~valid] = -1.0
    if dataset == "lasot" and target_visible is not None:
        # the reference would ~None-crash here; real LaSOT sequences always
        # carry visibility, so guarding changes nothing on the benchmark
        err_center_norm[~target_visible] = np.inf
        err_center[~target_visible] = np.inf
    if np.isnan(err_overlap).any():
        raise ValueError("NaNs in calculated overlap")
    return err_overlap, err_center, err_center_norm, valid


def calc_seq_err_robust_rgbt(pred_bb: np.ndarray, anno_bb_vi: np.ndarray,
                             dataset: str, target_visible=None):
    """RGBT per-frame errors vs both modal GTs (extract_results.py:106-201).

    anno_bb_vi: (N, 2, 4), [:, 0] = RGB gt, [:, 1] = TIR gt.
    overlap = max over modalities, center errors = min over modalities.
    """
    pred_bb = np.array(pred_bb, dtype=np.float64, copy=True)
    anno_bb_vi = np.asarray(anno_bb_vi, dtype=np.float64)
    if np.isnan(pred_bb).any() or (pred_bb[:, 2:] < 0.0).any():
        raise ValueError("Invalid results (NaN or negative size)")
    if np.isnan(anno_bb_vi).any() and dataset != "uav":
        raise ValueError("NaNs in annotation")

    # NOTE: the zero-size carry-forward repair is deliberately ABSENT here —
    # the reference's RGBT variant has it commented out
    # (extract_results.py:120-123), unlike the unimodal path.

    if dataset == "VTUAV":
        # sparse 10-frame annotations: evaluate every 10th prediction
        pred_bb = pred_bb[0::10]

    pred_bb = _align_lengths(pred_bb, anno_bb_vi.shape[0], dataset,
                             anno_bb_vi[0, 0], vot_repair=True)
    pred_bb[0] = anno_bb_vi[0, 0]          # first frame forced to the RGB gt

    err_center_m, err_center_norm_m, err_overlap_m = [], [], []
    for idx in range(2):
        anno = anno_bb_vi[:, idx]
        err_center_m.append(calc_err_center(pred_bb, anno))
        err_center_norm_m.append(calc_err_center(pred_bb, anno, normalized=True))
        err_overlap_m.append(calc_iou_overlap(pred_bb, anno))
    err_center = np.minimum(err_center_m[0], err_center_m[1])
    err_center_norm = np.minimum(err_center_norm_m[0], err_center_norm_m[1])
    err_overlap = np.maximum(err_overlap_m[0], err_overlap_m[1])

    valid = (((anno_bb_vi[:, 0, 2:] > 0.0).sum(1) == 2)
             & ((anno_bb_vi[:, 1, 2:] > 0.0).sum(1) == 2))
    if target_visible is not None:
        valid = valid & np.asarray(target_visible).astype(bool)

    err_center[~valid] = -1.0 if dataset == "uav" else np.inf
    err_center_norm[~valid] = -1.0
    err_overlap[~valid] = -1.0
    if dataset == "lasot" and target_visible is not None:
        # same convention as the unimodal path (extract_results.py:195-197):
        # lasot masks centre errors on VISIBILITY, not on the valid mask
        tv = np.asarray(target_visible).astype(bool)
        err_center_norm[~tv] = np.inf
        err_center[~tv] = np.inf
    if np.isnan(err_overlap).any():
        raise ValueError("NaNs in calculated overlap")
    return err_overlap, err_center, err_center_norm, valid
