"""Result analysis: success/precision curves, AUC/OP/Precision/NormPrec
tables, matplotlib plots.

The port's own copy of the JAX package's `eval/analysis.py`; its tables
equal the JAX package's exactly. `plot_results` imports matplotlib when it
is called and raises ImportError where matplotlib is not installed.
Parity target of both: lib/test/analysis/extract_results.py extract_results
(:204-330: per-sequence error curves binned over thresholds, pickle cache)
and plot_results.py get_auc_curve (:227-232), get_prec_curve (:235-240),
print_results (:363-425), plot_results (:243-336),
print_per_sequence_results (:530+).
"""
from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence as Seq

import numpy as np

from multi_modal_tracking_torch.eval.data import load_text
from multi_modal_tracking_torch.eval.metrics import (calc_seq_err_robust,
                                                   calc_seq_err_robust_rgbt)


class TrackerResults:
    """Handle to one tracker's results directory (analysis/tracker.py:30-55)."""

    def __init__(self, results_dir: str, display_name: Optional[str] = None):
        self.results_dir = results_dir
        self.display_name = display_name or os.path.basename(results_dir.rstrip("/"))


def extract_results(trackers: List[TrackerResults], dataset, report_name: str = "report",
                    plot_bin_gap: float = 0.05, skip_missing_seq: bool = False,
                    exclude_invalid_frames: bool = False,
                    result_plot_path: Optional[str] = None) -> dict:
    eps = 1e-16
    threshold_set_overlap = np.arange(0.0, 1.0 + plot_bin_gap, plot_bin_gap)
    threshold_set_center = np.arange(0, 51, dtype=np.float64)
    threshold_set_center_norm = np.arange(0, 51, dtype=np.float64) / 100.0

    n_seq, n_trk = len(dataset), len(trackers)
    avg_overlap_all = np.zeros((n_seq, n_trk))
    succ_overlap = np.zeros((n_seq, n_trk, threshold_set_overlap.size), np.float32)
    succ_center = np.zeros((n_seq, n_trk, threshold_set_center.size), np.float32)
    succ_center_norm = np.zeros((n_seq, n_trk, threshold_set_center_norm.size), np.float32)
    valid_sequence = np.ones(n_seq, dtype=bool)

    for seq_id, seq in enumerate(dataset):
        anno_bb = np.asarray(seq.ground_truth_rect)
        target_visible = seq.target_visible
        for trk_id, trk in enumerate(trackers):
            results_path = os.path.join(trk.results_dir, f"{seq.name}.txt")
            if not os.path.isfile(results_path):
                alt = os.path.join(trk.results_dir, seq.dataset, f"{seq.name}.txt")
                if os.path.isfile(alt):
                    results_path = alt
                elif skip_missing_seq:
                    valid_sequence[seq_id] = False
                    break
                else:
                    raise FileNotFoundError(f"Result not found: {results_path}")
            pred_bb = load_text(results_path, delimiter=("\t", ",", " ", None))

            if anno_bb.ndim == 3:
                err_overlap, err_center, err_center_norm, valid_frame = \
                    calc_seq_err_robust_rgbt(pred_bb, anno_bb, seq.dataset, target_visible)
            else:
                err_overlap, err_center, err_center_norm, valid_frame = \
                    calc_seq_err_robust(pred_bb, anno_bb, seq.dataset, target_visible)

            # NaN when a sequence has zero valid frames — matches the
            # reference exactly (extract_results.py:287 does the same
            # empty-slice mean); curves below use the full length so they
            # stay finite
            avg_overlap_all[seq_id, trk_id] = (
                err_overlap[valid_frame].mean() if valid_frame.any()
                else np.nan)
            seq_length = int(valid_frame.sum()) if exclude_invalid_frames else anno_bb.shape[0]
            if seq_length <= 0:
                raise ValueError("Seq length zero")
            succ_overlap[seq_id, trk_id] = (
                err_overlap[:, None] > threshold_set_overlap[None]).sum(0) / seq_length
            succ_center[seq_id, trk_id] = (
                err_center[:, None] <= threshold_set_center[None]).sum(0) / seq_length
            succ_center_norm[seq_id, trk_id] = (
                err_center_norm[:, None] <= threshold_set_center_norm[None]).sum(0) / seq_length

    eval_data = {
        "sequences": [s.name for s in dataset],
        "trackers": [t.display_name for t in trackers],
        "valid_sequence": valid_sequence,
        "ave_success_rate_plot_overlap": succ_overlap,
        "ave_success_rate_plot_center": succ_center,
        "ave_success_rate_plot_center_norm": succ_center_norm,
        "avg_overlap_all": avg_overlap_all,
        "threshold_set_overlap": threshold_set_overlap,
        "threshold_set_center": threshold_set_center,
        "threshold_set_center_norm": threshold_set_center_norm,
    }
    if result_plot_path:
        os.makedirs(result_plot_path, exist_ok=True)
        with open(os.path.join(result_plot_path, "eval_data.pkl"), "wb") as f:
            pickle.dump(eval_data, f)
    return eval_data


def get_auc_curve(succ_overlap: np.ndarray, valid_sequence: np.ndarray):
    """(plot_results.py:227-232)"""
    curve = succ_overlap[valid_sequence].mean(0) * 100.0
    return curve, curve.mean(-1)


def get_prec_curve(succ_center: np.ndarray, valid_sequence: np.ndarray):
    """(plot_results.py:235-240): score = value at threshold 20px (or 0.20)."""
    curve = succ_center[valid_sequence].mean(0) * 100.0
    return curve, curve[:, 20]


def compute_scores(eval_data: dict) -> dict:
    """AUC / OP50 / OP75 / Precision / Norm Precision per tracker."""
    valid = eval_data["valid_sequence"]
    thr_ov = eval_data["threshold_set_overlap"]
    auc_curve, auc = get_auc_curve(eval_data["ave_success_rate_plot_overlap"], valid)
    prec_curve, prec = get_prec_curve(eval_data["ave_success_rate_plot_center"], valid)
    nprec_curve, nprec = get_prec_curve(eval_data["ave_success_rate_plot_center_norm"], valid)
    return {
        "trackers": eval_data["trackers"],
        "AUC": auc,
        "OP50": auc_curve[:, np.argmin(np.abs(thr_ov - 0.50))],
        "OP75": auc_curve[:, np.argmin(np.abs(thr_ov - 0.75))],
        "Precision": prec,
        "Norm Precision": nprec,
        "auc_curve": auc_curve,
        "prec_curve": prec_curve,
        "norm_prec_curve": nprec_curve,
    }


def generate_formatted_report(row_labels: Seq[str], scores: dict,
                              table_name: str = "") -> str:
    """(plot_results.py:338-360)"""
    name_width = max([len(d) for d in row_labels] + [len(table_name)]) + 5
    min_score_width = 10
    report = "{label: <{width}} |".format(label=table_name, width=name_width)
    metrics = [k for k in ("AUC", "OP50", "OP75", "Precision", "Norm Precision")
               if k in scores]
    score_widths = [max(min_score_width, len(k) + 3) for k in metrics]
    for k, w in zip(metrics, score_widths):
        report += "{metric: <{width}} |".format(metric=k, width=w)
    report += "\n"
    for trk_id, label in enumerate(row_labels):
        report += "{label: <{width}} |".format(label=label, width=name_width)
        for k, w in zip(metrics, score_widths):
            report += "{score: <{width}.2f} |".format(score=scores[k][trk_id], width=w)
        report += "\n"
    return report


def print_results(trackers: List[TrackerResults], dataset, report_name: str = "report",
                  eval_data: dict = None, **kwargs) -> dict:
    """Extract + print the metric table; returns the scores dict.
    Pass `eval_data` (a prior extract_results return) to skip re-reading
    and re-scoring every result file."""
    if eval_data is None:
        eval_data = extract_results(trackers, dataset, report_name, **kwargs)
    scores = compute_scores(eval_data)
    print(f"\nReport: {report_name}, {int(eval_data['valid_sequence'].sum())} / "
          f"{len(eval_data['sequences'])} sequences")
    print(generate_formatted_report(scores["trackers"], scores, table_name=report_name))
    return scores


def print_per_sequence_results(trackers: List[TrackerResults], dataset,
                               report_name: str = "report",
                               eval_data: dict = None, **kwargs):
    """Per-sequence average-overlap table (plot_results.py:530+)."""
    if eval_data is None:
        eval_data = extract_results(trackers, dataset, report_name, **kwargs)
    avg = eval_data["avg_overlap_all"] * 100.0
    names = eval_data["sequences"]
    width = max(len(n) for n in names) + 3
    print("{: <{w}}".format("Sequence", w=width)
          + " | ".join(f"{t: <12}" for t in eval_data["trackers"]))
    for i, n in enumerate(names):
        print("{: <{w}}".format(n, w=width)
              + " | ".join(f"{avg[i, j]: <12.2f}" for j in range(avg.shape[1])))
    return avg


_PLOT_LABELS = {
    # (xlabel, ylabel, title) per plot type per language; "cn" mirrors the
    # reference's plot_results_cn.py (Chinese-labelled figure variant)
    "en": {
        "success": ("Overlap threshold", "Overlap Precision [%]", "Success plot"),
        "prec": ("Location error threshold [pixels]", "Distance Precision [%]",
                 "Precision plot"),
        "norm_prec": ("Location error threshold", "Distance Precision [%]",
                      "Normalized Precision plot"),
    },
    "cn": {
        "success": ("重叠率阈值", "成功率 [%]", "成功率图"),
        "prec": ("中心位置误差阈值 [像素]", "精确率 [%]", "精确率图"),
        "norm_prec": ("归一化中心误差阈值", "精确率 [%]", "归一化精确率图"),
    },
}


def plot_results(trackers: List[TrackerResults], dataset, report_name: str = "report",
                 plot_types=("success", "prec", "norm_prec"),
                 result_plot_path: str = "plots", language: str = "en",
                 eval_data: dict = None, **kwargs):
    """Success / precision / normalized-precision plots
    (plot_results.py:243-336; language="cn" reproduces plot_results_cn.py).
    Saved as pdf+png per plot type."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if eval_data is None:
        eval_data = extract_results(trackers, dataset, report_name,
                                    result_plot_path=result_plot_path,
                                    **kwargs)
    scores = compute_scores(eval_data)
    os.makedirs(result_plot_path, exist_ok=True)

    lab = _PLOT_LABELS[language]
    specs = {
        "success": (scores["auc_curve"], eval_data["threshold_set_overlap"],
                    scores["AUC"], *lab["success"]),
        "prec": (scores["prec_curve"], eval_data["threshold_set_center"],
                 scores["Precision"], *lab["prec"]),
        "norm_prec": (scores["norm_prec_curve"], eval_data["threshold_set_center_norm"],
                      scores["Norm Precision"], *lab["norm_prec"]),
    }
    out_files = []
    for pt in plot_types:
        curve, x, score, xlabel, ylabel, title = specs[pt]
        order = np.argsort(-np.asarray(score))
        fig, ax = plt.subplots()
        for idx in order:
            ax.plot(x, curve[idx], linewidth=2,
                    label=f"{scores['trackers'][idx]} [{score[idx]:.1f}]")
        ax.set(xlabel=xlabel, ylabel=ylabel, title=f"{title} — {report_name}")
        ax.grid(True, linestyle="-.")
        ax.legend(loc="lower left" if pt == "success" else "lower right", fontsize=9)
        for ext in ("png", "pdf"):
            p = os.path.join(result_plot_path, f"{pt}_plot_{report_name}.{ext}")
            fig.savefig(p, dpi=150, bbox_inches="tight")
            out_files.append(p)
        plt.close(fig)
    return out_files
